// Fused dense fp32 scan top-k over a bank slab (Hopper).
//
// Replaces the TPU kernel repro/kernels/retrieval_topk/kernel.py::_topk_kernel
// (entry retrieval_topk_pallas).
//
// Function: q (Q, E) f32, bank (N, E) f32; score = q . b, both sides
// optionally L2-normalised (x * rsqrt(max(sum x^2, 1e-16))); rows >= n_valid
// are masked; output the per-query top k (k <= 64), descending, ties to the
// lower row id, as (Q, k) f32 scores and (Q, k) int32 row ids.
//
// What bounds it on the H100: at Q = 192, N = 2^20, E = 1024 the scan does
// 2*Q*N*E = 4.1e11 fp32 operations against 4.3 GB of bank: fp32 FMA throughput
// (67 TFLOP/s, no tensor cores for fp32: TF32 stays off), not the 3.35 TB/s
// of HBM, provided the bank crosses into the SMs about once and each shared-
// memory load feeds many FMAs.
//
// Design: the register-blocked GEMM tile with the top-k fused behind it
// (topk_tile.cuh, shared with the int4 scan) over the DenseBank policy:
// cp.async brings 32-float slices of the bank into the ring and the FMA
// loop reads them as they land. For `normalize` the query norms come from a
// prologue and each bank row's sum of squares from its staged slices; both
// multiply the finished dot. A 12 x 8 tile a thread (one block an SM, 254
// registers) loads less per FMA but measured slower on the card than 6 x 8
// at two blocks an SM.
#include "topk_tile.cuh"

namespace {

template <int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
topk_dense_pass1(const float* __restrict__ q, const float* __restrict__ bank,
                 float* __restrict__ part_s, int* __restrict__ part_i, int Q,
                 int E, int k, int n_valid, int normalize, int chunk_rows,
                 int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  scan_pass1<TM, VEC, DenseBank<VEC>>(q, part_s, part_i, Q, E, k, n_valid,
                                      normalize, chunk_rows, n_chunks, smem,
                                      bank, E);
}

}  // namespace

// chunk_rows must be a multiple of 128 (the tile). The query tile is 96
// rows unless 64-row tiles pad Q less.
extern "C" int topk_dense_launch(const float* q, const float* bank,
                                 float* part_s, int* part_i, float* out_s,
                                 int* out_i, int Q, int E, int k, int n_valid,
                                 int normalize, int chunk_rows, int n_chunks,
                                 cudaStream_t stream) {
  if (k < 1 || k > KMAX || E < 1 || Q < 1 || n_chunks < 1 ||
      n_chunks > 65535 || chunk_rows % BN)
    return (int)cudaErrorInvalidValue;
#define PASS(TM, VEC)                                                        \
  launch_scan<TM, DenseBank<VEC>>(topk_dense_pass1<TM, VEC>, q, part_s,      \
                                  part_i, out_s, out_i, Q, E, k, n_valid,    \
                                  normalize, chunk_rows, n_chunks, stream,   \
                                  bank)
  const bool vec = E % 4 == 0;
  cudaError_t err;
  if (wide_query_tile(Q))
    err = vec ? PASS(6, true) : PASS(6, false);
  else
    err = vec ? PASS(4, true) : PASS(4, false);
#undef PASS
  return (int)err;
}
