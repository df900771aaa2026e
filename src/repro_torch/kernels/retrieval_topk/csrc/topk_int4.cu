// Fused int4 dequant-and-scan top-k over a packed embedding bank (Hopper).
//
// Replaces the TPU kernel repro/kernels/retrieval_topk/kernel.py
// ::_topk_int4_kernel (entry retrieval_topk_int4_pallas).
//
// Function: q (Q, E) f32, packed (N, E/2) int8 nibble rows (low nibble =
// element 2i, high nibble = element 2i+1, two's complement), scales (N, 1)
// f32. score = q . (nibbles * scale) in fp32 (optionally both sides
// L2-normalised), rows >= n_valid are masked, output the per-query top k
// (k <= 64) sorted by descending score, ties to the lower row id, as
// (Q, k) f32 scores and (Q, k) int32 row ids.
//
// What bounds it on the H100: at the serving shape (Q = 192 query rows,
// N = 2^20, E = 1024) the scan does 2*Q*N*E = 4.1e11 fp32 operations against
// 0.54 GB of int4 rows + scales, so it is bound by fp32 FMA issue (67
// TFLOP/s, no tensor cores for fp32), not by the 3.35 TB/s of HBM: what
// matters is how many FMAs each shared-memory load and each decoded nibble
// feed.
//
// Design: the register-blocked GEMM tile with the top-k fused behind it
// (topk_tile.cuh, shared with the dense fp32 scan) over the Int4Bank
// policy. A block owns 96 queries (64 when that pads Q less) x 128 bank
// rows; cp.async brings each 32-element slice as 16 packed bytes a row (and
// each row's scale with the tile's first slice) into a 2-stage ring beside
// the query slices; once a slice lands, every nibble is decoded once for the
// block (nib2f: integer ops, no conversion unit) into an fp32 slice of
// stride 36, and the FMA loop is the dense tile's own: a 6 x 8 register tile
// a thread, 96 FMAs for each decoded element. Each warp merges its rows
// into the top-k lists at the tile's end with no block barrier; pass 2 is
// shared (topk_common.cuh). The wrapper (kernel.py) sizes the chunks so
// that the grid is one wave at two blocks an SM with the query blocks of a
// chunk side by side, so the bank crosses from HBM about once. Scores keep
// the scan contract of topk_common.cuh, so the gathered (IVF) scan scores a
// row bit for bit alike. E % 32 != 0 (E/2 not a multiple of 16 bytes)
// decodes straight from global memory, byte by byte.
#include "topk_tile.cuh"

namespace {

template <int TM, bool VEC, bool AVEC>
__global__ void __launch_bounds__(THREADS, 2)
topk_int4_pass1(const float* __restrict__ q, const int8_t* __restrict__ packed,
                const float* __restrict__ scales, float* __restrict__ part_s,
                int* __restrict__ part_i, int Q, int E, int k, int n_valid,
                int normalize, int chunk_rows, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  scan_pass1<TM, AVEC, Int4Bank<VEC>>(q, part_s, part_i, Q, E, k, n_valid,
                                      normalize, chunk_rows, n_chunks, smem,
                                      packed, scales, E);
}

}  // namespace

// chunk_rows must be a multiple of 128 (the tile). The query tile is 96
// rows unless 64-row tiles pad Q less.
extern "C" int topk_int4_launch(const float* q, const int8_t* packed,
                                const float* scales, float* part_s,
                                int* part_i, float* out_s, int* out_i, int Q,
                                int E, int k, int n_valid, int normalize,
                                int chunk_rows, int n_chunks,
                                cudaStream_t stream) {
  if (k < 1 || k > KMAX || E < 2 || (E & 1) || Q < 1 || n_chunks < 1 ||
      n_chunks > 65535 || chunk_rows % BN)
    return (int)cudaErrorInvalidValue;
#define PASS(TM, VEC, AVEC)                                                \
  launch_scan<TM, Int4Bank<VEC>>(topk_int4_pass1<TM, VEC, AVEC>, q, part_s, \
                                 part_i, out_s, out_i, Q, E, k, n_valid,    \
                                 normalize, chunk_rows, n_chunks, stream,   \
                                 packed, scales)
  // a bank slice is 16 aligned bytes a row when E % 32 == 0; the query
  // slices take 16-byte copies when E % 4 == 0
  cudaError_t err;
  if (wide_query_tile(Q))
    err = E % 32 == 0 ? PASS(6, true, true)
          : E % 4 == 0 ? PASS(6, false, true) : PASS(6, false, false);
  else
    err = E % 32 == 0 ? PASS(4, true, true)
          : E % 4 == 0 ? PASS(4, false, true) : PASS(4, false, false);
#undef PASS
  return (int)err;
}
