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
// TFLOP/s, no tensor cores for fp32), not by the 3.35 TB/s of HBM.
//
// Design (simple and right first; wgmma/TMA/pipelining are later work):
//  * the TPU grid carried a running top-k from one bank block to the next;
//    Hopper blocks run in no order, so this is two passes. Pass 1: grid
//    (ceil(Q/BQ), n_chunks); each block stages its BQ query rows in shared
//    memory (fp32, normalised there if asked), walks its chunk of rows in
//    tiles of 256 (one row per thread), and keeps a per-query sorted top-k
//    in shared memory, written out as a partial (Q, n_chunks, k). Pass 2
//    merges the n_chunks partial lists of each query.
//  * dequantisation happens in registers only: each thread reads its row
//    with 16-byte loads (32 nibbles), turns each nibble into a float with
//    integer ops (no int-to-float conversion unit), and does BQ = 16 FMAs
//    per element against query values read as float4 broadcasts from shared
//    memory. The per-row scale multiplies the finished dot product.
//  * rows >= n_valid are never read: their score is -1e30 by definition and
//    they can only appear when n_valid < k, where pass 2 appends them in id
//    order, exactly where a stable descending sort puts them.
//  * merge: a warp tests its candidates against the current k-th entry with
//    one ballot; the few that beat it are inserted by lane 0.
//  * the row dot, the merge and pass 2 live in topk_common.cuh, shared with
//    the gathered (IVF) and dense scans.
#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BQ = 16;          // query rows per block
constexpr int TILE = THREADS;   // bank rows per tile, one per thread

__global__ void __launch_bounds__(THREADS)
topk_int4_pass1(const float* __restrict__ q, const int8_t* __restrict__ packed,
                const float* __restrict__ scales, float* __restrict__ part_s,
                int* __restrict__ part_i, int Q, int E, int k, int n_valid,
                int normalize, int chunk_rows, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // BQ * E
  float* sc = qs + BQ * E;                   // BQ * TILE
  float* ls = sc + BQ * TILE;                // BQ * KMAX
  int* li = reinterpret_cast<int*>(ls + BQ * KMAX);  // BQ * KMAX
  int* cnt = li + BQ * KMAX;                 // BQ

  const int tid = threadIdx.x, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n_valid);
  const int E2 = E / 2;

  if (tid < BQ) cnt[tid] = 0;
  stage_queries<BQ, THREADS>(q, Q, E, q0, normalize, qs);

  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int row = t0 + tid;
    if (row < r1) {
      float acc[BQ];
      float ss;
      int4_row_dot<BQ>(qs, E, packed + (size_t)row * E2, normalize, acc, ss);
      const float sr = scales[row];
      const float rn = normalize ? rsqrtf(fmaxf(sr * sr * ss, 1e-16f)) : 1.f;
#pragma unroll
      for (int i = 0; i < BQ; ++i) sc[i * TILE + tid] = acc[i] * sr * rn;
    }
    __syncthreads();
    const int n_tile = min(TILE, r1 - t0);
    for (int i = warp; i < BQ; i += NWARPS) {
      if (q0 + i >= Q) continue;  // warp-uniform
      const float* s_row = sc + i * TILE;
      warp_merge(n_tile,
                 [&](int j, float& s, int& id) {
                   s = s_row[j];
                   id = t0 + j;
                   return true;
                 },
                 ls + i * KMAX, li + i * KMAX, cnt + i, k);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < BQ * k; idx += THREADS) {
    const int i = idx / k, j = idx % k;
    if (q0 + i >= Q) continue;
    const size_t o = ((size_t)(q0 + i) * n_chunks + chunk) * k + j;
    const bool have = j < cnt[i];
    part_s[o] = have ? ls[i * KMAX + j] : -INFINITY;
    part_i[o] = have ? li[i * KMAX + j] : INT_MAX;
  }
}

}  // namespace

extern "C" int topk_int4_launch(const float* q, const int8_t* packed,
                                const float* scales, float* part_s,
                                int* part_i, float* out_s, int* out_i, int Q,
                                int E, int k, int n_valid, int normalize,
                                int chunk_rows, int n_chunks,
                                cudaStream_t stream) {
  if (k < 1 || k > KMAX || (E & 1) || n_chunks < 1 || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * E + BQ * TILE + BQ * KMAX) +
                      sizeof(int) * ((size_t)BQ * KMAX + BQ);
  cudaError_t err = cudaFuncSetAttribute(
      topk_int4_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((Q + BQ - 1) / BQ, n_chunks);
  topk_int4_pass1<<<grid1, THREADS, smem, stream>>>(
      q, packed, scales, part_s, part_i, Q, E, k, n_valid, normalize,
      chunk_rows, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_chunks,
                           n_valid, 0, stream);
}
