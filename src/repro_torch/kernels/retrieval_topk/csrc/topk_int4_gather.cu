// Fused int4 dequant-and-scan top-k over per-query candidate rows: the IVF
// pruned scan (Hopper).
//
// Replaces the TPU kernel repro/kernels/retrieval_topk/kernel.py
// ::_topk_int4_gather_kernel (entry retrieval_topk_int4_gathered_pallas).
//
// Function: q (Q, E) f32; the bank's packed (N, E/2) int8 nibble rows and
// scales (N, 1) f32; ids (Q, L) int32, each query's candidate bank rows.
// An id < 0 (padding) or >= n_valid (a row past the scanned snapshot) is
// dead. Output: per query the top k (k <= 64) live candidates by raw inner
// product q . (nibbles * scale), descending, ties to the lower row id, as
// (Q, k) f32 scores and (Q, k) int32 global row ids; slots with no live
// candidate hold the sentinel pair (-1e30, -1).
//
// What bounds it on the H100: each live candidate costs one 516-byte read
// (E/2 nibble bytes + scale + id at E = 1024) against 2*E operations, four
// operations per byte: it is bound by bytes (3.35 TB/s), and the rows are
// scattered over the bank, so every read is a separate row.
//
// Design (simple and right first):
//  * the TPU kernel was handed a (Q, L, E/2) block gathered by XLA; here
//    each thread reads its candidate's row by id straight from the bank
//    (16-byte loads of 32 nibbles), so the gathered copy never exists in
//    device memory. Dead ids are never read.
//  * the score is int4_row_dot times the row scale, the int4 scan contract
//    of topk_common.cuh that the exhaustive scan (topk_int4.cu) keeps too,
//    so a row scores bit for bit alike in both.
//  * pass 1: grid (Q, ceil(L / CHUNK_L)); the block stages its query row in
//    shared memory; each warp walks its share of the chunk 32 candidates
//    at a time, one per lane, and merges them into its own sorted list with
//    one ballot per 32. Each warp's list is one partial. Pass 2 (shared)
//    merges a query's ceil(L / CHUNK_L) * 8 partials and writes the
//    sentinel pair into slots no live candidate filled.
#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
topk_int4_gather_pass1(const float* __restrict__ q,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       const int* __restrict__ ids, float* __restrict__ part_s,
                       int* __restrict__ part_i, int E, int L, int k,
                       int n_valid, int chunk_l, int n_parts) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // E
  float* ls = qs + E;                                 // NWARPS * KMAX
  int* li = reinterpret_cast<int*>(ls + NWARPS * KMAX);  // NWARPS * KMAX
  int* cnt = li + NWARPS * KMAX;                      // NWARPS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qi = blockIdx.x;
  const int l0 = blockIdx.y * chunk_l;
  const int l1 = min(l0 + chunk_l, L);
  const int E2 = E / 2;
  const int* idrow = ids + (size_t)qi * L;

  if (tid < NWARPS) cnt[tid] = 0;
  for (int e = tid; e < E; e += THREADS) qs[e] = q[(size_t)qi * E + e];
  __syncthreads();

  float* wl_s = ls + warp * KMAX;
  int* wl_i = li + warp * KMAX;
  // t0 depends on the warp only: every lane of a warp takes the same trips
  for (int t0 = l0 + warp * 32; t0 < l1; t0 += THREADS) {
    const int j = t0 + lane;
    const int id = j < l1 ? idrow[j] : -1;
    const bool live = id >= 0 && id < n_valid;
    float s = -INFINITY;
    if (live) s = int4_row_dot(qs, E, packed + (size_t)id * E2) * scales[id];
    warp_merge(32,
               [&](int, float& s_out, int& id_out) {
                 s_out = s;
                 id_out = id;
                 return live;
               },
               wl_s, wl_i, cnt + warp, k);
  }
  __syncwarp();

  const int c = cnt[warp];
  const size_t o = ((size_t)qi * n_parts + blockIdx.y * NWARPS + warp) * k;
  for (int j = lane; j < k; j += 32) {
    const bool have = j < c;
    part_s[o + j] = have ? wl_s[j] : -INFINITY;
    part_i[o + j] = have ? wl_i[j] : INT_MAX;
  }
}

}  // namespace

// part_s / part_i hold (Q, n_parts, k): n_parts must be
// ceil(L / chunk_l) * 8, one list per warp of every pass-1 block.
extern "C" int topk_int4_gather_launch(const float* q, const int8_t* packed,
                                       const float* scales, const int* ids,
                                       float* part_s, int* part_i,
                                       float* out_s, int* out_i, int Q, int E,
                                       int L, int k, int n_valid, int chunk_l,
                                       int n_parts, cudaStream_t stream) {
  const int n_chunks = chunk_l < 1 ? 0 : (L + chunk_l - 1) / chunk_l;
  if (k < 1 || k > KMAX || (E & 1) || L < 1 || n_chunks < 1 ||
      n_chunks > 65535 || n_parts != n_chunks * NWARPS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)E + NWARPS * KMAX) +
                      sizeof(int) * (NWARPS * KMAX + NWARPS);
  cudaError_t err = cudaFuncSetAttribute(
      topk_int4_gather_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_int4_gather_pass1<<<dim3(Q, n_chunks), THREADS, smem, stream>>>(
      q, packed, scales, ids, part_s, part_i, E, L, k, n_valid, chunk_l,
      n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_parts,
                           n_valid, 1, stream);
}
