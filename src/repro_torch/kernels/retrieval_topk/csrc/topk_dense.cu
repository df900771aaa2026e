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
// of HBM.
//
// Design: the two-pass layout of topk_int4.cu over fp32 rows. Pass 1: grid
// (ceil(Q/BQ), n_chunks); the block stages BQ query rows in shared memory
// (normalised there if asked), walks its chunk of bank rows in tiles of 256
// (one row per thread, 16-byte loads of 4 floats), keeps a per-query sorted
// top-k in shared memory and writes it as a partial. Pass 2 (shared, in
// topk_common.cuh) merges the partials. Rows >= n_valid are never read; with
// n_valid < k pass 2 appends them in id order at -1e30, where a stable
// descending sort puts them.
#include "topk_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BQ = 16;          // query rows per block
constexpr int TILE = THREADS;   // bank rows per tile, one per thread

// NQ query rows in shared memory (stride E) against one fp32 bank row: one
// fmaf chain per query in element order; ss = the row's sum of squares when
// `norm`. float4 loads when E % 4 == 0 (rows 16-byte aligned), else scalar.
template <int NQ>
__device__ __forceinline__ void f32_row_dot(const float* __restrict__ qs,
                                            int E,
                                            const float* __restrict__ brow,
                                            bool norm, float (&acc)[NQ],
                                            float& ss) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) acc[i] = 0.f;
  ss = 0.f;
  if ((E & 3) == 0) {
    const float4* bv = reinterpret_cast<const float4*>(brow);
    for (int vi = 0; vi < E / 4; ++vi) {
      const float4 b = __ldg(bv + vi);
      if (norm) {
        ss = fmaf(b.x, b.x, ss); ss = fmaf(b.y, b.y, ss);
        ss = fmaf(b.z, b.z, ss); ss = fmaf(b.w, b.w, ss);
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qs + i * E + 4 * vi);
        float x = acc[i];
        x = fmaf(a.x, b.x, x); x = fmaf(a.y, b.y, x);
        x = fmaf(a.z, b.z, x); x = fmaf(a.w, b.w, x);
        acc[i] = x;
      }
    }
  } else {
    for (int e = 0; e < E; ++e) {
      const float b = __ldg(brow + e);
      if (norm) ss = fmaf(b, b, ss);
#pragma unroll
      for (int i = 0; i < NQ; ++i) acc[i] = fmaf(qs[i * E + e], b, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
topk_dense_pass1(const float* __restrict__ q, const float* __restrict__ bank,
                 float* __restrict__ part_s, int* __restrict__ part_i, int Q,
                 int E, int k, int n_valid, int normalize, int chunk_rows,
                 int n_chunks) {
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

  if (tid < BQ) cnt[tid] = 0;
  stage_queries<BQ, THREADS>(q, Q, E, q0, normalize, qs);

  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int row = t0 + tid;
    if (row < r1) {
      float acc[BQ];
      float ss;
      f32_row_dot<BQ>(qs, E, bank + (size_t)row * E, normalize, acc, ss);
      const float rn = normalize ? rsqrtf(fmaxf(ss, 1e-16f)) : 1.f;
#pragma unroll
      for (int i = 0; i < BQ; ++i) sc[i * TILE + tid] = acc[i] * rn;
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

extern "C" int topk_dense_launch(const float* q, const float* bank,
                                 float* part_s, int* part_i, float* out_s,
                                 int* out_i, int Q, int E, int k, int n_valid,
                                 int normalize, int chunk_rows, int n_chunks,
                                 cudaStream_t stream) {
  if (k < 1 || k > KMAX || E < 1 || n_chunks < 1 || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * E + BQ * TILE + BQ * KMAX) +
                      sizeof(int) * ((size_t)BQ * KMAX + BQ);
  cudaError_t err = cudaFuncSetAttribute(
      topk_dense_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((Q + BQ - 1) / BQ, n_chunks);
  topk_dense_pass1<<<grid1, THREADS, smem, stream>>>(
      q, bank, part_s, part_i, Q, E, k, n_valid, normalize, chunk_rows,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_chunks,
                           n_valid, 0, stream);
}
