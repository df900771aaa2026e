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
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BQ = 16;          // query rows per block
constexpr int TILE = THREADS;   // bank rows per tile, one per thread
constexpr int KMAX = 64;

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Signed nibble (two's complement, 4 bits) to float without I2F:
// (n ^ 8) = n + 8 in [0, 15] sits in the mantissa of 2^23.
__device__ __forceinline__ float nib2f(unsigned n) {
  return __int_as_float(0x4B000000u | (n ^ 8u)) - 8388616.0f;
}

// One thread inserts (s, id) into a sorted list of cnt <= k entries.
__device__ void list_insert(float* ls, int* li, int* cnt, int k, float s,
                            int id) {
  int c = *cnt;
  if (c == k && !better(s, id, ls[k - 1], li[k - 1])) return;
  int pos = c < k ? c : k - 1;
  while (pos > 0 && better(s, id, ls[pos - 1], li[pos - 1])) {
    ls[pos] = ls[pos - 1];
    li[pos] = li[pos - 1];
    --pos;
  }
  ls[pos] = s;
  li[pos] = id;
  if (c < k) *cnt = c + 1;
}

// A whole warp merges n candidates into one list; get(j, s, id) reads
// candidate j and returns whether it is live.
template <typename Get>
__device__ void warp_merge(int n, Get get, float* ls, int* li, int* cnt,
                           int k) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    float s = -INFINITY;
    int id = INT_MAX;
    bool live = j < n && get(j, s, id);
    // a stale threshold only lets more candidates through; insertion
    // re-checks against the current list
    const int c = *cnt;
    bool cand = live && (c < k || better(s, id, ls[k - 1], li[k - 1]));
    unsigned m = __ballot_sync(0xffffffffu, cand);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float ss = __shfl_sync(0xffffffffu, s, src);
      const int ii = __shfl_sync(0xffffffffu, id, src);
      if (lane == 0) list_insert(ls, li, cnt, k, ss, ii);
      __syncwarp();
    }
  }
}

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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n_valid);
  const int E2 = E / 2;

  for (int idx = tid; idx < BQ * E; idx += THREADS) {
    const int qi = idx / E;
    qs[idx] = q0 + qi < Q ? q[(size_t)(q0 + qi) * E + idx % E] : 0.f;
  }
  if (tid < BQ) cnt[tid] = 0;
  __syncthreads();
  if (normalize) {
    for (int qi = warp; qi < BQ; qi += NWARPS) {
      float ss = 0.f;
      for (int e = lane; e < E; e += 32) ss += qs[qi * E + e] * qs[qi * E + e];
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float r = rsqrtf(fmaxf(ss, 1e-16f));
      for (int e = lane; e < E; e += 32) qs[qi * E + e] *= r;
    }
    __syncthreads();
  }

  for (int t0 = r0; t0 < r1; t0 += TILE) {
    const int row = t0 + tid;
    if (row < r1) {
      float acc[BQ];
#pragma unroll
      for (int i = 0; i < BQ; ++i) acc[i] = 0.f;
      float ss = 0.f;
      const int8_t* prow = packed + (size_t)row * E2;
      if ((E2 & 15) == 0) {
        const int4* pv = reinterpret_cast<const int4*>(prow);
        for (int vi = 0; vi < E2 / 16; ++vi) {
          const int4 w4 = __ldg(pv + vi);
          const unsigned words[4] = {(unsigned)w4.x, (unsigned)w4.y,
                                     (unsigned)w4.z, (unsigned)w4.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            // nibble j of word w is element 32*vi + 8*w + j
            float f[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) f[j] = nib2f((words[w] >> (4 * j)) & 0xFu);
            if (normalize) {
#pragma unroll
              for (int j = 0; j < 8; ++j) ss = fmaf(f[j], f[j], ss);
            }
            const int e0 = 32 * vi + 8 * w;
#pragma unroll
            for (int i = 0; i < BQ; ++i) {
              const float4 a = *reinterpret_cast<const float4*>(qs + i * E + e0);
              const float4 b = *reinterpret_cast<const float4*>(qs + i * E + e0 + 4);
              float x = acc[i];
              x = fmaf(a.x, f[0], x); x = fmaf(a.y, f[1], x);
              x = fmaf(a.z, f[2], x); x = fmaf(a.w, f[3], x);
              x = fmaf(b.x, f[4], x); x = fmaf(b.y, f[5], x);
              x = fmaf(b.z, f[6], x); x = fmaf(b.w, f[7], x);
              acc[i] = x;
            }
          }
        }
      } else {  // E/2 not a multiple of 16: byte loads
        for (int j = 0; j < E2; ++j) {
          const unsigned byte = (unsigned char)prow[j];
          const float f0 = nib2f(byte & 0xFu), f1 = nib2f(byte >> 4);
          if (normalize) ss = fmaf(f0, f0, fmaf(f1, f1, ss));
#pragma unroll
          for (int i = 0; i < BQ; ++i)
            acc[i] = fmaf(qs[i * E + 2 * j + 1], f1,
                          fmaf(qs[i * E + 2 * j], f0, acc[i]));
        }
      }
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

constexpr int P2_WARPS = 4;

__global__ void __launch_bounds__(P2_WARPS * 32)
topk_int4_pass2(const float* __restrict__ part_s, const int* __restrict__ part_i,
                float* __restrict__ out_s, int* __restrict__ out_i, int Q,
                int k, int n_chunks, int n_valid) {
  __shared__ float ls[P2_WARPS][KMAX];
  __shared__ int li[P2_WARPS][KMAX];
  __shared__ int cnt[P2_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * P2_WARPS + warp;
  if (qi >= Q) return;  // warp-uniform; no block barrier follows
  if (lane == 0) cnt[warp] = 0;
  __syncwarp();
  const float* cs = part_s + (size_t)qi * n_chunks * k;
  const int* ci = part_i + (size_t)qi * n_chunks * k;
  warp_merge(n_chunks * k,
             [&](int j, float& s, int& id) {
               s = cs[j];
               id = ci[j];
               return id != INT_MAX;
             },
             ls[warp], li[warp], &cnt[warp], k);
  __syncwarp();
  const int c = cnt[warp];
  for (int j = lane; j < k; j += 32) {
    const bool have = j < c;
    // fewer than k live rows (n_valid < k): masked rows follow in id order
    out_s[(size_t)qi * k + j] = have ? ls[warp][j] : -1e30f;
    out_i[(size_t)qi * k + j] = have ? li[warp][j] : n_valid + (j - c);
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
  topk_int4_pass2<<<(Q + P2_WARPS - 1) / P2_WARPS, P2_WARPS * 32, 0, stream>>>(
      part_s, part_i, out_s, out_i, Q, k, n_chunks, n_valid);
  return (int)cudaGetLastError();
}
