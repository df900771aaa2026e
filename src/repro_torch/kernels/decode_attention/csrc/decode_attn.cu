// Flash-decoding for Hopper: one query token per sequence against a KV cache,
// bf16 or f32.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// ::_decode_kernel (entry decode_fwd_pallas). The JAX package's decode step
// reaches the same function through its XLA reference; the port's decode
// step runs this kernel.
//
// Function: q (B, H, D), k/v (B, S, KV, D) in the model's cache layout,
// lengths (B,) int32. GQA: the G = H / KV query heads of kv head h read it
// together. Positions p with p < length (and p > length - 1 - window when
// window > 0) are valid. A sequence with no valid position gets the
// reference's answer: every position masked to -1e30, a uniform softmax over
// all S. Scores, softmax and P.V run in fp32; the output is in q's dtype.
//
// What bounds it on the H100: each cache byte is read once and feeds
// 2 * G operations (G = 6 for qwen2, 8 for qwen3-moe), so the cache read
// bounds it: (2 * sum_b valid_b * KV * D + B * H * D) * bytes / 3.35e12.
//
// Design (the TPU kernel walks S sequentially with a running max/sum in
// VMEM; here blocks run in parallel, so the valid range is cut in splits and
// a second pass merges them):
//   * pass 1: one warp per (sequence, kv head, split). The split count is
//     chosen by the wrapper from B * KV and the SM count; each sequence's
//     own valid range [max(0, length - window), min(length, S)) is cut in
//     n_split equal parts on the device, so positions outside it (the
//     unfilled cache, tiles before the window) are never read, and the host
//     never syncs on lengths. The 4 warps of a block share the G query rows
//     in shared memory.
//   * scores: lane j takes key p0 + j of a 32-key step, reads its K row with
//     16-byte loads and dots it with the G query rows (broadcast float4 reads
//     of shared memory); no shuffles. The step's max is one warp reduction
//     per head; m is uniform across the warp, so l stays a per-lane partial
//     until the end.
//   * P.V: p goes through shared memory (per warp), lanes switch to owning
//     D / 32 output dims each and read the step's V rows coalesced.
//   * pass 2 (decode_merge_kernel): one block per (b, h) rescales the
//     splits' (m, l, acc) and writes the output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;             // splits per block, one per warp
constexpr int THREADS = WARPS * 32;
constexpr int GMAX = 8;              // query heads per kv head
constexpr float NEG = -1e30f;        // the reference's masked score

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 aligned bytes as floats (4 f32 or 8 bf16)
__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x; o[2 * i + 1] = f.y;
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* o) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = to_f(p[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc,
                    float2* __restrict__ part_ml, int S, int H, int KV,
                    int n_split, int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);        // K elements per 16-byte load
  constexpr int DPL = D >= 32 ? D / 32 : 1;  // P.V: output dims per lane
  constexpr int LD = D / DPL;                // P.V: lanes covering D
  constexpr int KG = 32 / LD;                // P.V: key groups in a warp
  static_assert(D % VEC == 0 && 32 % LD == 0, "unsupported head dim");
  __shared__ __align__(16) float qs[GMAX * D];
  __shared__ float ps[WARPS][GMAX][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  for (int i = threadIdx.x; i < G * D; i += THREADS)
    qs[i] = to_f(q[head0 * D + i]);
  __syncthreads();

  const int split = blockIdx.x * WARPS + warp;
  const int len = lengths[b];
  int lo = window > 0 ? max(0, len - window) : 0;
  int hi = min(len, S);
  const bool all_masked = lo >= hi;
  if (all_masked) { lo = 0; hi = S; }
  const int chunk = (hi - lo + n_split - 1) / n_split;
  const int start = lo + split * chunk;
  const int end = min(hi, start + chunk);
  if (start >= end) {  // an empty split: weight 0 in the merge
    if (lane < G)
      part_ml[(head0 + lane) * n_split + split] = make_float2(-INFINITY, 0.f);
    return;
  }

  const size_t pstride = (size_t)KV * D;  // elements between positions
  const T* kbase = k + ((size_t)b * S * KV + kvh) * D;
  const T* vbase = v + ((size_t)b * S * KV + kvh) * D;
  const int kg = lane / LD, d0 = (lane % LD) * DPL;
  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY; l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int p0 = start; p0 < end; p0 += 32) {
    const int pos = p0 + lane;
    const bool in = pos < end;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (in) {
      const T* kr = kbase + (size_t)pos * pstride;
#pragma unroll 4
      for (int c = 0; c < D; c += VEC) {
        float kf[VEC];
        load16(kr + c, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4* qv = reinterpret_cast<const float4*>(qs + g * D + c);
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 t = qv[e4];
              s[g] = fmaf(t.x, kf[4 * e4], s[g]);
              s[g] = fmaf(t.y, kf[4 * e4 + 1], s[g]);
              s[g] = fmaf(t.z, kf[4 * e4 + 2], s[g]);
              s[g] = fmaf(t.w, kf[4 * e4 + 3], s[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {  // G is uniform: every lane takes the shuffles
        // keys past the split weigh exactly 0; masked keys score -1e30
        const float sg = !in ? -INFINITY : (all_masked ? NEG : s[g] * scale);
        float mx = sg;
#pragma unroll
        for (int off = 16; off; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);  // finite: lane 0 is in range
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sg - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
        ps[warp][g][lane] = p;
      }
    }
    __syncwarp();
    const int nk = min(32, end - p0);
#pragma unroll 4
    for (int j = kg; j < nk; j += KG) {
      float vf[DPL];
      load_n<T, DPL>(vbase + (size_t)(p0 + j) * pstride + d0, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float pj = ps[warp][g][j];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
#pragma unroll
        for (int off = LD; off < 32; off <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      const size_t idx = (head0 + g) * n_split + split;
      if (kg == 0) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) part_acc[idx * D + d0 + e] = acc[g][e];
      }
      if (lane == 0) part_ml[idx] = make_float2(m[g], l[g]);
    }
  }
}

template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float2* __restrict__ part_ml,
                                    T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const float2* ml = part_ml + bh * n_split;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[s].x);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float2 t = ml[s];
      if (t.x == -INFINITY) continue;  // empty split
      const float w = expf(t.x - M);
      num = fmaf(w, part_acc[(bh * n_split + s) * D + d], num);
      den = fmaf(w, t.y, den);
    }
    out[bh * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, void* part_ml, int B, int S, int H,
           int KV, int n_split, int window, float scale, cudaStream_t stream) {
  const dim3 grid(n_split / WARPS, KV, B);
  decode_split_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc,
      static_cast<float2*>(part_ml), S, H, KV, n_split, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T, D><<<B * H, D < 128 ? D : 128, 0, stream>>>(
      part_acc, static_cast<const float2*>(part_ml), static_cast<T*>(out),
      n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* lengths, void* out, float* part_acc, void* part_ml,
             int B, int S, int H, int KV, int n_split, int window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc: (B, H, n_split, D) f32 scratch; part_ml: (B, H, n_split) float2
// scratch; n_split a multiple of 4. Returns a cudaError_t.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out,
                                  float* part_acc, void* part_ml, int B, int S,
                                  int H, int KV, int D, int is_bf16,
                                  int n_split, int window, float scale,
                                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || KV < 1 || KV > 65535 || H % KV ||
      H / KV > GMAX || n_split < WARPS || n_split % WARPS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, lengths, out, part_acc,
                                   part_ml, B, S, H, KV, n_split, window,
                                   scale, stream);
  return launch_d<float>(D, q, k, v, lengths, out, part_acc, part_ml, B, S, H,
                         KV, n_split, window, scale, stream);
}
