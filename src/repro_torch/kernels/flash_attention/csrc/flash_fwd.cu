// Flash-attention forward (online softmax) for Hopper, bf16 or f32 inputs.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// ::_fwd_kernel (entry flash_fwd_pallas, via ops.flash_attention).
//
// Function: q (B, Sq, H, D), k/v (B, Skv, KV, D) in the wrapper's layout
// (no transposes), GQA head h reads kv head h / (H / KV). Masks as the TPU
// kernel: keys past Skv, causal (k <= q + q_offset), sliding window
// (k > q + q_offset - window). Masked scores are -1e30, so a row with at
// least one visible key gets exactly the reference softmax. Writes out
// (B, Sq, H, D) in the input dtype and lse (B, H, Sq) f32.
//
// What bounds it on the H100: at the encoder shapes (B = 64, S = 257,
// H = 16, D = 80 and S = 78, D = 64) attention does 4*B*H*S^2*D operations
// on ~4*B*S*H*D*2 bytes, about 40 operations per byte: far below the bf16
// tensor-core ridge, far above the fp32 FMA one. This first version runs
// fp32 FMAs, so fp32 issue rate (67 TFLOP/s) and shared-memory loads bound
// it; mma.sync/wgmma on bf16 is a later PR.
//
// Design: one block per (b, h, 32-row q tile), 8 warps x 4 query rows. The
// block loops over 64-key tiles staged in shared memory as fp32 (K rows
// padded to D+1 words so the per-lane key reads are conflict-free); lane j
// scores keys j and j+32 for its warp's 4 rows (q read as float4
// broadcasts), keeps m / l / acc in fp32 registers (acc: output dims lane,
// lane+32, lane+64, lane+96), and broadcasts each p with a shuffle for the
// P.V update. Ragged Sq and Skv (257, 78) are masked in place, never
// padded. D is a template parameter: 64, 80 (the vision tower's head dim,
// not a power of two) and 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROWS = 4;              // query rows per warp
constexpr int BQ = NWARPS * ROWS;    // query rows per block
constexpr int BK = 64;               // keys per kv tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                 float scale, int causal, int window, int q_offset) {
  constexpr int DP = (D + 31) / 32;  // output dims per lane
  constexpr int KS = D + 1;          // padded K row stride
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // BQ * D
  float* ks = qs + BQ * D;           // BK * KS
  float* vs = ks + BK * KS;          // BK * D

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * BQ;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, qi = q0 + r;
    qs[idx] = qi < Sq ? to_f(q[(((size_t)b * Sq + qi) * H + h) * D + d]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DP];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * ROWS * D;

  for (int t0 = 0; t0 < Skv; t0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and q staged)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, kj = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * KV + kvh) * D + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[j * KS + d] = kx;
      vs[j * D + d] = vx;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = ks + lane * KS;
    const float* k1 = ks + (lane + 32) * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float a0 = k0[d], a1 = k0[d + 1], a2 = k0[d + 2], a3 = k0[d + 3];
      const float b0 = k1[d], b1 = k1[d + 1], b2 = k1[d + 2], b3 = k1[d + 3];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r][0] = fmaf(x.w, a3, fmaf(x.z, a2, fmaf(x.y, a1, fmaf(x.x, a0, s[r][0]))));
        s[r][1] = fmaf(x.w, b3, fmaf(x.z, b2, fmaf(x.y, b1, fmaf(x.x, b0, s[r][1]))));
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qp = q0 + warp * ROWS + r + q_offset;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = t0 + lane + 32 * c;
        float x = s[r][c] * scale;
        if (kj >= Skv) x = -INFINITY;  // not a key: weight exactly 0
        else if ((causal && kj > qp) || (window > 0 && kj <= qp - window)) x = NEG;
        s[r][c] = x;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[r][i] *= alpha;
      s[r][0] = p0;
      s[r][1] = p1;
    }

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float vv[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = __shfl_sync(0xffffffffu, j < 32 ? s[r][0] : s[r][1], j & 31);
#pragma unroll
        for (int i = 0; i < DP; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f<T>(acc[r][i] / l_safe);
    }
    if (lane == 0) lse[((size_t)b * H + h) * Sq + qi] = m[r] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Skv, int H, int KV, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * D + BK * (D + 1) + BK * D);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, KV,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int Sq, int Skv, int H, int KV, float scale,
             int causal, int window, int q_offset, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, H, KV, scale, causal, window, q_offset, stream);
    case 80: return launch<T, 80>(q, k, v, out, lse, B, Sq, Skv, H, KV, scale, causal, window, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, H, KV, scale, causal, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int Sq, int Skv,
                                int H, int KV, int D, int is_bf16, float scale,
                                int causal, int window, int q_offset,
                                cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, Sq, Skv, H, KV,
                                   scale, causal, window, q_offset, stream);
  return launch_d<float>(D, q, k, v, out, lse, B, Sq, Skv, H, KV, scale,
                         causal, window, q_offset, stream);
}
