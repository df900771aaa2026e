// The chunked forward of KDA (Kimi Delta Attention), a gated delta rule with
// a per-channel decay:
//
//   S_t = Diag(exp g_t) S_{t-1};  S_t += beta_t k_t (v_t - S_t^T k_t)^T;
//   o_t = S_t^T (scale q_t)
//
// over one sequence and head a block, for dk = dv = 128 (the published
// head_dim), from bf16 q, k, v, fp32 g (<= 0) and fp32 beta, an optional
// fp32 initial state; o in bf16 and the final state in fp32.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer.
// The model is Kimi-Linear-48B-A3B's KDA layer (models/attention.py::KDA).
// The arithmetic is ref.py::kda_chunked's (with tf32=True): chunks of C =
// 64 tokens in the WY/UT form. In a chunk, Gamma = cumsum(g);
//   A_ij = beta_i sum_c k_ic k_jc e^(Gamma_ic - Gamma_jc) (j < i),
//   Aqk_ij = scale sum_c q_ic k_jc e^(Gamma_ic - Gamma_jc) (j <= i),
//   T = (I + A)^-1 (by 16 x 16 blocks), T' = T Diag(beta),
//   w = T' (k e^Gamma), u = T' v, then with S in fp32:
//   v' = u - w S, o = (scale q e^Gamma) S + Aqk v',
//   S <- Diag(e^Gamma_C) S + (k e^(Gamma_C - Gamma))^T v'.
// Every exponent is <= 0: A's and Aqk's 16-row sub-blocks off the diagonal
// factor through the later sub-block's first row r, e^(Gamma_i - Gamma_r)
// e^(Gamma_r - Gamma_j); the diagonal 16 x 16 sub-blocks are computed pair
// by pair in fp32; e^(-Gamma) alone is never formed.
//
// What bounds it: the recurrence's 6 dk dv operations a token and head
// against q, k, v and o at 2 bytes, g at 4 bytes a channel and beta at 4
// bytes (~1.6 KB a token and head): bytes, ~1 ms for 2.1M token-heads at
// 3.35 TB/s. Design: one block a (sequence, head), the chunks in order;
// the state S (128 x 128 fp32, 64 KB) stays in shared memory for the
// whole sequence, with the chunk's fp32 buffers (Gamma, u/v', w, T', Aqk)
// and bf16 q, k (231 KB, all of an SM's shared memory). The chunk's
// products (A's and Aqk's off-diagonal blocks, w, u, v', o and the state
// update, ~5.4M multiply-adds) run on the tensor cores: mma.sync m16n8k8
// with operands rounded to TF32 (cvt.rna) and fp32 accumulators, a warp a
// 32 x 32 output tile. The fp32 buffers are 128 (or 64) floats a row with
// the column XOR-swizzled by 4 (row & 7), so that a warp's A-fragment
// loads hit 32 banks and its B-fragment loads and C stores two to a bank.
// The diagonal blocks, T (its 16 x 16 diagonal blocks by forward
// substitution, the blocks below them by block rows) and the elementwise
// work stay on the FMA units. No atomics: every output element is written by
// one thread, so a call gives the same bits twice.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 64;      // tokens a chunk
constexpr int D = 128;     // dk = dv
constexpr int SUB = 16;    // rows a sub-block of A and Aqk
constexpr int NT = 256;    // threads a block
constexpr int NW = NT / 32;
constexpr int LDH = D + 2;   // row stride of the bf16 (C, D) buffers

constexpr size_t SMEM_FLOATS = (size_t)D * D + 3 * C * D + 2 * C * C
                               + C * LDH  // two bf16 buffers
                               + C + D;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// element (r, c) of a swizzled fp32 buffer of ld floats a row
__device__ __forceinline__ int sw(int r, int c, int ld) {
  return r * ld + (c ^ ((r & 7) << 2));
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// operand views: element (r, c) of a matrix
struct F32 {       // a swizzled fp32 buffer
  const float* p; int ld;
  __device__ float operator()(int r, int c) const { return p[sw(r, c, ld)]; }
};
struct F32T {      // its transpose
  const float* p; int ld;
  __device__ float operator()(int r, int c) const { return p[sw(c, r, ld)]; }
};
struct B16 {       // a bf16 (C, LDH) buffer
  const __nv_bfloat16* p;
  __device__ float operator()(int r, int c) const {
    return bf(p + r * LDH + c);
  }
};
struct B16T {      // its transpose
  const __nv_bfloat16* p;
  __device__ float operator()(int r, int c) const {
    return bf(p + c * LDH + r);
  }
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (a swizzled fp32 buffer of ldc floats a row) (+)= alpha * sum_k A(r, k)
// B(k, n) for r < M, n < N, on the tensor cores; a warp takes (16 WM) x (8
// WN) output tiles. M % (16 WM) == 0, N % (8 WN) == 0, K % 8 == 0. Every
// call with the same M, N, WM and WN gives each warp the same tiles.
template <int WM, int WN, class LA, class LB>
__device__ __forceinline__ void gemm(int M, int N, int K, LA la, LB lb,
                                     float* c, int ldc, float alpha,
                                     bool acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tn = N / (8 * WN), tiles = (M / (16 * WM)) * tn;
  for (int tile = warp; tile < tiles; tile += NW) {
    const int r0 = tile / tn * 16 * WM, n0 = tile % tn * 8 * WN;
    float d[WM][WN][4];
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t a[WM][4], b[WN][2];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        const int r = r0 + 16 * i + g;
        a[i][0] = tf32(la(r, k0 + t));
        a[i][1] = tf32(la(r + 8, k0 + t));
        a[i][2] = tf32(la(r, k0 + t + 4));
        a[i][3] = tf32(la(r + 8, k0 + t + 4));
      }
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = n0 + 8 * j + g;
        b[j][0] = tf32(lb(k0 + t, n));
        b[j][1] = tf32(lb(k0 + t + 4, n));
      }
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) mma8(d[i][j], a[i], b[j]);
    }
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * i + g + (e >> 1) * 8;
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          float* p = c + sw(r, n, ldc);
          *p = acc ? *p + alpha * d[i][j][e] : alpha * d[i][j][e];
        }
  }
}

// rows [0, C) of a (B, S, H, D) bf16 tensor's chunk into a (C, LDH) buffer,
// rows from n on zeroed
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* src,
                                          __nv_bfloat16* dst, int n,
                                          long row) {
  for (int i = threadIdx.x; i < C * (D / 8); i += NT) {
    const int t = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) x = *reinterpret_cast<const uint4*>(src + t * row + c8);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + t * LDH + c8);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

__global__ void __launch_bounds__(NT, 1)
kda_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ g, const float* __restrict__ beta,
               const float* __restrict__ s0, __nv_bfloat16* __restrict__ o,
               float* __restrict__ s_out, int S, int H, float scale) {
  extern __shared__ float sm[];
  float* Ss = sm;                  // the state, D x D (k rows, v columns)
  float* Gs = Ss + D * D;          // Gamma; later scale q e^Gamma
  float* Vs = Gs + C * D;          // scratch; k e^Gamma; then u, v'
  float* Ws = Vs + C * D;          // scratch, T; then w; then o
  float* As = Ws + C * D;          // A, then T' (C x C)
  float* Aq = As + C * C;          // Aqk (C x C)
  __nv_bfloat16* Qb = reinterpret_cast<__nv_bfloat16*>(Aq + C * C);
  __nv_bfloat16* Kb = Qb + C * LDH;  // k; later k e^(Gamma_C - Gamma)
  float* bs = reinterpret_cast<float*>(Kb + C * LDH);   // beta, C
  float* egc = bs + C;                                   // e^Gamma_C, D

  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const long row = (long)H * D;                 // a token's stride
  const long base = ((long)b * S * H + h) * D;  // element (b, 0, h, 0)
  const long sbase = (long)bh * D * D;
  for (int i = tid; i < D * D; i += NT)
    Ss[sw(i / D, i % D, D)] = s0 ? s0[sbase + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += C) {
    const int n = min(C, S - c0);
    const long cbase = base + (long)c0 * row;
    load_bf16(q + cbase, Qb, n, row);
    load_bf16(k + cbase, Kb, n, row);
    for (int i = tid; i < C * (D / 4); i += NT) {
      const int t = i / (D / 4), c4 = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < n) x = *reinterpret_cast<const float4*>(g + cbase + t * row
                                                      + c4);
      Gs[sw(t, c4, D)] = x.x; Gs[sw(t, c4 + 1, D)] = x.y;
      Gs[sw(t, c4 + 2, D)] = x.z; Gs[sw(t, c4 + 3, D)] = x.w;
    }
    if (tid < C)
      bs[tid] = tid < n ? beta[((long)b * S + c0 + tid) * H + h] : 0.f;
    for (int i = tid; i < C * C; i += NT) { As[i] = 0.f; Aq[i] = 0.f; }
    __syncthreads();
    if (tid < D) {                  // Gamma, a column a thread
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        run += Gs[sw(t, tid, D)];
        Gs[sw(t, tid, D)] = run;
      }
    }
    __syncthreads();

    // A and Aqk off the diagonal sub-blocks: rows [r, r + SUB) against
    // columns [0, r), through row r: R (rows j < r) in Vs, the k and q
    // rows' left factors in Ws rows [0, SUB) and [SUB, 2 SUB)
    for (int r = SUB; r < C; r += SUB) {
      for (int i = tid; i < r * D; i += NT) {
        const int j = i / D, c = i % D;
        Vs[sw(j, c, D)] = bf(Kb + j * LDH + c)
                          * __expf(Gs[sw(r, c, D)] - Gs[sw(j, c, D)]);
      }
      for (int i = tid; i < SUB * D; i += NT) {
        const int t = i / D, c = i % D;
        const float e = __expf(Gs[sw(r + t, c, D)] - Gs[sw(r, c, D)]);
        Ws[sw(t, c, D)] = bf(Kb + (r + t) * LDH + c) * e;
        Ws[sw(SUB + t, c, D)] = bf(Qb + (r + t) * LDH + c) * e;
      }
      __syncthreads();
      gemm<1, 1>(SUB, r, D, F32{Ws, D}, F32T{Vs, D}, As + r * C, C, 1.f,
                 false);
      gemm<1, 1>(SUB, r, D, F32{Ws + SUB * D, D}, F32T{Vs, D}, Aq + r * C,
                 C, scale, false);
      __syncthreads();
    }
    // the diagonal sub-blocks, pair by pair: the live pairs j <= i only
    constexpr int PAIRS = SUB * (SUB + 1) / 2;
    for (int p = tid; p < (C / SUB) * PAIRS; p += NT) {
      const int blk = p / PAIRS, qq = p % PAIRS;
      int ii = (int)((sqrtf(8.f * qq + 1.f) - 1.f) * 0.5f);
      if (ii * (ii + 1) / 2 > qq) --ii;
      if ((ii + 1) * (ii + 2) / 2 <= qq) ++ii;
      const int i = blk * SUB + ii, j = blk * SUB + qq - ii * (ii + 1) / 2;
      float a = 0.f, aq = 0.f;
      for (int c = 0; c < D; ++c) {
        const float kj = bf(Kb + j * LDH + c)
                         * __expf(Gs[sw(i, c, D)] - Gs[sw(j, c, D)]);
        a = fmaf(bf(Kb + i * LDH + c), kj, a);
        aq = fmaf(bf(Qb + i * LDH + c), kj, aq);
      }
      if (j < i) As[sw(i, j, C)] = a;
      Aq[sw(i, j, C)] = aq * scale;
    }
    __syncthreads();
    for (int i = tid; i < C * C; i += NT) As[i] *= bs[i / C];  // row i: beta_i
    __syncthreads();

    // T = (I + A)^-1 into Ws (C x C, swizzled) by 16 x 16 blocks: the
    // diagonal blocks' inverses D_I by forward substitution, a column a
    // thread (the other threads zero the blocks off the diagonal); then
    // block rows I = 1, 2, 3 in turn, every J < I at once: X_IJ = sum over
    // J <= K < I of A_IK T_KJ (into Vs), T_IJ = -D_I X_IJ
    if (tid < C) {
      const int blk = tid / SUB * SUB, c = tid;
      for (int i = 0; i < SUB; ++i) {
        float a0 = blk + i == c ? 1.f : 0.f;
        for (int j = 0; j < i; ++j)
          a0 = fmaf(-As[sw(blk + i, blk + j, C)], Ws[sw(blk + j, c, C)], a0);
        Ws[sw(blk + i, c, C)] = a0;
      }
    } else {
      for (int i = tid - C; i < C * C; i += NT - C)
        if (i / C / SUB != i % C / SUB) Ws[sw(i / C, i % C, C)] = 0.f;
    }
    __syncthreads();
    for (int I = 1; I < C / SUB; ++I) {
      const int r = I * SUB, w = r;           // block row I, its width
      for (int e = tid; e < SUB * w; e += NT) {
        const int i = e / w, col = e % w;
        float x = 0.f;
        for (int kk = col / SUB * SUB; kk < r; ++kk)
          x = fmaf(As[sw(r + i, kk, C)], Ws[sw(kk, col, C)], x);
        Vs[i * C + col] = x;
      }
      __syncthreads();
      for (int e = tid; e < SUB * w; e += NT) {
        const int i = e / w, col = e % w;
        float x = 0.f;
        for (int m = 0; m <= i; ++m)
          x = fmaf(Ws[sw(r + i, r + m, C)], Vs[m * C + col], x);
        Ws[sw(r + i, col, C)] = -x;
      }
      __syncthreads();
    }
    // T' = T Diag(beta) into As; k e^Gamma into Vs; e^Gamma_C
    for (int i = tid; i < C * C; i += NT) {
      const int r = i / C, cc = i % C;
      As[sw(r, cc, C)] = Ws[sw(r, cc, C)] * bs[cc];
    }
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, c = i % D;
      Vs[sw(t, c, D)] = bf(Kb + t * LDH + c) * __expf(Gs[sw(t, c, D)]);
    }
    if (tid < D) egc[tid] = __expf(Gs[sw(C - 1, tid, D)]);
    __syncthreads();
    gemm<2, 4>(C, D, C, F32{As, C}, F32{Vs, D}, Ws, D, 1.f, false);  // w
    // k e^(Gamma_C - Gamma), rounded to bf16, in place
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, c = i % D;
      Kb[t * LDH + c] = __float2bfloat16(
          bf(Kb + t * LDH + c)
          * __expf(Gs[sw(C - 1, c, D)] - Gs[sw(t, c, D)]));
    }
    __syncthreads();
    for (int i = tid; i < C * D; i += NT) {   // scale q e^Gamma, in place
      const int t = i / D, c = i % D;
      Gs[sw(t, c, D)] = scale * bf(Qb + t * LDH + c)
                        * __expf(Gs[sw(t, c, D)]);
    }
    __syncthreads();
    load_bf16(v + cbase, Qb, n, row);
    __syncthreads();
    gemm<2, 4>(C, D, C, F32{As, C}, B16{Qb}, Vs, D, 1.f, false);      // u
    __syncthreads();
    gemm<2, 4>(C, D, D, F32{Ws, D}, F32{Ss, D}, Vs, D, -1.f, true);   // v'
    __syncthreads();
    // o = (scale q e^Gamma) S + Aqk v' into Ws: both products give each
    // warp the same tiles, so the second needs no barrier
    gemm<2, 4>(C, D, D, F32{Gs, D}, F32{Ss, D}, Ws, D, 1.f, false);
    gemm<2, 4>(C, D, C, F32{Aq, C}, F32{Vs, D}, Ws, D, 1.f, true);
    __syncthreads();
    for (int i = tid; i < n * (D / 2); i += NT) {
      const int t = i / (D / 2), c = (i % (D / 2)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(o + cbase + t * row + c) =
          __floats2bfloat162_rn(Ws[sw(t, c, D)], Ws[sw(t, c + 1, D)]);
    }
    for (int i = tid; i < D * D; i += NT) Ss[i] *= egc[i / D];  // row i
    __syncthreads();
    gemm<2, 4>(D, D, C, B16T{Kb}, F32{Vs, D}, Ss, D, 1.f, true);      // S
    __syncthreads();
  }
  for (int i = tid; i < D * D; i += NT)
    s_out[sbase + i] = Ss[sw(i / D, i % D, D)];
}

}  // namespace

extern "C" {

int kda_fwd_smem_bytes() { return (int)SMEM_BYTES; }

// q, k (B, S, H, 128) and v (B, S, H, 128) bf16, g (B, S, H, 128) fp32,
// beta (B, S, H) fp32, s0 (B, H, 128, 128) fp32 or null; o (B, S, H, 128)
// bf16 and s_out (B, H, 128, 128) fp32 written. All contiguous.
int kda_fwd_launch(const void* q, const void* k, const void* v,
                   const void* g, const void* beta, const void* s0, void* o,
                   void* s_out, int B, int S, int H, float scale,
                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kda_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kda_fwd_kernel<<<B * H, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)g, (const float*)beta,
      (const float*)s0, (__nv_bfloat16*)o, (float*)s_out, S, H, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
