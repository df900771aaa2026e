// Flash-attention backward for Hopper: register-blocked FMA tiles, f32 and
// bf16 inputs with fp32 accumulation.
//
// Replaces the backward of the TPU kernel's custom_vjp,
// repro/kernels/flash_attention/ops.py::_bwd_blocked (the reference's
// Pallas forward _fwd_kernel has no Pallas backward; XLA runs that JAX
// function). Plain version: ref.py::attention_bwd_reference.
//
// Function: q, out, dout (B, Sq, H, D), k, v (B, Skv, KV, D), lse (B, H, Sq)
// f32 from the forward; GQA head h reads kv head h / (H / KV). With
// delta = rowsum(dout * out), P = exp(S * scale - lse) where the key is
// visible and 0 where the reference's _block_mask hides it (keys past Skv,
// causal k > q + q_offset, window k <= q + q_offset - window; a row that
// sees no key, which the forward gives a uniform softmax, so passes no
// gradient), it writes dV = P^T dO, dS = P * (dO V^T - delta) * scale,
// dQ = dS K, dK = dS^T Q in the input dtype. bf16 rounds as the reference
// does: P to bf16 before dV, dS to bf16 before dQ and dK (dO is bf16
// already); every product sums in fp32.
//
// What bounds it on the H100: 5 products of 2 * B * H * Sq * Skv * D
// operations (S, dO V^T, dV, dQ, dK; half of it causal) on fp32 FMAs
// (67 TFLOP/s; bf16 values are widened to fp32, no tensor cores yet), far
// above the bytes (each of q, k, v, out, dout read once, dq, dk, dv
// written once).
//
// Design: simple and deterministic, no atomics, so two runs give the same
// bits (Adam turns noise in near-zero gradients into different updates).
// Two kernels, one after the other on the stream:
//   * flash_bwd_dq: one block of 256 threads (a 16 x 16 grid) per
//     (64-row q tile, head, sequence). Its prologue computes delta for its
//     rows (a warp a row) and writes it out for the second kernel. It
//     walks the key tiles that can meet its rows, recomputes S and P,
//     forms dS in shared memory and accumulates dQ += dS K in registers.
//   * flash_bwd_dkdv: one block per (64-key tile, kv head, sequence). It
//     walks the group's G query heads and, for each, the q tiles that can
//     meet its keys (the inverse of the forward's kv_tile_range),
//     recomputes S^T and P^T, and accumulates dV += P^T dO and
//     dK += dS^T Q in registers.
// Every product is the forward f32 kernel's register-blocked tile: thread
// (ty, tx) owns rows 4 ty .. 4 ty + 3 and columns tx + 16 j of a 64 x 64
// score tile (LDS.128 fragments along D), and 4 rows x D / 16 columns of a
// D-wide accumulator (a float4 at 4 tx + 64 c and, at D = 80, one column
// at 64 + tx). Tiles live in shared memory as fp32 (bf16 widened on load);
// a warp whose 8 rows lie past the sequence only loads and syncs, and
// column groups of 16 past the tile's live rows are skipped, so at S = 257
// the work tracks 257^2. expf is the accurate one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int BT = 64;        // rows of a tile: q rows or keys
constexpr int RM = 4;         // tile rows per thread (4 ty .. 4 ty + 3)
constexpr int KJ = 4;         // score columns per thread (tx + 16 j)
constexpr int PS = BT + 4;    // row stride of the P / dS tile

template <int D> struct Layout {
  static constexpr int QS = D + 4;          // row stride of the D-wide tiles
  static constexpr int NV4 = D / 64;        // float4 accumulator columns
  static constexpr int NS = (D % 64) / 16;  // scalar accumulator columns
  static constexpr int DT = 4 * NV4 + NS;
  static constexpr int T0 = 0;              // four BT x QS tiles
  static constexpr int T1 = T0 + BT * QS;
  static constexpr int T2 = T1 + BT * QS;
  static constexpr int T3 = T2 + BT * QS;
  static constexpr int P = T3 + BT * QS;    // BT x PS: P or dS
  static constexpr int R0 = P + BT * PS;    // BT: lse of the q rows
  static constexpr int R1 = R0 + BT;        // BT: delta of the q rows
  static constexpr int FLOATS = R1 + BT;
  static_assert(16 * DT == D, "accumulator columns tile D");
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Can a query of [q0, q0 + bq) (rows below Sq) see a key of [k0, k0 + bk)?
// True whenever one pair is visible (it may be true with none: the
// element mask decides). Both kernels skip the tile pairs where it fails.
__host__ __device__ __forceinline__ bool tiles_meet(int q0, int bq, int k0,
                                                    int bk, int Sq, int causal,
                                                    int window, int q_offset) {
  const int p_lo = q0 + q_offset, p_hi = imin(q0 + bq, Sq) - 1 + q_offset;
  if (causal && k0 > p_hi) return false;
  if (window > 0 && k0 + bk - 1 <= p_lo - window) return false;
  return true;
}

// Is key kj visible to the query at position qp (q row + q_offset)?
__device__ __forceinline__ bool visible(int qp, int kj, int causal,
                                        int window) {
  return (!causal || kj <= qp) && (window <= 0 || kj > qp - window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T's precision, kept in fp32 (the identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Rows [row0, row0 + BT) of x (B, S, NH, D) at (b, h) into a BT x QS fp32
// tile, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          int b, int row0, int S, int NH,
                                          int h) {
  constexpr int QS = D + 4, D4 = D / 4;
  for (int c = threadIdx.x; c < BT * D4; c += THREADS) {
    const int r = c / D4, d = (c % D4) * 4, row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) val = load4(x + (((size_t)b * S + row) * NH + h) * D + d);
    *reinterpret_cast<float4*>(dst + r * QS + d) = val;
  }
}

// s[r][j] = sum_d A[4 ty + r][d] * Bt[tx + 16 j][d], for the column groups
// j < jmax (the others are left 0).
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ty, int tx, int jmax,
                                         float (&s)[RM][KJ]) {
  constexpr int QS = D + 4;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[r][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (RM * ty + r) * QS + d);
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      if (j < jmax) {
        const float4 b =
            *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * QS + d);
#pragma unroll
        for (int r = 0; r < RM; ++r)
          s[r][j] = fmaf(a[r].w, b.w, fmaf(a[r].z, b.z,
                    fmaf(a[r].y, b.y, fmaf(a[r].x, b.x, s[r][j]))));
      }
    }
  }
}

// acc[r][i] += sum_{j < n} P[4 ty + r][j] * V[j][column i of this thread],
// n a multiple of 4 (rows past the live ones are 0 in P's columns).
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* V,
                                         int ty, int tx, int n,
                                         float (&acc)[RM][Layout<D>::DT]) {
  using L = Layout<D>;
  constexpr int QS = L::QS, NV4 = L::NV4, NS = L::NS, DT = L::DT;
  for (int j = 0; j < n; j += 4) {
    float4 p4[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      p4[r] = *reinterpret_cast<const float4*>(P + (RM * ty + r) * PS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* vr = V + (j + jj) * QS;
      float vv[DT];
#pragma unroll
      for (int c = 0; c < NV4; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 4 * tx + 64 * c);
        vv[4 * c] = x.x;
        vv[4 * c + 1] = x.y;
        vv[4 * c + 2] = x.z;
        vv[4 * c + 3] = x.w;
      }
#pragma unroll
      for (int c = 0; c < NS; ++c) vv[4 * NV4 + c] = vr[64 * NV4 + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y
                      : jj == 2 ? p4[r].z : p4[r].w;
#pragma unroll
        for (int i = 0; i < DT; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }
}

// Row r of a 4 ty + r accumulator into y (B, S, NH, D) at (b, h), as T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ y,
                                           const float (&acc)[RM][Layout<D>::DT],
                                           int b, int row0, int S, int NH,
                                           int h, int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + RM * ty + r;
    if (row >= S) continue;
    T* yr = y + (((size_t)b * S + row) * NH + h) * D;
#pragma unroll
    for (int c = 0; c < L::NV4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yr[4 * tx + 64 * c + e] = from_f<T>(acc[r][4 * c + e]);
#pragma unroll
    for (int c = 0; c < L::NS; ++c)
      yr[64 * L::NV4 + tx + 16 * c] = from_f<T>(acc[r][4 * L::NV4 + c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv,
             int H, int KV, float scale, int causal, int window,
             int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::T0;
  float* dos = smem + L::T1;
  float* ks = smem + L::T2;
  float* vs = smem + L::T3;
  float* ps = smem + L::P;
  float* lse_s = smem + L::R0;
  float* del_s = smem + L::R1;

  const int n_qt = (Sq + BT - 1) / BT;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int h = bh % H, b = bh / H, kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BT;
  load_tile<T, D>(qs, q, b, q0, Sq, H, h);
  load_tile<T, D>(dos, dout, b, q0, Sq, H, h);
  __syncthreads();
  // delta = rowsum(dO * O) in fp32, a warp a row
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const T* orow = o + (((size_t)b * Sq + row) * H + h) * D;
      for (int d = lane; d < D; d += 32) acc += dos[r * L::QS + d] * to_f(orow[d]);
    }
#pragma unroll
    for (int o_ = 16; o_; o_ >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o_);
    if (lane == 0) {
      const size_t at = ((size_t)b * H + h) * Sq + row;
      del_s[r] = acc;
      lse_s[r] = row < Sq ? lse[at] : 0.f;
      if (row < Sq) delta[at] = acc;
    }
  }
  // this warp's 8 rows (ty = 2 w, 2 w + 1); rows past Sq only help
  const bool active = q0 + 8 * warp < Sq;
  float acc[RM][L::DT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < L::DT; ++i) acc[r][i] = 0.f;

  const int n_kt = (Skv + BT - 1) / BT;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BT;
    if (!tiles_meet(q0, BT, k0, BT, Sq, causal, window, q_offset)) continue;
    __syncthreads();  // the last tile's readers are done (and delta is in)
    load_tile<T, D>(ks, k, b, k0, Skv, KV, kvh);
    load_tile<T, D>(vs, v, b, k0, Skv, KV, kvh);
    __syncthreads();
    const int n_live = imin(BT, Skv - k0);
    if (active) {
      float s[RM][KJ], dp[RM][KJ];
      tile_dot<D>(qs, ks, ty, tx, (n_live + 15) / 16, s);
      tile_dot<D>(dos, vs, ty, tx, (n_live + 15) / 16, dp);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int rr = RM * ty + r, qi = q0 + rr;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kj = k0 + tx + 16 * j;
          const bool seen = qi < Sq && kj < Skv &&
                            visible(qi + q_offset, kj, causal, window);
          const float p = seen ? expf(s[r][j] * scale - lse_s[rr]) : 0.f;
          ps[rr * PS + tx + 16 * j] =
              round_to<T>(p * (dp[r][j] - del_s[rr]) * scale);
        }
      }
    }
    __syncthreads();
    if (active) tile_acc<D>(ps, ks, ty, tx, (n_live + 3) & ~3, acc);
  }
  if (active) store_rows<T, D>(dq, acc, b, q0, Sq, H, h, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
               int H, int KV, float scale, int causal, int window,
               int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem + L::T0;
  float* vs = smem + L::T1;
  float* qs = smem + L::T2;
  float* dos = smem + L::T3;
  float* ps = smem + L::P;
  float* lse_s = smem + L::R0;
  float* del_s = smem + L::R1;

  const int n_kt = (Skv + BT - 1) / BT;
  const int kt = blockIdx.x % n_kt, bk = blockIdx.x / n_kt;
  const int kvh = bk % KV, b = bk / KV, G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * BT;
  load_tile<T, D>(ks, k, b, k0, Skv, KV, kvh);
  load_tile<T, D>(vs, v, b, k0, Skv, KV, kvh);
  // this warp's 8 keys; keys past Skv only help
  const bool active = k0 + 8 * (tid / 32) < Skv;
  float dk_acc[RM][L::DT], dv_acc[RM][L::DT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  const int n_qt = (Sq + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      if (!tiles_meet(q0, BT, k0, BT, Sq, causal, window, q_offset)) continue;
      __syncthreads();  // the last q tile's readers are done
      load_tile<T, D>(qs, q, b, q0, Sq, H, h);
      load_tile<T, D>(dos, dout, b, q0, Sq, H, h);
      for (int r = tid; r < BT; r += THREADS) {
        const int row = q0 + r;
        const size_t at = ((size_t)b * H + h) * Sq + row;
        lse_s[r] = row < Sq ? lse[at] : 0.f;
        del_s[r] = row < Sq ? delta[at] : 0.f;
      }
      __syncthreads();
      const int n_live = imin(BT, Sq - q0);
      float ds[RM][KJ];
      if (active) {
        float s[RM][KJ];
        tile_dot<D>(ks, qs, ty, tx, (n_live + 15) / 16, s);
        tile_dot<D>(vs, dos, ty, tx, (n_live + 15) / 16, ds);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int rr = RM * ty + r, kj = k0 + rr;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int c = tx + 16 * j, qi = q0 + c;
            const bool seen = qi < Sq && kj < Skv &&
                              visible(qi + q_offset, kj, causal, window);
            const float p = seen ? expf(s[r][j] * scale - lse_s[c]) : 0.f;
            ds[r][j] = round_to<T>(p * (ds[r][j] - del_s[c]) * scale);
            ps[rr * PS + c] = round_to<T>(p);
          }
        }
      }
      __syncthreads();
      if (active) tile_acc<D>(ps, dos, ty, tx, (n_live + 3) & ~3, dv_acc);
      __syncthreads();  // P is read: dS goes there
      if (active) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int j = 0; j < KJ; ++j)
            ps[(RM * ty + r) * PS + tx + 16 * j] = ds[r][j];
      }
      __syncthreads();
      if (active) tile_acc<D>(ps, qs, ty, tx, (n_live + 3) & ~3, dk_acc);
    }
  }
  if (active) {
    store_rows<T, D>(dk, dk_acc, b, k0, Skv, KV, kvh, ty, tx);
    store_rows<T, D>(dv, dv_acc, b, k0, Skv, KV, kvh, ty, tx);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int Sq, int Skv, int H, int KV, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * Layout<D>::FLOATS;
  auto k_dq = flash_bwd_dq<T, D>;
  auto k_kv = flash_bwd_dkdv<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        k_kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long g_dq = (long long)B * H * ((Sq + BT - 1) / BT);
  const long long g_kv = (long long)B * KV * ((Skv + BT - 1) / BT);
  if (g_dq > 2147483647LL || g_kv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  k_dq<<<(unsigned)g_dq, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), lse, tdo, static_cast<T*>(dq),
      delta, Sq, Skv, H, KV, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_kv<<<(unsigned)g_kv, THREADS, smem, stream>>>(
      tq, tk, tv, lse, delta, tdo, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, H, KV, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16 picks the element type (bf16 or f32, all tensors alike but lse
// and delta, f32); D is 64, 80 or 128. delta (B, H, Sq) f32 is scratch the
// first kernel writes and the second reads. Returns a cudaError_t.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* out, const float* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, float* delta, int B, int Sq,
                                int Skv, int H, int KV, int D, int is_bf16,
                                float scale, int causal, int window,
                                int q_offset, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS q, k, v, out, lse, dout, dq, dk, dv, delta, B, Sq, Skv, H, \
                 KV, scale, causal, window, q_offset, stream
  if (is_bf16) {
    switch (D) {
      case 64: return launch<__nv_bfloat16, 64>(BWD_ARGS);
      case 80: return launch<__nv_bfloat16, 80>(BWD_ARGS);
      case 128: return launch<__nv_bfloat16, 128>(BWD_ARGS);
    }
  } else {
    switch (D) {
      case 64: return launch<float, 64>(BWD_ARGS);
      case 80: return launch<float, 80>(BWD_ARGS);
      case 128: return launch<float, 128>(BWD_ARGS);
    }
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
