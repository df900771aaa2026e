// Flash-attention backward for Hopper: bf16 on wgmma tensor cores, f32 on
// register-blocked FMA tiles, fp32 accumulation in both.
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
// operations (S, dO V^T, dV, dQ, dK; about half of them causal), in bf16 on
// the tensor cores (989 TFLOP/s) and in f32 on the FMA units (67 TFLOP/s),
// far above the bytes (each of q, k, v, out, dout read once, dq, dk, dv
// written once).
//
// Design: deterministic, no atomics, so two runs give the same bits (Adam
// turns noise in near-zero gradients into different updates). Under GQA
// (G = H / KV > 1) a dK/dV block runs per query head and writes its head's
// fp32 share into partials (B, Skv, H, D); reduce_heads sums the G shares
// of a kv head in head order (g = 0 .. G - 1), then casts: the grid is G
// times the kv heads', and the sum still has one fixed order.
//
// bf16 (namespace wg, described there): two wgmma kernels, dQ and dK/dV,
// each recomputing S and P from lse (7 products where the bound counts 5).
//
// f32: one pass, the 5 products, in three launches on the stream:
//   * bwd_delta: delta = rowsum(dout * out), a warp a row;
//   * flash_bwd_f32: one block per (64-key tile, query head, sequence), K
//     and V resident; it walks the q tiles that can meet its keys (the
//     inverse of the forward's kv_tile_range), accumulates dV += P^T dO and
//     dK += dS^T Q in registers, and writes dS K, its key tile's fp32 share
//     of those rows' dQ, to a slab of dq_part (B, n_kt, Sq, H, D);
//   * sum_key_tiles: dQ = the slabs summed in key-tile order (kt = 0 ..
//     n_kt - 1), the same fixed-order pattern as reduce_heads.
// 256 threads (a 16 x 16 grid), two blocks an SM at D <= 80 (104 KB of
// shared memory and 128 registers each; one at D = 128). Every product is
// the forward f32 kernel's register-blocked tile: thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 and columns tx + 16 j of a 64 x 64 score tile (LDS.128
// fragments along D), and 4 rows x D / 16 columns of a D-wide accumulator
// (a float4 at 4 tx + 64 c and, at D = 80, one column at 64 + tx); P and dS
// pass through shared memory, dQ's product reads dS through its transpose.
// Q, dO, lse and delta come by cp.async into one buffer each: the next q
// tile's dO is issued once dV has read this one's, its Q once dK has, so
// the copies fly under dK and dQ's products. A second stage of Q and dO
// (146 KB, one block an SM) ran slower than the second resident block. A
// warp whose 8 rows lie past the sequence only loads and syncs, and column
// groups of 16 past the tile's live rows are skipped; a tile with at most
// 8 live rows (S = 257 is four tiles and one row) spreads its work over
// the block (the thin tiles below), so at S = 257 the work tracks 257^2.
// expf is the accurate one in both paths.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "../../hopper.cuh"

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

// Does some (query, key) pair of rows [q0, q0 + nq) and keys [k0, k0 + nk)
// lie past Sq or Skv, or outside the causal or window mask? (Else every
// pair is visible and the element mask can be skipped.)
__host__ __device__ __forceinline__ bool needs_mask(int q0, int nq, int k0,
                                                   int nk, int Sq, int Skv,
                                                   int causal, int window,
                                                   int q_offset) {
  return q0 + nq > Sq || k0 + nk > Skv ||
         (causal && k0 + nk - 1 > q0 + q_offset) ||
         (window > 0 && k0 <= q0 + nq - 1 + q_offset - window);
}

// Is key kj visible to the query at position qp (q row + q_offset)?
__device__ __forceinline__ bool visible(int qp, int kj, int causal,
                                        int window) {
  return (!causal || kj <= qp) && (window <= 0 || kj > qp - window);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Rows [row0, row0 + BT) of x (B, S, NH, D) at (b, h) into a BT x QS fp32
// tile by 16-byte cp.async, zeros past S.
template <int D>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ x, int b,
                                          int row0, int S, int NH, int h) {
  constexpr int QS = D + 4, D4 = D / 4;
  for (int c = threadIdx.x; c < BT * D4; c += THREADS) {
    const int r = c / D4, d = (c % D4) * 4, row = row0 + r;
    const bool live = row < S;
    const float* src = live ? x + (((size_t)b * S + row) * NH + h) * D + d : x;
    hopper::cp_async16(dst + r * QS + d, src, live ? 16 : 0);
  }
}

// lse and delta of q rows [q0, q0 + BT) (the (B, H, Sq) row that starts at
// `at`) into BT floats each by 4-byte cp.async, zeros past Sq.
__device__ __forceinline__ void copy_rows(float* lse_s, float* del_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          size_t at, int q0, int Sq) {
  const int t = threadIdx.x, r = t % BT;
  if (t >= 2 * BT) return;
  const bool live = q0 + r < Sq;
  const float* src = t < BT ? lse : delta;
  hopper::cp_async4((t < BT ? lse_s : del_s) + r,
                    live ? src + at + q0 + r : src, live ? 4 : 0);
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

// This thread's columns of a row of a D-wide tile: a float4 at
// 4 tx + 64 c, and at D = 80 one column at 64 + tx.
template <int D>
__device__ __forceinline__ void row_cols(const float* row,
                                         float (&x)[Layout<D>::DT], int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int c = 0; c < L::NV4; ++c) {
    const float4 f = *reinterpret_cast<const float4*>(row + 4 * tx + 64 * c);
    x[4 * c] = f.x;
    x[4 * c + 1] = f.y;
    x[4 * c + 2] = f.z;
    x[4 * c + 3] = f.w;
  }
#pragma unroll
  for (int c = 0; c < L::NS; ++c)
    x[4 * L::NV4 + c] = row[64 * L::NV4 + tx + 16 * c];
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[r][i] += sum_{j < n} P[4 ty + r][j] * V[j][column i of this thread],
// n a multiple of 4 (rows past the live ones are 0 in P's columns).
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* V,
                                         int ty, int tx, int n,
                                         float (&acc)[RM][Layout<D>::DT]) {
  constexpr int QS = D + 4, DT = Layout<D>::DT;
  for (int j = 0; j < n; j += 4) {
    float4 p4[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r)
      p4[r] = *reinterpret_cast<const float4*>(P + (RM * ty + r) * PS + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[DT];
      row_cols<D>(V + (j + jj) * QS, vv, tx);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float p = lane_of(p4[r], jj);
#pragma unroll
        for (int i = 0; i < DT; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }
}

// acc[r][i] += sum_{j < n} P[j][4 ty + r] * K[j][column i of this thread]:
// tile_acc through P's transpose (P's rows are keys here, the thread's
// accumulator rows q rows), a float4 of P a key.
template <int D>
__device__ __forceinline__ void tile_acc_t(const float* P, const float* K,
                                           int ty, int tx, int n,
                                           float (&acc)[RM][Layout<D>::DT]) {
  constexpr int QS = D + 4, DT = Layout<D>::DT;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 p4 = *reinterpret_cast<const float4*>(P + j * PS + RM * ty);
    float kk[DT];
    row_cols<D>(K + j * QS, kk, tx);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float p = lane_of(p4, r);
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[r][i] = fmaf(p, kk[i], acc[r][i]);
    }
  }
}

// Rows row0 + 4 ty + r (those below S) of an accumulator into y, row i at
// y + i * stride.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ y,
                                           size_t stride,
                                           const float (&acc)[RM][Layout<D>::DT],
                                           int row0, int S, int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + RM * ty + r;
    if (row >= S) continue;
    float* yr = y + row * stride;
#pragma unroll
    for (int c = 0; c < L::NV4; ++c)
      *reinterpret_cast<float4*>(yr + 4 * tx + 64 * c) =
          make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                      acc[r][4 * c + 3]);
#pragma unroll
    for (int c = 0; c < L::NS; ++c)
      yr[64 * L::NV4 + tx + 16 * c] = acc[r][4 * L::NV4 + c];
  }
}

// delta = rowsum(dout * out) in fp32 for each of the `rows` (b, q row, h)
// rows of (B, Sq, H, D), written to delta (B, H, Sq); a warp a row.
template <int D>
__global__ void bwd_delta(const float* __restrict__ o,
                          const float* __restrict__ dout,
                          float* __restrict__ delta, long long rows, int Sq,
                          int H) {
  const long long row = blockIdx.x * (long long)(blockDim.x / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = 4 * lane; d < D; d += 128) {
    const float4 x = load4(o + row * D + d), y = load4(dout + row * D + d);
    acc = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
  }
#pragma unroll
  for (int o_ = 16; o_; o_ >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o_);
  if (lane == 0) {
    const long long bs = row / H;  // b * Sq + q row
    delta[((bs / Sq) * H + row % H) * Sq + bs % Sq] = acc;
  }
}

// The thin tiles: a key tile or a q tile with at most 8 live rows (S = 257
// is four 64-row tiles and one row). The 64 x 64 register tile would leave
// one warp computing and seven waiting; a thin tile spreads its work over
// the block instead, thread t on row t % 8 of the thin side. Each sum runs
// in the register tile's order.

// s[i] = A[a] . Bm[o + 32 i] and dp[i] = C[a] . E[o + 32 i] over D, for the
// thin side's row a = t % 8 and the other side's rows o + 32 i, o = t / 8:
// S and dO V^T of two pairs (K, V against Q, dO, or the reverse).
template <int D>
__device__ __forceinline__ void thin_dots(const float* A, const float* C,
                                          const float* Bm, const float* E,
                                          float (&s)[2], float (&dp)[2]) {
  constexpr int QS = D + 4;
  const int a = threadIdx.x % 8, o = threadIdx.x / 8;
  s[0] = s[1] = dp[0] = dp[1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(A + a * QS + d);
    const float4 y = *reinterpret_cast<const float4*>(C + a * QS + d);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (o + 32 * i) * QS + d;
      const float4 b = *reinterpret_cast<const float4*>(Bm + row);
      const float4 e = *reinterpret_cast<const float4*>(E + row);
      s[i] = fmaf(x.w, b.w, fmaf(x.z, b.z,
             fmaf(x.y, b.y, fmaf(x.x, b.x, s[i]))));
      dp[i] = fmaf(y.w, e.w, fmaf(y.z, e.z,
              fmaf(y.y, e.y, fmaf(y.x, e.x, dp[i]))));
    }
  }
}

// acc[0..3] += sum_{j < n} P[a][j] * X[j][4 g .. 4 g + 3] for P's row
// a = t % 8 (stride sa, step sj along j) and the column group g = t / 8:
// dV and dK of a thin key tile, and dQ of a thin q tile (through P's
// transpose).
template <int D>
__device__ __forceinline__ void thin_acc(const float* P, int sa, int sj,
                                         const float* X, int n,
                                         float (&acc)[Layout<D>::DT]) {
  constexpr int QS = D + 4;
  const int g = threadIdx.x / 8;
  if (4 * g >= D) return;
  const float* pa = P + (threadIdx.x % 8) * sa;
  const float* xg = X + 4 * g;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float p = pa[j * sj];
    const float4 x = *reinterpret_cast<const float4*>(xg + j * QS);
    acc[0] = fmaf(p, x.x, acc[0]);
    acc[1] = fmaf(p, x.y, acc[1]);
    acc[2] = fmaf(p, x.z, acc[2]);
    acc[3] = fmaf(p, x.w, acc[3]);
  }
}

// Row row0 + t % 8 (below S) of a thin accumulator into y, row i at
// y + i * stride.
template <int D>
__device__ __forceinline__ void thin_store(float* __restrict__ y,
                                           size_t stride,
                                           const float (&acc)[Layout<D>::DT],
                                           int row0, int S) {
  const int row = row0 + threadIdx.x % 8, g = threadIdx.x / 8;
  if (row >= S || 4 * g >= D) return;
  *reinterpret_cast<float4*>(y + row * stride + 4 * g) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// One block per (64-key tile, query head, sequence): K and V resident, the
// q tiles that meet them streamed (Q, dO, lse, delta); per q tile it adds
// P^T dO to dV and dS^T Q to dK, and writes dS K, this key tile's share of
// those rows' dQ, to its slab of dq_part (B, n_kt, Sq, H, D).
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ dout,
              float* __restrict__ dk, float* __restrict__ dv,
              float* __restrict__ dk_part, float* __restrict__ dv_part,
              float* __restrict__ dq_part, int Sq, int Skv, int H, int KV,
              float scale, int causal, int window, int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem + L::T0;
  float* vs = smem + L::T1;
  float* qs = smem + L::T2;
  float* dos = smem + L::T3;
  float* ps = smem + L::P;
  float* lse_s = smem + L::R0;
  float* del_s = smem + L::R1;

  const int n_kt = (Skv + BT - 1) / BT, n_qt = (Sq + BT - 1) / BT;
  const int kt = blockIdx.x % n_kt, bh = blockIdx.x / n_kt;
  const int h = bh % H, b = bh / H, G = H / KV, kvh = h / G;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32;
  const int k0 = kt * BT, n_keys = imin(BT, Skv - k0);
  const bool thin_k = n_keys <= 8;
  const size_t at = ((size_t)b * H + h) * Sq;
  float* dq_rows = dq_part + (((size_t)b * n_kt + kt) * Sq * H + h) * D;
  // the q tiles that can meet this key tile, in order
  auto next_qt = [&](int t) {
    do ++t;
    while (t < n_qt &&
           !tiles_meet(t * BT, BT, k0, BT, Sq, causal, window, q_offset));
    return t;
  };
  auto copy_q = [&](int t) { copy_tile<D>(qs, q, b, t * BT, Sq, H, h); };
  auto copy_do = [&](int t) {
    copy_tile<D>(dos, dout, b, t * BT, Sq, H, h);
    copy_rows(lse_s, del_s, lse, delta, at, t * BT, Sq);
  };
  copy_tile<D>(ks, k, b, k0, Skv, KV, kvh);
  copy_tile<D>(vs, v, b, k0, Skv, KV, kvh);
  int qt = next_qt(-1);
  if (qt < n_qt) {
    copy_q(qt);
    copy_do(qt);
  }
  hopper::cp_async_commit();
  // this warp's 8 keys; keys past Skv only help
  const bool active = !thin_k && k0 + 8 * warp < Skv;
  // a thin key tile keeps its dK, dV in row 0 (thin_acc's columns)
  float dk_acc[RM][L::DT], dv_acc[RM][L::DT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  while (qt < n_qt) {
    const int q0 = qt * BT, nxt = next_qt(qt);
    const int n_live = imin(BT, Sq - q0);
    const bool thin = thin_k || n_live <= 8;
    hopper::cp_async_wait<0>();
    __syncthreads();  // this q tile landed; the last one's dQ reads are done
    float ds[RM][KJ];  // a thin tile keeps its two dS in ds[0]
    if (thin) {  // pairs (t % 8, t / 8 + 32 i) of (thin side, other side)
      float ts[2], tdp[2];
      if (thin_k) thin_dots<D>(ks, vs, qs, dos, ts, tdp);
      else thin_dots<D>(qs, dos, ks, vs, ts, tdp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = tid % 8, o = tid / 8 + 32 * i;
        const int key = thin_k ? a : o, c = thin_k ? o : a;
        const int kj = k0 + key, qi = q0 + c;
        const bool seen = qi < Sq && kj < Skv &&
                          visible(qi + q_offset, kj, causal, window);
        const float p = seen ? expf(ts[i] * scale - lse_s[c]) : 0.f;
        ds[0][i] = p * (tdp[i] - del_s[c]) * scale;
        ps[key * PS + c] = p;
      }
    } else if (active) {
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
          ds[r][j] = p * (ds[r][j] - del_s[c]) * scale;
          ps[rr * PS + c] = p;
        }
      }
    }
    __syncthreads();
    if (thin_k) thin_acc<D>(ps, PS, 1, dos, n_live, dv_acc[0]);
    else if (active) tile_acc<D>(ps, dos, ty, tx, (n_live + 3) & ~3, dv_acc);
    __syncthreads();  // P, dO, lse and delta are read: the next ones come in
    if (nxt < n_qt) copy_do(nxt);
    hopper::cp_async_commit();
    if (thin) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = tid % 8, o = tid / 8 + 32 * i;
        ps[(thin_k ? a : o) * PS + (thin_k ? o : a)] = ds[0][i];
      }
    } else if (active) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          ps[(RM * ty + r) * PS + tx + 16 * j] = ds[r][j];
    }
    __syncthreads();
    if (thin_k) thin_acc<D>(ps, PS, 1, qs, n_live, dk_acc[0]);
    else if (active) tile_acc<D>(ps, qs, ty, tx, (n_live + 3) & ~3, dk_acc);
    __syncthreads();  // Q is read: the next one comes in
    if (nxt < n_qt) copy_q(nxt);
    hopper::cp_async_commit();
    // dS K: this key tile's share of the q rows' dQ
    if (n_live <= 8) {
      float acc[L::DT] = {};
      thin_acc<D>(ps, 1, PS, ks, n_keys, acc);
      thin_store<D>(dq_rows, (size_t)H * D, acc, q0, Sq);
    } else if (q0 + 8 * warp < Sq) {
      float acc[RM][L::DT];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int i = 0; i < L::DT; ++i) acc[r][i] = 0.f;
      tile_acc_t<D>(ps, ks, ty, tx, (n_keys + 3) & ~3, acc);
      store_rows<D>(dq_rows, (size_t)H * D, acc, q0, Sq, ty, tx);
    }
    qt = nxt;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block
  const size_t off = G == 1 ? (size_t)b * Skv * KV + kvh
                            : (size_t)b * Skv * H + h;
  const size_t stride = (size_t)(G == 1 ? KV : H) * D;
  // G > 1: this head's fp32 share, summed by reduce_heads
  float* yk = (G == 1 ? dk : dk_part) + off * D;
  float* yv = (G == 1 ? dv : dv_part) + off * D;
  if (thin_k) {
    thin_store<D>(yk, stride, dk_acc[0], k0, Skv);
    thin_store<D>(yv, stride, dv_acc[0], k0, Skv);
  } else if (active) {
    store_rows<D>(yk, stride, dk_acc, k0, Skv, ty, tx);
    store_rows<D>(yv, stride, dv_acc, k0, Skv, ty, tx);
  }
}

// dq (B, Sq, H, D) from the key tiles' shares dq_part (B, n_kt, Sq, H, D):
// for each row, the shares of the key tiles that meet its q tile (the
// others were never written) summed in key-tile order kt = 0 .. n_kt - 1.
// Four elements a thread.
__global__ void sum_key_tiles(const float* __restrict__ part,
                              float* __restrict__ dq, long long n4, int Sq,
                              int HD, int n_kt, int causal, int window,
                              int q_offset) {
  const int HD4 = HD / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long bs = i / HD4;  // b * Sq + q row
    const int row = (int)(bs % Sq), c = (int)(i % HD4) * 4;
    const int q0 = row / BT * BT;
    const float* p = part + ((bs / Sq) * n_kt * Sq + row) * HD + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < n_kt; ++t) {
      if (!tiles_meet(q0, BT, t * BT, BT, Sq, causal, window, q_offset))
        continue;
      const float4 x = load4(p + (size_t)t * Sq * HD);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(dq + bs * HD + c) = acc;
  }
}

// ------------------------------------------------------------------------
// bf16: the products on wgmma (bf16 operands, fp32 accumulators), one
// warpgroup (128 threads) a block owning 64 resident rows: keys (dK/dV)
// or q rows (dQ). Tiles are 64 rows of D bf16 columns in shared memory as
// 128-byte-swizzled 64-column atoms (hopper.cuh), loaded by 16-byte
// cp.async; the streamed tiles (Q, dO, lse, delta for dK/dV; K, V for dQ)
// go through a 2-stage ring, so the next tile loads while this one
// multiplies. S^T, dP^T (dK/dV) and S, dP (dQ) are m64n64 products of two
// K-major operands in shared memory; their accumulators, rounded to bf16
// in registers, are the A fragments of dV += P^T dO, dK += dS^T Q and
// dQ += dS K (m64nD, the B operand MN-major through the descriptor's
// transpose bit), so P and dS never leave the registers and each streamed
// tile is read once by the four warps. A tile's wgmma groups overlap the
// register work that needs the group before: S^T, then dP^T while P^T is
// formed, dV while dS^T is formed, then dK.
namespace wg {

constexpr int ROWS = 64, W = 16, ATOM = ROWS * 128;
// a tile's bytes: NA atoms across D (D = 80: the second zero past column 80)
template <int D> struct Tile {
  static constexpr int NA = (D + 63) / 64;
  static constexpr int BYTES = NA * ATOM;
};

// Rows [row0, row0 + 64) of x (B, S, NH, D) at (b, h) into a swizzled tile
// by 16-byte cp.async (128 threads); rows past S and columns past D read as
// zeros.
template <int D>
__device__ __forceinline__ void load_swizzled(
    uint8_t* dst, const __nv_bfloat16* __restrict__ x, int b, int row0, int S,
    int NH, int h) {
  constexpr int CPR = Tile<D>::NA * 8, LIVE = D / 8;  // chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += 128) {
    const int r = c / CPR, ch = c % CPR, row = row0 + r;
    const bool live = row < S && ch < LIVE;
    const size_t g = (((size_t)b * S + (row < S ? row : 0)) * NH + h) * D +
                     (ch < LIVE ? ch * 8 : 0);
    uint8_t* at = dst + (ch / 8) * ATOM + r * 128 + ((ch % 8) ^ (r % 8)) * 16;
    hopper::cp_async16(at, x + g, live ? 16 : 0);
  }
}

// K-major operand of a swizzled tile at the k16 step kk; MN-major B whose
// K runs down the tile's rows, at the k16 step kk.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* t, int kk) {
  return hopper::desc_sw128(t + (kk / 4) * ATOM + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* t, int kk) {
  return hopper::desc_sw128(t + kk * 2048, ATOM, 1024);
}

// [lo, hi): the 64-row tiles of the other operand that meet the resident
// rows [r0, r0 + 64) (tiles_meet fails on a prefix under causal and a
// suffix under a window, so the tiles that meet are one run); dkdv: the
// resident rows are keys, else q rows.
__device__ __forceinline__ void tile_run(int n_tiles, bool dkdv, int r0,
                                         int Sq, int causal, int window,
                                         int q_offset, int& lo, int& hi) {
  auto meet = [&](int t) {
    return dkdv ? tiles_meet(t * ROWS, ROWS, r0, ROWS, Sq, causal, window,
                             q_offset)
                : tiles_meet(r0, ROWS, t * ROWS, ROWS, Sq, causal, window,
                             q_offset);
  };
  lo = 0;
  while (lo < n_tiles && !meet(lo)) ++lo;
  hi = lo;
  while (hi < n_tiles && meet(hi)) ++hi;
}

// dK and dV for keys [k0, k0 + 64) of query head h: one block per (key
// tile, query head, sequence), heaviest key tiles (causal: the first)
// scheduled first. K and V stay in shared memory; the q tiles that meet
// them stream. Warp w's accumulator rows are keys k0 + 16 w .. + 15. With
// G = H / KV = 1 it writes dK and dV; else this head's fp32 share into the
// partials (B, Skv, H, D), which reduce_heads sums in head order.
template <int D>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dkdv_wgmma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ dk_part, float* __restrict__ dv_part,
                     int B, int Sq, int Skv, int H, int KV, float scale,
                     int causal, int window, int q_offset) {
  constexpr int TB = Tile<D>::BYTES, R = ROWS;
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  uint8_t* ks = hopper::align1024(smem_wg);
  uint8_t* vs = ks + TB;
  uint8_t* ring = vs + TB;  // stage s: Q at 2 s TB, dO after it
  float* rows = reinterpret_cast<float*>(ring + 4 * TB);

  const int bh = blockIdx.x % (B * H), kt = blockIdx.x / (B * H);
  const int h = bh % H, b = bh / H, G = H / KV, kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int k0 = kt * R, kw = k0 + W * warp;  // this warp's first key

  load_swizzled<D>(ks, k, b, k0, Skv, KV, kvh);
  load_swizzled<D>(vs, v, b, k0, Skv, KV, kvh);
  int lo, hi;
  tile_run((Sq + R - 1) / R, true, k0, Sq, causal, window, q_offset, lo, hi);
  auto load_q = [&](int t, int s) {
    const int q0 = t * R;
    load_swizzled<D>(ring + 2 * s * TB, q, b, q0, Sq, H, h);
    load_swizzled<D>(ring + (2 * s + 1) * TB, dout, b, q0, Sq, H, h);
    for (int r = threadIdx.x; r < R; r += 128) {
      const bool live = q0 + r < Sq;
      const size_t at = ((size_t)b * H + h) * Sq + (live ? q0 + r : 0);
      hopper::cp_async4(rows + 2 * s * R + r, lse + at, live ? 4 : 0);
      hopper::cp_async4(rows + (2 * s + 1) * R + r, delta + at, live ? 4 : 0);
    }
  };
  if (lo < hi) load_q(lo, 0);
  hopper::cp_async_commit();  // group: K, V and the first q tile

  // accumulator element (key kw + gr + 8 i, column 8 c + 2 tq + j) is
  // acc[4 c + 2 i + j] (the m64nN layout)
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int s = (t - lo) & 1;
    if (t + 1 < hi) load_q(t + 1, s ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();    // this thread's copies of tile t
    hopper::fence_proxy_async();   // visible to wgmma's operand reads
    __syncthreads();               // everyone's
    const uint8_t* qs = ring + 2 * s * TB;
    const uint8_t* dos = qs + TB;
    const float* lse_s = rows + 2 * s * R;
    const float* del_s = lse_s + R;
    const int q0 = t * R;
    // four wgmma groups, each overlapping the registers' work that needs
    // the one before: S^T, then dP^T while P^T is formed, dV += P^T dO
    // while dS^T is formed, then dK += dS^T Q
    const bool masked = needs_mask(q0, R, k0, R, Sq, Skv, causal, window,
                                   q_offset);
    float st[32], dpt[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(st, desc_k(ks, kk), desc_k(qs, kk), kk > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(dpt, desc_k(vs, kk), desc_k(dos, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // S^T (groups complete in order)
    hopper::fence_regs(st);
    // element 4 c + e: key kw + gr + 8 (e / 2), query q0 + 8 c + 2 tq +
    // e % 2; st becomes P^T. P^T and dS^T of queries 16 j .. 16 j + 15 are
    // the A fragments pa[j], da[j].
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kw + gr + 8 * (e >> 1);
        const int col = 8 * c + 2 * tq + (e & 1), qi = q0 + col;
        const bool seen = !masked || (qi < Sq && kj < Skv &&
                                      visible(qi + q_offset, kj, causal,
                                              window));
        st[4 * c + e] = seen ? expf(st[4 * c + e] * scale - lse_s[col]) : 0.f;
      }
      pa[c / 2][2 * (c % 2)] = hopper::pack_bf16(st[4 * c], st[4 * c + 1]);
      pa[c / 2][2 * (c % 2) + 1] =
          hopper::pack_bf16(st[4 * c + 2], st[4 * c + 3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::Wgmma<D>::template rs<1>(dv_acc, pa[j], desc_mn(dos, j), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // dP^T
    hopper::fence_regs(dpt);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = st[4 * c + e] *
                (dpt[4 * c + e] - del_s[8 * c + 2 * tq + (e & 1)]) * scale;
      da[c / 2][2 * (c % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::Wgmma<D>::template rs<1>(dk_acc, da[j], desc_mn(qs, j), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    __syncthreads();  // stage s is read: the next load may overwrite it
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kj = kw + gr + 8 * i, d = 8 * c + 2 * tq;
      if (kj >= Skv) continue;
      const float* gk = dk_acc + 4 * c + 2 * i;
      const float* gv = dv_acc + 4 * c + 2 * i;
      if (G == 1) {
        const size_t at = (((size_t)b * Skv + kj) * KV + kvh) * D + d;
        *reinterpret_cast<uint32_t*>(dk + at) = hopper::pack_bf16(gk[0], gk[1]);
        *reinterpret_cast<uint32_t*>(dv + at) = hopper::pack_bf16(gv[0], gv[1]);
      } else {
        const size_t at = (((size_t)b * Skv + kj) * H + h) * D + d;
        *reinterpret_cast<float2*>(dk_part + at) = make_float2(gk[0], gk[1]);
        *reinterpret_cast<float2*>(dv_part + at) = make_float2(gv[0], gv[1]);
      }
    }
  }
}

// dQ for q rows [q0, q0 + 64) of head h, and delta = rowsum(dO * O) of
// those rows for the dK/dV kernel: one block per (q tile, head, sequence),
// heaviest q tiles (causal: the last) scheduled first. Q and dO stay in
// shared memory; the key tiles that meet them stream.
template <int D>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dq_wgmma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ o,
                   const float* __restrict__ lse,
                   const __nv_bfloat16* __restrict__ dout,
                   __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                   int B, int Sq, int Skv, int H, int KV, float scale,
                   int causal, int window, int q_offset) {
  constexpr int TB = Tile<D>::BYTES, R = ROWS;
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  uint8_t* qs = hopper::align1024(smem_wg);
  uint8_t* dos = qs + TB;
  uint8_t* ring = dos + TB;  // stage s: K at 2 s TB, V after it
  float* del_s = reinterpret_cast<float*>(ring + 4 * TB);

  const int n_qt = (Sq + R - 1) / R;
  const int bh = blockIdx.x % (B * H), qt = n_qt - 1 - blockIdx.x / (B * H);
  const int h = bh % H, b = bh / H, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tq = lane & 3;
  const int q0 = qt * R, qw = q0 + W * warp;  // this warp's first row

  load_swizzled<D>(qs, q, b, q0, Sq, H, h);
  load_swizzled<D>(dos, dout, b, q0, Sq, H, h);
  int lo, hi;
  tile_run((Skv + R - 1) / R, false, q0, Sq, causal, window, q_offset, lo,
           hi);
  auto load_kv = [&](int t, int s) {
    load_swizzled<D>(ring + 2 * s * TB, k, b, t * R, Skv, KV, kvh);
    load_swizzled<D>(ring + (2 * s + 1) * TB, v, b, t * R, Skv, KV, kvh);
  };
  if (lo < hi) load_kv(lo, 0);
  hopper::cp_async_commit();  // group: Q, dO and the first key tile
  // delta = rowsum(dO * O) in fp32 from global memory, a warp a row
  for (int r = warp; r < R; r += 4) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const size_t at = (((size_t)b * Sq + row) * H + h) * D;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dout[at + d]) * __bfloat162float(o[at + d]);
    }
#pragma unroll
    for (int o_ = 16; o_; o_ >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o_);
    if (lane == 0) {
      del_s[r] = acc;
      if (row < Sq) delta[((size_t)b * H + h) * Sq + row] = acc;
    }
  }
  __syncthreads();
  // this thread's rows qw + gr + 8 i: lse, delta
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + gr + 8 * i;
    lse_r[i] = row < Sq ? lse[((size_t)b * H + h) * Sq + row] : 0.f;
    del_r[i] = del_s[W * warp + gr + 8 * i];
  }
  // accumulator element (row qw + gr + 8 i, column 8 c + 2 tq + j) is
  // acc[4 c + 2 i + j]
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int s = (t - lo) & 1;
    if (t + 1 < hi) load_kv(t + 1, s ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    hopper::fence_proxy_async();
    __syncthreads();
    const uint8_t* kst = ring + 2 * s * TB;
    const uint8_t* vst = kst + TB;
    const int kt0 = t * R;
    const bool masked = needs_mask(q0, R, kt0, R, Sq, Skv, causal, window,
                                   q_offset);
    float sc[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(sc, desc_k(qs, kk), desc_k(kst, kk), kk > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::Wgmma<64>::ss<0>(dp, desc_k(dos, kk), desc_k(vst, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // S
    hopper::fence_regs(sc);
    // element 4 c + e: row qw + gr + 8 (e / 2), key kt0 + 8 c + 2 tq +
    // e % 2; sc becomes P
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qw + gr + 8 * (e >> 1);
        const int kj = kt0 + 8 * c + 2 * tq + (e & 1);
        const bool seen = !masked || (qi < Sq && kj < Skv &&
                                      visible(qi + q_offset, kj, causal,
                                              window));
        sc[4 * c + e] =
            seen ? expf(sc[4 * c + e] * scale - lse_r[e >> 1]) : 0.f;
      }
    }
    hopper::wgmma_wait<0>();  // dP
    hopper::fence_regs(dp);
    // dS of keys 16 j .. 16 j + 15 is the A fragment da[j]
    uint32_t da[4][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = sc[4 * c + e] * (dp[4 * c + e] - del_r[e >> 1]) * scale;
      da[c / 2][2 * (c % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::Wgmma<D>::template rs<1>(dq_acc, da[j], desc_mn(kst, j), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    __syncthreads();  // stage s is read: the next load may overwrite it
  }
  hopper::cp_async_wait<0>();
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = qw + gr + 8 * i;
      if (row >= Sq) continue;
      *reinterpret_cast<uint32_t*>(
          dq + (((size_t)b * Sq + row) * H + h) * D + 8 * c + 2 * tq) =
          hopper::pack_bf16(dq_acc[4 * c + 2 * i], dq_acc[4 * c + 2 * i + 1]);
    }
  }
}

}  // namespace wg

// dk (B, Skv, KV, D) = sum over g = 0 .. G - 1, in that order, of the fp32
// partials (B, Skv, H = KV G, D) of heads kvh G + g, cast to T; dv alike.
// Four elements a thread.
template <typename T>
__global__ void reduce_heads(const float* __restrict__ dk_part,
                             const float* __restrict__ dv_part,
                             T* __restrict__ dk, T* __restrict__ dv,
                             long long n4, int G, int D) {
  const int D4 = D / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long rk = i / D4;  // (b, key, kv head)
    const int d = (int)(i % D4) * 4;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* p = (which ? dv_part : dk_part) + rk * G * D + d;
      float4 acc = *reinterpret_cast<const float4*>(p);
      for (int g = 1; g < G; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(p + (size_t)g * D);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      T* y = (which ? dv : dk) + rk * D + d;
      y[0] = from_f<T>(acc.x);
      y[1] = from_f<T>(acc.y);
      y[2] = from_f<T>(acc.z);
      y[3] = from_f<T>(acc.w);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_reduce(const float* dk_part, const float* dv_part, void* dk,
                  void* dv, int B, int Skv, int KV, int G, int D,
                  cudaStream_t stream) {
  const long long n4 = (long long)B * Skv * KV * D / 4;
  const long long blocks = (n4 + 255) / 256;
  reduce_heads<T><<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                    stream>>>(dk_part, dv_part, static_cast<T*>(dk),
                              static_cast<T*>(dv), n4, G, D);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const float* lse, const void* dout, void* dq, void* dk,
                 void* dv, float* delta, float* dk_part, float* dv_part,
                 int B, int Sq, int Skv, int H, int KV, float scale,
                 int causal, int window, int q_offset, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  // two resident tiles, two stages of two streamed tiles, two stages of
  // lse and delta, and the slack to align the atoms to 1024 bytes
  const int smem = 6 * wg::Tile<D>::BYTES + 4 * wg::ROWS * 4 + 1024;
  auto k_dq = wg::flash_bwd_dq_wgmma<D>;
  auto k_kv = wg::flash_bwd_dkdv_wgmma<D>;
  cudaError_t err = set_smem(k_dq, smem);
  if (err == cudaSuccess) err = set_smem(k_kv, smem);
  if (err != cudaSuccess) return (int)err;
  const long long g_dq = (long long)B * H * ((Sq + wg::ROWS - 1) / wg::ROWS);
  const long long g_kv = (long long)B * H * ((Skv + wg::ROWS - 1) / wg::ROWS);
  if (g_dq > 2147483647LL || g_kv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  k_dq<<<(unsigned)g_dq, 128, smem, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(o), lse, tdo,
      static_cast<bf16*>(dq), delta, B, Sq, Skv, H, KV, scale, causal,
      window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_kv<<<(unsigned)g_kv, 128, smem, stream>>>(
      tq, tk, tv, lse, delta, tdo, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dk_part, dv_part, B, Sq, Skv, H, KV, scale,
      causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == KV) return (int)err;
  return launch_reduce<bf16>(dk_part, dv_part, dk, dv, B, Skv, KV, H / KV, D,
                             stream);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, float* dk_part, float* dv_part, int B,
               int Sq, int Skv, int H, int KV, float scale, int causal,
               int window, int q_offset, cudaStream_t stream,
               float* dq_part) {
  const int smem = (int)sizeof(float) * Layout<D>::FLOATS;
  auto kern = flash_bwd_f32<D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (Skv + BT - 1) / BT;
  const long long rows = (long long)B * Sq * H;
  const long long grid = (long long)B * H * n_kt;
  if (grid > 2147483647LL || (rows + 7) / 8 > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* tdo = static_cast<const float*>(dout);
  bwd_delta<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), tdo, delta, rows, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lse, delta, tdo, static_cast<float*>(dk),
      static_cast<float*>(dv), dk_part, dv_part, dq_part, Sq, Skv, H, KV,
      scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = rows * D / 4, blocks = (n4 + 255) / 256;
  sum_key_tiles<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                  stream>>>(dq_part, static_cast<float*>(dq), n4, Sq, H * D,
                            n_kt, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == KV) return (int)err;
  return launch_reduce<float>(dk_part, dv_part, dk, dv, B, Skv, KV, H / KV, D,
                              stream);
}

}  // namespace

// is_bf16 picks the element type (bf16 or f32, all tensors alike but lse
// and delta, f32); D is 64, 80 or 128. delta (B, H, Sq) f32 is scratch the
// first kernel writes and the others read; dk_part and dv_part
// (B, Skv, H, D) f32 are scratch for H > KV (null otherwise); dq_part
// (B, ceil(Skv / 64), Sq, H, D) f32 is the f32 path's scratch for the key
// tiles' shares of dQ (null for bf16). Returns a cudaError_t.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* out, const float* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, float* delta, float* dk_part,
                                float* dv_part, float* dq_part, int B, int Sq,
                                int Skv, int H, int KV, int D, int is_bf16,
                                float scale, int causal, int window,
                                int q_offset, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (H > KV && (dk_part == nullptr || dv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16 && dq_part == nullptr) return (int)cudaErrorInvalidValue;
#define BWD_ARGS q, k, v, out, lse, dout, dq, dk, dv, delta, dk_part, \
                 dv_part, B, Sq, Skv, H, KV, scale, causal, window, q_offset, \
                 stream
  if (is_bf16) {
    switch (D) {
      case 64: return launch_wgmma<64>(BWD_ARGS);
      case 80: return launch_wgmma<80>(BWD_ARGS);
      case 128: return launch_wgmma<128>(BWD_ARGS);
    }
  } else {
    switch (D) {
      case 64: return launch_f32<64>(BWD_ARGS, dq_part);
      case 80: return launch_f32<80>(BWD_ARGS, dq_part);
      case 128: return launch_f32<128>(BWD_ARGS, dq_part);
    }
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
