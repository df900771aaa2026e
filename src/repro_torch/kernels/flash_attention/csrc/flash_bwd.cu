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
// turns noise in near-zero gradients into different updates). Two kernels
// one after the other on the stream, each recomputing S and P from lse (7
// products where the bound counts 5):
//   * dQ: one block per (64-row q tile, head, sequence). It computes delta
//     for its rows (a warp a row) and writes it out for the second kernel,
//     then walks the key tiles that can meet its rows and accumulates
//     dQ += dS K.
//   * dK/dV: one block per (64-key tile, query head, sequence); it walks
//     the q tiles that can meet its keys (the inverse of the forward's
//     kv_tile_range) and accumulates dV += P^T dO and dK += dS^T Q. Under
//     GQA (G = H / KV > 1) each block writes its head's fp32 share into
//     partials (B, Skv, H, D) and reduce_heads sums the G shares of a kv
//     head in head order (g = 0 .. G - 1), then casts: the grid is G times
//     the kv heads', and the sum still has one fixed order.
// The bf16 kernels (namespace wg) are described there. The f32 kernels:
// 256 threads (a 16 x 16 grid); every product is the forward f32 kernel's
// register-blocked tile: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and
// columns tx + 16 j of a 64 x 64 score tile (LDS.128 fragments along D),
// and 4 rows x D / 16 columns of a D-wide accumulator (a float4 at
// 4 tx + 64 c and, at D = 80, one column at 64 + tx); P and dS pass through
// shared memory. A warp whose 8 rows lie past the sequence only loads and
// syncs, and column groups of 16 past the tile's live rows are skipped, so
// at S = 257 the work tracks 257^2. expf is the accurate one in both.
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
// tile, zeros past S.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x,
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

// Row r of a 4 ty + r accumulator into y (B, S, NH, D) at (b, h).
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ y,
                                           const float (&acc)[RM][Layout<D>::DT],
                                           int b, int row0, int S, int NH,
                                           int h, int ty, int tx) {
  using L = Layout<D>;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + RM * ty + r;
    if (row >= S) continue;
    float* yr = y + (((size_t)b * S + row) * NH + h) * D;
#pragma unroll
    for (int c = 0; c < L::NV4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        yr[4 * tx + 64 * c + e] = acc[r][4 * c + e];
#pragma unroll
    for (int c = 0; c < L::NS; ++c)
      yr[64 * L::NV4 + tx + 16 * c] = acc[r][4 * L::NV4 + c];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ lse, const float* __restrict__ dout,
             float* __restrict__ dq, float* __restrict__ delta, int Sq, int Skv,
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
  load_tile<D>(qs, q, b, q0, Sq, H, h);
  load_tile<D>(dos, dout, b, q0, Sq, H, h);
  __syncthreads();
  // delta = rowsum(dO * O) in fp32, a warp a row
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Sq) {
      const float* orow = o + (((size_t)b * Sq + row) * H + h) * D;
      for (int d = lane; d < D; d += 32) acc += dos[r * L::QS + d] * orow[d];
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
    load_tile<D>(ks, k, b, k0, Skv, KV, kvh);
    load_tile<D>(vs, v, b, k0, Skv, KV, kvh);
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
              p * (dp[r][j] - del_s[rr]) * scale;
        }
      }
    }
    __syncthreads();
    if (active) tile_acc<D>(ps, ks, ty, tx, (n_live + 3) & ~3, acc);
  }
  if (active) store_rows<D>(dq, acc, b, q0, Sq, H, h, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const float* __restrict__ dout,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dk_part, float* __restrict__ dv_part,
               int Sq, int Skv, int H, int KV, float scale, int causal,
               int window, int q_offset) {
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
  const int kt = blockIdx.x % n_kt, bh = blockIdx.x / n_kt;
  const int h = bh % H, b = bh / H, G = H / KV, kvh = h / G;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = kt * BT;
  load_tile<D>(ks, k, b, k0, Skv, KV, kvh);
  load_tile<D>(vs, v, b, k0, Skv, KV, kvh);
  // this warp's 8 keys; keys past Skv only help
  const bool active = k0 + 8 * (tid / 32) < Skv;
  float dk_acc[RM][L::DT], dv_acc[RM][L::DT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < L::DT; ++i) dk_acc[r][i] = dv_acc[r][i] = 0.f;

  const int n_qt = (Sq + BT - 1) / BT;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BT;
    if (!tiles_meet(q0, BT, k0, BT, Sq, causal, window, q_offset)) continue;
    __syncthreads();  // the last q tile's readers are done
    load_tile<D>(qs, q, b, q0, Sq, H, h);
    load_tile<D>(dos, dout, b, q0, Sq, H, h);
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
          ds[r][j] = p * (ds[r][j] - del_s[c]) * scale;
          ps[rr * PS + c] = p;
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
  if (active && G == 1) {
    store_rows<D>(dk, dk_acc, b, k0, Skv, KV, kvh, ty, tx);
    store_rows<D>(dv, dv_acc, b, k0, Skv, KV, kvh, ty, tx);
  } else if (active) {  // this head's fp32 share, summed by reduce_heads
    store_rows<D>(dk_part, dk_acc, b, k0, Skv, H, h, ty, tx);
    store_rows<D>(dv_part, dv_acc, b, k0, Skv, H, h, ty, tx);
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
               int window, int q_offset, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * Layout<D>::FLOATS;
  auto k_dq = flash_bwd_dq<D>;
  auto k_kv = flash_bwd_dkdv<D>;
  cudaError_t err = set_smem(k_dq, smem);
  if (err == cudaSuccess) err = set_smem(k_kv, smem);
  if (err != cudaSuccess) return (int)err;
  const long long g_dq = (long long)B * H * ((Sq + BT - 1) / BT);
  const long long g_kv = (long long)B * H * ((Skv + BT - 1) / BT);
  if (g_dq > 2147483647LL || g_kv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  k_dq<<<(unsigned)g_dq, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), lse, tdo,
      static_cast<float*>(dq), delta, Sq, Skv, H, KV, scale, causal, window,
      q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_kv<<<(unsigned)g_kv, THREADS, smem, stream>>>(
      tq, tk, tv, lse, delta, tdo, static_cast<float*>(dk),
      static_cast<float*>(dv), dk_part, dv_part, Sq, Skv, H, KV, scale,
      causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == KV) return (int)err;
  return launch_reduce<float>(dk_part, dv_part, dk, dv, B, Skv, KV, H / KV, D,
                              stream);
}

}  // namespace

// is_bf16 picks the element type (bf16 or f32, all tensors alike but lse
// and delta, f32); D is 64, 80 or 128. delta (B, H, Sq) f32 is scratch the
// dQ kernel writes and the dK/dV kernel reads; dk_part and dv_part
// (B, Skv, H, D) f32 are scratch for H > KV (null otherwise). Returns a
// cudaError_t.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* out, const float* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, float* delta, float* dk_part,
                                float* dv_part, int B, int Sq, int Skv, int H,
                                int KV, int D, int is_bf16, float scale,
                                int causal, int window, int q_offset,
                                cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (H > KV && (dk_part == nullptr || dv_part == nullptr))
    return (int)cudaErrorInvalidValue;
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
      case 64: return launch_f32<64>(BWD_ARGS);
      case 80: return launch_f32<80>(BWD_ARGS);
      case 128: return launch_f32<128>(BWD_ARGS);
    }
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
