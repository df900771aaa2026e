// Flash-attention forward (online softmax) for Hopper: bf16 on wgmma tensor
// cores fed by TMA, f32 on FMAs.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// ::_fwd_kernel (entry flash_fwd_pallas, via ops.flash_attention).
//
// Function: q (B, Sq, H, D), k/v (B, Skv, KV, D) in the wrapper's layout
// (no transposes), GQA head h reads kv head h / (H / KV). Masks as the TPU
// kernel: keys past Skv, causal (k <= q + q_offset), sliding window
// (k > q + q_offset - window). Masked scores are -1e30 and keys past Skv
// weigh exactly 0, so a row with at least one visible key gets exactly the
// reference softmax and a row that sees no key the reference's uniform
// softmax over the Skv keys. Writes out (B, Sq, H, D) in the input dtype
// and lse (B, H, Sq) f32.
//
// Key tiles: a q tile visits only kv_tile_range's tiles, those where the
// reference's _kv_block_live (repro/kernels/flash_attention/ops.py) holds,
// and applies the element mask only on tiles that a mask boundary crosses.
// A q tile holding a row that sees no key walks every tile instead, so
// that row keeps the reference's uniform result. The Python mirror of this
// arithmetic is kernels/flash_attention/kernel.py::kv_tile_range, tested
// against _kv_block_live.
//
// bf16 (the LM prefill: D = 128, GQA 6:1 and 8:1, causal; the text tower:
// D = 64, S = 78): 4 * B * H * Sq * Skv * D operations (half of it
// causal) on ~4 * B * S * H * D * 2 bytes, far above the tensor cores'
// ridge, so the 989 TFLOP/s of bf16 wgmma bound it. Design: one block per
// (b, h, 128-row q tile), three warpgroups. Warpgroup 0 is the producer:
// one thread loads the q tile and then each key tile's K and V by TMA
// (4-D tensor maps over (D, heads, S, B), so a tile past Sq or Skv reads
// zeros and never the next sequence) into a 2-stage ring guarded by
// mbarriers, K and V with barriers of their own so K runs a tile ahead,
// and gives its registers to the consumers (setmaxnreg). Warpgroups 1 and
// 2 each own 64 query rows: S = Q K^T on wgmma m64n128k16 from shared
// memory (K rows are D-contiguous, the K-major B), the online softmax in
// fp32 registers on the accumulator's own layout (a row lives in one quad
// of lanes), then P is rounded to bf16 in registers and fed as wgmma's A
// for O += P V, V read MN-major through the descriptor's transpose bit.
// S of tile i is issued beside P V of tile i - 1, so the tile's softmax
// runs while the tensor cores finish P V. A tile no mask boundary crosses
// computes p with one FMA a score. q tiles launch heaviest first (causal).
// D = 80 uses two 64-column atoms, the second zero-filled past column 80 by
// TMA.
//
// f32 (the vision tower and refinement: D = 80, S = 257, not causal):
// 4 * B * H * Sq * Skv * D operations on 67 TFLOP/s of fp32 FMAs (no TF32:
// the parity rule). Design: an online-softmax flash forward built from two
// register-blocked SIMT products. One block of 256 threads (a 16 x 16
// grid) per (b, h, 64-row q tile); 64-key K/V tiles arrive by cp.async
// (16-byte copies, zero past Skv) into a double buffer, so the next tile's
// copy runs under this tile's math. S = Q K^T: thread (ty, tx) scores rows
// 4 ty .. 4 ty + 3 against keys tx + 16 j from LDS.128 fragments along D;
// a row's 64 scores lie on 16 lanes of one warp, so its max and sum are
// shuffles. P goes to shared memory over the K stage S has just read, then
// O += P V on the same rows, each thread owning D / 16 output columns (a
// float4 at 4 tx + 64 c, and at D = 80 one more column at 64 + tx: no idle
// lane). A warp whose 8 rows all lie past Sq skips the math, and key groups
// of 16 past Skv are skipped, so at S = 257 the work tracks 257^2 rather
// than 320^2. expf is the accurate one.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "../../hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float L2E = 1.4426950408889634f;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Does a real row of the q tile [q0, q0 + bq) see no key at all?
__host__ __device__ __forceinline__ bool keyless_row(int q0, int bq, int Sq,
                                                     int Skv, int causal,
                                                     int window, int q_offset) {
  const int first = q0 + q_offset;
  const int last = imin(q0 + bq, Sq) - 1 + q_offset;
  return (causal && first < 0) || (window > 0 && last - window >= Skv - 1);
}

// [lo, hi): the bk-key tiles the q tile [q0, q0 + bq) visits.
__host__ __device__ __forceinline__ void kv_tile_range(
    int q0, int bq, int bk, int Sq, int Skv, int causal, int window,
    int q_offset, int& lo, int& hi) {
  const int nkt = (Skv + bk - 1) / bk;
  lo = 0;
  hi = nkt;
  if (keyless_row(q0, bq, Sq, Skv, causal, window, q_offset)) return;
  if (causal) hi = imin(nkt, (q0 + bq - 1 + q_offset) / bk + 1);
  if (window > 0) {
    const int x = q0 + q_offset - window + 1;
    if (x > 0) lo = x / bk;
  }
}

// Does any score of query positions [p_lo, p_hi] x keys [kj0, kj0 + bk)
// need a mask?
__device__ __forceinline__ bool tile_needs_mask(int kj0, int bk, int p_lo,
                                                int p_hi, int Skv, int causal,
                                                int window) {
  return kj0 + bk > Skv || (causal && kj0 + bk - 1 > p_lo) ||
         (window > 0 && kj0 <= p_hi - window);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- bf16, wgmma

namespace fa {
constexpr int BQ = 128, BK = 128, STAGES = 2;
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int ATOM_Q = BQ * 128;        // bytes of one 64-column atom
constexpr int ATOM_K = BK * 128;

// q and k tiles DQK columns wide, v tiles DV (DQK = DV but for MLA)
template <int DQK, int DV> struct Smem {
  static constexpr int NA = (DQK + 63) / 64;  // 64-column atoms across DQK
  static constexpr int NV = (DV + 63) / 64;   // and across DV
  static constexpr int Q = 0;
  static constexpr int K = Q + NA * ATOM_Q;
  static constexpr int V = K + STAGES * NA * ATOM_K;
  static constexpr int BAR = V + STAGES * NV * ATOM_K;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + align
};

// S = Q K^T for the warpgroup's 64 rows and one 128-key tile (issued, not
// waited for).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         const uint8_t* qa,
                                         const uint8_t* kt) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_sw128(qa + (kk / 4) * ATOM_Q + (kk % 4) * 32,
                                   16, 1024);
    const uint64_t db = desc_sw128(kt + (kk / 4) * ATOM_K + (kk % 4) * 32,
                                   16, 1024);
    Wgmma<BK>::template ss<0>(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V for one tile, P (bf16) from registers (issued, not waited for).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const uint8_t* vt) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<D>::template rs<1>(o, pa[kk], desc_sw128(vt + kk * 2048, ATOM_K,
                                                   1024), 1);
  wgmma_commit();
}

// The online softmax of one tile of raw scores, on the accumulator's
// layout (this lane: rows r0 and r0 + 8, columns 8c + 2t + {0, 1}): sc
// becomes the tile's fp32 p; m, l (this lane's part of the row sum) move
// on; a is each row's rescale factor for O. A tile no mask boundary
// crosses takes one FMA a score into ex2.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], bool masked, int kj0, int qp0, int qp1, int t,
    int Skv, int causal, int window, float scale, float& m0, float& m1,
    float& l0, float& l1, float& a0, float& a1) {
  float mn0, mn1;
  if (masked || !(scale > 0.f)) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * c + e] * scale;
        if (masked) {
          const int kj = kj0 + 8 * c + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kj >= Skv) x = -INFINITY;  // not a key: weight exactly 0
          else if ((causal && kj > qp) || (window > 0 && kj <= qp - window))
            x = NEG;
        }
        sc[4 * c + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    mn0 = fmaxf(m0, mx0);
    mn1 = fmaxf(m1, mx1);
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      sc[4 * c] = ex2((sc[4 * c] - mn0) * L2E);
      sc[4 * c + 1] = ex2((sc[4 * c + 1] - mn0) * L2E);
      sc[4 * c + 2] = ex2((sc[4 * c + 2] - mn1) * L2E);
      sc[4 * c + 3] = ex2((sc[4 * c + 3] - mn1) * L2E);
    }
  } else {  // every score is a key's: the max of raw scores, scale > 0
    float mx0 = sc[0], mx1 = sc[2];
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    mn0 = fmaxf(m0, mx0 * scale);
    mn1 = fmaxf(m1, mx1 * scale);
    const float sl2 = scale * L2E, b0 = -mn0 * L2E, b1 = -mn1 * L2E;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      sc[4 * c] = ex2(fmaf(sc[4 * c], sl2, b0));
      sc[4 * c + 1] = ex2(fmaf(sc[4 * c + 1], sl2, b0));
      sc[4 * c + 2] = ex2(fmaf(sc[4 * c + 2], sl2, b1));
      sc[4 * c + 3] = ex2(fmaf(sc[4 * c + 3], sl2, b1));
    }
  }
  a0 = ex2((m0 - mn0) * L2E);
  a1 = ex2((m1 - mn1) * L2E);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    ps0 += sc[4 * c] + sc[4 * c + 1];
    ps1 += sc[4 * c + 2] + sc[4 * c + 3];
  }
  l0 = l0 * a0 + ps0;
  l1 = l1 * a1 + ps1;
}

// p (fp32, accumulator layout) -> the bf16 A fragments of P V's k16 steps.
__device__ __forceinline__ void p_to_bf16(const float (&sc)[BK / 2],
                                          uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
    pa[c / 2][(c % 2) * 2] = hopper::pack_bf16(sc[4 * c], sc[4 * c + 1]);
    pa[c / 2][(c % 2) * 2 + 1] = hopper::pack_bf16(sc[4 * c + 2],
                                                   sc[4 * c + 3]);
  }
}
}  // namespace fa

// The bf16 kernels' body: q and k DQK wide, v and out DV wide.
template <int DQK, int DV>
__device__ __forceinline__ void fwd_wgmma_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Skv, int H, int KV, float scale,
    int causal, int window, int q_offset) {
  using namespace fa;
  using namespace hopper;
  using L = Smem<DQK, DV>;
  constexpr int NA = L::NA, NV = L::NV, D = DV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full_k = bar_q + 1;         // [STAGES] K tile landed
  uint64_t* full_v = full_k + STAGES;   // [STAGES] V tile landed
  uint64_t* empty_k = full_v + STAGES;  // [STAGES] consumers done with K
  uint64_t* empty_v = empty_k + STAGES; // [STAGES] consumers done with V

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest (causal) first
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  int lo, hi;
  kv_tile_range(q0, BQ, BK, Sq, Skv, causal, window, q_offset, lo, hi);
  const int n = hi - lo;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMERS);
      mbar_init(&empty_v[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, NA * ATOM_Q);
      for (int a = 0; a < NA; ++a)
        tma_load_4d(sm + L::Q + a * ATOM_Q, &map_q, bar_q, a * 64, h, q0, b);
      // K runs a tile ahead of V: a K stage frees when S is done with it,
      // a V stage only when P V is
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const uint32_t par = (i / STAGES - 1) & 1;
        const int kj0 = (lo + i) * BK;
        if (i >= STAGES) mbar_wait(&empty_k[s], par);
        mbar_expect_tx(&full_k[s], NA * ATOM_K);
        for (int a = 0; a < NA; ++a)
          tma_load_4d(sm + L::K + (s * NA + a) * ATOM_K, &map_k, &full_k[s],
                      a * 64, kvh, kj0, b);
        if (i >= STAGES) mbar_wait(&empty_v[s], par);
        mbar_expect_tx(&full_v[s], NV * ATOM_K);
        for (int a = 0; a < NV; ++a)
          tma_load_4d(sm + L::V + (s * NV + a) * ATOM_K, &map_v, &full_v[s],
                      a * 64, kvh, kj0, b);
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;
    const int qp0 = row0 + q_offset, qp1 = row1 + q_offset;
    const int p_lo = q0 + cw * 64 + q_offset, p_hi = p_lo + 63;
    const uint8_t* qa = sm + L::Q + cw * 64 * 128;
    auto k_tile = [&](int s) { return sm + L::K + s * NA * ATOM_K; };
    auto v_tile = [&](int s) { return sm + L::V + s * NV * ATOM_K; };
    auto masked = [&](int i) {
      return tile_needs_mask((lo + i) * BK, BK, p_lo, p_hi, Skv, causal,
                             window);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this lane's part
    float a0, a1;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    mbar_wait(bar_q, 0);

    // tile 0: S, softmax, P
    mbar_wait(&full_k[0], 0);
    issue_qk<DQK>(sc, qa, k_tile(0));
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&empty_k[0]);
    softmax_tile(sc, masked(0), lo * BK, qp0, qp1, t, Skv, causal, window,
                 scale, m0, m1, l0, l1, a0, a1);
    p_to_bf16(sc, pa);
    // tile i: S_i runs beside O += P_{i-1} V_{i-1}; the softmax of S_i
    // runs while P V is still on the tensor cores
    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      mbar_wait(&full_k[s], (i / STAGES) & 1);
      issue_qk<DQK>(sc, qa, k_tile(s));
      mbar_wait(&full_v[sp], ((i - 1) / STAGES) & 1);
      issue_pv<D>(o, pa, v_tile(sp));
      wgmma_wait<1>();  // S_i is done (groups complete in order)
      fence_regs(sc);
      mbar_arrive(&empty_k[s]);
      softmax_tile(sc, masked(i), (lo + i) * BK, qp0, qp1, t, Skv, causal,
                   window, scale, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();  // P_{i-1} V_{i-1} is done
      fence_regs(o);
      mbar_arrive(&empty_v[sp]);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= a0;
        o[4 * c + 1] *= a0;
        o[4 * c + 2] *= a1;
        o[4 * c + 3] *= a1;
      }
      p_to_bf16(sc, pa);
    }
    const int sl = (n - 1) % STAGES;
    mbar_wait(&full_v[sl], ((n - 1) / STAGES) & 1);
    issue_pv<D>(o, pa, v_tile(sl));
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
    __nv_bfloat16* o0 = out + (((size_t)b * Sq + row0) * H + h) * D + 2 * t;
    __nv_bfloat16* o1 = o0 + (size_t)8 * H * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * c) =
            pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * c) =
            pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
    }
    if (t == 0) {
      float* lr = lse + ((size_t)b * H + h) * Sq;
      if (row0 < Sq) lr[row0] = m0 + logf(ls0);
      if (row1 < Sq) lr[row1] = m1 + logf(ls1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(fa::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Skv, int H, int KV, float scale, int causal,
                int window, int q_offset) {
  fwd_wgmma_body<D, D>(map_q, map_k, map_v, out, lse, Sq, Skv, H, KV, scale,
                       causal, window, q_offset);
}

// MLA (DeepSeek-V3's attention after the up-projection): q and k 192 wide
// (nope 128 + rope 64), v 128. The smem ring: q 48 KB, K 2 x 48 KB, V 2 x
// 32 KB, 209 KB in all; the registers those of D = 128 (S is 128 keys
// wide whatever DQK, O 128 columns).
template <int DQK, int DV>
__global__ void __launch_bounds__(fa::THREADS, 1)
flash_fwd_mla(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int Sq, int Skv, int H, int KV, float scale, int causal,
              int window, int q_offset) {
  fwd_wgmma_body<DQK, DV>(map_q, map_k, map_v, out, lse, Sq, Skv, H, KV,
                          scale, causal, window, q_offset);
}

template <int DQK, int DV, typename Kern>
int launch_bf16(Kern kern, const void* q, const void* k, const void* v,
                void* out, float* lse, int B, int Sq, int Skv, int H, int KV,
                float scale, int causal, int window, int q_offset,
                cudaStream_t stream) {
  using namespace fa;
  constexpr int D = DQK;
  CUtensorMap mq, mk, mv;
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t sq[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2,
                          (uint64_t)Sq * H * D * 2};
  const uint32_t bq[4] = {64, 1, BQ, 1};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)KV, (uint64_t)Skv,
                          (uint64_t)B};
  const uint64_t sk[3] = {(uint64_t)D * 2, (uint64_t)KV * D * 2,
                          (uint64_t)Skv * KV * D * 2};
  const uint32_t bk[4] = {64, 1, BK, 1};
  const uint64_t dv[4] = {(uint64_t)DV, (uint64_t)KV, (uint64_t)Skv,
                          (uint64_t)B};
  const uint64_t sv[3] = {(uint64_t)DV * 2, (uint64_t)KV * DV * 2,
                          (uint64_t)Skv * KV * DV * 2};
  int err = hopper::encode_bf16_map(&mq, q, 4, dq, sq, bq);
  if (!err) err = hopper::encode_bf16_map(&mk, k, 4, dk, sk, bk);
  if (!err) err = hopper::encode_bf16_map(&mv, v, 4, dv, sv, bk);
  if (err) return err;
  const int smem = Smem<DQK, DV>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (Sq + BQ - 1) / BQ;
  if ((long long)B * H > 2147483647LL || n_qt > 65535)
    return (int)cudaErrorInvalidValue;
  kern<<<dim3(B * H, n_qt), THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, KV,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- f32, FMAs

namespace f32 {
constexpr int THREADS = 256;         // a 16 x 16 thread grid
constexpr int BQ = 64, BK = 64;      // q rows and keys of a tile
constexpr int RM = 4;                // q rows per thread (4 ty .. 4 ty + 3)
constexpr int KJ = 4;                // keys per thread (tx + 16 j)
constexpr int PS = BK + 4;           // P row stride (conflict-free)

template <int D> struct Layout {
  static constexpr int QS = D + 4;           // Q and K row stride
  static constexpr int NV4 = D / 64;         // float4 output columns a thread
  static constexpr int NS = (D % 64) / 16;   // scalar output columns a thread
  static constexpr int Q = 0;                // BQ x QS
  static constexpr int K = Q + BQ * QS;      // 2 x (BK x QS), P over K's stage
  static constexpr int V = K + 2 * BK * QS;  // 2 x (BK x D)
  static constexpr int FLOATS = V + 2 * BK * D;
  static_assert(BQ * PS <= BK * QS, "P fits in a K stage");
  static_assert(16 * (4 * NV4 + NS) == D, "output columns tile D");
};
}  // namespace f32

template <int D>
__global__ void __launch_bounds__(f32::THREADS, D <= 80 ? 2 : 1)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int Sq, int Skv, int H, int KV,
              float scale, int causal, int window, int q_offset) {
  using namespace f32;
  using L = Layout<D>;
  constexpr int QS = L::QS, NV4 = L::NV4, NS = L::NS, DT = 4 * NV4 + NS;
  constexpr int D4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + L::Q;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * BQ;
  int lo, hi;
  kv_tile_range(q0, BQ, BK, Sq, Skv, causal, window, q_offset, lo, hi);
  const int n = hi - lo;
  // this warp's 8 rows (ty = 2w, 2w + 1); a warp whose rows all lie past Sq
  // only helps with the copies and the barriers
  const bool active = q0 + 8 * (tid / 32) < Sq;
  const int p_lo = q0 + RM * ty + q_offset, p_hi = p_lo + RM - 1;

  for (int c = tid; c < BQ * D4; c += THREADS) {
    const int r = c / D4, d = (c % D4) * 4, qi = q0 + r;
    const bool live = qi < Sq;
    const float* src = live ? q + (((size_t)b * Sq + qi) * H + h) * D + d : q;
    hopper::cp_async16(qs + r * QS + d, src, live ? 16 : 0);
  }
  auto load_kv = [&](int tile, int st) {
    float* ks = smem + L::K + st * BK * QS;
    float* vs = smem + L::V + st * BK * D;
    for (int c = tid; c < BK * D4; c += THREADS) {
      const int j = c / D4, d = (c % D4) * 4, kj = tile * BK + j;
      const bool live = kj < Skv;  // keys past Skv read as 0
      const size_t off = (((size_t)b * Skv + kj) * KV + kvh) * D + d;
      hopper::cp_async16(ks + j * QS + d, live ? k + off : k, live ? 16 : 0);
      hopper::cp_async16(vs + j * D + d, live ? v + off : v, live ? 16 : 0);
    }
  };
  load_kv(lo, 0);
  hopper::cp_async_commit();

  float m[RM], l[RM], o[RM][DT];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DT; ++i) o[r][i] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, t0 = (lo + it) * BK;
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile it landed; the other stage's readers are done
    if (it + 1 < n) load_kv(lo + it + 1, st ^ 1);
    hopper::cp_async_commit();
    float* ks = smem + L::K + st * BK * QS;
    const float* vs = smem + L::V + st * BK * D;
    const int n_live = imin(BK, Skv - t0);    // keys of this tile
    const int jmax = (n_live + 15) / 16;      // key groups that hold one

    float s[RM][KJ];
    if (active) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          a[r] = *reinterpret_cast<const float4*>(qs + (RM * ty + r) * QS + d);
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          if (j < jmax) {
            const float4 kb =
                *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * QS + d);
#pragma unroll
            for (int r = 0; r < RM; ++r)
              s[r][j] = fmaf(a[r].w, kb.w, fmaf(a[r].z, kb.z,
                        fmaf(a[r].y, kb.y, fmaf(a[r].x, kb.x, s[r][j]))));
          }
        }
      }
      // the online softmax: a row's 64 scores lie on the 16 lanes of one ty
      const bool masked = tile_needs_mask(t0, BK, p_lo, p_hi, Skv, causal,
                                          window);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int qp = p_lo + r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kj = t0 + tx + 16 * j;
          float x = s[r][j] * scale;
          if (j >= jmax || kj >= Skv) x = -INFINITY;  // not a key: weight 0
          else if (masked && ((causal && kj > qp) ||
                              (window > 0 && kj <= qp - window)))
            x = NEG;
          s[r][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int o_ = 8; o_; o_ >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[r][j] = expf(s[r][j] - m_new);
          ps += s[r][j];
        }
#pragma unroll
        for (int o_ = 8; o_; o_ >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o_);
        l[r] = l[r] * alpha + ps;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DT; ++i) o[r][i] *= alpha;
      }
    }
    __syncthreads();  // every read of this K stage is done: P goes there
    float* ps_ = ks;
    if (active) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          ps_[(RM * ty + r) * PS + tx + 16 * j] = s[r][j];
    }
    __syncthreads();
    if (active) {  // O += P V over the tile's keys, 4 at a time
      const int n4 = (n_live + 3) & ~3;
      for (int j = 0; j < n4; j += 4) {
        float4 p4[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          p4[r] = *reinterpret_cast<const float4*>(ps_ + (RM * ty + r) * PS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vr = vs + (j + jj) * D;
          float vv[DT];
#pragma unroll
          for (int c = 0; c < NV4; ++c) {
            const float4 x =
                *reinterpret_cast<const float4*>(vr + 4 * tx + 64 * c);
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
            for (int i = 0; i < DT; ++i) o[r][i] = fmaf(p, vv[i], o[r][i]);
          }
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int qi = q0 + RM * ty + r;
    if (qi >= Sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NV4; ++c)
      *reinterpret_cast<float4*>(orow + 4 * tx + 64 * c) =
          make_float4(o[r][4 * c] / l_safe, o[r][4 * c + 1] / l_safe,
                      o[r][4 * c + 2] / l_safe, o[r][4 * c + 3] / l_safe);
#pragma unroll
    for (int c = 0; c < NS; ++c)
      orow[64 * NV4 + tx + 16 * c] = o[r][4 * NV4 + c] / l_safe;
    if (tx == 0) lse[((size_t)b * H + h) * Sq + qi] = m[r] + logf(l_safe);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Skv, int H, int KV, float scale,
               int causal, int window, int q_offset, cudaStream_t stream) {
  using namespace f32;
  const size_t smem = sizeof(float) * Layout<D>::FLOATS;
  auto kern = flash_fwd_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv, H,
      KV, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16 picks the path: bf16 runs the wgmma kernel, f32 the FMA kernel.
// D is q's and k's head dim, Dv v's and out's: (D, D) for D 64, 80 or 128,
// or MLA's (192, 128) on the bf16 path alone (its own kernel,
// flash_fwd_mla). Returns a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* lse, int B, int Sq, int Skv,
                                int H, int KV, int D, int Dv, int is_bf16,
                                float scale, int causal, int window,
                                int q_offset, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV)
    return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, out, lse, B, Sq, Skv, H, KV, scale, causal, \
                   window, q_offset, stream
  if (is_bf16 && D == 192 && Dv == 128)
    return launch_bf16<192, 128>(flash_fwd_mla<192, 128>, FLASH_ARGS);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (D) {
      case 64: return launch_bf16<64, 64>(flash_fwd_wgmma<64>, FLASH_ARGS);
      case 80: return launch_bf16<80, 80>(flash_fwd_wgmma<80>, FLASH_ARGS);
      case 128:
        return launch_bf16<128, 128>(flash_fwd_wgmma<128>, FLASH_ARGS);
    }
  } else {
    switch (D) {
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 80: return launch_f32<80>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
