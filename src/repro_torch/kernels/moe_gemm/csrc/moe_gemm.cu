// Grouped ("ragged") expert GEMM for Hopper: two kernels of one function.
//
// Replaces the TPU kernel repro/kernels/moe_gemm/kernel.py::_gemm_kernel
// (entry moe_gemm_pallas). The JAX package's MoE layer computes the same
// expert FFN as a dense capacity-buffer einsum; the port's MoE layer runs
// this kernel for gate, up and down.
//
// Function: xs (T_pad, d) rows sorted by expert, each expert's group padded
// to a multiple of bt rows (ops.plan); block_expert (T_pad / bt,) int32
// names the expert of each bt-row block; used (1,) int32 on the device is
// the row count of the real groups. ys[r] = xs[r] @ w[block_expert[r / bt]]
// for r < used, products accumulated in fp32 and written in xs's dtype;
// rows from used on are not written. Ragged d and F are handled in place
// (the TPU kernel asserts F % block_f == 0; 768 and 1408 fail it). In both
// kernels a block reads its expert id and the used count from device
// memory, so blocks past the last real group exit and the host never syncs.
// kernel.py::kernel_for picks the kernel from (dtype, bt, d, F) alone.
//
// moe_gemm_wgmma (bf16, bt 64 or 128, d % 8 == 0, F % 8 == 0: the prefill).
// What bounds it: 2 * T * d * F operations on bf16 tensor cores, 989
// TFLOP/s (T = 131,072 assignments, d = 2048, F = 768). Design: one block
// per (bt token rows, 256 output columns), three warpgroups. Warpgroup 0's
// first thread loads, by TMA, each 64-deep slice of the xs tile (a 2-D map
// over (d, T_pad)) and of w[e] (a 3-D map over (F, d, E), four 64-column
// boxes) into a ring of 4 (bt 128) or 5 (bt 64) stages guarded by
// mbarriers; TMA zero-fills past d and F. It gives its registers to the
// consumers (setmaxnreg). Warpgroups 1 and 2 run wgmma m64nNk16 from shared
// memory, w read MN-major through the descriptor's transpose bit: at bt 128
// each owns 64 rows x 256 columns, at bt 64 each 64 rows x 128 columns of
// the one 64-row tile. A consumer keeps one wgmma group in flight and
// releases a stage as soon as the group reading it has completed. Columns
// past F are masked at the store.
//
// moe_gemm_kernel (the decode regime: bt 16, T = 128; also f32 and shapes
// that break TMA's 16-byte strides). What bounds it at decode: the expert
// weights' read, E_used * d * F * 2 bytes / 3.35e12. Design: one block per
// (64 or 16 token rows, 128 output columns), 4 warps. The d dimension is
// walked in 64-deep stages: x and w tiles are loaded 16 bytes a thread into
// registers for the next stage while the current one runs from shared
// memory (rows padded by 8 halves so the fragment reads are conflict-free),
// and bf16 products run on mma.sync.m16n8k16 with fp32 accumulators (f32
// inputs take fp32 FMAs on the same fragment layout).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../hopper.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int BN = 128;       // output columns per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BK = 64, PAD = 8; };
template <> struct Cfg<float> { static constexpr int BK = 32, PAD = 4; };

// 16 bytes of T (8 bf16 or 4 f32) of a row at column c, zero where
// c + i >= ncols; one vector load when the chunk is whole and aligned.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ base, int c,
                                            int ncols, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  if (aligned && c + V <= ncols)
    return __ldg(reinterpret_cast<const uint4*>(base + c));
  uint4 r = make_uint4(0, 0, 0, 0);
  T* t = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c + i < ncols) t[i] = base[c + i];
  return r;
}

using hopper::mma_bf16;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// One 16-deep step of a 16x8 output fragment: C[g][2t..2t+1], C[g+8][..]
// += A[16 rows][kk..kk+16] @ B[kk..kk+16][8 cols], in the layout of
// mma.m16n8k16 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void frag_step(float c[4], const __nv_bfloat16* xa,
                                          int lda, const __nv_bfloat16* wb,
                                          int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  a[0] = *reinterpret_cast<const uint32_t*>(xa + g * lda + 2 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * lda + 2 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(xa + g * lda + 2 * t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * lda + 2 * t + 8);
  b[0] = pack2(wb[(2 * t) * ldb + g], wb[(2 * t + 1) * ldb + g]);
  b[1] = pack2(wb[(2 * t + 8) * ldb + g], wb[(2 * t + 9) * ldb + g]);
  mma_bf16(c, a, b);
}

__device__ __forceinline__ void frag_step(float c[4], const float* xa, int lda,
                                          const float* wb, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float a0 = xa[g * lda + kk], a1 = xa[(g + 8) * lda + kk];
    const float b0 = wb[kk * ldb + 2 * t], b1 = wb[kk * ldb + 2 * t + 1];
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const T* __restrict__ xs, const int* __restrict__ block_expert,
                const T* __restrict__ w, const int* __restrict__ used,
                T* __restrict__ ys, int d, int F, int bt) {
  constexpr int BK = Cfg<T>::BK, PAD = Cfg<T>::PAD;
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int WM_WARPS = BM >= 64 ? 2 : 1;  // warps along rows
  constexpr int WN_WARPS = 4 / WM_WARPS;      // warps along columns
  constexpr int WM = BM / WM_WARPS, WN = BN / WN_WARPS;
  constexpr int MF = WM / 16, NF = WN / 8;    // fragments per warp
  constexpr int LDA = BK + PAD, LDB = BN + PAD;
  constexpr int XCH = BM * BK / V / THREADS;  // x chunks per thread
  constexpr int WCH = BK * BN / V / THREADS;  // w chunks per thread
  static_assert(XCH >= 1 && WCH >= 1, "tile too small for the block");
  __shared__ __align__(16) T xsh[BM * LDA];
  __shared__ __align__(16) T wsh[BK * LDB];

  const int row0 = blockIdx.y * BM;
  if (row0 >= *used) return;  // past the last real group
  const int e = block_expert[row0 / bt];
  const int n0 = blockIdx.x * BN;
  const T* wexp = w + (size_t)e * d * F;
  const bool x_al = (d % V) == 0, w_al = (F % V) == 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN_WARPS, wn = warp % WN_WARPS;

  uint4 xr[XCH], wr[WCH];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BK / V),
                c = (ch % (BK / V)) * V;
      xr[i] = load_chunk(xs + (size_t)(row0 + r) * d, k0 + c, d, x_al);
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BN / V),
                c = (ch % (BN / V)) * V;
      if (k0 + r < d)
        wr[i] = load_chunk(wexp + (size_t)(k0 + r) * F, n0 + c, F, w_al);
      else
        wr[i] = make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BK / V),
                c = (ch % (BK / V)) * V;
      *reinterpret_cast<uint4*>(xsh + r * LDA + c) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BN / V),
                c = (ch % (BN / V)) * V;
      *reinterpret_cast<uint4*>(wsh + r * LDB + c) = wr[i];
    }
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < d) fetch(k0 + BK);  // next stage in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
          frag_step(acc[i][j], xsh + (wm * WM + i * 16) * LDA + kk, LDA,
                    wsh + kk * LDB + wn * WN + j * 8, LDB, lane);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + wm * WM + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn * WN + j * 8 + 2 * t + (r & 1);
        if (col < F) ys[(size_t)row * F + col] = from_f<T>(acc[i][j][r]);
      }
}

template <typename T, int BM>
int launch(const void* xs, const int* block_expert, const void* w,
           const int* used, void* ys, int T_pad, int d, int F, int bt,
           cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, T_pad / BM);
  moe_gemm_kernel<T, BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(xs), block_expert, static_cast<const T*>(w), used,
      static_cast<T*>(ys), d, F, bt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bm(const void* xs, const int* block_expert, const void* w,
              const int* used, void* ys, int T_pad, int d, int F, int bt,
              cudaStream_t stream) {
  if (bt % 64 == 0)
    return launch<T, 64>(xs, block_expert, w, used, ys, T_pad, d, F, bt, stream);
  return launch<T, 16>(xs, block_expert, w, used, ys, T_pad, d, F, bt, stream);
}


// ------------------------------------------------------- bf16, wgmma + TMA

namespace gm {
constexpr int BN = 256, BK = 64;
constexpr int THREADS = 384;          // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int B_ATOM = BK * 128;      // [64 rows of d][64 columns of F]
constexpr int B_BYTES = (BN / 64) * B_ATOM;
template <int BM> struct Cfg {
  static constexpr int STAGES = BM == 128 ? 4 : 5;
  static constexpr int A_BYTES = BM * 128;  // [BM rows][64 of d]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + align
  static constexpr int WN = BM == 128 ? 256 : 128;  // columns a consumer owns
};
}  // namespace gm

template <int BM>
__global__ void __launch_bounds__(gm::THREADS, 1)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const int* __restrict__ block_expert,
               const int* __restrict__ used, __nv_bfloat16* __restrict__ ys,
               int d, int F, int bt) {
  using namespace hopper;
  using C = gm::Cfg<BM>;
  constexpr int STAGES = C::STAGES, WN = C::WN;
  const int row0 = blockIdx.y * BM;
  if (row0 >= *used) return;  // past the last real group
  const int e = block_expert[row0 / bt];
  const int n0 = blockIdx.x * gm::BN;
  const int nk = (d + gm::BK - 1) / gm::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], gm::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // w boxes that start inside F (a box past F would only read zeros)
      const int n_atoms = min(gm::BN / 64, (F - n0 + 63) / 64);
      const uint32_t bytes = C::A_BYTES + n_atoms * gm::B_ATOM;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* st = sm + s * C::STAGE;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(st, &map_x, &full[s], kt * gm::BK, row0);
        for (int a = 0; a < n_atoms; ++a)
          tma_load_3d(st + C::A_BYTES + a * gm::B_ATOM, &map_w, &full[s],
                      n0 + 64 * a, kt * gm::BK, e);
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int wm = BM == 128 ? cw : 0, wn = BM == 128 ? 0 : cw;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      const uint8_t* st = sm + s * C::STAGE;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < gm::BK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + wm * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(
            st + C::A_BYTES + (wn * WN / 64) * gm::B_ATOM + kk * 2048, gm::B_ATOM,
            1024);
        Wgmma<WN>::template ss<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's group is done: free its stage
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row = row0 + wm * 64 + warp * 16 + g;
    __nv_bfloat16* y0 = ys + (size_t)row * F;
    __nv_bfloat16* y1 = y0 + (size_t)8 * F;
#pragma unroll
    for (int c = 0; c < WN / 8; ++c) {
      const int col = n0 + wn * WN + 8 * c + 2 * t;
      if (col < F) {
        *reinterpret_cast<uint32_t*>(y0 + col) = pack_bf16(acc[4 * c], acc[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(y1 + col) = pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
      }
    }
  }
}

template <int BM>
int launch_wgmma(const void* xs, const int* block_expert, const void* w,
                 const int* used, void* ys, int T_pad, int d, int F, int E,
                 cudaStream_t stream) {
  CUtensorMap mx, mw;
  const uint64_t dx[2] = {(uint64_t)d, (uint64_t)T_pad};
  const uint64_t sx[1] = {(uint64_t)d * 2};
  const uint32_t bx[2] = {64, BM};
  const uint64_t dw[3] = {(uint64_t)F, (uint64_t)d, (uint64_t)E};
  const uint64_t sw[2] = {(uint64_t)F * 2, (uint64_t)d * F * 2};
  const uint32_t bw[3] = {64, gm::BK, 1};
  int err = hopper::encode_bf16_map(&mx, xs, 2, dx, sx, bx);
  if (!err) err = hopper::encode_bf16_map(&mw, w, 3, dw, sw, bw);
  if (err) return err;
  const int smem = gm::Cfg<BM>::BYTES;
  auto kern = moe_gemm_wgmma<BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((F + gm::BN - 1) / gm::BN, T_pad / BM);
  kern<<<grid, gm::THREADS, smem, stream>>>(
      mx, mw, block_expert, used, static_cast<__nv_bfloat16*>(ys), d, F, BM);
  return (int)cudaGetLastError();
}

}  // namespace

// bt: rows per expert block, a multiple of 16 dividing T_pad. Returns a
// cudaError_t.
extern "C" int moe_gemm_launch(const void* xs, const int* block_expert,
                               const void* w, const int* used, void* ys,
                               int T_pad, int d, int F, int bt, int is_bf16,
                               cudaStream_t stream) {
  if (T_pad < 1 || d < 1 || F < 1 || bt < 16 || bt % 16 || T_pad % bt ||
      T_pad / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bm<__nv_bfloat16>(xs, block_expert, w, used, ys, T_pad, d,
                                    F, bt, stream);
  return launch_bm<float>(xs, block_expert, w, used, ys, T_pad, d, F, bt,
                          stream);
}

// bf16 only; bt 64 or 128 rows per expert block dividing T_pad; d and F
// multiples of 8 (TMA's 16-byte strides); E experts in w. Returns a
// cudaError_t.
extern "C" int moe_gemm_wgmma_launch(const void* xs, const int* block_expert,
                                     const void* w, const int* used, void* ys,
                                     int T_pad, int d, int F, int E, int bt,
                                     cudaStream_t stream) {
  if (T_pad < 1 || d < 8 || F < 8 || E < 1 || d % 8 || F % 8 ||
      (bt != 64 && bt != 128) || T_pad % bt || T_pad / bt > 65535)
    return (int)cudaErrorInvalidValue;
  if (bt == 128)
    return launch_wgmma<128>(xs, block_expert, w, used, ys, T_pad, d, F, E,
                             stream);
  return launch_wgmma<64>(xs, block_expert, w, used, ys, T_pad, d, F, E,
                          stream);
}
