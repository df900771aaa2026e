// Grouped ("ragged") expert GEMM for Hopper: two kernels of one function,
// and a third that fuses the MoE layer's gate, up and SiLU·up.
//
// Replaces the TPU kernel repro/kernels/moe_gemm/kernel.py::_gemm_kernel
// (entry moe_gemm_pallas). The JAX package's MoE layer computes the same
// expert FFN as a dense capacity-buffer einsum; the port's MoE layer runs
// this kernel for gate, up and down, and, where no gradient is recorded,
// gate and up with SiLU·up in one launch (moe_gemm_wgmma_swiglu).
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
// moe_gemm_wgmma_swiglu (the same shapes; the MoE layer's gate and up where
// no gradient is recorded): h[r] = bf16(SiLU(bf16(g))) * bf16(u), g = xs[r]
// @ w_gate[e] and u = xs[r] @ w_up[e], with the unfused layer's roundings (g
// and u stored in bf16, F.silu in fp32 cast back, the product rounded once),
// in one launch: g and u never reach device memory. What bounds it: 2 * 2 *
// T * d * F operations at 989 TFLOP/s (4.59 ms at T = 393,216, d = 2048,
// F = 1408). Design: the forward's, with one block per (bt rows, 128
// columns of h); each stage brings the xs slice once and the 64 x 128
// slices of w_gate and w_up through two 3-D maps, their 64-column atoms
// interleaved (gate, up, gate, up), so the same m64nNk16 instructions sum a
// row's gate and up columns side by side and the epilogue pairs them in
// registers. 1,408 = 11 x 128: no column of the tiles is wasted there.
//
// The backward (no Pallas site: the reference differentiates its MoE
// layer's einsums) is the same grouped product twice more, each with
// kernels of its own, picked by kernel.py::kernel_for as the forward's. No
// atomics and no split-K anywhere, so a gradient has the same bits twice.
// At the train shape (T = 32,768 assignments, d 2,048, F 768, E 128) each
// is bound by its bytes, 0.175 ms at 3.35 TB/s, over the 2 * T * d * F
// operations' 0.104 ms.
// - dX (T_pad, d) = dys[r] @ w[block_expert[r / bt]]^T: a reduction over F
//   into d columns, w read K-major (its rows are d, F contiguous); rows
//   from used on are written as 0 (dys holds garbage there: the forward
//   left those rows unwritten) and nothing is read for them.
//   moe_gemm_dx_wgmma (the forward's wgmma shapes): a persistent block an
//   SM over (bt rows, 256 columns of d) tiles, TMA loads into a 3- or
//   4-stage ring that runs on across tiles, and a TMA-store epilogue that
//   drains under the next tile's products (design at the kernel).
//   moe_gemm_kernel with its DX flag (f32, bt 16 and the rest): w's tile
//   staged as [n][k].
// - dW (E, d, F): each output tile walks its expert's rows in order, from
//   its group's start to its end (the plan's ends, never past used: rows
//   from used on are never read), sums xs^T dys in fp32 registers and
//   stores once; an expert with no rows stores zeros. The bytes are the
//   E * d * F output (403 MB bf16) and both inputs.
//   moe_gemm_dw_wgmma (bf16, token blocks of 64 or 128 rows, d and F
//   multiples of 8): a persistent block an SM over 128 x 256 tiles of dw,
//   TMA loads of both operands read MN-major by wgmma, and a TMA-store
//   epilogue as dX's (design at the kernel).
//   moe_gemm_dw_kernel (f32 and every other shape): one block per (expert,
//   128 rows of d, 128 columns of F), 256 threads in 4 x 2 warps of 32 x
//   64 outputs; 32-row slices of xs and dys staged through registers into
//   padded shared memory while the previous slice runs; both operands read
//   transposed by ldmatrix.trans into mma.sync m16n8k16 (bf16) or by FMAs
//   (f32).
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
// mma.m16n8k16 (g = lane / 4, t = lane % 4). B is stored [k][n] (wb at
// B[kk][0]), or [n][k] where BT (wb at B[0][kk]: the backward's w^T).
template <bool BT>
__device__ __forceinline__ void frag_step(float c[4], const __nv_bfloat16* xa,
                                          int lda, const __nv_bfloat16* wb,
                                          int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  a[0] = *reinterpret_cast<const uint32_t*>(xa + g * lda + 2 * t);
  a[1] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * lda + 2 * t);
  a[2] = *reinterpret_cast<const uint32_t*>(xa + g * lda + 2 * t + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * lda + 2 * t + 8);
  if (BT) {
    b[0] = *reinterpret_cast<const uint32_t*>(wb + g * ldb + 2 * t);
    b[1] = *reinterpret_cast<const uint32_t*>(wb + g * ldb + 2 * t + 8);
  } else {
    b[0] = pack2(wb[(2 * t) * ldb + g], wb[(2 * t + 1) * ldb + g]);
    b[1] = pack2(wb[(2 * t + 8) * ldb + g], wb[(2 * t + 9) * ldb + g]);
  }
  mma_bf16(c, a, b);
}

// f32: the step's 16 products are summed apart and then added to c, so a
// reduction over K rounds about K / 16 + 16 times on an element's path, not
// K times (one running sum over dX's F = 1,408 read 4.2x the plain
// version's float64-relative error on an H100, over the gate's 4x).
template <bool BT>
__device__ __forceinline__ void frag_step(float c[4], const float* xa, int lda,
                                          const float* wb, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float a0 = xa[g * lda + kk], a1 = xa[(g + 8) * lda + kk];
    const float b0 = BT ? wb[(2 * t) * ldb + kk] : wb[kk * ldb + 2 * t];
    const float b1 = BT ? wb[(2 * t + 1) * ldb + kk] : wb[kk * ldb + 2 * t + 1];
    s[0] = fmaf(a0, b0, s[0]);
    s[1] = fmaf(a0, b1, s[1]);
    s[2] = fmaf(a1, b0, s[2]);
    s[3] = fmaf(a1, b1, s[3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += s[i];
}

// K is the reduction, N the output width: the forward's (d, F), DX's (F, d).
// w (E, d, F) holds B(k, n) at w[e][k][n] in the forward, at w[e][n][k] in
// DX; its tile lands in shared memory as [k][n] or [n][k] alike.
template <typename T, int BM, bool DX>
__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const T* __restrict__ xs, const int* __restrict__ block_expert,
                const T* __restrict__ w, const int* __restrict__ used,
                T* __restrict__ ys, int K, int N, int bt) {
  constexpr int BK = Cfg<T>::BK, PAD = Cfg<T>::PAD;
  constexpr int V = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int WM_WARPS = BM >= 64 ? 2 : 1;  // warps along rows
  constexpr int WN_WARPS = 4 / WM_WARPS;      // warps along columns
  constexpr int WM = BM / WM_WARPS, WN = BN / WN_WARPS;
  constexpr int MF = WM / 16, NF = WN / 8;    // fragments per warp
  constexpr int LDA = BK + PAD;
  constexpr int WR = DX ? BN : BK, WC = DX ? BK : BN;  // w tile rows, columns
  constexpr int LDB = WC + PAD;
  constexpr int XCH = BM * BK / V / THREADS;  // x chunks per thread
  constexpr int WCH = WR * WC / V / THREADS;  // w chunks per thread
  static_assert(XCH >= 1 && WCH >= 1, "tile too small for the block");
  __shared__ __align__(16) T xsh[BM * LDA];
  __shared__ __align__(16) T wsh[WR * LDB];

  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (row0 >= *used) {  // past the last real group
    if (DX)  // the gradient of a row no assignment fills is 0
      for (int i = tid; i < BM * BN; i += THREADS)
        if (n0 + i % BN < N)
          ys[(size_t)(row0 + i / BN) * N + n0 + i % BN] = from_f<T>(0.f);
    return;
  }
  const int e = block_expert[row0 / bt];
  const T* wexp = w + (size_t)e * K * N;
  const bool x_al = (K % V) == 0, w_al = ((DX ? K : N) % V) == 0;
  const int wm = warp / WN_WARPS, wn = warp % WN_WARPS;

  uint4 xr[XCH], wr[WCH];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BK / V),
                c = (ch % (BK / V)) * V;
      xr[i] = load_chunk(xs + (size_t)(row0 + r) * K, k0 + c, K, x_al);
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (WC / V),
                c = (ch % (WC / V)) * V;
      if (DX)  // row n0 + r of w[e], columns k0 + c
        wr[i] = n0 + r < N ? load_chunk(wexp + (size_t)(n0 + r) * K, k0 + c,
                                        K, w_al)
                           : make_uint4(0, 0, 0, 0);
      else     // row k0 + r of w[e], columns n0 + c
        wr[i] = k0 + r < K ? load_chunk(wexp + (size_t)(k0 + r) * N, n0 + c,
                                        N, w_al)
                           : make_uint4(0, 0, 0, 0);
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
      const int ch = tid + i * THREADS, r = ch / (WC / V),
                c = (ch % (WC / V)) * V;
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
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);  // next stage in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int n = wn * WN + j * 8;
          frag_step<DX>(acc[i][j], xsh + (wm * WM + i * 16) * LDA + kk, LDA,
                        DX ? wsh + n * LDB + kk : wsh + kk * LDB + n, LDB,
                        lane);
        }
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
        if (col < N) ys[(size_t)row * N + col] = from_f<T>(acc[i][j][r]);
      }
}

// d, F: w's (E, d, F); the forward reduces over d into F columns, DX over
// F into d columns.
template <typename T, bool DX>
int launch(const void* xs, const int* block_expert, const void* w,
           const int* used, void* ys, int T_pad, int d, int F, int bt,
           cudaStream_t stream) {
  const int K = DX ? F : d, N = DX ? d : F;
  const dim3 grid((N + BN - 1) / BN, T_pad / (bt % 64 == 0 ? 64 : 16));
  if (bt % 64 == 0)
    moe_gemm_kernel<T, 64, DX><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(xs), block_expert, static_cast<const T*>(w),
        used, static_cast<T*>(ys), K, N, bt);
  else
    moe_gemm_kernel<T, 16, DX><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(xs), block_expert, static_cast<const T*>(w),
        used, static_cast<T*>(ys), K, N, bt);
  return (int)cudaGetLastError();
}

template <bool DX>
int launch_dtype(const void* xs, const int* block_expert, const void* w,
                 const int* used, void* ys, int T_pad, int d, int F, int bt,
                 int is_bf16, cudaStream_t stream) {
  if (T_pad < 1 || d < 1 || F < 1 || bt < 16 || bt % 16 || T_pad % bt ||
      T_pad / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16, DX>(xs, block_expert, w, used, ys, T_pad, d,
                                     F, bt, stream);
  return launch<float, DX>(xs, block_expert, w, used, ys, T_pad, d, F, bt,
                           stream);
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

// h = bf16(SiLU(g) * u) from the fp32 sums, with the unfused layer's
// roundings: g and u as stored in bf16, SiLU in fp32 (as PyTorch's silu
// kernel computes it) cast back, times u; the product of two bf16 values is
// exact in fp32, so pack_bf16 rounds it once, as a bf16 multiply does.
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float gr = __bfloat162float(__float2bfloat16(g));
  const float ur = __bfloat162float(__float2bfloat16(u));
  return __bfloat162float(__float2bfloat16(gr / (1.f + expf(-gr)))) * ur;
}

// The forward's body. The w maps cover (F, d, E) in 64 x 64 boxes (64-column
// atoms, read MN-major through the transpose bit). Plain (SWIGLU false):
// four atoms of w0 stacked along F, ys (T_pad, F) = xs @ w0[e], 256 columns
// a block. SWIGLU: 128 columns of h a block, its B tile the atoms of w0
// (gate) and w1 (up) interleaved, gate n0, up n0, gate n0 + 64, up n0 + 64;
// ys is h.
template <int BM, bool SWIGLU>
__device__ __forceinline__ void wgmma_fwd(const CUtensorMap* map_x,
                                          const CUtensorMap* map_w0,
                                          const CUtensorMap* map_w1,
                                          const int* __restrict__ block_expert,
                                          const int* __restrict__ used,
                                          __nv_bfloat16* __restrict__ ys,
                                          int d, int F, int bt) {
  using namespace hopper;
  using C = gm::Cfg<BM>;
  constexpr int STAGES = C::STAGES, WN = C::WN;
  constexpr int NOUT = SWIGLU ? gm::BN / 2 : gm::BN;  // output columns a block
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * NOUT;
  if (row0 >= *used) return;  // past the last real group
  const int e = block_expert[row0 / bt];
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
      // output atoms that start inside F (a box past F would only read zeros)
      const int n_atoms = min(NOUT / 64, (F - n0 + 63) / 64);
      const uint32_t bytes =
          C::A_BYTES + (SWIGLU ? 2 : 1) * n_atoms * gm::B_ATOM;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* st = sm + s * C::STAGE;
        uint8_t* b = st + C::A_BYTES;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(st, map_x, &full[s], kt * gm::BK, row0);
        for (int a = 0; a < n_atoms; ++a) {
          if (SWIGLU) {
            tma_load_3d(b + 2 * a * gm::B_ATOM, map_w0, &full[s], n0 + 64 * a,
                        kt * gm::BK, e);
            tma_load_3d(b + (2 * a + 1) * gm::B_ATOM, map_w1, &full[s],
                        n0 + 64 * a, kt * gm::BK, e);
          } else {
            tma_load_3d(b + a * gm::B_ATOM, map_w0, &full[s], n0 + 64 * a,
                        kt * gm::BK, e);
          }
        }
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
      const uint8_t* bt_ = st + C::A_BYTES + (wn * WN / 64) * gm::B_ATOM;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < gm::BK / 16; ++kk)
        Wgmma<WN>::template ss<1>(
            acc, desc_sw128(st + wm * 64 * 128 + kk * 32, 16, 1024),
            desc_sw128(bt_ + kk * 2048, gm::B_ATOM, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's group is done: free its stage
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // element (row 16 warp + g + 8 h, column 8 c + 2 t + j) of the
    // consumer's WN columns of the B tile is acc[4 c + 2 h + j]
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row = row0 + wm * 64 + warp * 16 + g;
    __nv_bfloat16* y0 = ys + (size_t)row * F;
    __nv_bfloat16* y1 = y0 + (size_t)8 * F;
    if constexpr (SWIGLU) {
      // atom pair q: the gate's columns at c = 16 q .. 16 q + 7, up's 8 on
#pragma unroll
      for (int q = 0; q < WN / 128; ++q)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int col = n0 + wn * (WN / 2) + 64 * q + 8 * cc + 2 * t;
          const int gi = 4 * (16 * q + cc), ui = gi + 32;
          if (col < F) {
            *reinterpret_cast<uint32_t*>(y0 + col) =
                pack_bf16(silu_mul(acc[gi], acc[ui]),
                          silu_mul(acc[gi + 1], acc[ui + 1]));
            *reinterpret_cast<uint32_t*>(y1 + col) =
                pack_bf16(silu_mul(acc[gi + 2], acc[ui + 2]),
                          silu_mul(acc[gi + 3], acc[ui + 3]));
          }
        }
    } else {
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
}

template <int BM>
__global__ void __launch_bounds__(gm::THREADS, 1)
moe_gemm_wgmma(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const int* __restrict__ block_expert,
               const int* __restrict__ used, __nv_bfloat16* __restrict__ ys,
               int d, int F, int bt) {
  wgmma_fwd<BM, false>(&map_x, &map_w, &map_w, block_expert, used, ys, d, F,
                       bt);
}

template <int BM>
__global__ void __launch_bounds__(gm::THREADS, 1)
moe_gemm_wgmma_swiglu(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_gate,
                      const __grid_constant__ CUtensorMap map_up,
                      const int* __restrict__ block_expert,
                      const int* __restrict__ used,
                      __nv_bfloat16* __restrict__ h, int d, int F, int bt) {
  wgmma_fwd<BM, true>(&map_x, &map_gate, &map_up, block_expert, used, h, d, F,
                      bt);
}

// ys = xs @ w0[e] on moe_gemm_wgmma, or (SWIGLU) h = SiLU(xs @ w0[e]) *
// (xs @ w1[e]) on moe_gemm_wgmma_swiglu; w1 is read only there.
template <int BM, bool SWIGLU>
int launch_wgmma(const void* xs, const int* block_expert, const void* w0,
                 const void* w1, const int* used, void* ys, int T_pad, int d,
                 int F, int E, cudaStream_t stream) {
  CUtensorMap mx, mw0, mw1;
  const uint64_t dx[2] = {(uint64_t)d, (uint64_t)T_pad};
  const uint64_t sx[1] = {(uint64_t)d * 2};
  const uint32_t bx[2] = {64, BM};
  const uint64_t dw[3] = {(uint64_t)F, (uint64_t)d, (uint64_t)E};
  const uint64_t sw[2] = {(uint64_t)F * 2, (uint64_t)d * F * 2};
  const uint32_t bw[3] = {64, 64, 1};
  int err = hopper::encode_bf16_map(&mx, xs, 2, dx, sx, bx);
  if (!err) err = hopper::encode_bf16_map(&mw0, w0, 3, dw, sw, bw);
  if (!err && SWIGLU) err = hopper::encode_bf16_map(&mw1, w1, 3, dw, sw, bw);
  if (err) return err;
  const int smem = gm::Cfg<BM>::BYTES;
  const void* kern = SWIGLU ? (const void*)moe_gemm_wgmma_swiglu<BM>
                            : (const void*)moe_gemm_wgmma<BM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int NOUT = SWIGLU ? gm::BN / 2 : gm::BN;
  const dim3 grid((F + NOUT - 1) / NOUT, T_pad / BM);
  auto* out = static_cast<__nv_bfloat16*>(ys);
  if constexpr (SWIGLU)
    moe_gemm_wgmma_swiglu<BM><<<grid, gm::THREADS, smem, stream>>>(
        mx, mw0, mw1, block_expert, used, out, d, F, BM);
  else
    moe_gemm_wgmma<BM><<<grid, gm::THREADS, smem, stream>>>(
        mx, mw0, block_expert, used, out, d, F, BM);
  return (int)cudaGetLastError();
}


// ------------------------------------------- dX = dys w^T, bf16, wgmma + TMA

namespace dxg {
constexpr int BN = 256, BK = 64;  // columns of d a tile owns, a slice of F
constexpr int THREADS = 384;      // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int ATOM = 64 * 128;    // [64 rows][64 columns], 128-byte swizzled
constexpr int B_BYTES = (BN / 64) * ATOM;  // w[e]: four atoms along d
template <int BM> struct Cfg {
  static constexpr int STAGES = BM == 128 ? 3 : 4;
  static constexpr int A_BYTES = BM * 128;  // dys: [BM rows][64 of F]
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int WN = BM == 128 ? 256 : 128;  // columns a consumer owns
  static constexpr int OUT_WG = (WN / 64) * ATOM;   // its 64 x WN of dX
  static constexpr int OUT = STAGES * STAGE;        // the consumers' boxes
  static constexpr int BAR = OUT + 2 * OUT_WG;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + align
};
}  // namespace dxg

// A consumer warpgroup's fp32 sums of wgmma m64nWNk16, rounded to bf16
// into WN / 64 128-byte-swizzled [64][64] boxes at `out`, the layout a TMA
// store of the map's 64 x 64 box reads (dX's and dW's epilogues). Element
// (row 16 warp + g + 8 h, column 8 c + 2 t4 + j) is acc[4 c + 2 h + j]: box
// c / 8, 16-byte chunk c % 8, swizzled by row.
template <int WN>
__device__ __forceinline__ void acc_to_boxes(uint8_t* out,
                                             const float (&acc)[WN / 2],
                                             int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
  for (int c = 0; c < WN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(out + (c / 8) * 64 * 128 +
                                   (warp * 16 + g + 8 * h) * 128 +
                                   (((c % 8) ^ g) * 16) + 4 * t4) =
          hopper::pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
}

struct DxTile {
  int row0, n0, e;  // first row, first column of d, expert
  bool real;        // row0 < used: rows from used on are written as 0
};

// Tile `tile` in row-major order (within a row tile, 256-column tiles of d
// vary fastest); its expert is read only for a real tile.
template <int BM>
__device__ __forceinline__ DxTile dx_tile(int tile, int n_tiles,
                                          const int* __restrict__ block_expert,
                                          int lim) {
  DxTile t;
  t.row0 = (tile / n_tiles) * BM;
  t.n0 = (tile % n_tiles) * dxg::BN;
  t.real = t.row0 < lim;
  t.e = t.real ? block_expert[t.row0 / BM] : 0;
  return t;
}

// dX (T_pad, d) = dys[r] @ w[block_expert[r / BM]]^T for r < used, 0 from
// used on, for bf16 token blocks of BM = 64 or 128 rows (a tile never
// straddles two experts). A persistent block an SM walks the tiles
// blockIdx.x, + gridDim.x, ... of (BM rows, 256 columns of d) in row-major
// order, so the blocks running at once share one or two experts' w[e] and
// the same dys rows in L2. The producer warp's first thread loads, by TMA,
// each 64-deep slice of F of the dys tile (a 2-D map over (F, T_pad)) and
// of w[e]'s [256 rows of d][64 of F] (four 64 x 64 boxes of a 3-D map over
// (F, d, E)), both K-major, into a ring of STAGES stages, running on into
// the next tile while the consumers store; TMA zero-fills past F, and boxes
// that start past d are not loaded (their columns are never stored). At BM
// 128 each consumer warpgroup owns 64 rows x 256 columns (m64n256k16), at
// BM 64 each 128 columns of the one 64-row tile (m64n128k16); a consumer
// keeps one wgmma group in flight and frees a stage when the group reading
// it completes. It rounds its fp32 sums to bf16 into its own swizzled
// [64][64] boxes and one thread stores them by TMA into a 2-D map over dX
// (d, T_pad), which clips columns past d; that store drains while the next
// tile's products run and is waited on (wait_group.read) only before the
// boxes are written again. A tile from used on loads nothing and stores
// boxes of zeros by the same path, so dys is never read there.
template <int BM>
__global__ void __launch_bounds__(dxg::THREADS, 1)
moe_gemm_dx_wgmma(const __grid_constant__ CUtensorMap map_dy,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_dx,
                  const int* __restrict__ block_expert,
                  const int* __restrict__ used, int T_pad, int d, int F) {
  using namespace hopper;
  using C = dxg::Cfg<BM>;
  constexpr int STAGES = C::STAGES, WN = C::WN;
  const int n_tiles = (d + dxg::BN - 1) / dxg::BN;
  const int tiles = (T_pad / BM) * n_tiles;
  const int nk = (F + dxg::BK - 1) / dxg::BK;
  const int lim = *used;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], dxg::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // slices this block has loaded, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const DxTile t = dx_tile<BM>(tile, n_tiles, block_expert, lim);
        if (!t.real) continue;
        // w boxes that start inside d (the rest are never stored)
        const int na = min(dxg::BN / 64, (d - t.n0 + 63) / 64);
        const uint32_t bytes = C::A_BYTES + na * dxg::ATOM;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          uint8_t* st = sm + s * C::STAGE;
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(st, &map_dy, &full[s], kt * dxg::BK, t.row0);
          for (int a = 0; a < na; ++a)
            tma_load_3d(st + C::A_BYTES + a * dxg::ATOM, &map_w, &full[s],
                        kt * dxg::BK, t.n0 + 64 * a, t.e);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int wm = BM == 128 ? cw : 0, wn = BM == 128 ? 0 : cw;
    const int tid = threadIdx.x - 128 * wg;
    uint8_t* out = sm + C::OUT + cw * C::OUT_WG;
    float acc[WN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const DxTile t = dx_tile<BM>(tile, n_tiles, block_expert, lim);
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; t.real && kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint8_t* st = sm + s * C::STAGE;
        const uint8_t* b = st + C::A_BYTES + (wn * WN / 64) * dxg::ATOM;
        mbar_wait(&full[s], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < dxg::BK / 16; ++kk)
          Wgmma<WN>::template ss<0>(
              acc, desc_sw128(st + wm * 64 * 128 + kk * 32, 16, 1024),
              desc_sw128(b + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's group is done: free its stage
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t.real) mbar_arrive(&empty[(it - 1) % STAGES]);

      if (tid == 0) bulk_wait_read<0>();  // the last tile's store read them
      named_bar_sync(1 + cw, 128);
      acc_to_boxes<WN>(out, acc, tid);
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0) {
        const int c0 = t.n0 + wn * WN;  // boxes that start inside d
        for (int a = 0; a < WN / 64 && c0 + 64 * a < d; ++a)
          tma_store_2d(&map_dx, out + a * dxg::ATOM, c0 + 64 * a,
                       t.row0 + 64 * wm);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // before the shared memory goes
  }
}

template <int BM>
int launch_dx_wgmma(const void* dys, const int* block_expert, const void* w,
                    const int* used, void* dxs, int T_pad, int d, int F,
                    int E, cudaStream_t stream) {
  CUtensorMap mdy, mw, mdx;
  const uint64_t ddy[2] = {(uint64_t)F, (uint64_t)T_pad};
  const uint64_t sdy[1] = {(uint64_t)F * 2};
  const uint32_t bdy[2] = {64, BM};
  const uint64_t dw[3] = {(uint64_t)F, (uint64_t)d, (uint64_t)E};
  const uint64_t sw[2] = {(uint64_t)F * 2, (uint64_t)d * F * 2};
  const uint32_t bw[3] = {64, 64, 1};
  const uint64_t ddx[2] = {(uint64_t)d, (uint64_t)T_pad};
  const uint64_t sdx[1] = {(uint64_t)d * 2};
  const uint32_t bdx[2] = {64, 64};
  int err = hopper::encode_bf16_map(&mdy, dys, 2, ddy, sdy, bdy);
  if (!err) err = hopper::encode_bf16_map(&mw, w, 3, dw, sw, bw);
  if (!err) err = hopper::encode_bf16_map(&mdx, dxs, 2, ddx, sdx, bdx);
  if (err) return err;
  const long long tiles =
      (long long)(T_pad / BM) * ((d + dxg::BN - 1) / dxg::BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int smem = dxg::Cfg<BM>::BYTES;
  auto kern = moe_gemm_dx_wgmma<BM>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, dxg::THREADS, smem, stream>>>(mdy, mw, mdx, block_expert, used,
                                             T_pad, d, F);
  return (int)cudaGetLastError();
}

// The shapes both wgmma kernels take: bt 64 or 128 dividing T_pad, d and F
// multiples of 8 (TMA's 16-byte strides).
bool wgmma_shape(int T_pad, int d, int F, int E, int bt) {
  return T_pad >= 1 && d >= 8 && F >= 8 && E >= 1 && d % 8 == 0 &&
         F % 8 == 0 && (bt == 64 || bt == 128) && T_pad % bt == 0 &&
         T_pad / bt <= 65535;
}


// ------------------------------------------------------------ dW = xs^T dys

namespace dwk {
constexpr int BM = 128, BN = 128;  // rows of d, columns of F a block owns
constexpr int THREADS = 256;       // 8 warps, 4 along d x 2 along F
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BK = 32, PAD = 8; };
template <> struct Cfg<float> { static constexpr int BK = 16, PAD = 4; };
}  // namespace dwk

// Four 8x8 bf16 matrices, each transposed on the way to registers: lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p)));
}

// One BK-row slice in shared memory, xs as [k][m] and dys as [k][n] (k the
// row of the sorted layout): acc += A B with A[m][k] = xs[k][m] and
// B[k][n] = dys[k][n]. bf16: warp (wm, wn) owns 32 x 64 outputs as 2 x 8
// m16n8 fragments; f32: thread (ty, tx) owns rows {4ty..4ty+3, 64+4ty..}
// x columns {4tx.., 64+4tx..}.
template <int BK, int LDA, int LDB>
__device__ __forceinline__ void dw_slice(float (&acc)[64],
                                         const __nv_bfloat16* xsh,
                                         const __nv_bfloat16* dsh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int q = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[2][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)  // matrices: (k, m), (k, m+8), (k+8, m), ..
      ldmatrix_x4_trans(a[i], xsh + (ks + rr + (q >> 1) * 8) * LDA +
                                  wm * 32 + i * 16 + (q & 1) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)  // (k, n), (k+8, n), (k, n+8), (k+8, n+8)
      ldmatrix_x4_trans(b[jj], dsh + (ks + rr + (q & 1) * 8) * LDB +
                                   wn * 64 + jj * 16 + (q >> 1) * 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_bf16(&acc[(i * 8 + j) * 4], a[i], &b[j >> 1][(j & 1) * 2]);
  }
}

template <int BK, int LDA, int LDB>
__device__ __forceinline__ void dw_slice(float (&acc)[64], const float* xsh,
                                         const float* dsh) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(xsh + k * LDA + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(xsh + k * LDA + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(dsh + k * LDB + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(dsh + k * LDB + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i * 8 + j] = fmaf(a[i], b[j], acc[i * 8 + j]);
  }
}

__device__ __forceinline__ void dw_store(float v0, float v1,
                                         __nv_bfloat16* row, int n, int F) {
  if ((F & 1) == 0) {  // n even: the pair lies inside F when n does
    if (n < F)
      *reinterpret_cast<uint32_t*>(row + n) = hopper::pack_bf16(v0, v1);
  } else {
    if (n < F) row[n] = __float2bfloat16(v0);
    if (n + 1 < F) row[n + 1] = __float2bfloat16(v1);
  }
}

// dw (E, d, F) = per expert e, xs[rows]^T dys[rows] over the rows of its
// group: [ends[e-1], ends[e]) (0 for e = 0), cut at used.
template <typename T>
__global__ void __launch_bounds__(dwk::THREADS, 2)
moe_gemm_dw_kernel(const T* __restrict__ xs, const T* __restrict__ dys,
                   const int* __restrict__ ends, const int* __restrict__ used,
                   T* __restrict__ dw, int d, int F) {
  constexpr int BK = dwk::Cfg<T>::BK, PAD = dwk::Cfg<T>::PAD;
  constexpr int BM = dwk::BM, BN = dwk::BN, THREADS = dwk::THREADS;
  constexpr int V = 16 / sizeof(T);
  constexpr int LDA = BM + PAD, LDB = BN + PAD;
  constexpr int XCH = BK * BM / V / THREADS, DCH = BK * BN / V / THREADS;
  static_assert(XCH >= 1 && DCH >= 1, "slice too small for the block");
  __shared__ __align__(16) T xsh[BK * LDA];
  __shared__ __align__(16) T dsh[BK * LDB];

  const int e = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lim = *used;
  const int r_end = min(ends[e], lim);
  const int r_begin = min(e > 0 ? ends[e - 1] : 0, r_end);
  const int tid = threadIdx.x;
  const bool x_al = (d % V) == 0, d_al = (F % V) == 0;

  uint4 xr[XCH], dr[DCH];
  auto fetch = [&](int r0) {  // rows r0.. of the group, zeros past its end
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BM / V),
                c = (ch % (BM / V)) * V;
      xr[i] = r0 + r < r_end
                  ? load_chunk(xs + (size_t)(r0 + r) * d, m0 + c, d, x_al)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < DCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BN / V),
                c = (ch % (BN / V)) * V;
      dr[i] = r0 + r < r_end
                  ? load_chunk(dys + (size_t)(r0 + r) * F, n0 + c, F, d_al)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BM / V),
                c = (ch % (BM / V)) * V;
      *reinterpret_cast<uint4*>(xsh + r * LDA + c) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < DCH; ++i) {
      const int ch = tid + i * THREADS, r = ch / (BN / V),
                c = (ch % (BN / V)) * V;
      *reinterpret_cast<uint4*>(dsh + r * LDB + c) = dr[i];
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (r_begin < r_end) fetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    stash();
    __syncthreads();
    if (r0 + BK < r_end) fetch(r0 + BK);  // next slice in flight
    dw_slice<BK, LDA, LDB>(acc, xsh, dsh);
    __syncthreads();
  }

  T* out = dw + (size_t)e * d * F;
  if constexpr (sizeof(T) == 2) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
          const int n = n0 + wn * 64 + j * 8 + 2 * t;
          if (m < d)
            dw_store(acc[(i * 8 + j) * 4 + 2 * h],
                     acc[(i * 8 + j) * 4 + 2 * h + 1], out + (size_t)m * F,
                     n, F);
        }
  } else {
    const int ty = tid / 16, tx = tid % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (m >= d) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (n < F) out[(size_t)m * F + n] = acc[i * 8 + j];
      }
    }
  }
}

// ------------------------------------------- dW = xs^T dys, bf16, wgmma + TMA

namespace dwg {
constexpr int BM = 128, BN = 256, BK = 64;  // rows of d, columns of F, rows
constexpr int THREADS = 384;  // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int STAGES = 3;
constexpr int ATOM = BK * 128;             // [64 group rows][64 of d or F]
constexpr int A_BYTES = (BM / 64) * ATOM;  // xs: two atoms along d
constexpr int STAGE = A_BYTES + (BN / 64) * ATOM;  // dys: four along F
constexpr int OUT_ATOM = 64 * 128;         // [64 rows of d][64 of F]
constexpr int OUT_WG = (BN / 64) * OUT_ATOM;  // a consumer's 64 x 256 of dw
constexpr int OUT = STAGES * STAGE;        // the two consumers' store boxes
constexpr int BAR = OUT + 2 * OUT_WG;
constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + align
}  // namespace dwg

struct DwTile {
  int e, m0, n0;  // expert, first row of d, first column of F
  int r0, nk;     // the group's rows [r0, r0 + 64 nk)
};

// Tile `tile` in expert-major order (within an expert, F tiles vary
// fastest), its expert's group from the plan's ends, cut at lim.
__device__ __forceinline__ DwTile dw_tile(int tile, int m_tiles, int n_tiles,
                                          const int* __restrict__ ends,
                                          int lim) {
  DwTile t;
  const int per = m_tiles * n_tiles, i = tile % per;
  t.e = tile / per;
  t.m0 = (i / n_tiles) * dwg::BM;
  t.n0 = (i % n_tiles) * dwg::BN;
  const int r_end = min(ends[t.e], lim);
  t.r0 = min(t.e > 0 ? ends[t.e - 1] : 0, r_end);
  t.nk = (r_end - t.r0) / dwg::BK;
  return t;
}

// dw (E, d, F) as moe_gemm_dw_kernel computes it, for bf16 groups that
// start and end on 64-row slices (token blocks of 64 or 128 rows). A
// persistent block an SM walks the tiles blockIdx.x, + gridDim.x, ... in
// expert-major order, so the blocks running at once share one or two
// experts' rows in L2. The producer warp's first thread loads, by TMA, each
// 64-row slice of the tile's rows of xs (a 2-D map over (d, T_pad), two
// 64 x 64 boxes) and dys ((F, T_pad), four boxes) into a ring of STAGES
// stages, running on into the next tile while the consumers store; both
// land [row][64 columns], 128-byte swizzled, so wgmma reads A = xs^T and
// B = dys MN-major (transpose bits set). Each consumer warpgroup sums its
// 64 rows of d x 256 columns of F in fp32 registers (m64n256k16), then
// rounds them to bf16 into its own four swizzled [64][64] boxes and one
// thread stores them by TMA into a 3-D map over dw (F, d, E), which clips
// rows past d and columns past F; that store drains while the next tile's
// products run, and is waited on (wait_group.read) only before the boxes
// are written again. An expert with no rows stores zeros.
__global__ void __launch_bounds__(dwg::THREADS, 1)
moe_gemm_dw_wgmma(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_dy,
                  const __grid_constant__ CUtensorMap map_dw,
                  const int* __restrict__ ends, const int* __restrict__ used,
                  int d, int F, int E) {
  using namespace hopper;
  constexpr int STAGES = dwg::STAGES;
  const int m_tiles = (d + dwg::BM - 1) / dwg::BM;
  const int n_tiles = (F + dwg::BN - 1) / dwg::BN;
  const int tiles = E * m_tiles * n_tiles;
  const int lim = *used;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + dwg::BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], dwg::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // slices this block has loaded, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const DwTile t = dw_tile(tile, m_tiles, n_tiles, ends, lim);
        // boxes that start inside d and F (the rest would read only zeros)
        const int ma = min(dwg::BM / 64, (d - t.m0 + 63) / 64);
        const int na = min(dwg::BN / 64, (F - t.n0 + 63) / 64);
        const uint32_t bytes = (ma + na) * dwg::ATOM;
        for (int kt = 0; kt < t.nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          uint8_t* st = sm + s * dwg::STAGE;
          const int r = t.r0 + kt * dwg::BK;
          mbar_expect_tx(&full[s], bytes);
          for (int a = 0; a < ma; ++a)
            tma_load_2d(st + a * dwg::ATOM, &map_x, &full[s], t.m0 + 64 * a,
                        r);
          for (int a = 0; a < na; ++a)
            tma_load_2d(st + dwg::A_BYTES + a * dwg::ATOM, &map_dy, &full[s],
                        t.n0 + 64 * a, r);
        }
      }
    }
  } else {  // consumers: warpgroup cw owns rows m0 + 64 cw .. + 63 of a tile
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    uint8_t* out = sm + dwg::OUT + cw * dwg::OUT_WG;
    float acc[128];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const DwTile t = dw_tile(tile, m_tiles, n_tiles, ends, lim);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < t.nk; ++kt, ++it) {
        const int s = it % STAGES;
        const uint8_t* st = sm + s * dwg::STAGE;
        mbar_wait(&full[s], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < dwg::BK / 16; ++kk)
          Wgmma<256>::ss<1, 1>(
              acc,
              desc_sw128(st + cw * dwg::ATOM + kk * 2048, dwg::ATOM, 1024),
              desc_sw128(st + dwg::A_BYTES + kk * 2048, dwg::ATOM, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's group is done: free its stage
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t.nk > 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      if (tid == 0) bulk_wait_read<0>();  // the last tile's store read them
      named_bar_sync(1 + cw, 128);
      acc_to_boxes<dwg::BN>(out, acc, tid);
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0 && t.m0 + 64 * cw < d) {
        const int na = min(dwg::BN / 64, (F - t.n0 + 63) / 64);
        for (int a = 0; a < na; ++a)
          tma_store_3d(&map_dw, out + a * dwg::OUT_ATOM, t.n0 + 64 * a,
                       t.m0 + 64 * cw, t.e);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // before the shared memory goes
  }
}

}  // namespace

// The forward on the mma.sync kernel. bt: rows per expert block, a multiple
// of 16 dividing T_pad. Returns a cudaError_t.
extern "C" int moe_gemm_launch(const void* xs, const int* block_expert,
                               const void* w, const int* used, void* ys,
                               int T_pad, int d, int F, int bt, int is_bf16,
                               cudaStream_t stream) {
  return launch_dtype<false>(xs, block_expert, w, used, ys, T_pad, d, F, bt,
                             is_bf16, stream);
}

// The forward on the wgmma kernel: bf16 only; bt 64 or 128 rows per expert
// block dividing T_pad; d and F multiples of 8 (TMA's 16-byte strides); E
// experts in w. Returns a cudaError_t.
extern "C" int moe_gemm_wgmma_launch(const void* xs, const int* block_expert,
                                     const void* w, const int* used, void* ys,
                                     int T_pad, int d, int F, int E, int bt,
                                     cudaStream_t stream) {
  if (!wgmma_shape(T_pad, d, F, E, bt)) return (int)cudaErrorInvalidValue;
  if (bt == 128)
    return launch_wgmma<128, false>(xs, block_expert, w, w, used, ys, T_pad,
                                    d, F, E, stream);
  return launch_wgmma<64, false>(xs, block_expert, w, w, used, ys, T_pad, d,
                                 F, E, stream);
}

// h (T_pad, F) = SiLU(xs @ w_gate[e]) * (xs @ w_up[e]) with the unfused
// layer's bf16 roundings, on moe_gemm_wgmma_swiglu (the shapes
// moe_gemm_wgmma_launch takes; w_gate and w_up both (E, d, F)). Rows from
// used on are not written. Returns a cudaError_t.
extern "C" int moe_gemm_swiglu_wgmma_launch(const void* xs,
                                            const int* block_expert,
                                            const void* w_gate,
                                            const void* w_up, const int* used,
                                            void* h, int T_pad, int d, int F,
                                            int E, int bt,
                                            cudaStream_t stream) {
  if (!wgmma_shape(T_pad, d, F, E, bt)) return (int)cudaErrorInvalidValue;
  if (bt == 128)
    return launch_wgmma<128, true>(xs, block_expert, w_gate, w_up, used, h,
                                   T_pad, d, F, E, stream);
  return launch_wgmma<64, true>(xs, block_expert, w_gate, w_up, used, h,
                                T_pad, d, F, E, stream);
}

// dX (T_pad, d) from dys (T_pad, F) and w (E, d, F), on the mma.sync kernel
// (the shapes moe_gemm_launch takes).
extern "C" int moe_gemm_dx_launch(const void* dys, const int* block_expert,
                                  const void* w, const int* used, void* dxs,
                                  int T_pad, int d, int F, int bt,
                                  int is_bf16, cudaStream_t stream) {
  return launch_dtype<true>(dys, block_expert, w, used, dxs, T_pad, d, F, bt,
                            is_bf16, stream);
}

// dX on the persistent wgmma kernel (the shapes moe_gemm_wgmma_launch
// takes). Returns a cudaError_t.
extern "C" int moe_gemm_dx_wgmma_launch(const void* dys,
                                        const int* block_expert,
                                        const void* w, const int* used,
                                        void* dxs, int T_pad, int d, int F,
                                        int E, int bt, cudaStream_t stream) {
  if (!wgmma_shape(T_pad, d, F, E, bt)) return (int)cudaErrorInvalidValue;
  if (bt == 128)
    return launch_dx_wgmma<128>(dys, block_expert, w, used, dxs, T_pad, d, F,
                                E, stream);
  return launch_dx_wgmma<64>(dys, block_expert, w, used, dxs, T_pad, d, F, E,
                             stream);
}

// dW (E, d, F) from xs (T_pad, d), dys (T_pad, F) and the plan's group ends
// (E,) int32. Returns a cudaError_t.
extern "C" int moe_gemm_dw_launch(const void* xs, const void* dys,
                                  const int* ends, const int* used, void* dw,
                                  int d, int F, int E, int is_bf16,
                                  cudaStream_t stream) {
  if (d < 1 || F < 1 || E < 1 || (d + dwk::BM - 1) / dwk::BM > 65535 ||
      E > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + dwk::BN - 1) / dwk::BN, (d + dwk::BM - 1) / dwk::BM, E);
  if (is_bf16)
    moe_gemm_dw_kernel<__nv_bfloat16><<<grid, dwk::THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(xs),
        static_cast<const __nv_bfloat16*>(dys), ends, used,
        static_cast<__nv_bfloat16*>(dw), d, F);
  else
    moe_gemm_dw_kernel<float><<<grid, dwk::THREADS, 0, stream>>>(
        static_cast<const float*>(xs), static_cast<const float*>(dys), ends,
        used, static_cast<float*>(dw), d, F);
  return (int)cudaGetLastError();
}

// dW on the wgmma kernel: bf16 only; T_pad a multiple of 64, and every
// group's end (ends, used) a multiple of 64 (the plan's token blocks of 64
// or 128 rows); d and F multiples of 8 (TMA's 16-byte strides). Returns a
// cudaError_t.
extern "C" int moe_gemm_dw_wgmma_launch(const void* xs, const void* dys,
                                        const int* ends, const int* used,
                                        void* dw, int T_pad, int d, int F,
                                        int E, cudaStream_t stream) {
  const long long tiles = (long long)E * ((d + dwg::BM - 1) / dwg::BM) *
                          ((F + dwg::BN - 1) / dwg::BN);
  if (T_pad < dwg::BK || T_pad % dwg::BK || d < 8 || F < 8 || E < 1 ||
      d % 8 || F % 8 || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mdy, mdw;
  const uint64_t dx[2] = {(uint64_t)d, (uint64_t)T_pad};
  const uint64_t sx[1] = {(uint64_t)d * 2};
  const uint64_t ddy[2] = {(uint64_t)F, (uint64_t)T_pad};
  const uint64_t sdy[1] = {(uint64_t)F * 2};
  const uint64_t dd[3] = {(uint64_t)F, (uint64_t)d, (uint64_t)E};
  const uint64_t sd[2] = {(uint64_t)F * 2, (uint64_t)d * F * 2};
  const uint32_t box2[2] = {64, 64}, box3[3] = {64, 64, 1};
  int err = hopper::encode_bf16_map(&mx, xs, 2, dx, sx, box2);
  if (!err) err = hopper::encode_bf16_map(&mdy, dys, 2, ddy, sdy, box2);
  if (!err) err = hopper::encode_bf16_map(&mdw, dw, 3, dd, sd, box3);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(moe_gemm_dw_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dwg::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  moe_gemm_dw_wgmma<<<grid, dwg::THREADS, dwg::BYTES, stream>>>(
      mx, mdy, mdw, ends, used, d, F, E);
  return (int)cudaGetLastError();
}
