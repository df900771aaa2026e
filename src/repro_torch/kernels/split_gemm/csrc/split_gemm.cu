// fp32 activations times bf16 weights on Hopper's tensor cores, at the
// precision of an fp32 product: the vision tower's SwiGLU (models/layers.py
// ::swiglu), whose float32 activations meet bfloat16 weights.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (jnp.dot in float32). Added because fp32 products run on the CUDA cores
// (67 TFLOP/s), and a TF32 product would be a lower precision than the
// configuration states.
//
// The split. An fp32 x is the exact sum of three bf16 terms: x1 = x with
// its low 16 bits cleared (bf16 rounded toward zero, so no term overflows
// near fp32's largest values), x2 the same of the remainder r = |x| - |x1|
// with x's sign, x3 = r - |x2| with x's sign; each remainder is exact, and
// 3 x 8 significant bits cover fp32's 24. Every product xk * w of bf16
// terms is exact in fp32 and wgmma sums in fp32, so the product is the
// fp32 product up to the order and rounding of the sums. Exact for |x| >=
// 2^-103 (every term a normal number) and for 0 (with its sign); below, a
// term's bits under 2^-133 (bf16's subnormal step) are lost. Where x is
// inf or NaN, x1 is x (a NaN stays a NaN) and x2 = x3 = 0, so inf and NaN
// propagate as in an fp32 product. ref.py::split3 is the same split in
// PyTorch.
//
// What bounds it: 3 * 2 * M * K * N operations on bf16 tensor cores, 989
// TFLOP/s, three times the work of a bf16 product; the CUDA-core fp32 bound
// is 2 * M * K * N / 67e12, 4.9x longer. Bytes (fp32 x and output, bf16 w)
// are far below at the tower's shapes.
//
// Accumulation. The tensor cores add a wgmma's products to its fp32
// accumulator with truncation, so an accumulator carried over many steps
// drifts toward zero: at K 1,280 a register-resident wgmma sum of the three
// terms missed float64 by 5-28x fp32 cuBLAS's error on the card. So the
// tensor cores sum only one 32-deep stage (six wgmma steps: two 16-deep
// steps of three terms) into a fresh partial, and each stage's partial is
// added into an fp32 accumulator in registers with round-to-nearest FADDs:
// the kernel's error against float64 is then that of an fp32 product.
//
// Design: a persistent block an SM walks (128 rows, 128 accumulator
// columns) tiles in row-major order (column tiles fastest, so the blocks
// running at once share rows of x and every weight in L2). A producer
// warp's first thread loads, by TMA, each 32-deep slice of K of the fp32 x
// tile (one 128-byte row per tile row, swizzled) and of the weight tile(s)
// as stored (bf16, [32 rows of K][64 columns] boxes, MN-major) into a ring
// of STAGES stages that runs on across tiles; TMA zero-fills rows past M and
// K and columns past N. Two consumer warpgroups own 64 rows each. For each
// 16-deep step a consumer thread reads its eight fp32 A elements from
// shared memory, splits them in registers into the three bf16 fragments of
// wgmma's register-A form, and starts three wgmma per weight tile against
// the same B descriptor: each weight tile is read once and used three
// times. The split of the next step runs while the tensor cores work on
// this one (the fragments a wgmma reads are held live until it completes);
// the other warpgroup's wgmma keep the tensor cores busy while one adds its
// partial. The accumulator and the partial take 64 registers each, which
// sets the tile's 128 columns. NB = 2 (swiglu_gate_up) computes the gate's
// and the up projection's 64 columns of the same rows from one A fragment
// and applies SiLU(g) * u in fp32 in the epilogue, so g and u never reach
// device memory; NB = 1 (matmul) owns 128 columns. The epilogue stores fp32
// from registers (each row's four lanes write one 32-byte sector), masked
// past M and N. No atomics and no split-K: the same bits twice.

#include "../../hopper.cuh"

namespace sg {
constexpr int BM = 128;        // rows a tile: 64 for each consumer warpgroup
constexpr int BN = 128;        // accumulator columns a consumer owns, over NB
constexpr int BK = 32;         // K of a stage: one 128-byte row of fp32 x
constexpr int STAGES = 8;
constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = BM * BK * 4;        // [128 rows][32 fp32], swizzled
constexpr int B_ATOM = BK * 128;            // [32 rows of K][64 bf16 columns]
constexpr int B_BYTES = (BN / 64) * B_ATOM; // NB tiles of BN / NB columns
constexpr int STAGE = A_BYTES + B_BYTES;    // 24 KB
constexpr int BAR = STAGES * STAGE;
constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + align
}  // namespace sg

namespace {

// Three bf16x2 registers (x1, x2, x3 of the split; lo in the low half)
// holding the exact split of the fp32 pair (lo, hi).
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t& p1,
                                           uint32_t& p2, uint32_t& p3) {
  uint32_t ul = __float_as_uint(lo), uh = __float_as_uint(hi);
  // a NaN whose payload lies below bit 16 would truncate to inf: quiet it
  ul |= (ul & 0x7fffffffu) > 0x7f800000u ? 0x00400000u : 0u;
  uh |= (uh & 0x7fffffffu) > 0x7f800000u ? 0x00400000u : 0u;
  p1 = __byte_perm(ul, uh, 0x7632);  // the high halves: x1 = trunc(x)
  const uint32_t sign = p1 & 0x80008000u;
  // |x| - |x1|: exact and >= 0 for finite x; inf - inf and NaN give NaN,
  // which fmaxf turns into 0
  const float rl = fmaxf(fabsf(lo) - __uint_as_float(ul & 0x7fff0000u), 0.f);
  const float rh = fmaxf(fabsf(hi) - __uint_as_float(uh & 0x7fff0000u), 0.f);
  const uint32_t ql = __float_as_uint(rl) & 0xffff0000u;
  const uint32_t qh = __float_as_uint(rh) & 0xffff0000u;
  p2 = __byte_perm(ql, qh, 0x7632) | sign;
  const float sl = rl - __uint_as_float(ql), sh = rh - __uint_as_float(qh);
  p3 = __byte_perm(__float_as_uint(sl), __float_as_uint(sh), 0x7632) | sign;
}

// The thread's A fragments of one 16-deep step (kk 0 or 1 of the stage):
// f[term][i] in the register layout of mma.m16n8k16's A for the warp's 16
// rows (a0 row g, columns 2t, 2t+1; a1 row g+8; a2 row g, columns 2t+8,
// 2t+9; a3 row g+8). The tile's row r sits at r * 128 bytes, its 16-byte
// chunk c at chunk c ^ (r % 8) (TMA's 128-byte swizzle); r % 8 == g.
__device__ __forceinline__ void load_split(const uint8_t* row, int kk, int g,
                                           int t, uint32_t (&f)[3][4]) {
  const int half = 8 * (t & 1);
  const int c0 = (((4 * kk + (t >> 1)) ^ g) << 4) + half;
  const int c1 = (((4 * kk + 2 + (t >> 1)) ^ g) << 4) + half;
  const float2 v0 = *reinterpret_cast<const float2*>(row + c0);
  const float2 v1 = *reinterpret_cast<const float2*>(row + 8 * 128 + c0);
  const float2 v2 = *reinterpret_cast<const float2*>(row + c1);
  const float2 v3 = *reinterpret_cast<const float2*>(row + 8 * 128 + c1);
  split_pair(v0.x, v0.y, f[0][0], f[1][0], f[2][0]);
  split_pair(v1.x, v1.y, f[0][1], f[1][1], f[2][1]);
  split_pair(v2.x, v2.y, f[0][2], f[1][2], f[2][2]);
  split_pair(v3.x, v3.y, f[0][3], f[1][3], f[2][3]);
}

// Holds fragments a wgmma may still be reading live (and in place) up to
// this point: the compiler may not reuse their registers before it.
__device__ __forceinline__ void keep(uint32_t (&f)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j]) :: "memory");
}

// part[p] += (x3 + x2 + x1) * w_p over one 16-deep step, smallest term
// first (`fresh`: part[p] = instead, at a stage's first step); the weight
// tiles of the stage at `b`, MN-major.
template <int NB>
__device__ __forceinline__ void mma_step(float (&part)[NB][sg::BN / NB / 2],
                                         const uint32_t (&f)[3][4],
                                         const uint8_t* b, int kk,
                                         bool fresh) {
  using namespace hopper;
  constexpr int WN = sg::BN / NB;
#pragma unroll
  for (int p = 0; p < NB; ++p) fence_regs(part[p]);
  wgmma_fence();
#pragma unroll
  for (int term = 2; term >= 0; --term)
#pragma unroll
    for (int p = 0; p < NB; ++p)
      Wgmma<WN>::template rs<1>(
          part[p], f[term],
          desc_sw128(b + p * (WN / 64) * sg::B_ATOM + kk * 2048, sg::B_ATOM,
                     1024),
          !(fresh && term == 2));
  wgmma_commit();
#pragma unroll
  for (int p = 0; p < NB; ++p) fence_regs(part[p]);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + expf(-g));  // as PyTorch's silu kernel computes it
}

// out (M, N) fp32 = x (M, K) fp32 @ w (K, N) bf16 (NB = 1), or
// SiLU(x @ w0) * (x @ w1) (NB = 2, w0 the gate's weights, w1 up's).
template <int NB>
__global__ void __launch_bounds__(sg::THREADS, 1)
split_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w0,
                  const __grid_constant__ CUtensorMap map_w1,
                  float* __restrict__ out, int M, int K, int N) {
  using namespace hopper;
  constexpr int WN = sg::BN / NB;  // output columns a tile owns
  constexpr int STAGES = sg::STAGES;
  const int n_col = (N + WN - 1) / WN;
  const int tiles = ((M + sg::BM - 1) / sg::BM) * n_col;
  const int nk = (K + sg::BK - 1) / sg::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + sg::BAR);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], sg::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages this block has loaded, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = (tile / n_col) * sg::BM, n0 = (tile % n_col) * WN;
        // weight boxes that start inside N (the rest are never stored)
        const int na = min(WN / 64, (N - n0 + 63) / 64);
        const uint32_t bytes = sg::A_BYTES + NB * na * sg::B_ATOM;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          uint8_t* st = sm + s * sg::STAGE;
          mbar_expect_tx(&full[s], bytes);
          tma_load_2d(st, &map_x, &full[s], kt * sg::BK, row0);
          for (int p = 0; p < NB; ++p)
            for (int a = 0; a < na; ++a)
              tma_load_2d(st + sg::A_BYTES + (p * (WN / 64) + a) * sg::B_ATOM,
                          p ? &map_w1 : &map_w0, &full[s], n0 + 64 * a,
                          kt * sg::BK);
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1, tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
    const int r = 64 * cw + 16 * warp + g;  // the thread's first tile row
    float acc[NB][WN / 2], part[NB][WN / 2];
    uint32_t fa[3][4], fb[3][4];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / n_col) * sg::BM, n0 = (tile % n_col) * WN;
#pragma unroll
      for (int p = 0; p < NB; ++p)
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) acc[p][i] = 0.f;
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      load_split(sm + (it % STAGES) * sg::STAGE + r * 128, 0, g, t, fa);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const uint8_t* st = sm + (it % STAGES) * sg::STAGE;
        mma_step<NB>(part, fa, st + sg::A_BYTES, 0, true);
        load_split(st + r * 128, 1, g, t, fb);
        mma_step<NB>(part, fb, st + sg::A_BYTES, 1, false);
        wgmma_wait<1>();  // the first step is done: fa is free
        keep(fa);
        if (kt + 1 < nk) {
          const int s1 = (it + 1) % STAGES;
          mbar_wait(&full[s1], ((it + 1) / STAGES) & 1);
          load_split(sm + s1 * sg::STAGE + r * 128, 0, g, t, fa);
        }
        wgmma_wait<0>();  // the stage's partial is done: fb, stage free
        keep(fb);
#pragma unroll
        for (int p = 0; p < NB; ++p) fence_regs(part[p]);
        mbar_arrive(&empty[it % STAGES]);
#pragma unroll
        for (int p = 0; p < NB; ++p)
#pragma unroll
          for (int i = 0; i < WN / 2; ++i) acc[p][i] += part[p][i];
      }

      // element (row 16 warp + g + 8 h, column 8 c + 2 t + j) is
      // acc[p][4 c + 2 h + j]
      const int row = row0 + r;
#pragma unroll
      for (int c = 0; c < WN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * t;
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row + 8 * h >= M) continue;
          float2 v;
          if constexpr (NB == 2) {
            v.x = silu(acc[0][4 * c + 2 * h]) * acc[1][4 * c + 2 * h];
            v.y = silu(acc[0][4 * c + 2 * h + 1]) * acc[1][4 * c + 2 * h + 1];
          } else {
            v.x = acc[0][4 * c + 2 * h];
            v.y = acc[0][4 * c + 2 * h + 1];
          }
          *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * N + col) =
              v;
        }
      }
    }
  }
}

template <int NB>
int launch(const void* x, const void* w0, const void* w1, void* out, int M,
           int K, int N, cudaStream_t stream) {
  CUtensorMap mx, mw0, mw1;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t sx[1] = {(uint64_t)K * 4};
  const uint32_t bx[2] = {sg::BK, sg::BM};
  const uint64_t dw[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t sw[1] = {(uint64_t)N * 2};
  const uint32_t bw[2] = {64, sg::BK};
  int err = hopper::encode_sw128_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x,
                                     2, dx, sx, bx);
  if (!err) err = hopper::encode_bf16_map(&mw0, w0, 2, dw, sw, bw);
  if (!err) err = hopper::encode_bf16_map(&mw1, w1, 2, dw, sw, bw);
  if (err) return err;
  constexpr int WN = sg::BN / NB;
  const long long tiles =
      (long long)((M + sg::BM - 1) / sg::BM) * ((N + WN - 1) / WN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto kern = split_gemm_kernel<NB>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sg::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, sg::THREADS, sg::BYTES, stream>>>(
      mx, mw0, mw1, static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// What the TMA maps take: fp32 rows of K and bf16 rows of N a whole number
// of 16 bytes (K and N multiples of 8), M >= 1.
bool takes(int M, int K, int N) {
  return M >= 1 && K >= 8 && N >= 8 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

// h (M, N) fp32 = SiLU(x @ w_gate) * (x @ w_up); x (M, K) fp32, w_gate and
// w_up (K, N) bf16, all contiguous and 16-byte aligned. Returns a
// cudaError_t.
extern "C" int split_gemm_gate_up_launch(const void* x, const void* w_gate,
                                         const void* w_up, void* h, int M,
                                         int K, int N, void* stream) {
  if (!takes(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch<2>(x, w_gate, w_up, h, M, K, N,
                   static_cast<cudaStream_t>(stream));
}

// y (M, N) fp32 = x @ w; x (M, K) fp32, w (K, N) bf16.
extern "C" int split_gemm_matmul_launch(const void* x, const void* w, void* y,
                                        int M, int K, int N, void* stream) {
  if (!takes(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch<1>(x, w, w, y, M, K, N, static_cast<cudaStream_t>(stream));
}
