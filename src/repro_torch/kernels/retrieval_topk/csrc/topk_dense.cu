// Fused dense fp32 scan top-k over a bank slab (Hopper).
//
// Replaces the TPU kernel repro/kernels/retrieval_topk/kernel.py::_topk_kernel
// (entry retrieval_topk_pallas).
//
// Function: q (Q, E) f32, bank (N, E) f32; score = q . b, both sides
// optionally L2-normalised (x * rsqrt(max(sum x^2, 1e-16))); rows >= n_valid
// are masked; output the per-query top k (k <= 64), descending, ties to the
// lower row id, as (Q, k) f32 scores and (Q, k) int32 row ids.
//
// What bounds it on the H100: at Q = 192, N = 2^20, E = 1024 the scan does
// 2*Q*N*E = 4.1e11 fp32 operations against 4.3 GB of bank: fp32 FMA throughput
// (67 TFLOP/s, no tensor cores for fp32: TF32 stays off), not the 3.35 TB/s
// of HBM, provided the bank crosses into the SMs about once and each shared-
// memory load feeds many FMAs.
//
// Design: a register-blocked SIMT GEMM tile with the top-k fused behind it,
// two passes. Pass 1: grid (ceil(Q/BQ), n_chunks), the query blocks of one
// bank chunk adjacent in launch order so they run together and share the
// chunk through L2: at Q = 192 two blocks of BQ = 96 read each chunk, so
// the bank crosses from HBM about once. The wrapper (kernel.py) sizes the
// chunks so that the grid is one wave at two blocks an SM. A block of 256 threads owns
// BQ = 16 * TM queries (TM = 6, or 4 when that pads Q less) x BN = 128 bank
// rows and walks its chunk tile by tile; for each tile it walks E in
// 32-float slices that cp.async brings (16-byte copies, zero-filled past E,
// Q and the chunk's live rows) into a 2-stage shared-memory ring, one
// pipeline across tile boundaries. Thread (ty, tx) keeps a TM x 8 register
// tile of scores, rows ty + 16 i, bank rows tx + 16 j, fed by LDS.128
// fragments along E: 6 + 8 loads for 192 FMAs at TM = 6. Such a thread
// needs no more than 128 registers, so two blocks share an SM (16 warps):
// on the card that beat a 12 x 8 tile at one block an SM, which loads less
// per FMA. For `normalize` the query norms come from a prologue and each
// bank row's sum of squares from its staged slices. At a tile's end each
// warp holds whole rows of the score tile (two rows a warp, 16 lanes x 8
// columns each) and merges them into its rows' sorted top-k lists in shared
// memory without a block barrier: a threshold test, a ballot, one lane
// inserting (topk_common.cuh). The lists are written as per-chunk partials;
// pass 2 (shared, topk_common.cuh) merges them. Rows >= n_valid are never
// read; with n_valid < k pass 2 appends them in id order at -1e30, where a
// stable descending sort puts them. Scores are summed in element order per
// (query, row), the same order for every row.
#include "topk_common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid over (bank rows, queries)
constexpr int TN = 8;            // bank rows per thread
constexpr int BN = TX * TN;      // bank rows per tile
constexpr int BK = 32;           // floats of E per slice
constexpr int SK = BK + 4;       // padded slice row stride (conflict-free)
constexpr int STAGES = 2;
static_assert(BN * 2 == THREADS && BK % 8 == 0, "row norms: 2 threads a row");

template <int TM>
struct Tile {
  static constexpr int BQ = TY * TM;
  static constexpr int A_STAGE = BQ * SK;  // floats
  static constexpr int B_STAGE = BN * SK;
  static size_t smem_bytes(int k) {
    return sizeof(float) * ((size_t)STAGES * (A_STAGE + B_STAGE) + BQ + BN +
                            (size_t)BQ * k) +
           sizeof(int) * ((size_t)BQ * k + BQ);
  }
};

// Copy `rows` rows x 16 floats of slice e0 (rows r0 + i, live while < r_end)
// into a staged slice of stride SK; dead rows and floats past E read as 0.
template <bool VEC>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ src,
                                            int rows, int r0, int r_end,
                                            int E, int e0) {
  if (VEC) {  // E % 4 == 0: rows are 16-byte aligned, BK / 4 chunks a row
    for (int c = threadIdx.x; c < rows * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), e = e0 + (c % (BK / 4)) * 4;
      const bool live = r0 + r < r_end && e < E;
      const float* p = live ? src + (size_t)(r0 + r) * E + e : src;
      hopper::cp_async16(dst + r * SK + e - e0, p, live ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < rows * BK; c += THREADS) {
      const int r = c / BK, e = e0 + c % BK;
      const bool live = r0 + r < r_end && e < E;
      const float* p = live ? src + (size_t)(r0 + r) * E + e : src;
      hopper::cp_async4(dst + r * SK + c % BK, p, live ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
topk_dense_pass1(const float* __restrict__ q, const float* __restrict__ bank,
                 float* __restrict__ part_s, int* __restrict__ part_i, int Q,
                 int E, int k, int n_valid, int normalize, int chunk_rows,
                 int n_chunks) {
  using T = Tile<TM>;
  constexpr int BQ = T::BQ;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                              // STAGES x BQ x SK
  float* bs = as + STAGES * T::A_STAGE;          // STAGES x BN x SK
  float* qn = bs + STAGES * T::B_STAGE;          // BQ query scales
  float* bn = qn + BQ;                           // BN bank-row scales
  float* ls = bn + BN;                           // BQ x k sorted scores
  int* li = reinterpret_cast<int*>(ls + BQ * k); // BQ x k their row ids
  int* cnt = li + BQ * k;                        // BQ list lengths

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int chunk = blockIdx.y;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(r0 + chunk_rows, n_valid);
  const int nk = (E + BK - 1) / BK;
  const int n_tiles = r1 > r0 ? (r1 - r0 + BN - 1) / BN : 0;
  const int total = n_tiles * nk;

  for (int r = tid; r < BQ; r += THREADS) cnt[r] = 0;
  if (normalize) {
    for (int r = tid / 32; r < BQ; r += THREADS / 32) {
      float ss = 0.f;
      if (q0 + r < Q)
        for (int e = lane; e < E; e += 32) {
          const float x = q[(size_t)(q0 + r) * E + e];
          ss = fmaf(x, x, ss);
        }
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) qn[r] = rsqrtf(fmaxf(ss, 1e-16f));
    }
  } else {
    for (int r = tid; r < BQ; r += THREADS) qn[r] = 1.f;
  }

  auto load = [&](int g) {
    const int st = g % STAGES, t0 = r0 + (g / nk) * BN, e0 = (g % nk) * BK;
    stage_slice<VEC>(as + st * T::A_STAGE, q, BQ, q0, Q, E, e0);
    stage_slice<VEC>(bs + st * T::B_STAGE, bank, BN, t0, r1, E, e0);
  };
#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < total) load(g);
    hopper::cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float ss_row = 0.f;  // normalize: see below

  for (int g = 0; g < total; ++g) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice g landed for all; slice g - 1's readers done
    if (g + STAGES - 1 < total) load(g + STAGES - 1);
    hopper::cp_async_commit();

    const float* a_s = as + (g % STAGES) * T::A_STAGE;
    const float* b_s = bs + (g % STAGES) * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(b_s + (tx + TX * j) * SK + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_s + (ty + TY * i) * SK + kk);
      // element by element, so consecutive FMAs are independent
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(lane_of(a[i], c), lane_of(b[j], c), acc[i][j]);
    }
    if (normalize) {  // thread t: half t % 2 of bank row t / 2's slice
      const float* p = b_s + (tid >> 1) * SK + (tid & 1) * (BK / 2);
#pragma unroll
      for (int e = 0; e < BK / 2; e += 4) {
        const float4 u = *reinterpret_cast<const float4*>(p + e);
        ss_row = fmaf(u.x, u.x, ss_row); ss_row = fmaf(u.y, u.y, ss_row);
        ss_row = fmaf(u.z, u.z, ss_row); ss_row = fmaf(u.w, u.w, ss_row);
      }
    }
    if (g % nk != nk - 1) continue;

    // ---- the tile's end: merge this thread's scores into its rows' lists
    const int t0 = r0 + (g / nk) * BN;
    if (normalize) {
      const float ss = ss_row + __shfl_xor_sync(0xffffffffu, ss_row, 1);
      if ((tid & 1) == 0) bn[tid >> 1] = rsqrtf(fmaxf(ss, 1e-16f));
      ss_row = 0.f;
      __syncthreads();
    }
    const int w_ty = (tid / 32) * 2;  // this warp's rows: ty = w_ty, w_ty + 1
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty + TY * i;
      const bool q_live = q0 + row < Q;
      const float rq = qn[row];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + TX * j, id = t0 + col;
        const float s = acc[i][j] * rq * (normalize ? bn[col] : 1.f);
        acc[i][j] = 0.f;
        const int c = cnt[row];
        const bool cand = q_live && id < r1 &&
                          (c < k || better(s, id, ls[row * k + k - 1],
                                           li[row * k + k - 1]));
        unsigned m = __ballot_sync(0xffffffffu, cand);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float s2 = __shfl_sync(0xffffffffu, s, src);
          const int id2 = __shfl_sync(0xffffffffu, id, src);
          const int r2 = w_ty + (src >> 4) + TY * i;
          if (lane == 0) list_insert(ls + r2 * k, li + r2 * k, cnt + r2, k, s2, id2);
          __syncwarp();
        }
      }
    }
  }

  __syncthreads();  // every warp's lists are final
  for (int idx = tid; idx < BQ * k; idx += THREADS) {
    const int i = idx / k, j = idx % k;
    if (q0 + i >= Q) continue;
    const size_t o = ((size_t)(q0 + i) * n_chunks + chunk) * k + j;
    const bool have = j < cnt[i];
    part_s[o] = have ? ls[i * k + j] : -INFINITY;
    part_i[o] = have ? li[i * k + j] : INT_MAX;
  }
}

template <int TM, bool VEC>
cudaError_t launch_pass1(const float* q, const float* bank, float* part_s,
                         int* part_i, int Q, int E, int k, int n_valid,
                         int normalize, int chunk_rows, int n_chunks,
                         cudaStream_t stream) {
  const size_t smem = Tile<TM>::smem_bytes(k);
  auto kern = topk_dense_pass1<TM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + Tile<TM>::BQ - 1) / Tile<TM>::BQ, n_chunks);
  kern<<<grid, THREADS, smem, stream>>>(q, bank, part_s, part_i, Q, E, k,
                                        n_valid, normalize, chunk_rows,
                                        n_chunks);
  return cudaGetLastError();
}

}  // namespace

// chunk_rows must be a multiple of 128 (the tile). The query tile is 96
// rows unless 64-row tiles pad Q less.
extern "C" int topk_dense_launch(const float* q, const float* bank,
                                 float* part_s, int* part_i, float* out_s,
                                 int* out_i, int Q, int E, int k, int n_valid,
                                 int normalize, int chunk_rows, int n_chunks,
                                 cudaStream_t stream) {
  if (k < 1 || k > KMAX || E < 1 || Q < 1 || n_chunks < 1 ||
      n_chunks > 65535 || chunk_rows % BN)
    return (int)cudaErrorInvalidValue;
  const bool wide = (Q + 95) / 96 * 96 <= (Q + 63) / 64 * 64;
  const bool vec = E % 4 == 0;
  cudaError_t err;
#define PASS1(TM, VEC)                                                       \
  launch_pass1<TM, VEC>(q, bank, part_s, part_i, Q, E, k, n_valid, normalize, \
                        chunk_rows, n_chunks, stream)
  if (wide)
    err = vec ? PASS1(6, true) : PASS1(6, false);
  else
    err = vec ? PASS1(4, true) : PASS1(4, false);
#undef PASS1
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_chunks,
                           n_valid, 0, stream);
}
