// The register-blocked scan tile shared by the exhaustive scans
// (topk_dense.cu over an fp32 bank, topk_int4.cu over a packed int4 bank):
// a SIMT GEMM tile of queries x bank rows with the top-k fused behind it.
// The two differ only in how a bank slice reaches shared memory as fp32 and
// in the factors a finished dot is multiplied by; that is the bank policy
// `BankT` (DenseBank, Int4Bank below) the pass-1 kernel is a template over.
//
// Pass 1: grid (ceil(Q/BQ), n_chunks), the query blocks of one bank chunk
// adjacent in launch order so they run together and share the chunk through
// L2 (the wrapper, kernel.py, sizes the chunks so that the grid is one wave
// at two blocks an SM). A block of 256 threads owns BQ = 16 * TM queries
// (TM = 6, or 4 when that pads Q less) x BN = 128 bank rows and walks its
// chunk tile by tile; for each tile it walks E in 32-element slices that
// cp.async brings (zero-filled past E, Q and the chunk's live rows) into a
// 2-stage shared-memory ring, one pipeline across tile boundaries. Thread
// (ty, tx) keeps a TM x 8 register tile of scores, rows ty + 16 i, bank rows
// tx + 16 j, fed by LDS.128 fragments along E: 6 + 8 loads for 192 FMAs at
// TM = 6. Such a thread needs no more than 128 registers, so two blocks
// share an SM (16 warps). Each dot is one fmaf chain in element order
// e = 0 .. E-1 (zeros past E add nothing). At a tile's end each warp holds
// whole rows of the score tile (two rows a warp, 16 lanes x 8 columns each)
// and merges them into its rows' sorted top-k lists in shared memory
// without a block barrier: a threshold test, a ballot, one lane inserting
// (topk_common.cuh). The lists are written as per-chunk partials; pass 2
// (topk_common.cuh) merges them. Rows >= n_valid are never read; with
// n_valid < k pass 2 appends them in id order at -1e30, where a stable
// descending sort puts them.
#pragma once

#include "topk_common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid over (bank rows, queries)
constexpr int TN = 8;            // bank rows per thread
constexpr int BN = TX * TN;      // bank rows per tile
constexpr int BK = 32;           // elements of E per slice
constexpr int SK = BK + 4;       // padded fp32 slice row stride (conflict-free)
constexpr int STAGES = 2;
static_assert(BN * 2 == THREADS && BK % 8 == 0, "two threads a bank row");

// Copy `rows` rows x BK floats of slice e0 (rows r0 + i, live while < r_end)
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

// ------------------------------------------------------------ bank policies
//
// A policy owns its shared memory (FLOATS), issues a slice's copies
// (load), turns a landed slice into the fp32 [BN][SK] operand the FMA loop
// reads (operand; it may end with a block barrier), accumulates bank-row
// norms for `normalize` (norm_step, tile_end) and scores a finished dot
// (score).

// fp32 bank (N, E): the slice is the operand. score = acc * rq * bn, the
// query and bank-row norms applied after the dot; a bank row's sum of
// squares comes from its staged slices, two threads a row.
template <bool VEC>
struct DenseBank {
  static constexpr int RING = STAGES * BN * SK;
  static constexpr int FLOATS = RING + BN;
  const float* __restrict__ bank;
  int E;
  float* ring;
  float* bn;  // BN bank-row rsqrt norms of the tile
  float ss;

  __device__ DenseBank(const float* b, int e, float* smem)
      : bank(b), E(e), ring(smem), bn(smem + RING), ss(0.f) {}
  __device__ void load(int st, int t0, int r_end, int e0, int) {
    stage_slice<VEC>(ring + st * BN * SK, bank, BN, t0, r_end, E, e0);
  }
  __device__ const float* operand(int st, int, int, int, float*, int,
                                  const float*, bool) {
    return ring + st * BN * SK;
  }
  __device__ void norm_step(const float* b_s) {
    // thread t: half t % 2 of bank row t / 2's slice
    const float* p = b_s + (threadIdx.x >> 1) * SK + (threadIdx.x & 1) * (BK / 2);
#pragma unroll
    for (int e = 0; e < BK / 2; e += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + e);
      ss = fmaf(u.x, u.x, ss); ss = fmaf(u.y, u.y, ss);
      ss = fmaf(u.z, u.z, ss); ss = fmaf(u.w, u.w, ss);
    }
  }
  __device__ void tile_end(bool normalize, int) {
    if (!normalize) return;
    const float s = ss + __shfl_xor_sync(0xffffffffu, ss, 1);
    if ((threadIdx.x & 1) == 0) bn[threadIdx.x >> 1] = rsqrtf(fmaxf(s, 1e-16f));
    ss = 0.f;
    __syncthreads();
  }
  __device__ float score(float acc, float rq, int col, bool normalize, int) const {
    return acc * rq * (normalize ? bn[col] : 1.f);
  }
};

// Packed int4 bank (N, E/2) int8 + scales (N, 1): a slice is 16 bytes a row.
// cp.async brings the packed bytes (VEC: E % 32 == 0, rows 16-byte aligned;
// otherwise the decode reads the bytes itself) and each row's scale with the
// tile's first slice; after the slice lands every nibble is decoded once
// into an fp32 [BN][SK] slice (nib2f, two threads a row), which the FMA loop
// reads as it reads a dense slice. The score is the scan contract of
// topk_common.cuh: acc * sr (* rn with `normalize`), the query rows already
// normalised in their staged slices, the row's nibble sum of squares one
// fmaf chain in element order (thread t < BN owns row t).
template <bool VEC>
struct Int4Bank {
  static constexpr int RAW = BN * 4;  // floats (16 bytes) a row per stage
  static constexpr int FLOATS = STAGES * RAW + BN * SK + 3 * BN;
  const int8_t* __restrict__ packed;
  const float* __restrict__ scales;
  int E;
  float* raw;   // STAGES x BN x 16 bytes
  float* fs;    // BN x SK decoded slice
  float* sc;    // 2 x BN row scales, by tile parity
  float* rn;    // BN row rsqrt norms (normalize)
  float ss;

  __device__ Int4Bank(const int8_t* p, const float* s, int e, float* smem)
      : packed(p), scales(s), E(e), raw(smem), fs(smem + STAGES * RAW),
        sc(fs + BN * SK), rn(sc + 2 * BN), ss(0.f) {}

  __device__ void load(int st, int t0, int r_end, int e0, int tile) {
    const int tid = threadIdx.x;
    if (tid >= BN) return;
    const int row = t0 + tid;
    const bool live = row < r_end;
    if (VEC) {
      const int8_t* p = live ? packed + (size_t)row * (E / 2) + e0 / 2 : packed;
      hopper::cp_async16(raw + st * RAW + tid * 4, p, live ? 16 : 0);
    }
    if (e0 == 0)
      hopper::cp_async4(sc + (tile & 1) * BN + tid, live ? scales + row : scales,
                        live ? 4 : 0);
  }

  // After the block barrier that made slice g visible: decode it, scale the
  // query slice by the query norms (normalize), barrier.
  __device__ const float* operand(int st, int t0, int r_end, int e0,
                                  float* a_s, int bq, const float* qn,
                                  bool normalize) {
    const int tid = threadIdx.x, r = tid >> 1, h = tid & 1;
    unsigned w0, w1;  // elements 16h .. 16h+7 and 16h+8 .. 16h+15 of the slice
    if (VEC) {
      const uint2 w = *reinterpret_cast<const uint2*>(raw + st * RAW + r * 4 + h * 2);
      w0 = w.x; w1 = w.y;
    } else {  // bytes past the row (E / 2) and dead rows read as 0 (nibbles 0)
      const int E2 = E / 2, b0 = e0 / 2 + h * 8;
      const bool live = t0 + r < r_end;
      const unsigned char* p =
          reinterpret_cast<const unsigned char*>(packed) + (size_t)(t0 + r) * E2;
      unsigned b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        b[i] = live && b0 + i < E2 ? (unsigned)__ldg(p + b0 + i) : 0u;
      w0 = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
      w1 = b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24;
    }
    float* d = fs + r * SK + h * 16;
    // nibble j of a word is element 8 * (word) + j: low nibble = element 2i
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const unsigned w = q4 < 2 ? w0 : w1;
      const int s = (q4 & 1) * 16;
      *reinterpret_cast<float4*>(d + q4 * 4) = make_float4(
          nib2f((w >> s) & 0xFu), nib2f((w >> (s + 4)) & 0xFu),
          nib2f((w >> (s + 8)) & 0xFu), nib2f((w >> (s + 12)) & 0xFu));
    }
    if (normalize) {  // q * rsqrt(|q|^2), rounded as stage-then-scale rounds
      for (int c = tid; c < bq * (BK / 4); c += THREADS) {
        const int i = c / (BK / 4);
        float4* a = reinterpret_cast<float4*>(a_s + i * SK + (c % (BK / 4)) * 4);
        const float r_q = qn[i];
        float4 v = *a;
        v.x = __fmul_rn(v.x, r_q); v.y = __fmul_rn(v.y, r_q);
        v.z = __fmul_rn(v.z, r_q); v.w = __fmul_rn(v.w, r_q);
        *a = v;
      }
    }
    __syncthreads();
    return fs;
  }
  __device__ void norm_step(const float* b_s) {
    if (threadIdx.x >= BN) return;
    const float* p = b_s + threadIdx.x * SK;
#pragma unroll
    for (int e = 0; e < BK; e += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + e);
      ss = fmaf(u.x, u.x, ss); ss = fmaf(u.y, u.y, ss);
      ss = fmaf(u.z, u.z, ss); ss = fmaf(u.w, u.w, ss);
    }
  }
  __device__ void tile_end(bool normalize, int tile) {
    if (!normalize) return;
    if (threadIdx.x < BN) {
      const float sr = sc[(tile & 1) * BN + threadIdx.x];
      rn[threadIdx.x] = rsqrtf(fmaxf(sr * sr * ss, 1e-16f));
    }
    ss = 0.f;
    __syncthreads();
  }
  __device__ float score(float acc, float, int col, bool normalize,
                         int tile) const {
    const float s = acc * sc[(tile & 1) * BN + col];
    return normalize ? s * rn[col] : s;
  }
};

// ------------------------------------------------------------------ pass 1

template <int TM, class BankT>
struct Tile {
  static constexpr int BQ = TY * TM;
  static constexpr int A_STAGE = BQ * SK;  // floats
  static size_t smem_bytes(int k) {
    return sizeof(float) * ((size_t)STAGES * A_STAGE + BankT::FLOATS + BQ +
                            (size_t)BQ * k) +
           sizeof(int) * ((size_t)BQ * k + BQ);
  }
};

// `BankT` is built on the block's shared memory from `args` (its
// constructor's arguments past the shared-memory pointer).
template <int TM, bool AVEC, class BankT, class... Args>
__device__ __forceinline__ void scan_pass1(const float* __restrict__ q,
                                           float* __restrict__ part_s,
                                           int* __restrict__ part_i, int Q,
                                           int E, int k, int n_valid,
                                           int normalize, int chunk_rows,
                                           int n_chunks, float* smem,
                                           Args... args) {
  using T = Tile<TM, BankT>;
  constexpr int BQ = T::BQ;
  float* as = smem;                                 // STAGES x BQ x SK
  BankT bank(args..., as + STAGES * T::A_STAGE);    // BankT::FLOATS
  float* qn = as + STAGES * T::A_STAGE + BankT::FLOATS;  // BQ query norms
  float* ls = qn + BQ;                              // BQ x k sorted scores
  int* li = reinterpret_cast<int*>(ls + BQ * k);    // BQ x k their row ids
  int* cnt = li + BQ * k;                           // BQ list lengths

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
  if (normalize) {  // rsqrt(max(sum x^2, 1e-16)): one lane-strided fmaf
                    // chain per lane, then a butterfly
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
    const int st = g % STAGES, tile = g / nk, e0 = (g % nk) * BK;
    stage_slice<AVEC>(as + st * T::A_STAGE, q, BQ, q0, Q, E, e0);
    bank.load(st, r0 + tile * BN, r1, e0, tile);
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

  // slice g is slice kq of tile `tile`, counted along rather than divided
  for (int g = 0, kq = 0, tile = 0; g < total; ++g) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice g landed for all; slice g - 1's readers done
    if (g + STAGES - 1 < total) load(g + STAGES - 1);
    hopper::cp_async_commit();

    const int t0 = r0 + tile * BN;
    float* a_s = as + (g % STAGES) * T::A_STAGE;
    const float* b_s = bank.operand(g % STAGES, t0, r1, kq * BK, a_s, BQ, qn,
                                    normalize);
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
    if (normalize) bank.norm_step(b_s);
    if (++kq < nk) continue;
    kq = 0;

    // ---- the tile's end: merge this thread's scores into its rows' lists
    bank.tile_end(normalize, tile);
    const int w_ty = (tid / 32) * 2;  // this warp's rows: ty = w_ty, w_ty + 1
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty + TY * i;
      const bool q_live = q0 + row < Q;
      const float rq = qn[row];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + TX * j, id = t0 + col;
        const float s = bank.score(acc[i][j], rq, col, normalize, tile);
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
    ++tile;
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

// Launches pass 1 (`kern`, a __global__ wrapper of scan_pass1 at TM) and
// pass 2.
template <int TM, class BankT, class Kern, class... Args>
cudaError_t launch_scan(Kern kern, const float* q, float* part_s, int* part_i,
                        float* out_s, int* out_i, int Q, int E, int k,
                        int n_valid, int normalize, int chunk_rows,
                        int n_chunks, cudaStream_t stream, Args... args) {
  const size_t smem = Tile<TM, BankT>::smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + Tile<TM, BankT>::BQ - 1) / Tile<TM, BankT>::BQ,
                  n_chunks);
  kern<<<grid, THREADS, smem, stream>>>(q, args..., part_s, part_i, Q, E, k,
                                        n_valid, normalize, chunk_rows,
                                        n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_chunks, n_valid,
                      0, stream);
}

// The query tile: 96 rows unless 64-row tiles pad Q less
// (kernel.py::query_tile mirrors it).
inline bool wide_query_tile(int Q) {
  return (Q + 95) / 96 * 96 <= (Q + 63) / 64 * 64;
}

}  // namespace
