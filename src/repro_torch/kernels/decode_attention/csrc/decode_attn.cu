// Flash-decoding for Hopper: one query token per sequence against a KV cache,
// bf16 or f32.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py
// ::_decode_kernel (entry decode_fwd_pallas). The JAX package's decode step
// reaches the same function through its XLA reference; the port's decode
// step runs this kernel.
//
// Function: q (B, H, D), k/v (B, S, KV, D) in the model's cache layout,
// lengths (B,) int32. GQA: the G = H / KV query heads of kv head h read it
// together. Positions p with p < length (and p > length - 1 - window when
// window > 0) are valid. A sequence with no valid position gets the
// reference's answer: every position masked to -1e30, a uniform softmax over
// all S. Scores, softmax and P.V run in fp32 (P is never rounded); the
// output is in q's dtype.
//
// What bounds it on the H100: each cache byte is read once. A K element
// feeds G products (G = 6 for qwen2, 8 for qwen3-moe) and a V element G
// FMAs, far under the ~20 operations a byte at which fp32 FMA would bind, so
// the cache read bounds it: (2 * sum_b valid_b * KV * D + B * H * D) * bytes
// / 3.35e12. The work is keeping enough bytes in flight on every SM, with
// little enough issue work per byte that the copies never wait on the math.
//
// Design: a stream over each sequence's valid range, two passes.
//   * pass 1: one block of 128 threads per (split, kv head, sequence). The
//     sequence's valid range [max(0, length - window), min(length, S)) is
//     cut on the device into n_split equal splits, so positions outside it
//     (the unfilled cache, keys before the window) are never read and the
//     host never syncs on lengths. The split count (kernel.py::n_splits) is
//     a pure function of (B, KV, S, SM count): about four waves of blocks,
//     so that sequences of unequal length even out, but no split of a full
//     cache under 16 tiles. On the device no split takes fewer than
//     MIN_CHUNK = 128 keys: a short sequence leaves its last splits empty.
//   * the split's keys come in tiles of 32 rows of K and V that every
//     thread brings with 16-byte cp.async copies into a shared-memory ring
//     of 3 stages (17 KB each at bf16, D = 128; rows padded by 16 bytes, so
//     the reads below are conflict-free): tiles t + 1 and t + 2 are in
//     flight while tile t is scored, four blocks an SM: up to 139 KB an SM.
//     f32 caches (a side case no model runs) take the same kernel with 2
//     stages of 33 KB, two blocks an SM. Rows past the split read as 0.
//   * scores, bf16: on the tensor cores (mma.sync m16n8k16: the G query
//     rows, zero-padded to 16, against 8 keys; bf16 products are exact and
//     the sums fp32), warp w taking keys 8w .. 8w + 7 over all of D. f32:
//     SIMT FMAs, warp w a quarter of D, lane j key j, the four partial sums
//     added in the softmax.
//   * softmax: warp w runs the online softmax of heads w and w + 4 (one max
//     reduction a head and tile; m is uniform in the warp, so l stays a
//     per-lane partial until the end) and writes p (fp32, never rounded) and
//     the rescale factor to shared memory.
//   * P.V: SIMT FMAs in fp32 (tensor cores would round P to bf16). Each
//     thread owns 16 bytes of D (8 bf16 or 4 f32 dims) for every head and a
//     key group; V comes from the ring in full 16-byte vectors, p as float4
//     broadcasts; the rescale is skipped when the max did not move.
//   * two block barriers a tile: after the scores (the stage of tile t - 1
//     is then free for tile t + 2), and after the softmax (each thread has
//     waited for its copies of tile t + 1 before it).
//   * the split's (m, l, acc) go to global scratch; pass 2
//     (decode_merge_kernel, one warp per (b, h)) rescales the splits and
//     writes the output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <atomic>

#include "../../hopper.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;  // bf16 8-key score tiles, f32 D quarters
constexpr int GMAX = 8;               // query heads per kv head
constexpr int BT = 32;                // keys per tile, one per lane
constexpr int MIN_CHUNK = 128;        // least keys a split takes (4 tiles)
constexpr float NEG = -1e30f;         // the reference's masked score
static_assert(GMAX == 2 * NWARPS, "a warp's softmax takes two heads");

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements of shared memory as floats, in 16-byte vectors
// (p 16-byte aligned).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  static_assert(N % 4 == 0, "f32: whole float4s");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    o[i] = t.x; o[i + 1] = t.y; o[i + 2] = t.z; o[i + 3] = t.w;
  }
}
template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float* o) {
  static_assert(N % 8 == 0, "bf16: whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[i + 2 * j] = f.x; o[i + 2 * j + 1] = f.y;
    }
  }
}

template <typename T, int D>
struct Cfg {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int STAGES = BF16 ? 3 : 2;
  static constexpr int MIN_BLOCKS = BF16 ? 4 : 2;     // an SM: shared memory
  static constexpr int RS = D + 16 / (int)sizeof(T);  // ring row stride, +16 B
  static constexpr int CPR = D * (int)sizeof(T) / 16; // 16-byte chunks a row
  static constexpr int NPART = BF16 ? 1 : NWARPS;     // score partials a key
  static constexpr int DS = D / NWARPS;                // f32 score dims a thread
  static constexpr int VW = 16 / (int)sizeof(T);       // P.V dims a thread
  static constexpr int DG = D / VW;                    // P.V dim groups
  static constexpr int KG = THREADS / DG;              // P.V key groups
  static constexpr size_t RING = (size_t)STAGES * 2 * BT * RS * sizeof(T);
  static constexpr int QS = BF16 ? D / 2 + 4 : D;  // query row stride, words
  static constexpr size_t SMEM =
      RING + sizeof(float) * (GMAX * QS + NPART * GMAX * BT + BT * GMAX + GMAX);
  static_assert(D % 16 == 0 && DG <= 32 && 32 % DG == 0,
                "unsupported head dim");
  static_assert(RING >= sizeof(float) * NWARPS * GMAX * D,
                "the epilogue's reduction reuses the ring");
  static_assert(BT == 8 * NWARPS, "bf16 scores: a warp per 8-key n-tile");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc,
                    float2* __restrict__ part_ml, int S, int H, int KV,
                    int n_split, int window, float scale) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                  // STAGES x {K, V} x BT x RS
  float* sp = reinterpret_cast<float*>(smem + C::RING);  // NPART x GMAX x BT
  float* ps = sp + C::NPART * GMAX * BT;                 // BT x GMAX
  float* al = ps + BT * GMAX;                            // GMAX
  float* qs = al + GMAX;  // GMAX query rows (f32 values; bf16 pairs as words)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;

  const int len = lengths[b];
  int lo = window > 0 ? max(0, len - window) : 0;
  int hi = min(len, S);
  const bool all_masked = lo >= hi;
  if (all_masked) { lo = 0; hi = S; }
  // no split under MIN_CHUNK keys: a short sequence leaves splits empty
  const int chunk = max((hi - lo + n_split - 1) / n_split, MIN_CHUNK);
  const int start = lo + split * chunk;
  const int end = min(hi, start + chunk);
  if (start >= end) {  // an empty split (block-uniform): weight 0 in the merge
    if (tid < G)
      part_ml[(head0 + tid) * n_split + split] = make_float2(-INFINITY, 0.f);
    return;
  }
  const int n_tiles = (end - start + BT - 1) / BT;

  // Tile t of the split: every thread copies 16-byte chunks of K and V
  // rows; rows past the split read as 0. One cp.async group a tile.
  const size_t seq0 = (size_t)b * S;
  auto load = [&](int t) {
    T* kd = ring + (size_t)(t % C::STAGES) * 2 * BT * C::RS;
    T* vd = kd + BT * C::RS;
    const int p0 = start + t * BT;
    for (int c = tid; c < BT * C::CPR; c += THREADS) {
      const int r = c / C::CPR, off = (c % C::CPR) * (16 / (int)sizeof(T));
      const bool live = p0 + r < end;
      const size_t g = ((seq0 + (live ? p0 + r : 0)) * KV + kvh) * D + off;
      hopper::cp_async16(kd + r * C::RS + off, k + g, live ? 16 : 0);
      hopper::cp_async16(vd + r * C::RS + off, v + g, live ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) {
    if (t < n_tiles) load(t);
    hopper::cp_async_commit();
  }

  // the G query rows in shared memory, rows G .. GMAX - 1 zero: bf16 as
  // element pairs (a row stride of D / 2 + 4 words keeps the fragment
  // reads below conflict-free), f32 as they are
  constexpr int QW = C::BF16 ? D / 2 : D;  // words of a query row
  for (int i = tid; i < GMAX * QW; i += THREADS) {
    const int g = i / QW, c = i % QW;
    float x = 0.f;
    if (g < G) {
      if constexpr (C::BF16)
        x = __uint_as_float(
            reinterpret_cast<const uint32_t*>(q + (head0 + g) * D)[c]);
      else
        x = q[(head0 + g) * D + c];
    }
    qs[g * C::QS + c] = x;
  }
  hopper::cp_async_wait<C::STAGES - 2>();
  __syncthreads();  // tile 0 and the query rows in for every thread

  // softmax state of heads warp and warp + NWARPS (this warp's)
  float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};
  // P.V: dims dg * VW .. + VW of every head, keys kg, kg + KG, ...
  const int dg = tid % C::DG, kg = tid / C::DG;
  float acc[GMAX][C::VW];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < C::VW; ++e) acc[g][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const T* kt = ring + (size_t)(t % C::STAGES) * 2 * BT * C::RS;
    const T* vt = kt + BT * C::RS;
    const int nk = min(BT, end - start - t * BT);

    if constexpr (C::BF16) {
      // scores on the tensor cores (bf16 products are exact, fp32 sums):
      // warp w takes keys 8w .. 8w + 7 over all of D
      // (A: query rows 0 .. 7 from shared memory, rows 8 .. 15 zero)
      const int gr = lane >> 2, tw = lane & 3;
      const uint32_t* kw =
          reinterpret_cast<const uint32_t*>(kt + (8 * warp + gr) * C::RS);
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs + gr * C::QS);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {  // words hold element pairs
        const int w = ks * 8 + tw;
        const uint32_t a[4] = {qw[w], 0u, qw[w + 4], 0u};
        const uint32_t bb[2] = {kw[w], kw[w + 4]};
        hopper::mma_bf16(c, a, bb);
      }
      if (gr < G) {  // c[0..1]: head gr, keys 8w + 2 tw, + 1
        sp[gr * BT + 8 * warp + 2 * tw] = c[0];
        sp[gr * BT + 8 * warp + 2 * tw + 1] = c[1];
      }
    } else {  // f32: key `lane`, dims warp * DS .. + DS, on the FMA units
      const T* kr = kt + lane * C::RS + warp * C::DS;
      const float* qq = qs + warp * C::DS;  // row stride QS = D
      float s[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
#pragma unroll
      for (int c = 0; c < C::DS; c += 4) {
        float kf[4];
        lds<4>(kr + c, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 a = *reinterpret_cast<const float4*>(qq + g * D + c);
            s[g] = fmaf(a.x, kf[0], s[g]);
            s[g] = fmaf(a.y, kf[1], s[g]);
            s[g] = fmaf(a.z, kf[2], s[g]);
            s[g] = fmaf(a.w, kf[3], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) sp[(warp * GMAX + g) * BT + lane] = s[g];
    }
    __syncthreads();  // scores in; every thread is done with tile t - 1
    if (t + C::STAGES - 1 < n_tiles) load(t + C::STAGES - 1);
    hopper::cp_async_commit();

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {  // online softmax, key `lane`
      const int g = warp + NWARPS * h2;
      if (g < G) {  // warp-uniform: every lane takes the shuffles
        float sg = 0.f;
#pragma unroll
        for (int w = 0; w < C::NPART; ++w) sg += sp[(w * GMAX + g) * BT + lane];
        // keys past the split weigh exactly 0; masked keys score -1e30
        sg = lane >= nk ? -INFINITY : (all_masked ? NEG : sg * scale);
        float mx = sg;
#pragma unroll
        for (int off = 16; off; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m2[h2], mx);  // finite: key 0 is in range
        const float alpha = expf(m2[h2] - m_new);
        const float p = expf(sg - m_new);
        l2[h2] = l2[h2] * alpha + p;
        m2[h2] = m_new;
        ps[lane * GMAX + g] = p;
        if (lane == 0) al[g] = alpha;
      }
    }
    hopper::cp_async_wait<C::STAGES - 2>();  // this thread's copies of t + 1
    __syncthreads();  // p and the rescale factors in; tile t + 1 landed

    {  // P.V on the FMA units, p in fp32
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float a = g < G ? al[g] : 1.f;
        if (a != 1.f) {  // block-uniform: skipped once the max settles
#pragma unroll
          for (int e = 0; e < C::VW; ++e) acc[g][e] *= a;
        }
      }
#pragma unroll 2
      for (int j = kg; j < nk; j += C::KG) {
        float vf[C::VW];
        lds<C::VW>(vt + j * C::RS + dg * C::VW, vf);
        const float4 p0 = *reinterpret_cast<const float4*>(ps + j * GMAX);
        const float4 p1 = *reinterpret_cast<const float4*>(ps + j * GMAX + 4);
        const float pj[GMAX] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) {
#pragma unroll
            for (int e = 0; e < C::VW; ++e) acc[g][e] = fmaf(pj[g], vf[e], acc[g][e]);
          }
      }
    }
  }

  // ---- the split's (m, l, acc)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int g = warp + NWARPS * h2;
    if (g < G) {
      float l = l2[h2];
#pragma unroll
      for (int off = 16; off; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0)
        part_ml[(head0 + g) * n_split + split] = make_float2(m2[h2], l);
    }
  }
  // sum the key groups: in the warp by shuffles, across warps in shared
  // memory (over the ring: every copy has landed, the last groups are
  // empty, and every read is done)
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) {
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
#pragma unroll
        for (int off = C::DG; off < 32; off <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // NWARPS x GMAX x D
  if (lane < C::DG) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) {
#pragma unroll
        for (int e = 0; e < C::VW; ++e)
          red[(warp * GMAX + g) * D + dg * C::VW + e] = acc[g][e];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red[(w * GMAX + g) * D + d];
    part_acc[((head0 + g) * n_split + split) * D + d] = o;
  }
}

// Pass 2: one warp per (b, h); lane l holds dims l, l + 32, ... The splits
// are read 8 at a time, so that their loads are in flight together.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float2* __restrict__ part_ml, T* __restrict__ out,
                    int BH, int n_split) {
  constexpr int DL = (D + 31) / 32;
  constexpr int U = 8;
  const int lane = threadIdx.x & 31;
  const size_t bh = (size_t)blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (bh >= (size_t)BH) return;  // warp-uniform
  const float2* ml = part_ml + bh * n_split;
  float M = -INFINITY;
  for (int s = lane; s < n_split; s += 32) M = fmaxf(M, ml[s].x);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float num[DL], den = 0.f;
#pragma unroll
  for (int i = 0; i < DL; ++i) num[i] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += U) {
    float2 t[U];
    float a[U][DL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      t[u] = s < n_split ? ml[s] : make_float2(-INFINITY, 0.f);
      // an empty split wrote no acc: its weight below is 0 and acc unused
      const float* p = part_acc + (bh * n_split + min(s, n_split - 1)) * D;
#pragma unroll
      for (int i = 0; i < DL; ++i) a[u][i] = lane + 32 * i < D ? p[lane + 32 * i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t[u].x == -INFINITY) continue;  // an empty split (or past the end)
      const float w = expf(t[u].x - M);
      den = fmaf(w, t[u].y, den);
#pragma unroll
      for (int i = 0; i < DL; ++i) num[i] = fmaf(w, a[u][i], num[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (lane + 32 * i < D)
      out[bh * D + lane + 32 * i] = from_f<T>(num[i] / fmaxf(den, 1e-30f));
}

// The split kernel's dynamic shared memory is above the 48 KB default: set
// once per device (the decode step calls this every layer).
template <typename T, int D>
cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg<T, D>::SMEM);
  if (err == cudaSuccess && bit) done.fetch_or(bit);
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part_acc, void* part_ml, int B, int S, int H,
           int KV, int n_split, int window, float scale,
           cudaStream_t stream) {
  cudaError_t err = allow_smem<T, D>();
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<T, D><<<dim3(n_split, KV, B), THREADS, Cfg<T, D>::SMEM,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc,
      static_cast<float2*>(part_ml), S, H, KV, n_split, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T, D><<<(B * H + NWARPS - 1) / NWARPS, THREADS, 0,
                              stream>>>(
      part_acc, static_cast<const float2*>(part_ml), static_cast<T*>(out),
      B * H, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* lengths, void* out, float* part_acc, void* part_ml,
             int B, int S, int H, int KV, int n_split, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, part_acc, part_ml, B, S, H, KV, n_split, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc: (B, H, n_split, D) f32 scratch; part_ml: (B, H, n_split) float2
// scratch; n_split in [1, 2^31); no split shorter than MIN_CHUNK keys (a
// sequence with fewer valid keys than n_split * MIN_CHUNK leaves splits
// empty). q, k, v 16-byte aligned. Returns a cudaError_t.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* out,
                                  float* part_acc, void* part_ml, int B, int S,
                                  int H, int KV, int D, int is_bf16,
                                  int n_split, int window, float scale,
                                  cudaStream_t stream) {
  if (B < 1 || B > 65535 || S < 1 || KV < 1 || KV > 65535 || H % KV ||
      H / KV > GMAX || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, lengths, out, part_acc,
                                   part_ml, B, S, H, KV, n_split, window,
                                   scale, stream);
  return launch_d<float>(D, q, k, v, lengths, out, part_acc, part_ml, B, S, H,
                         KV, n_split, window, scale, stream);
}
