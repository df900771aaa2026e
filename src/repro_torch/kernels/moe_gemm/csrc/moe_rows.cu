// The MoE layer's row moves between token order and the grouped GEMMs'
// expert-sorted, block-padded order (ops.plan), one kernel each way.
//
// Replaces no TPU kernel: the JAX package's MoE layer dispatches into a
// dense capacity buffer with einsums (repro/models/moe.py). The port's
// torch steps ran these moves as an index_put of an expanded copy of x into
// a zeroed buffer (ops.scatter_rows), a gather back (ops.gather_rows) and a
// batched GEMV of the top-k weights (torch.bmm). Both kernels run the
// plan's inverse permutation, slot_of (A = T * K,) int32: assignment
// a = t * K + k (token t's k-th expert) lives at row slot_of[a] of the
// sorted buffer. Neither uses atomics: each output element is written by
// one thread, so a call gives the same bits twice.
//
// moe_dispatch_rows: xs (T_pad, d) from x (T, d). Row slot_of[t * K + k] =
// x[t] for every k; each expert group's padding rows, from its last real
// row (start + counts[e]) up to its padded end (ends[e]), are zeroed; rows
// from used = ends[E - 1] on are not written (no kernel reads them). Below
// used it is bit for bit ops.scatter_rows: a copy of bytes, so one kernel
// serves every dtype. What bounds it: bytes, T * d read once plus
// (A + padding) * d written, 0.571 ms at T 65,536, K 6, d 2,048 bf16 and
// 3.35 TB/s. Design: one warp a token; each lane reads UNROLL 16-byte
// vectors of the row (a warp-wide 512-byte segment each) and writes each
// to its K rows, so the row is read once and no expanded copy exists. The
// first E blocks zero the padding rows, one block an expert group, a warp
// a row.
//
// moe_combine_rows: y (T, d) from the sorted down output ys (T_pad, d):
// y[t] = sum over k = 0 .. K - 1, in that order, of r(w[t, k]) *
// ys[slot_of[t * K + k]], w (T, K) fp32, r the rounding to ys's dtype (as
// w.to(x.dtype) rounds it), products and sum in fp32 registers, rounded to
// ys's dtype once. What bounds it: bytes, A * d read plus T * d written,
// 0.561 ms at the same shape. Design: one warp a token, a lane a 16-byte
// vector of the row at a time; the K rows' vectors are loaded (up to KCHUNK
// in flight) before they are summed, so a warp has K 512-byte segments in
// flight and no gathered (A, d) copy exists.
//
// Row offsets are 64-bit: T_pad * d * 2 bytes passes 2^31 at the cell's
// shape (1.64 GB).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // tokens (warps) a block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;              // dispatch: vectors a lane holds
constexpr int KCHUNK = 8;              // combine: rows in flight a lane

template <typename V>
__global__ void __launch_bounds__(THREADS)
moe_dispatch_rows(const V* __restrict__ x, const int* __restrict__ slot_of,
                  const int* __restrict__ counts, const int* __restrict__ ends,
                  V* __restrict__ xs, int T, int K, int E, int nv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < E) {  // expert group e's padding rows
    const int e = blockIdx.x;
    const int start = e ? ends[e - 1] : 0;
    const V zero{};
    for (int r = start + counts[e] + warp; r < ends[e]; r += WARPS) {
      V* dst = xs + (size_t)r * nv;
      for (int c = lane; c < nv; c += 32) dst[c] = zero;
    }
    return;
  }
  const int t = ((int)blockIdx.x - E) * WARPS + warp;
  if (t >= T) return;
  const V* src = x + (size_t)t * nv;
  const int* slots = slot_of + (size_t)t * K;
  for (int c0 = lane; c0 < nv; c0 += 32 * UNROLL) {
    V v[UNROLL] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + 32 * u < nv) v[u] = __ldg(src + c0 + 32 * u);
    for (int k = 0; k < K; ++k) {
      V* dst = xs + (size_t)__ldg(slots + k) * nv;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (c0 + 32 * u < nv) dst[c0 + 32 * u] = v[u];
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// N elements of T moved as one value: 16 bytes (uint4), or one element.
template <typename T, int N> struct Vec { uint4 raw; };
template <typename T> struct Vec<T, 1> { T raw; };

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
moe_combine_rows(const T* __restrict__ ys, const int* __restrict__ slot_of,
                 const float* __restrict__ w, T* __restrict__ y, int T_tok,
                 int K, int d) {
  using VT = Vec<T, N>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T_tok) return;
  const int nv = d / N;
  const int* slots = slot_of + (size_t)t * K;
  const float* wt = w + (size_t)t * K;
  const VT* rows = reinterpret_cast<const VT*>(ys);
  VT* out = reinterpret_cast<VT*>(y + (size_t)t * d);
  for (int c = lane; c < nv; c += 32) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KCHUNK) {
      VT r[KCHUNK];
#pragma unroll
      for (int j = 0; j < KCHUNK; ++j)
        if (k0 + j < K) r[j] = rows[(size_t)__ldg(slots + k0 + j) * nv + c];
#pragma unroll
      for (int j = 0; j < KCHUNK; ++j) {
        if (k0 + j < K) {
          const float wk = to_f(from_f<T>(__ldg(wt + k0 + j)));
          const T* e = reinterpret_cast<const T*>(&r[j].raw);
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] = fmaf(wk, to_f(e[i]), acc[i]);
        }
      }
    }
    VT o;
    T* oe = reinterpret_cast<T*>(&o.raw);
#pragma unroll
    for (int i = 0; i < N; ++i) oe[i] = from_f<T>(acc[i]);
    out[c] = o;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename V>
int launch_dispatch(const void* x, const int* slot_of, const int* counts,
                    const int* ends, void* xs, int T, int K, int E,
                    int row_bytes, cudaStream_t stream) {
  const int blocks = E + (T + WARPS - 1) / WARPS;
  moe_dispatch_rows<V><<<blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(x), slot_of, counts, ends, static_cast<V*>(xs), T,
      K, E, row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* ys, const int* slot_of, const float* w,
                   void* y, int T_tok, int K, int d, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int blocks = (T_tok + WARPS - 1) / WARPS;
  if (d % N == 0 && aligned(ys, 16) && aligned(y, 16))
    moe_combine_rows<T, N><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(ys), slot_of, w, static_cast<T*>(y), T_tok, K,
        d);
  else
    moe_combine_rows<T, 1><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(ys), slot_of, w, static_cast<T*>(y), T_tok, K,
        d);
  return (int)cudaGetLastError();
}

}  // namespace

// xs (T_pad, d) from x (T, d) rows of row_bytes bytes (d * the element
// size), slot_of (T * K,), counts and ends (E,) the plan's: token rows to
// their K slots, padding rows zeroed, rows from ends[E - 1] on untouched.
// Moves the widest of 16, 8, 4 or 2 bytes that row_bytes and both pointers
// allow. Returns a cudaError_t.
extern "C" int moe_dispatch_rows_launch(const void* x, const int* slot_of,
                                        const int* counts, const int* ends,
                                        void* xs, int T, int K, int E,
                                        int row_bytes, cudaStream_t stream) {
  if (T < 0 || K < 1 || E < 1 || row_bytes < 2 || row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  auto moves = [&](int b) {
    return row_bytes % b == 0 && aligned(x, b) && aligned(xs, b);
  };
  if (moves(16))
    return launch_dispatch<uint4>(x, slot_of, counts, ends, xs, T, K, E,
                                  row_bytes, stream);
  if (moves(8))
    return launch_dispatch<uint2>(x, slot_of, counts, ends, xs, T, K, E,
                                  row_bytes, stream);
  if (moves(4))
    return launch_dispatch<unsigned int>(x, slot_of, counts, ends, xs, T, K,
                                         E, row_bytes, stream);
  return launch_dispatch<unsigned short>(x, slot_of, counts, ends, xs, T, K,
                                         E, row_bytes, stream);
}

// y (T, d) = each token's K rows of ys (slot_of (T * K,)) weighed by w
// (T, K) fp32 rounded to ys's dtype, summed in fp32 in the order k = 0 ..
// K - 1 and rounded once. ys and y bf16 (is_bf16) or fp32. Returns a
// cudaError_t.
extern "C" int moe_combine_rows_launch(const void* ys, const int* slot_of,
                                       const float* w, void* y, int T, int K,
                                       int d, int is_bf16,
                                       cudaStream_t stream) {
  if (T < 0 || K < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  if (is_bf16)
    return launch_combine<__nv_bfloat16>(ys, slot_of, w, y, T, K, d, stream);
  return launch_combine<float>(ys, slot_of, w, y, T, K, d, stream);
}
