// Pieces shared by the port's top-k scans (topk_int4.cu, topk_int4_gather.cu,
// topk_dense.cu, and the scan tile of topk_tile.cuh): the (score, id) order,
// the nibble decode, the sorted-list insert, the warp-wide merge, and the
// pass-2 merge of the partial lists that pass 1 of every scan writes.
//
// The int4 scan contract. Every int4 scan scores a bank row as follows, so
// that the IVF pruned scan (gathered ids, topk_int4_gather.cu) and the
// exhaustive scan (the register-blocked tile of topk_tile.cuh) return the
// same float for the same row, and pruning can only drop rows, never
// re-score them (chip_smoke.py's check_gathered holds the two kernels to
// torch.equal on one shared candidate set):
//   * acc = one fmaf chain per (query, row) in element order e = 0 .. E-1,
//     starting from 0, of query value times the UNSCALED nibble value
//     (nib2f's value; topk_int4_gather.cu's nib_at gives the same float by
//     another decode); zeros past E may be added (they change nothing);
//   * score = acc * sr, sr the row's scale, one multiply;
//   * with `normalize` (the exhaustive scan only): the query values are
//     q * rsqrt(max(ss_q, 1e-16)) rounded once before the chain, ss_q one
//     lane-strided fmaf chain per lane of a warp over the row (lane l: e = l,
//     l + 32, ...) then a butterfly of adds (offsets 16 .. 1); the row's
//     nibble sum of squares ss is one fmaf chain in element order; score =
//     acc * sr * rsqrt(max(sr * sr * ss, 1e-16)), left to right.
// A kernel that changes this order changes the bits: change both scans.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 64;

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// Signed nibble (two's complement, 4 bits) to float without I2F:
// (n ^ 8) = n + 8 in [0, 15] sits in the mantissa of 2^23.
__device__ __forceinline__ float nib2f(unsigned n) {
  return __int_as_float(0x4B000000u | (n ^ 8u)) - 8388616.0f;
}

// One thread inserts (s, id) into a sorted list of cnt <= k entries.
__device__ inline void list_insert(float* ls, int* li, int* cnt, int k,
                                   float s, int id) {
  int c = *cnt;
  if (c == k && !better(s, id, ls[k - 1], li[k - 1])) return;
  int pos = c < k ? c : k - 1;
  while (pos > 0 && better(s, id, ls[pos - 1], li[pos - 1])) {
    ls[pos] = ls[pos - 1];
    li[pos] = li[pos - 1];
    --pos;
  }
  ls[pos] = s;
  li[pos] = id;
  if (c < k) *cnt = c + 1;
}

// A whole warp merges n candidates into one list; get(j, s, id) reads
// candidate j and returns whether it is live. All 32 lanes must call it.
template <typename Get>
__device__ void warp_merge(int n, Get get, float* ls, int* li, int* cnt,
                           int k) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    float s = -INFINITY;
    int id = INT_MAX;
    bool live = j < n && get(j, s, id);
    // a stale threshold only lets more candidates through; insertion
    // re-checks against the current list
    const int c = *cnt;
    bool cand = live && (c < k || better(s, id, ls[k - 1], li[k - 1]));
    unsigned m = __ballot_sync(0xffffffffu, cand);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float ss = __shfl_sync(0xffffffffu, s, src);
      const int ii = __shfl_sync(0xffffffffu, id, src);
      if (lane == 0) list_insert(ls, li, cnt, k, ss, ii);
      __syncwarp();
    }
  }
}

// Pass 2: one warp per query merges its n_parts partial lists (k entries
// each, (Q, n_parts, k), unused slots id INT_MAX) into the final sorted
// top-k. Slots left empty (fewer than k live rows) get score -1e30 and, with
// dead_id_minus_one, id -1 (the gathered scan's sentinel pair); otherwise
// ids n_valid, n_valid + 1, ... (where a stable descending sort of the
// masked rows puts them).
constexpr int P2_WARPS = 4;

__global__ void __launch_bounds__(P2_WARPS * 32)
topk_pass2(const float* __restrict__ part_s, const int* __restrict__ part_i,
           float* __restrict__ out_s, int* __restrict__ out_i, int Q, int k,
           int n_parts, int n_valid, int dead_id_minus_one) {
  __shared__ float ls[P2_WARPS][KMAX];
  __shared__ int li[P2_WARPS][KMAX];
  __shared__ int cnt[P2_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * P2_WARPS + warp;
  if (qi >= Q) return;  // warp-uniform; no block barrier follows
  if (lane == 0) cnt[warp] = 0;
  __syncwarp();
  const float* cs = part_s + (size_t)qi * n_parts * k;
  const int* ci = part_i + (size_t)qi * n_parts * k;
  warp_merge(n_parts * k,
             [&](int j, float& s, int& id) {
               s = cs[j];
               id = ci[j];
               return id != INT_MAX;
             },
             ls[warp], li[warp], &cnt[warp], k);
  __syncwarp();
  const int c = cnt[warp];
  for (int j = lane; j < k; j += 32) {
    const bool have = j < c;
    out_s[(size_t)qi * k + j] = have ? ls[warp][j] : -1e30f;
    out_i[(size_t)qi * k + j] =
        have ? li[warp][j] : (dead_id_minus_one ? -1 : n_valid + (j - c));
  }
}

inline cudaError_t launch_pass2(const float* part_s, const int* part_i,
                                float* out_s, int* out_i, int Q, int k,
                                int n_parts, int n_valid,
                                int dead_id_minus_one, cudaStream_t stream) {
  topk_pass2<<<(Q + P2_WARPS - 1) / P2_WARPS, P2_WARPS * 32, 0, stream>>>(
      part_s, part_i, out_s, out_i, Q, k, n_parts, n_valid,
      dead_id_minus_one);
  return cudaGetLastError();
}

}  // namespace
