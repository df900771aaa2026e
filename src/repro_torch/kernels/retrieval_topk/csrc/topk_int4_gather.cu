// Fused int4 dequant-and-scan top-k over per-query candidate rows: the IVF
// pruned scan (Hopper).
//
// Replaces the TPU kernel repro/kernels/retrieval_topk/kernel.py
// ::_topk_int4_gather_kernel (entry retrieval_topk_int4_gathered_pallas).
//
// Function: q (Q, E) f32; the bank's packed (N, E/2) int8 nibble rows and
// scales (N, 1) f32; ids (Q, L) int32, each query's candidate bank rows.
// An id < 0 (padding) or >= n_valid (a row past the scanned snapshot) is
// dead. Output: per query the top k (k <= 64) live candidates by raw inner
// product q . (nibbles * scale), descending, ties to the lower row id, as
// (Q, k) f32 scores and (Q, k) int32 global row ids; slots with no live
// candidate hold the sentinel pair (-1e30, -1).
//
// What bounds it on the H100: each live candidate costs one 520-byte read
// (E/2 nibble bytes + scale + id at E = 1024) against 2*E operations, four
// operations per byte: it is bound by bytes (3.35 TB/s), and the rows are
// scattered over the bank, so every read is a separate row. The decode
// comes close behind: at one fmaf chain per (query, row) in element order
// (the int4 scan contract of topk_common.cuh, which keeps the scores bit
// for bit equal to the exhaustive scan's) every nibble costs its own
// instructions, about as many issue slots as the bytes take to arrive.
//
// Design:
//  * grid Q * n_blocks, the blocks of a query side by side: a block of
//    WARPS warps owns one query; the wrapper (kernel.py::gather_blocks)
//    picks n_blocks so that the grid is one wave at the blocks an SM that
//    this kernel's shared memory allows (gather_blocks_per_sm;
//    topk_int4_gather_occupancy reports the card's own count). The query
//    row is staged once in shared memory.
//  * a query's candidates are groups of 32, dealt round-robin over its
//    blocks' warps (group G to block G % n_blocks, warp G / n_blocks %
//    WARPS), so that the -1 padding at the end of a row spreads evenly;
//    a warp scores its groups one candidate a lane, one fmaf chain a lane,
//    and skips the arithmetic of a group with no live candidate.
//    Rows reach the warp through its own 2-stage ring in shared memory:
//    a stage is a 256-byte slice of each of the 32 rows (8 KB), copied
//    with cp.async in whole lines (16 lanes a row, two rows a warp
//    instruction) at a padded row stride of 272 bytes, so that the lane-
//    per-row LDS.128 that reads it is conflict-free. The next slice (of
//    this group, or of the next group, whose ids a lane holds a group
//    ahead) is in flight while the current one is scored: 8 KB a warp,
//    12 warps an SM (three blocks, as the ring's shared memory allows).
//    No block barrier after the query is staged: the warps run free of
//    each other.
//  * positional decode: nibble j (j <= 4) of a 32-bit word is masked in
//    place and xor-ed into the mantissa of a float of exponent 2^(23-4j)
//    (one LOP3, nib_at below), which is then exactly 2^(23-4j) + (n + 8);
//    one FADD leaves n. Nibbles 5..7 take the same after one shift of the
//    word by 20. About 1 1/8 integer op, 1 FADD and 1 FFMA a nibble, with
//    a quarter of a broadcast LDS.128 of the query; the fmaf operands are
//    the nib2f values, so the bits are the contract's. The five xor
//    constants come from shared memory, so that the compiler holds them in
//    registers: with the mask and the constant both immediates a LOP3
//    cannot take them, and it splits the decode into two.
//  * E/2 not a multiple of 16 (rows not 16-byte aligned): each lane reads
//    its row byte by byte from global memory (the byte path; shapes off
//    the serving path only).
//  * the scores of a group go into the warp's sorted list (one ballot per
//    32, topk_common.cuh); each warp's list is one partial, and pass 2
//    (shared) merges a query's n_blocks * WARPS partials and writes the
//    sentinel pair into slots no live candidate filled.
#include "topk_common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 3;          // blocks an SM at E <= 1024
constexpr int SLICE = 256;             // packed bytes of a row per stage
constexpr int CH = SLICE / 16;         // 16-byte chunks per slice
constexpr int RSTRIDE = SLICE + 16;    // padded row stride of a stage
constexpr int STAGE_BYTES = 32 * RSTRIDE;
constexpr int STAGES = 2;              // one stage scored, one landing
static_assert(CH <= 32 && 32 % CH == 0, "whole rows a copy instruction");

// Shared memory of a pass-1 block at width E (kernel.py::gather_smem_bytes
// mirrors it): the query row, the warps' rings, their lists and counts, the
// five decode keys.
inline size_t smem_bytes(int E) {
  const size_t q = ((size_t)E + 3) / 4 * 16;
  return q + (size_t)WARPS * STAGES * STAGE_BYTES +
         (size_t)WARPS * KMAX * (sizeof(float) + sizeof(int)) +
         WARPS * sizeof(int) + 5 * sizeof(unsigned);
}

// The xor constant of nibble J (J <= 4): the exponent of 2^(23-4J) and the
// nibble's sign bit.
template <int J>
__host__ __device__ constexpr unsigned nib_key() {
  return ((127u + 23u - 4u * J) << 23) | (8u << (4 * J));
}

// Signed nibble at bits 4J..4J+3 of x (J <= 4), as nib2f gives it, with
// key = nib_key<J>(): the masked nibble xor 8 is n + 8 in the mantissa
// bits 4J.. of a float whose exponent makes a mantissa step of 2^(4J) worth
// 1, so the float is 2^(23-4J) + n + 8 exactly, and subtracting
// 2^(23-4J) + 8 leaves n.
template <int J>
__device__ __forceinline__ float nib_at(unsigned x, unsigned key) {
  constexpr float BIAS = (float)(1u << (23 - 4 * J)) + 8.0f;
  return __uint_as_float((x & (0xFu << (4 * J))) ^ key) - BIAS;
}

// acc += the nc (<= CH) 16-byte chunks of one staged row slice against the
// query values qv of its elements, one fmaf a nibble in element order;
// key[j] = nib_key<j>().
__device__ __forceinline__ float dot_slice(float acc,
                                           const unsigned char* row,
                                           const float* qv, int nc,
                                           const unsigned (&key)[5]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (c < nc) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(row + c * 16);
      const unsigned words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // nibble j of word w is element 32c + 8w + j of the slice
        const float4 a = *reinterpret_cast<const float4*>(qv + 32 * c + 8 * w);
        const float4 b =
            *reinterpret_cast<const float4*>(qv + 32 * c + 8 * w + 4);
        const unsigned x = words[w], y = x >> 20;
        acc = fmaf(a.x, nib_at<0>(x, key[0]), acc);
        acc = fmaf(a.y, nib_at<1>(x, key[1]), acc);
        acc = fmaf(a.z, nib_at<2>(x, key[2]), acc);
        acc = fmaf(a.w, nib_at<3>(x, key[3]), acc);
        acc = fmaf(b.x, nib_at<4>(x, key[4]), acc);
        acc = fmaf(b.y, nib_at<0>(y, key[0]), acc);
        acc = fmaf(b.z, nib_at<1>(y, key[1]), acc);
        acc = fmaf(b.w, nib_at<2>(y, key[2]), acc);
      }
    }
  }
  return acc;
}

// The byte path's row dot: E/2 bytes read from global memory, low nibble =
// element 2i, the same chain.
__device__ __forceinline__ float dot_row_bytes(
    const float* __restrict__ qs, int E2, const int8_t* __restrict__ prow) {
  float acc = 0.f;
  for (int j = 0; j < E2; ++j) {
    const unsigned byte = (unsigned char)__ldg(prow + j);
    acc = fmaf(qs[2 * j], nib_at<0>(byte, nib_key<0>()), acc);
    acc = fmaf(qs[2 * j + 1], nib_at<1>(byte, nib_key<1>()), acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
topk_int4_gather_pass1(const float* __restrict__ q,
                       const int8_t* __restrict__ packed,
                       const float* __restrict__ scales,
                       const int* __restrict__ ids, float* __restrict__ part_s,
                       int* __restrict__ part_i, int E, int L, int k,
                       int n_valid, int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // E, padded to 16 bytes
  unsigned char* ring = smem + ((size_t)E + 3) / 4 * 16;
  float* ls = reinterpret_cast<float*>(ring + WARPS * STAGES * STAGE_BYTES);
  int* li = reinterpret_cast<int*>(ls + WARPS * KMAX);
  int* cnt = li + WARPS * KMAX;
  unsigned* keys = reinterpret_cast<unsigned*>(cnt + WARPS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qi = blockIdx.x / n_blocks, blk = blockIdx.x - qi * n_blocks;
  const int E2 = E / 2;
  const int* idrow = ids + (size_t)qi * L;

  if (tid < WARPS) cnt[tid] = 0;
  if (tid == 0) {
    keys[0] = nib_key<0>(); keys[1] = nib_key<1>(); keys[2] = nib_key<2>();
    keys[3] = nib_key<3>(); keys[4] = nib_key<4>();
  }
  for (int e = tid; e < E; e += THREADS) qs[e] = q[(size_t)qi * E + e];
  __syncthreads();

  float* wl_s = ls + warp * KMAX;
  int* wl_i = li + warp * KMAX;
  // this warp's groups: g = 0 .. ng-1 is group G = g0 + stride * g, the
  // candidates 32 G .. 32 G + 31
  const int n_groups = (L + 31) / 32;
  const int g0 = blk + n_blocks * warp, stride = n_blocks * WARPS;
  const int ng = g0 < n_groups ? (n_groups - g0 + stride - 1) / stride : 0;
  // a lane's candidate id in group g, -1 if dead or past the warp's groups
  auto load_id = [&](int g) {
    const int j = 32 * (g0 + stride * g) + lane;
    const int id = g < ng && j < L ? __ldg(idrow + j) : -1;
    return id >= 0 && id < n_valid ? id : -1;
  };
  auto merge = [&](float s, int id) {
    warp_merge(32,
               [&](int, float& s_out, int& id_out) {
                 s_out = s;
                 id_out = id;
                 return id >= 0;
               },
               wl_s, wl_i, cnt + warp, k);
  };

  if ((E2 & 15) == 0) {
    const int nchunk = E2 / 16, nsl = (nchunk + CH - 1) / CH;
    const int total = ng * nsl;  // stages of this warp
    unsigned char* wring = ring + warp * STAGES * STAGE_BYTES;
    const unsigned key[5] = {keys[0], keys[1], keys[2], keys[3], keys[4]};
    int id_c = load_id(0), id_n = load_id(1);
    // copy stage t (slice t % nsl of group t / nsl, which is group g or
    // g + 1) into ring slot t % 2: lane copies chunk lane % CH of rows
    // lane / CH + (32 / CH) i
    auto issue = [&](int t, int g) {
      if (t < total) {
        const int gt = t / nsl, s = t - gt * nsl;
        const int idg = gt == g ? id_c : id_n;
        const int c = s * CH + lane % CH;
        unsigned char* dst = wring + (t % STAGES) * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int r = lane / CH + 32 / CH * i;
          const int id = __shfl_sync(0xffffffffu, idg, r);
          if (id >= 0 && c < nchunk)
            hopper::cp_async16(dst + r * RSTRIDE + lane % CH * 16,
                               packed + (size_t)id * E2 + c * 16, 16);
        }
      }
      hopper::cp_async_commit();
    };
    issue(0, 0);
    for (int g = 0, t = 0; g < ng; ++g) {
      const float sr = id_c >= 0 ? __ldg(scales + id_c) : 0.f;
      const bool any_live = __any_sync(0xffffffffu, id_c >= 0);
      float acc = 0.f;
      for (int s = 0; s < nsl; ++s, ++t) {
        hopper::cp_async_wait<0>();
        __syncwarp();  // stage t landed for every lane; stage t - 1 read
        issue(t + 1, g);
        if (any_live)
          acc = dot_slice(acc, wring + (t % STAGES) * STAGE_BYTES +
                                   lane * RSTRIDE,
                          qs + s * CH * 32, min(CH, nchunk - s * CH), key);
      }
      merge(acc * sr, id_c);
      id_c = id_n;
      id_n = load_id(g + 2);
    }
  } else {
    for (int g = 0; g < ng; ++g) {
      const int id = load_id(g);
      const float s =
          id >= 0 ? dot_row_bytes(qs, E2, packed + (size_t)id * E2) *
                        __ldg(scales + id)
                  : -INFINITY;
      merge(s, id);
    }
  }
  __syncwarp();

  const int c = cnt[warp];
  const size_t o =
      ((size_t)qi * n_blocks * WARPS + (size_t)blk * WARPS + warp) * k;
  for (int j = lane; j < k; j += 32) {
    const bool have = j < c;
    part_s[o + j] = have ? wl_s[j] : -INFINITY;
    part_i[o + j] = have ? wl_i[j] : INT_MAX;
  }
}

// Pass 1's shared memory at width E, with the whole carveout for shared
// memory (the blocks an SM holds are counted against it).
inline cudaError_t configure(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_int4_gather_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(topk_int4_gather_pass1,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Blocks of pass 1 an SM holds at width E (kernel.py::gather_blocks_per_sm
// mirrors it; chip_smoke.py holds the two equal).
extern "C" int topk_int4_gather_occupancy(int E, int* blocks) {
  const size_t smem = smem_bytes(E);
  const cudaError_t err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, topk_int4_gather_pass1, THREADS, smem);
}

// part_s / part_i hold (Q, n_parts, k): n_parts must be n_blocks * WARPS,
// one list per warp of every pass-1 block.
extern "C" int topk_int4_gather_launch(const float* q, const int8_t* packed,
                                       const float* scales, const int* ids,
                                       float* part_s, int* part_i,
                                       float* out_s, int* out_i, int Q, int E,
                                       int L, int k, int n_valid, int n_blocks,
                                       int n_parts, cudaStream_t stream) {
  if (k < 1 || k > KMAX || (E & 1) || E < 2 || L < 1 || Q < 1 ||
      n_blocks < 1 || n_parts != n_blocks * WARPS ||
      (long long)Q * n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(E);
  cudaError_t err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  topk_int4_gather_pass1<<<Q * n_blocks, THREADS, smem, stream>>>(
      q, packed, scales, ids, part_s, part_i, E, L, k, n_valid, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass2(part_s, part_i, out_s, out_i, Q, k, n_parts,
                           n_valid, 1, stream);
}
