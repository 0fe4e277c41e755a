// Bounded match extension (scheme S2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_match_extend_kernel` / `match_extend_pallas`
// (src/repro/kernels/match_extend.py): given a candidate per position and a
// mask of positions whose 4-byte words already matched, the full match length
//   length(p) = 0                         where ~valid(p)
//             = 4 + e                     otherwise, where e is the number of
//   leading j in [0, max_extra) with block[p+4+j] == block[cand+4+j] and
//   max_extra = clamp(n - LAST_LITERALS - (p + 4), 0, max_match - 4).
//
// The TPU kernel unrolls the max_match - 4 compares with a running
// prefix-AND over a whole tile of positions, the block resident in VMEM.
// Here:
//
//  * The row through L1.  Both sides of every compare read 4-byte words of
//    the row in device memory (the row's aligned words, one or two per
//    unaligned word); a 64 KiB row stays in L1 and L2 while its CTAs work
//    on it.  Copying the whole row into each CTA's shared memory first
//    (every CTA needs all of it: the candidate can be anywhere before p, or
//    anywhere at all where the input is garbage) measured slower at every
//    launch shape tried (PERF.md, section 6), and would cap the width.
//  * Four bytes per compare.  Each side's unaligned word is cut from two
//    aligned words by a funnel shift; the count of equal leading bytes is
//    the first set bit of the XOR / 8.  At max_match 36 that is at most 8
//    steps, stopping at the first mismatch; each step reads one new aligned
//    word per side, and two steps' words are loaded together.  The clamps
//    of the plain version's gathers matter only where a read would leave
//    [0, B): a position whose two ranges (up to the cap, plus the words'
//    spill) lie inside the row takes
//    that loop with no checks; any other (near the row's end, or a garbage
//    `cand`: negative, past the row, near INT_MAX) builds each word byte by
//    byte with every index clamped to [0, B - 1], index sums in 64 bits.
//    Nothing outside the row is read for any input.
//  * Only the valid positions are worked on.  A warp owns 256 positions,
//    eight per lane: `valid` read as 8 bytes, `cand` as two 16-byte loads
//    (skipped where the 8 or 4 positions are all invalid); the lanes list
//    the valid ones in the warp's shared memory in position order (a prefix
//    sum of their counts), share that list out one position per lane at a
//    time, so neighbouring lanes compare neighbouring bytes, write each
//    length over the candidate it replaces, and store their own eight as
//    two 16-byte stores.  Rows whose P is not a multiple of 8 take one position at a
//    time per thread.
//
// Layout: grid (tiles, M), THREADS threads, one group of 8 positions per
// thread: tiles = ceil(P / (8 * THREADS)).
//
// Bound: bytes.  The function reads M * P valid bytes and writes M * P
// int32 lengths; it needs a candidate only where valid, and of each row only
// the bytes its compares reach (at most max_match - 4 per valid position,
// none past n - LAST_LITERALS).  What bounds it now: the compare steps of
// blocks in which every position matches to the cap (one dependent word
// load per side per step).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 8;            // positions per thread, one 32-byte sector of cand
constexpr int WARP_POS = 32 * GROUP;  // positions per warp and step
constexpr int MIN_MATCH = 4;
constexpr int LAST_LITERALS = 5;

// The unaligned word at row byte i (0 <= i, i + 3 < B), from words that
// hold the row from its byte -o on.
__device__ __forceinline__ uint32_t word_at(const uint32_t* src, int o, long long i) {
  const long long k = o + i;
  const uint32_t lo = src[k >> 2];
  const uint32_t hi = (k & 3) ? src[(k >> 2) + 1] : 0u;
  return __funnelshift_r(lo, hi, 8 * (uint32_t)(k & 3));
}

// The four bytes at row indices i..i+3, each clamped to [0, B - 1].
__device__ __forceinline__ uint32_t word_clamped(const uint32_t* src, int o, long long i,
                                                 long long B) {
  if (i >= 0 && i + 3 < B) return word_at(src, o, i);
  const uint8_t* s8 = reinterpret_cast<const uint8_t*>(src) + o;
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long j = max(0LL, min(i + q, B - 1));
    w |= (uint32_t)s8[j] << (8 * q);
  }
  return w;
}

// e: equal leading bytes at p + 4 and c + 4, at most cap.  Where both
// ranges, with the words' spill, lie inside the row (p + cap + 15 <= B and
// the same for c), one new aligned word per side per step, two steps'
// words loaded together, and no checks; elsewhere every byte index clamped.
__device__ __forceinline__ int extension(const uint32_t* src, int o, long long B,
                                         long long p, long long c, int cap) {
  if (c >= 0 && c + cap + 15 <= B && p + cap + 15 <= B) {
    const long long kp = o + p + MIN_MATCH, kc = o + c + MIN_MATCH;
    const uint32_t* a = src + (kp >> 2);
    const uint32_t* b = src + (kc >> 2);
    const uint32_t sa = 8 * (uint32_t)(kp & 3), sb = 8 * (uint32_t)(kc & 3);
    uint32_t a0 = __ldg(a), b0 = __ldg(b);
    for (int e = 0; e < cap; e += 8) {
      a += 2;
      b += 2;
      const uint32_t a1 = __ldg(a - 1), b1 = __ldg(b - 1), a2 = __ldg(a), b2 = __ldg(b);
      const uint32_t d0 = __funnelshift_r(a0, a1, sa) ^ __funnelshift_r(b0, b1, sb);
      if (d0) return min(e + ((__ffs(d0) - 1) >> 3), cap);
      const uint32_t d1 = __funnelshift_r(a1, a2, sa) ^ __funnelshift_r(b1, b2, sb);
      if (d1) return min(e + 4 + ((__ffs(d1) - 1) >> 3), cap);
      a0 = a2;
      b0 = b2;
    }
    return cap;
  }
  int e = 0;
  while (e < cap) {
    const uint32_t d = word_clamped(src, o, p + MIN_MATCH + e, B) ^
                       word_clamped(src, o, c + MIN_MATCH + e, B);
    const int k = d ? (__ffs(d) - 1) >> 3 : 4;
    e = min(e + k, cap);
    if (k < 4) break;
  }
  return e;
}

// The length at a valid position p with candidate c.
__device__ __forceinline__ int length_at(const uint32_t* src, int o, long long B,
                                         long long n, long long p, int c, int max_match) {
  const long long cap = max(0LL, min(n - LAST_LITERALS - (p + MIN_MATCH),
                                     (long long)(max_match - MIN_MATCH)));
  return MIN_MATCH + extension(src, o, B, p, (long long)c, (int)cap);
}

__global__ void __launch_bounds__(THREADS)
match_extend_kernel(const uint8_t* __restrict__ blocks,
                    const int* __restrict__ cand,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ ns, int* __restrict__ out,
                    int B, int P, int max_match, int vec) {
  // Per warp: 256 candidate / length slots (int) and the list of the valid
  // ones (uint8).
  __shared__ __align__(16) int s_buf[WARPS][WARP_POS];
  __shared__ uint8_t s_list[WARPS][WARP_POS];
  const int m = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uintptr_t ra = reinterpret_cast<uintptr_t>(blocks + (size_t)m * B);
  const int o = (int)(ra & 3);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(ra - o);  // the row's words
  const long long n = ns[m];
  const size_t rowp = (size_t)m * P;
  const int groups = (P + GROUP - 1) / GROUP;
  if (!vec) {  // P % 8 != 0 or a row off 16-byte alignment: one position at a time
    for (int gi = blockIdx.x * THREADS + threadIdx.x; gi < groups; gi += gridDim.x * THREADS) {
      const int p0 = gi * GROUP;
      for (int p = p0; p < min(p0 + GROUP, P); ++p) {
        const bool v = valid[rowp + p] != 0;
        out[rowp + p] = v ? length_at(src, o, B, n, p, cand[rowp + p], max_match) : 0;
      }
    }
    return;
  }
  // A warp takes 256 positions (a chunk) at a time, the loop's trip count
  // the same for all its lanes, so shuffles and the list see all 32 lanes.
  int* buf = s_buf[warp];
  uint8_t* list = s_list[warp];
  for (int g0 = blockIdx.x * THREADS + warp * 32; g0 < groups; g0 += gridDim.x * THREADS) {
    const bool mine = g0 + lane < groups;
    const size_t at = rowp + (size_t)(g0 + lane) * GROUP;
    const uint2 v8 = mine ? __ldg(reinterpret_cast<const uint2*>(valid + at)) : make_uint2(0u, 0u);
    // Both candidate loads go out before either is stored.
    const int4 c0 = v8.x ? __ldg(reinterpret_cast<const int4*>(cand + at)) : make_int4(0, 0, 0, 0);
    const int4 c1 = v8.y ? __ldg(reinterpret_cast<const int4*>(cand + at + 4)) : make_int4(0, 0, 0, 0);
    uint32_t bits = 0;  // this lane's valid positions
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      bits |= (uint32_t)((((k < 4 ? v8.x : v8.y) >> (8 * (k & 3))) & 0xffu) != 0) << k;
    reinterpret_cast<int4*>(buf)[2 * lane] = c0;
    reinterpret_cast<int4*>(buf)[2 * lane + 1] = c1;
    // The list of the valid slots (slot = 8 lane + k) in slot order: a
    // prefix sum of the lanes' counts, so that neighbouring lanes take
    // neighbouring positions and their words share cache lines.
    int rank = __popc(bits);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, rank, d);
      if (lane >= d) rank += y;
    }
    const int count = __shfl_sync(0xffffffffu, rank, 31);
    rank -= __popc(bits);
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      if ((bits >> k) & 1u) list[rank++] = (uint8_t)(GROUP * lane + k);
    __syncwarp();
    // One valid position per lane at a time; its length replaces its
    // candidate in buf.
    const long long pw = (long long)g0 * GROUP;
    for (int t = lane; t < count; t += 32) {
      const int slot = list[t];
      buf[slot] = length_at(src, o, B, n, pw + slot, buf[slot], max_match);
    }
    __syncwarp();
    if (mine) {
      int4 l0 = reinterpret_cast<const int4*>(buf)[2 * lane];
      int4 l1 = reinterpret_cast<const int4*>(buf)[2 * lane + 1];
      // Invalid positions hold a candidate or zero: their length is 0.
      if (!(bits & 1u)) l0.x = 0;
      if (!(bits & 2u)) l0.y = 0;
      if (!(bits & 4u)) l0.z = 0;
      if (!(bits & 8u)) l0.w = 0;
      if (!(bits & 16u)) l1.x = 0;
      if (!(bits & 32u)) l1.y = 0;
      if (!(bits & 64u)) l1.z = 0;
      if (!(bits & 128u)) l1.w = 0;
      int4* o4 = reinterpret_cast<int4*>(out + at);
      o4[0] = l0;
      o4[1] = l1;
    }
    __syncwarp();
  }
}

}  // namespace

// blocks (M, B) uint8, cand (M, P) int32, valid (M, P) bool/uint8, ns (M,)
// int32 -> lengths (M, P) int32; B >= 1, max_match >= 4.
extern "C" int match_extend_launch(const void* blocks, const void* cand,
                                   const void* valid, const void* ns, void* out,
                                   int M, int B, int P, int max_match,
                                   void* stream) {
  if (B < 1 || max_match < MIN_MATCH || M < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const int groups = (P + GROUP - 1) / GROUP;
  const int tiles = (groups + THREADS - 1) / THREADS;
  const int vec = (P % GROUP) == 0 && ((uintptr_t)cand & 15) == 0 &&
                  ((uintptr_t)out & 15) == 0 && ((uintptr_t)valid & 7) == 0;
  match_extend_kernel<<<dim3(tiles, M), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int*)cand, (const uint8_t*)valid,
      (const int*)ns, (int*)out, B, P, max_match, vec);
  return (int)cudaGetLastError();
}
