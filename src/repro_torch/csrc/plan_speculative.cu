// Speculative LZ4 sequence parsing for Hopper (sm_90a).
//
// Replaces the Pallas kernel `plan_spec_pallas` (_plan_spec_kernel,
// src/repro/kernels/plan_speculative.py).  Per block (one row of the batch,
// B bytes of which the first n are the compressed payload), for EVERY byte
// offset i: decode a candidate sequence header as if one started at i
// (token nibbles, 0xFF-run literal/match length extensions, literal span,
// 16-bit offset, next-header position, truncation flags), then mark the
// offsets actually reachable from offset 0 through the next-header map.
// Field for field this is `ref.plan_fields_ref`, including the clamped
// reads at min(pos, n - 1) and the run-table read at index n.
//
// Bound: bytes.  The function reads B bytes and n and writes seven int32
// rows of B, 28 B bytes per block, which is nearly all of it.  So the design
// spreads each block over a thread block cluster of CLUSTER CTAs, each of
// which owns one chunk of L offsets (L = B / CLUSTER rounded up to 32) and
// writes that chunk's fields, and keeps every intermediate in shared memory:
//
//  1. Staging.  Every CTA copies the whole block into shared memory (header
//     reads land anywhere below n) and builds the 0xFF-run queries from it:
//     a bitmask of the 0xFF bytes below n (16 bytes per thread) and, per 32-bit
//     word, the index of the next word that is not all 0xFF (a block-wide
//     suffix-min scan over the words).  ffrun[j] = (first offset >= j that
//     is not a 0xFF byte below n) - j is then one masked find-first-set in
//     j's word or, when the rest of that word is 0xFF, one more in the word
//     the index names: a constant number of shared-memory reads, also in an
//     all-0xFF block.  No run table exists in device memory.
//  2. Fields.  The seven fields of each offset of the chunk, as before, with
//     coalesced stores; the chain map jump[i] = i < n ? min(next, n) : i is
//     kept in shared memory, and beside it as int16 relative to the chunk.
//  3. Chain select in segments of SEG offsets, without global rounds.  The
//     chunk's segments are cut among its warps; each warp walks a segment
//     from the top, 32 offsets at a time, and turns the jump map into
//     segment exits (the first node at or past the segment's end on the
//     chain from an offset, or n where the chain ends inside): a jump past
//     the group of 32 reads an exit already final, a jump inside it is
//     resolved by pointer jumping over shuffles.  One pass over the segments
//     from the last composes them into chunk exits.  After a cluster barrier
//     each CTA finds the chain's entry into its chunk by walking the chunk
//     exits of the CTAs before it from offset 0 (at most CLUSTER - 1 reads of
//     distributed shared memory), follows segment exits to the chain's first
//     node in each of its segments, and one thread per segment marks the
//     chain through it.  A chain of 3-byte hops walks SEG / 3 nodes per
//     segment at most.
//
// What bounds it now: the fields' stores, at about the card's memory rate,
// are the largest phase; the segment exits and the pass that composes them
// (one barrier per segment) come next.  Shared memory (about 161 KB at
// B = 65,664) allows one CTA per SM and caps B near 94,000
// (`plan_speculative_max_b`).
//
// Why this marks what the reference marks: the reference marks the offsets
// that offset 0 reaches in fewer than 2^16 hops (16 doubling rounds); this
// kernel marks every offset that offset 0 reaches.  Every hop advances at
// least 3 bytes or ends at the fixed point n, so a node at offset x is
// x / 3 hops from 0 at most, and for B < 3 * 2^16 = 196,608 the two sets are
// the same.
//
// Wider rows (B > plan_speculative_max_b(): caps wider than the engine's
// default, or a corrupt payload that fills them) take a second kernel in
// the same launch, one CTA per row, with every per-offset table in a
// scratch buffer in device memory that the wrapper allocates: the 0xFF
// bitmask and its next-word index (int32), the fields as above, then the
// reference's own 16 doubling rounds of the chain select over two jump maps
// and two mark maps, ping-ponged, one CTA barrier per round.  A round only
// ever sets marks (a scatter of ones from the marks of the round before),
// and the map it writes holds the marks of two rounds before, a subset, so
// no write needs clearing and no two writes disagree.  It equals the plain
// version at any B, also past 196,607.  It is correct, not fast: no engine
// path with the default caps reaches it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 8;        // CTAs per block, one thread block cluster
constexpr int SEG = 512;          // offsets per segment of the chain select
constexpr int MAX_B = 196607;     // B < 3 * 2^16: see the note above
constexpr int SMEM_MAX = 232448;
constexpr int STATIC_SMEM = 1024;  // room left for the static shared arrays

// Where each array sits in dynamic shared memory, for a row of B bytes.
struct Layout {
  int W, L, nseg;  // 32-bit words of the bitmask; offsets and segments per chunk
  size_t ff_off, nxt_off, se_off, ex_off, j_off, mark_off, sege_off, bytes;
};

__host__ __device__ inline Layout layout_of(int B) {
  Layout y;
  y.W = (B + 31) / 32;
  y.L = ((B + CLUSTER - 1) / CLUSTER + 31) & ~31;
  y.nseg = (y.L + SEG - 1) / SEG;
  y.ff_off = 32 * (size_t)y.W;                                 // the block's bytes
  y.nxt_off = y.ff_off + 4 * (size_t)y.W;                      // 0xFF bitmask
  y.se_off = y.nxt_off + ((2 * (size_t)y.W + 15) & ~(size_t)15);  // next-word index
  y.ex_off = y.se_off + 4 * (size_t)y.L;                       // segment exits
  y.j_off = y.ex_off + 4 * (size_t)y.L;                        // chunk exits
  y.mark_off = y.j_off + 2 * (size_t)y.L;                      // chunk-relative jumps
  y.sege_off = y.mark_off + 4 * (size_t)(y.L / 32);            // chain marks
  y.bytes = y.sege_off + 4 * (size_t)y.nseg;                   // segment entries
  return y;
}

// Bit k set where byte k of x is 0xFF: bit 7 of each byte of t is set
// exactly where that byte of ~x is zero (no carry crosses a byte).
__device__ __forceinline__ uint32_t ff_nibble(uint32_t x) {
  const uint32_t y = ~x;
  const uint32_t t = ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y | 0x7f7f7f7fu);
  return (t >> 7 | t >> 14 | t >> 21 | t >> 28) & 0xfu;
}

// First offset >= j that is not a 0xFF byte below n, for 0 <= j < B.
// When j < n the word of n has a clear bit at n, so the word index never
// runs past it; when j >= n bit j itself is clear.
template <typename NxtT>
__device__ __forceinline__ int next_not_ff(const uint32_t* ff, const NxtT* nxt,
                                           int j) {
  int w = j >> 5;
  uint32_t bits = ~ff[w] & (0xffffffffu << (j & 31));
  if (!bits) {
    w = nxt[w];
    bits = ~ff[w];
  }
  return (w << 5) + __ffs(bits) - 1;
}

struct Header {
  int lit_start, lit_len, ls_end, off, mlen, flags, next;
};

// The candidate header at offset i (plan_fields_ref's math, byte for byte).
template <typename NxtT>
__device__ __forceinline__ Header header_at(const uint8_t* blk,
                                            const uint32_t* ff, const NxtT* nxt,
                                            int i, int n, int B) {
  const int nm1 = max(n - 1, 0);
  Header h;
  const int byte = blk[i];
  const int lit_nib = byte >> 4;
  const bool has_lx = lit_nib == 15;
  const int j1 = min(i + 1, B - 1);
  const int r1 = next_not_ff(ff, nxt, j1) - j1;
  const int term1 = i + 1 + r1;
  const int t1b = blk[min(term1, nm1)];
  h.lit_len = has_lx ? r1 * 255 + t1b + 15 : lit_nib;
  h.lit_start = i + 1 + (has_lx ? 1 + r1 : 0);
  h.ls_end = h.lit_start + h.lit_len;
  const int m_nib = byte & 15;
  const bool has_mx = m_nib == 15;
  const int o0 = min(h.ls_end, nm1);
  h.off = blk[o0] | (blk[min(o0 + 1, nm1)] << 8);
  const int j2 = min(h.ls_end + 2, n);
  const int r2 = next_not_ff(ff, nxt, j2) - j2;
  const int term2 = h.ls_end + 2 + r2;
  const int t2b = blk[min(term2, nm1)];
  h.mlen = has_mx ? r2 * 255 + t2b + 19 : m_nib + 4;
  h.next = h.ls_end + 2 + (has_mx ? r2 + 1 : 0);
  h.flags = (int)(has_lx && term1 >= n) | ((int)(has_mx && term2 >= n) << 1);
  return h;
}

// nxt[w] = the first word after w of the 0xFF bitmask that is not all
// 0xFF (W if none): each thread takes a run of words, a suffix-min scan over
// the threads joins them.  All THREADS threads call it; s_warp holds
// THREADS / 32 ints.  Ends with ff read and nxt written, not with a barrier.
template <typename NxtT>
__device__ void next_word_index(const uint32_t* ff, NxtT* nxt, int W, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (W + THREADS - 1) / THREADS;
  const int lo = min(tid * per, W), hi = min(lo + per, W);
  int v = W;
  for (int w = hi - 1; w >= lo; --w)
    if (ff[w] != 0xffffffffu) v = w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, o);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = lane < THREADS / 32 ? s_warp[lane] : W;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(0xffffffffu, x, d);
      if (lane + d < 32) x = min(x, o);
    }
    if (lane < THREADS / 32) s_warp[lane] = x;
  }
  __syncthreads();
  int run = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) run = W;
  if (warp + 1 < THREADS / 32) run = min(run, s_warp[warp + 1]);
  for (int w = hi - 1; w >= lo; --w) {
    nxt[w] = (NxtT)run;
    if (ff[w] != 0xffffffffu) run = w;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
plan_speculative_kernel(const uint8_t* __restrict__ blocks,
                        const int* __restrict__ ns, int* __restrict__ is_start,
                        int* __restrict__ lit_start_o, int* __restrict__ lit_len_o,
                        int* __restrict__ ls_end_o, int* __restrict__ off_o,
                        int* __restrict__ mlen_o, int* __restrict__ flags_o,
                        int B) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_warp[THREADS / 32];
  __shared__ int s_entry;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)m * B;
  const int n = min(max(ns[m], 0), B - 1);  // the caller's precondition
  const Layout y = layout_of(B);
  const int W = y.W;
  const int s = min(rank * y.L, B), e = min(s + y.L, B), len = e - s;  // the chunk
  uint8_t* s_blk = smem;
  uint32_t* s_ff = reinterpret_cast<uint32_t*>(smem + y.ff_off);
  uint16_t* s_nxt = reinterpret_cast<uint16_t*>(smem + y.nxt_off);
  int* s_se = reinterpret_cast<int*>(smem + y.se_off);
  int* s_ex = reinterpret_cast<int*>(smem + y.ex_off);
  int16_t* s_j = reinterpret_cast<int16_t*>(smem + y.j_off);
  uint32_t* s_mark = reinterpret_cast<uint32_t*>(smem + y.mark_off);
  int* s_sege = reinterpret_cast<int*>(smem + y.sege_off);
  const int nseg = y.nseg;

  // -- 1. stage the block; 0xFF bitmask; next-word index ---------------------
  // A row that starts 16-byte aligned (every row where B is a multiple of
  // 16, as on the engine's path) is copied 16 bytes at a time, the rest of
  // it and any other row byte by byte: with byte loads alone the whole
  // kernel takes about 10 % longer at B = 65,664 on an H100.
  const uint8_t* brow = blocks + row;
  int head = 0;  // bytes copied 16 at a time
  if ((reinterpret_cast<uintptr_t>(brow) & 15) == 0) {
    head = B & ~15;
    for (int i = tid; i < (head >> 4); i += THREADS)
      reinterpret_cast<uint4*>(s_blk)[i] = __ldg(reinterpret_cast<const uint4*>(brow) + i);
  }
  for (int i = head + tid; i < B; i += THREADS) s_blk[i] = __ldg(brow + i);
  __syncthreads();
  // The bitmask from 16 staged bytes per thread (two threads per word, joined
  // by a shuffle).  The trip count is a multiple of 32, so every shuffle has
  // all lanes; bytes at or past n, the row's padding among them, are masked.
  for (int q = tid; q < ((2 * W + 31) & ~31); q += THREADS) {
    uint32_t bits = 0;
    if (q < 2 * W) {
      const uint4 v = reinterpret_cast<const uint4*>(s_blk)[q];
      bits = (ff_nibble(v.x) | ff_nibble(v.y) << 4 | ff_nibble(v.z) << 8 |
              ff_nibble(v.w) << 12) << (16 * (q & 1));
    }
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    const int below = n - 16 * q;  // positions of the word below n
    if (!(q & 1) && q < 2 * W)
      s_ff[q >> 1] = below >= 32 ? bits : below <= 0 ? 0u : bits & ((1u << below) - 1u);
  }
  __syncthreads();
  next_word_index(s_ff, s_nxt, W, s_warp);
  __syncthreads();

  // -- 2. the fields of this chunk's offsets; the chain map --------------------
  for (int k = tid; k < len; k += THREADS) {
    const int i = s + k;
    const Header h = header_at(s_blk, s_ff, s_nxt, i, n, B);
    lit_start_o[row + i] = h.lit_start;
    lit_len_o[row + i] = h.lit_len;
    ls_end_o[row + i] = h.ls_end;
    off_o[row + i] = h.off;
    mlen_o[row + i] = h.mlen;
    flags_o[row + i] = h.flags;
    const int jump = i < n ? min(h.next, n) : i;
    s_se[k] = jump;
    s_j[k] = (int16_t)(jump < e ? jump - s : -1);
  }
  for (int w = tid; w < y.L / 32; w += THREADS) s_mark[w] = 0u;
  for (int g = tid; g < nseg; g += THREADS) s_sege[g] = -1;
  __syncthreads();

  // -- 3. chain select -------------------------------------------------------
  // Segment exits, in place over the jump map: one warp per segment of SEG
  // offsets walks it from the top, 32 offsets at a time.  An offset whose
  // jump leaves the segment (or stays put) is resolved at once; one whose
  // jump lands in a later group of 32 reads that offset's exit, already
  // final; one whose jump lands in its own group waits on a later lane,
  // resolved by pointer jumping over shuffles (hops are >= 3 lanes, so at
  // most 11 hops, 4 rounds).
  for (int g = warp; g < nseg; g += THREADS / 32) {
    const int ka = g * SEG, kb = min(ka + SEG, len);
    for (int base = (kb - 1) & ~31; base >= ka; base -= 32) {
      const int k = base + lane;
      int r = 0, t = -1;  // the exit, or the lane whose exit it is
      if (k < kb) {
        const int jump = s_se[k];
        const int jr = jump - s;
        if (jump == s + k || jr >= kb) r = jump;
        else if (jr >= base + 32) r = s_se[jr];
        else t = jr - base;
      }
      while (__any_sync(0xffffffffu, t >= 0)) {
        const int rt = __shfl_sync(0xffffffffu, r, t & 31);
        const int tt = __shfl_sync(0xffffffffu, t, t & 31);
        if (t >= 0) {
          if (tt < 0) r = rt;
          t = tt;
        }
      }
      if (k < kb) s_se[k] = r;
      __syncwarp();
    }
  }
  __syncthreads();
  // Chunk exits from the segment exits, segment by segment from the last:
  // an exit inside the chunk lands in a later segment, whose exits are final.
  for (int g = nseg - 1; g >= 0; --g) {
    const int kb = min((g + 1) * SEG, len);
    for (int k = g * SEG + tid; k < kb; k += THREADS) {
      const int x = s_se[k];
      s_ex[k] = x < e && x - s >= kb ? s_ex[x - s] : x;
    }
    __syncthreads();
  }
  cluster.sync();  // every CTA's chunk exits are final
  if (tid == 0) {
    int cur = 0;  // the chain starts at offset 0
    for (int j = 0; j < rank; ++j) {
      const int sj = min(j * y.L, B), ej = min(sj + y.L, B);
      if (cur >= sj && cur < ej) cur = *cluster.map_shared_rank(&s_ex[cur - sj], j);
    }
    // The chain's first node in each segment of this chunk, by segment exits.
    int k = cur >= s && cur < e ? cur - s : len;
    while (k < len) {
      const int g = k / SEG;
      s_sege[g] = k;
      const int x = s_se[k] - s;
      if (x < (g + 1) * SEG) break;  // the chain ends at n in this segment
      k = x;
    }
  }
  __syncthreads();

  // Mark the chain: one thread per segment walks it from the segment's first
  // node; the segment's mark words are that thread's alone.
  for (int g = tid; g < nseg; g += THREADS) {
    int k = s_sege[g];
    if (k < 0) continue;
    const int kb = min((g + 1) * SEG, len);
    int wi = k >> 5;
    uint32_t word = 0;
    for (;;) {
      if ((k >> 5) != wi) {
        s_mark[wi] = word;
        wi = k >> 5;
        word = 0;
      }
      word |= 1u << (k & 31);
      const int j = s_j[k];
      if (j < 0 || j == k || j >= kb) break;
      k = j;
    }
    s_mark[wi] = word;
  }
  __syncthreads();
  for (int k = tid; k < len; k += THREADS) {
    const int i = s + k;
    is_start[row + i] = i < n ? (int)((s_mark[k >> 5] >> (k & 31)) & 1u) : 0;
  }
  cluster.sync();  // no CTA leaves while another may still read its exits
}


// -- rows wider than shared memory --------------------------------------------

constexpr int CHAIN_ROUNDS = 16;  // the plain version's doubling rounds

// One row's scratch for the wide kernel: the 0xFF bitmask (W uint32), its
// next-word index (W int32), two jump maps (B int32 each) and two mark maps
// (B bytes each), each part 16-byte aligned.
struct WideLayout {
  size_t nxt_off, jump_off, mark_off, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int B) {
  const size_t W = ((size_t)B + 31) / 32;
  WideLayout y;
  y.nxt_off = (4 * W + 15) & ~(size_t)15;
  y.jump_off = y.nxt_off + ((4 * W + 15) & ~(size_t)15);
  y.mark_off = y.jump_off + ((8 * (size_t)B + 15) & ~(size_t)15);
  y.bytes = y.mark_off + ((2 * (size_t)B + 15) & ~(size_t)15);
  return y;
}

// The same fields, one CTA per row, tables in `scratch` (rows of
// wide_layout(B).bytes); the chain select as the plain version runs it.
// Tables written in this launch are read with plain loads (not __ldg):
// a CTA barrier makes its own global stores visible to its threads.
__global__ void __launch_bounds__(THREADS, 1)
plan_speculative_wide_kernel(const uint8_t* __restrict__ blocks,
                             const int* __restrict__ ns, int* __restrict__ is_start,
                             int* __restrict__ lit_start_o, int* __restrict__ lit_len_o,
                             int* __restrict__ ls_end_o, int* __restrict__ off_o,
                             int* __restrict__ mlen_o, int* __restrict__ flags_o,
                             uint8_t* __restrict__ scratch, int B) {
  __shared__ int s_warp[THREADS / 32];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)m * B;
  const int n = min(max(ns[m], 0), B - 1);  // the caller's precondition
  const WideLayout y = wide_layout(B);
  const int W = (B + 31) / 32;
  uint8_t* sc = scratch + (size_t)m * y.bytes;
  uint32_t* ff = reinterpret_cast<uint32_t*>(sc);
  int* nxt = reinterpret_cast<int*>(sc + y.nxt_off);
  int* jump[2] = {reinterpret_cast<int*>(sc + y.jump_off),
                  reinterpret_cast<int*>(sc + y.jump_off) + B};
  uint8_t* mark[2] = {sc + y.mark_off, sc + y.mark_off + B};
  const uint8_t* blk = blocks + row;

  // -- 1. the 0xFF bitmask of the bytes below n; the next-word index ----------
  for (int w = tid; w < W; w += THREADS) {
    uint32_t bits = 0;
    for (int b = 0; b < 32 && 32 * w + b < n; ++b)
      if (blk[32 * w + b] == 0xff) bits |= 1u << b;
    ff[w] = bits;
  }
  __syncthreads();
  next_word_index(ff, nxt, W, s_warp);
  __syncthreads();

  // -- 2. the fields; the jump map and the marks of round 0 -------------------
  for (int i = tid; i < B; i += THREADS) {
    const Header h = header_at(blk, ff, nxt, i, n, B);
    lit_start_o[row + i] = h.lit_start;
    lit_len_o[row + i] = h.lit_len;
    ls_end_o[row + i] = h.ls_end;
    off_o[row + i] = h.off;
    mlen_o[row + i] = h.mlen;
    flags_o[row + i] = h.flags;
    jump[0][i] = i < n ? min(h.next, n) : i;
    mark[0][i] = i == 0;
    mark[1][i] = 0;
  }
  __syncthreads();

  // -- 3. chain select: CHAIN_ROUNDS rounds of mark |= scatter(jump, mark),
  // jump = jump[jump], reading one copy of each map and writing the other ---
  int cur = 0;
  for (int r = 0; r < CHAIN_ROUNDS; ++r) {
    const int* ja = jump[cur];
    int* jb = jump[cur ^ 1];
    const uint8_t* ma = mark[cur];
    uint8_t* mb = mark[cur ^ 1];
    for (int i = tid; i < B; i += THREADS) {
      const int j = ja[i];
      if (ma[i]) {
        mb[i] = 1;
        mb[j] = 1;
      }
      jb[i] = ja[j];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = tid; i < B; i += THREADS)
    is_start[row + i] = i < n ? (int)mark[cur][i] : 0;
}

}  // namespace

// The largest B the shared-memory kernel takes: MAX_B, or less where its
// layout outgrows shared memory (its size grows with B).  Wider rows take
// the wide kernel.
extern "C" int plan_speculative_max_b() {
  int lo = 1, hi = MAX_B;
  while (lo < hi) {
    const int mid = hi - (hi - lo) / 2;
    if (layout_of(mid).bytes + STATIC_SMEM <= (size_t)SMEM_MAX) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Bytes of device scratch a launch of M rows of B bytes needs: 0 where the
// shared-memory kernel takes B.
extern "C" long long plan_speculative_scratch_bytes(int M, int B) {
  if (B <= plan_speculative_max_b()) return 0;
  return (long long)M * (long long)wide_layout(B).bytes;
}

// blocks (M, B) uint8, n (M,) int32 (0 <= n < B) -> seven (M, B) int32 rows
// (is_start, lit_start, lit_len, ls_end, off, mlen, flags).  scratch:
// plan_speculative_scratch_bytes(M, B) bytes, 16-byte aligned (null if 0).
extern "C" int plan_speculative_launch(const void* blocks, const void* n,
                                       void* is_start, void* lit_start,
                                       void* lit_len, void* ls_end, void* off,
                                       void* mlen, void* flags, void* scratch,
                                       int M, int B, void* stream) {
  if (B < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (B > plan_speculative_max_b()) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    plan_speculative_wide_kernel<<<M, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int*)n, (int*)is_start, (int*)lit_start,
        (int*)lit_len, (int*)ls_end, (int*)off, (int*)mlen, (int*)flags,
        (uint8_t*)scratch, B);
    return (int)cudaGetLastError();
  }
  const size_t smem = layout_of(B).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      plan_speculative_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, plan_speculative_kernel, (const uint8_t*)blocks,
                         (const int*)n, (int*)is_start, (int*)lit_start,
                         (int*)lit_len, (int*)ls_end, (int*)off, (int*)mlen,
                         (int*)flags, B);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
