// Fused single-pass compression datapath for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` / `fused_compress_pallas`
// (src/repro/kernels/fused_compress.py): per position p of a 64 KB block,
//   word(p)  = little-endian 4 bytes at p
//   hash(p)  = (word * 2654435761 mod 2^32) >> (32 - hash_bits)
//   cand(p)  = max{q : hash(q) = hash(p), win(q) < win(p)}   (win = p / pws)
//   length   = 0, or 4 + bounded extension when the 4-byte words match.
//
// What the TPU version does with a sequential grid and a (windows x entries)
// scatter grid per tile has no counterpart here: CUDA blocks run in no order
// and that grid (256 KB at defaults) exceeds a CTA's shared memory.  Instead
// a block is spread over a thread block cluster of C CTAs (CLUSTER at the
// engine's shapes; the wrapper's plan takes fewer where P / C would not be
// a whole number of max(32, pws) positions).  CTA r owns the positions
// [r * P / C, (r + 1) * P / C), whose bounds are window bounds:
//
//   0. stage  : the row up to the last byte this CTA's positions read, into
//               shared memory with 16-byte loads (from L2 after the first
//               CTA's read).  The copy keeps the row's misalignment mod 16.
//   1. walk   : the CTA's positions are cut into `nseg` segments of
//               consecutive windows, one warp each, with a private table
//               (2^hash_bits uint32 entries, initially empty).  A step covers
//               32 positions = 32/pws whole windows, taken in order: the
//               lanes of a window read table[hash] (read-before-write port
//               order, win(q) < win(p), never <=; the earlier windows of the
//               step have written), then store p+1 with a shared-memory
//               atomicMax, which keeps the highest position of a hash group
//               (positions ascend, so the maximum is the latest).  A window
//               wider than a step is read whole, then written.  The
//               segment-local candidate (p+1, 0 = none) stays in shared
//               memory.  A warp stops at the first step past n - 4: nothing
//               after it is valid.
//   2. prefix : the CTA publishes its summary table (the maximum over its
//               segment tables).  After a cluster barrier it folds the
//               summaries of the CTAs before it (distributed shared memory)
//               into an exclusive running maximum over its segment tables,
//               entry by entry: table s becomes the table state at the START
//               of segment s of the whole block.
//   3. match  : four consecutive positions per thread: a position without a
//               segment-local candidate takes its segment's incoming table
//               entry; then the 4-byte compare and the extension, both by
//               words (an unaligned word is a funnel shift of two aligned
//               shared words; the first differing byte of x ^ y is
//               (ffs - 1) / 8), clamped where the byte loop clamps.
//               cand and lengths leave in one 16-byte store each.
//
// Segment-local candidates are uint16 (T) where P <= 65536: a valid p is at
// most n - 4 <= 65532, so p + 1 fits.  For larger P they are uint32 and live
// in the `cand` output row itself (each thread reads its four entries before
// it overwrites them).  Tables that do not fit the shared memory move to a
// device-memory scratch (the wrapper's plan).
//
// Bound: bytes.  The function must read M * B bytes and write 2 * M * P
// int32; there is almost no arithmetic.  Every re-read (four byte streams,
// candidate words, up to max_match - 4 extension bytes) hits shared memory,
// and each output leaves the SM once.
//
// Bytes at index >= n need no masking: every read that can influence an
// output lies below n (valid_pos needs p + 3 < n, matches end at n - 5).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 4;        // CTAs per block at the engine's shapes
constexpr int MAX_SEGMENTS = 32;  // one warp per segment
constexpr uint32_t HASH_PRIME = 2654435761u;
constexpr int MIN_MATCH = 4;
constexpr int MF_LIMIT = 12;
constexpr int LAST_LITERALS = 5;

// The little-endian word at staged byte index i (the row's misalignment
// included): two aligned shared words and one funnel shift.
__device__ __forceinline__ uint32_t word_at(const uint32_t* sw, int i) {
  return __funnelshift_r(sw[i >> 2], sw[(i >> 2) + 1], (i & 3) << 3);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_compress_kernel(const uint8_t* __restrict__ blocks,
                      const int* __restrict__ ns, int* cand_out,
                      int* __restrict__ len_out, uint32_t* gtables, int B, int P,
                      int hash_bits, int pws, int max_match, int nseg,
                      int tab_off, int lc_off) {
  constexpr bool kWide = sizeof(T) == 4;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int E = 1 << hash_bits;
  const int shift = 32 - hash_bits;
  const int span = P / C;           // positions per CTA
  const int lo = rank * span, hi = lo + span;
  const int Ls = span / nseg;       // positions per segment, whole windows
  const int n = min(max(ns[m], 0), P);
  const int last = n - MIN_MATCH;   // the last valid position

  // -- 0. stage the row up to the last byte this CTA reads ------------------
  const uint8_t* src = blocks + (size_t)m * B;
  const int mis = (int)((uintptr_t)src & 15);
  const uint4* g16 = reinterpret_cast<const uint4*>(src - mis);
  uint4* s16 = reinterpret_cast<uint4*>(smem);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);
  const int need = min(min(P, hi + max_match) + 8, B);
  const int nchunks = (mis + need + 15) >> 4;
#pragma unroll 4
  for (int i = tid; i < nchunks; i += THREADS) s16[i] = __ldg(g16 + i);

  uint32_t* tables = gtables ? gtables + ((size_t)m * C + rank) * (nseg + 1) * E
                             : reinterpret_cast<uint32_t*>(smem + tab_off);
  uint32_t* summary = tables + (size_t)nseg * E;
  T* lc = kWide ? reinterpret_cast<T*>(cand_out + (size_t)m * P + lo)
                : reinterpret_cast<T*>(smem + lc_off);
  for (int i = tid; i < (nseg + 1) * E; i += THREADS) tables[i] = 0u;
  __syncthreads();

  // -- 1. ordered table walk, one warp per segment ---------------------------
  if (warp < nseg) {
    uint32_t* tab = tables + (size_t)warp * E;
    const int p0 = lo + warp * Ls;
    const int pend = min(p0 + Ls, last + 1);  // positions >= pend are invalid
    if (pws <= 32) {
      // A step covers 32 / pws whole windows, taken in order: a window's
      // lanes read the table (seeing the earlier windows of the step), then
      // write it; atomicMax keeps the highest position of a hash group.
      for (int base = p0; base < pend; base += 32) {
        const int p = base + lane;
        const uint32_t h = (word_at(sw, mis + p) * HASH_PRIME) >> shift;
        for (int w = 0; w < 32; w += pws) {
          const bool mine = p < pend && (unsigned)(lane - w) < (unsigned)pws;
          if (mine) lc[p - lo] = (T)tab[h];
          __syncwarp();
          if (mine) atomicMax(tab + h, (uint32_t)(p + 1));
          __syncwarp();
        }
      }
    } else {
      // A window spans several 32-position steps: read the whole window
      // before writing any of it.
      for (int wbase = p0; wbase < pend; wbase += pws) {
        for (int base = wbase; base < wbase + pws; base += 32) {
          const int p = base + lane;
          if (p < pend) lc[p - lo] = (T)tab[(word_at(sw, mis + p) * HASH_PRIME) >> shift];
        }
        __syncwarp();
        for (int base = wbase; base < wbase + pws; base += 32) {
          const int p = base + lane;
          if (p < pend)
            atomicMax(tab + ((word_at(sw, mis + p) * HASH_PRIME) >> shift), (uint32_t)(p + 1));
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // -- 2. summary, cluster barrier, prefix over the block --------------------
  for (int e = tid; e < E; e += THREADS) {
    uint32_t run = 0;
    for (int s = 0; s < nseg; ++s) run = max(run, tables[(size_t)s * E + e]);
    summary[e] = run;
  }
  cluster.sync();  // every CTA's summary is final (shared or device memory)
  for (int e = tid; e < E; e += THREADS) {
    uint32_t run = 0;
    for (int j = 0; j < rank; ++j) {
      const uint32_t* other = gtables
          ? gtables + (((size_t)m * C + j) * (nseg + 1) + nseg) * E
          : cluster.map_shared_rank(summary, j);
      run = max(run, other[e]);
    }
    for (int s = 0; s < nseg; ++s) {
      const uint32_t t = tables[(size_t)s * E + e];
      tables[(size_t)s * E + e] = run;
      run = max(run, t);
    }
  }
  cluster_arrive();  // this CTA reads no other summary from here on
  __syncthreads();

  // -- 3. candidate fix-up, word compare, word extension ---------------------
  int* cand_row = cand_out + (size_t)m * P;
  int* len_row = len_out + (size_t)m * P;
  for (int p = lo + tid * 4; p < hi; p += THREADS * 4) {
    int c[4] = {-1, -1, -1, -1}, l[4] = {0, 0, 0, 0};
    if (p <= last) {
      const uint32_t* tab = tables + (size_t)((p - lo) / Ls) * E;
      uint32_t c1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c1[i] = p + i <= last ? (uint32_t)lc[p + i - lo] : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = p + i;
        if (q > last) break;
        const uint32_t w = word_at(sw, mis + q);
        if (c1[i] == 0) c1[i] = tab[(w * HASH_PRIME) >> shift];
        const int cand = (int)c1[i] - 1;
        c[i] = cand;
        if (cand >= 0 && q <= n - MF_LIMIT && word_at(sw, mis + cand) == w) {
          const int max_extra = min(max(n - LAST_LITERALS - (q + MIN_MATCH), 0),
                                    max_match - MIN_MATCH);
          // Both sides advance one aligned word per step; the unaligned
          // words are funnel shifts of the carried pair.
          const int ia = mis + q + MIN_MATCH, ib = mis + cand + MIN_MATCH;
          const uint32_t sa = (ia & 3) << 3, sb = (ib & 3) << 3;
          const uint32_t* wa = sw + (ia >> 2);
          const uint32_t* wb = sw + (ib >> 2);
          uint32_t alo = wa[0], blo = wb[0];
          int j = 0;
          while (j < max_extra) {
            const uint32_t ahi = *++wa, bhi = *++wb;
            const uint32_t x = __funnelshift_r(alo, ahi, sa) ^ __funnelshift_r(blo, bhi, sb);
            if (x) { j += (__ffs(x) - 1) >> 3; break; }
            j += 4;
            alo = ahi;
            blo = bhi;
          }
          l[i] = MIN_MATCH + min(j, max_extra);
        }
      }
    }
    *reinterpret_cast<int4*>(cand_row + p) = make_int4(c[0], c[1], c[2], c[3]);
    *reinterpret_cast<int4*>(len_row + p) = make_int4(l[0], l[1], l[2], l[3]);
  }
  cluster_wait();  // no CTA leaves while another may still read its summary
}

template <typename T>
int launch(const void* blocks, const void* ns, void* cand, void* lengths,
           void* gtables, int M, int B, int P, int hash_bits, int pws,
           int max_match, int cluster, int nseg, int tab_off, int lc_off,
           int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_compress_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_compress_kernel<T>, (const uint8_t*)blocks,
                         (const int*)ns, (int*)cand, (int*)lengths, (uint32_t*)gtables,
                         B, P, hash_bits, pws, max_match, nseg, tab_off, lc_off);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// blocks (M, B) uint8, ns (M,) int32 -> cand, lengths (M, P) int32.  The
// launch plan comes from the wrapper (`_plan`): `cluster` CTAs per block
// (P / cluster a multiple of max(32, pws)), `nseg` segments per CTA, the
// shared-memory offsets of the tables and the segment-local candidates and
// the total; `wide` selects uint32 candidates (P > 65536).  gtables: nullptr to
// keep the tables in shared memory, else a (M, cluster, nseg + 1,
// 2^hash_bits) uint32 scratch in device memory.
extern "C" int fused_compress_launch(const void* blocks, const void* ns,
                                     void* cand, void* lengths, void* gtables,
                                     int M, int B, int P, int hash_bits,
                                     int pws, int max_match, int cluster,
                                     int nseg, int tab_off, int lc_off,
                                     int smem_bytes, int wide, void* stream) {
  if (cluster < 1 || cluster > 8 || nseg < 1 || nseg > MAX_SEGMENTS ||
      P % (cluster * nseg) || (P / cluster / nseg) % (pws > 32 ? pws : 32) ||
      (wide == 0 && P > 65536))
    return (int)cudaErrorInvalidValue;
  return wide ? launch<uint32_t>(blocks, ns, cand, lengths, gtables, M, B, P,
                                 hash_bits, pws, max_match, cluster, nseg,
                                 tab_off, lc_off, smem_bytes, (cudaStream_t)stream)
              : launch<uint16_t>(blocks, ns, cand, lengths, gtables, M, B, P,
                                 hash_bits, pws, max_match, cluster, nseg,
                                 tab_off, lc_off, smem_bytes, (cudaStream_t)stream);
}
