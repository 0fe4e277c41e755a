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
// one CTA owns one input block, which it keeps in shared memory as bytes
// (64 KB), and the ordered table walk is cut into `nseg` segments of
// consecutive windows, one warp each:
//
//   1. walk   : warp s walks its windows in order with a private table
//               (2^hash_bits entries, initially empty).  A step covers 32
//               positions = 32/pws whole windows: every lane reads
//               table[hash] BEFORE any lane of the step writes
//               (read-before-write port order, win(q) < win(p), never <=);
//               a candidate in an earlier window of the same step is found
//               with __match_any_sync.  The highest lane of each hash group
//               then stores p+1.  Positions ascend, so a plain store is the
//               running maximum.  The segment-local candidate goes to the
//               `cand` output as p+1 (0 = none).
//   2. prefix : an exclusive running maximum over the nseg tables, entry by
//               entry, turns table s into the table state at the START of
//               segment s.
//   3. match  : all threads: a position without a segment-local candidate
//               takes the incoming table's; then the 4-byte compare and the
//               bounded extension (early exit on the first mismatch) read
//               the block from shared memory.
//
// Bound: bytes.  The function must read M * B bytes and write 2 * M * P
// int32; there is almost no arithmetic.  The design keeps every re-read (four
// byte streams, candidate words, up to max_match - 4 extension compares) in
// shared memory so device memory sees each input byte once; `cand` is written
// twice (steps 1 and 3) and re-read once from L2.  What is left above the
// bound is the ordered walk: P / (32 * nseg) dependent steps per warp.
//
// Bytes at index >= n need no masking: every read that can influence an
// output lies below n (valid_pos needs p + 3 < n, matches end at n - 5).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr uint32_t HASH_PRIME = 2654435761u;
constexpr int MIN_MATCH = 4;
constexpr int MF_LIMIT = 12;
constexpr int LAST_LITERALS = 5;

__device__ __forceinline__ uint32_t load_word(const uint8_t* b, int p) {
  return (uint32_t)b[p] | ((uint32_t)b[p + 1] << 8) |
         ((uint32_t)b[p + 2] << 16) | ((uint32_t)b[p + 3] << 24);
}

__global__ void __launch_bounds__(THREADS)
fused_compress_kernel(const uint8_t* __restrict__ blocks,
                      const int* __restrict__ ns,
                      int* cand_out, int* __restrict__ len_out,
                      int* gtables, int B, int P, int hash_bits, int pws,
                      int max_match, int nseg, int block_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int E = 1 << hash_bits;
  const int shift = 32 - hash_bits;

  // The shared copy keeps the row's misalignment, so whole aligned 32-bit
  // words are copied (the first/last word may carry up to 3 foreign bytes
  // of the same aligned word; they are never indexed).
  const uint8_t* src = blocks + (size_t)m * B;
  const int mis = (int)((uintptr_t)src & 3);
  const int nwords = (mis + B + 3) >> 2;
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(src - mis);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  const uint8_t* blk = smem + mis;
  int* tables = gtables ? gtables + (size_t)m * nseg * E
                        : reinterpret_cast<int*>(smem + block_bytes);

  for (int i = tid; i < nwords; i += THREADS) sw[i] = gw[i];
  for (int i = tid; i < nseg * E; i += THREADS) tables[i] = 0;
  __syncthreads();

  const int n = min(max(ns[m], 0), P);
  int* cand_row = cand_out + (size_t)m * P;
  int* len_row = len_out + (size_t)m * P;
  const int L = P / nseg;  // positions per segment; a multiple of max(32, pws)

  // -- 1. ordered table walk, one warp per segment ---------------------------
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < nseg) {
    int* tab = tables + warp * E;
    const int p0 = warp * L;
    if (pws <= 32) {
      // Lanes below this mask belong to earlier windows of the same step.
      const uint32_t earlier_mask = (1u << ((lane / pws) * pws)) - 1u;
      for (int base = p0; base < p0 + L; base += 32) {
        const int p = base + lane;
        const bool valid = p <= n - MIN_MATCH;
        const uint32_t h = (load_word(blk, p) * HASH_PRIME) >> shift;
        int c1 = valid ? tab[h] : 0;
        // Invalid positions get a key no hash can equal (hash_bits <= 16).
        const uint32_t peers =
            __match_any_sync(0xffffffffu, valid ? h : (0x80000000u | lane));
        const uint32_t earlier = peers & earlier_mask;
        if (valid && earlier) c1 = base + (31 - __clz(earlier)) + 1;
        cand_row[p] = c1;
        __syncwarp();
        if (valid && (peers >> lane) == 1u) tab[h] = p + 1;
        __syncwarp();
      }
    } else {
      // A window spans several 32-position steps: read the whole window
      // before writing any of it.
      for (int wbase = p0; wbase < p0 + L; wbase += pws) {
        for (int base = wbase; base < wbase + pws; base += 32) {
          const int p = base + lane;
          const bool valid = p <= n - MIN_MATCH;
          const uint32_t h = (load_word(blk, p) * HASH_PRIME) >> shift;
          cand_row[p] = valid ? tab[h] : 0;
        }
        __syncwarp();
        for (int base = wbase; base < wbase + pws; base += 32) {
          const int p = base + lane;
          const bool valid = p <= n - MIN_MATCH;
          const uint32_t h = (load_word(blk, p) * HASH_PRIME) >> shift;
          const uint32_t peers =
              __match_any_sync(0xffffffffu, valid ? h : (0x80000000u | lane));
          if (valid && (peers >> lane) == 1u) tab[h] = p + 1;
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // -- 2. exclusive running maximum over the segment tables ------------------
  for (int e = tid; e < E; e += THREADS) {
    int run = 0;
    for (int s = 0; s < nseg; ++s) {
      const int t = tables[s * E + e];
      tables[s * E + e] = run;
      run = max(run, t);
    }
  }
  __syncthreads();

  // -- 3. candidate fix-up, word compare, bounded extension ------------------
  for (int p = tid; p < P; p += THREADS) {
    const bool valid = p <= n - MIN_MATCH;
    const uint32_t w = load_word(blk, p);
    int c1 = cand_row[p];
    if (valid && c1 == 0) c1 = tables[(p / L) * E + ((w * HASH_PRIME) >> shift)];
    const int cand = valid ? c1 - 1 : -1;
    int len = 0;
    if (cand >= 0 && p <= n - MF_LIMIT && load_word(blk, cand) == w) {
      const int max_extra =
          min(max(n - LAST_LITERALS - (p + MIN_MATCH), 0), max_match - MIN_MATCH);
      const uint8_t* a = blk + p + MIN_MATCH;
      const uint8_t* b = blk + cand + MIN_MATCH;
      int j = 0;
      while (j < max_extra && a[j] == b[j]) ++j;
      len = MIN_MATCH + j;
    }
    cand_row[p] = cand;
    len_row[p] = len;
  }
}

}  // namespace

// blocks (M, B) uint8, ns (M,) int32 -> cand, lengths (M, P) int32.
// gtables: nullptr to keep the nseg tables in shared memory, else a
// (M, nseg, 2^hash_bits) int32 scratch in device memory.  smem_bytes is the
// dynamic shared memory the caller computed (block_bytes + tables).
extern "C" int fused_compress_launch(const void* blocks, const void* ns,
                                     void* cand, void* lengths, void* gtables,
                                     int M, int B, int P, int hash_bits,
                                     int pws, int max_match, int nseg,
                                     int block_bytes, int smem_bytes,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_compress_kernel<<<M, THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int*)ns, (int*)cand, (int*)lengths,
      (int*)gtables, B, P, hash_bits, pws, max_match, nseg, block_bytes);
  return (int)cudaGetLastError();
}
