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
// Three phases in one CTA per block (1024 threads):
//
//  1. 0xFF-run table, ffrun[i] = (first offset j >= i that is not a 0xFF
//     byte below n) - i, by a block-wide reverse min-scan: each thread
//     scans a contiguous segment, a shared-memory scan combines the
//     segments.  The reference builds it with a reversed cummin (the
//     Pallas kernel by suffix-min doubling); all three give the same
//     table.  As int32 it is 263 KB — more than a CTA's shared memory — so
//     it lives in a scratch row in device memory that the wrapper
//     allocates; it stays in L2.  The block's bytes are in shared memory.
//  2. The seven fields at every offset, written with coalesced stores, and
//     the chain map jump[i] = i < n ? min(next, n) : i into scratch.
//  3. Chain select by pointer doubling with a barrier per round, as the
//     reference: mark |= mark scattered through jump (from the previous
//     round's marks, two bit arrays in shared memory), jump = jump[jump]
//     (two scratch rows, ping-pong).  Why doubling and not a serial walk
//     from offset 0: both give identical marks — every hop advances at
//     least 3 bytes or ends at the fixed point n, so the chain from 0 has
//     at most 21,846 hops, fewer than 2^16, and 16 doubling rounds mark
//     exactly the reachable offsets — but the walk is one thread doing up
//     to 21,846 dependent hops (a few hundred microseconds per block),
//     while a doubling round is one parallel pass.  A round that changes
//     neither a mark nor a pointer is a fixed point, so the loop may stop
//     there with the same result.
//
// Bound: bytes.  The function reads B bytes and n, and writes seven int32
// rows of B (28 B bytes per row); the scratch traffic stays in L2.  Left on
// the table: one CTA per block (M of 132 SMs busy), uncoalesced segment
// stores of the run table, and up to 16 doubling rounds with a random
// gather each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ int bit_of(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1;
}

__global__ void __launch_bounds__(THREADS, 1)
plan_speculative_kernel(const uint8_t* __restrict__ blocks,
                        const int* __restrict__ ns, int* __restrict__ is_start,
                        int* __restrict__ lit_start_o, int* __restrict__ lit_len_o,
                        int* __restrict__ ls_end_o, int* __restrict__ off_o,
                        int* __restrict__ mlen_o, int* __restrict__ flags_o,
                        int* ffrun_s, int* jump_a, int* jump_b, int B) {
  // Scratch rows are written and read back by this CTA: plain pointers, no
  // read-only cache (__syncthreads makes the writes visible to the CTA).
  extern __shared__ __align__(16) uint8_t smem[];
  const int bpad = ((B + 15) / 16) * 16;
  const int W = (B + 31) / 32;
  uint8_t* s_blk = smem;
  uint32_t* s_mark0 = reinterpret_cast<uint32_t*>(smem + bpad);
  uint32_t* s_mark1 = s_mark0 + W;
  int* s_scan = reinterpret_cast<int*>(s_mark1 + W);

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)m * B;
  const int n = min(max(ns[m], 0), B - 1);  // the caller's precondition
  const int nm1 = max(n - 1, 0);
  int* ffrun = ffrun_s + row;
  int* cur = jump_a + row;
  int* nxt = jump_b + row;

  for (int i = tid; i < B; i += THREADS) s_blk[i] = blocks[row + i];
  for (int w = tid; w < W; w += THREADS) {
    s_mark0[w] = w == 0 ? 1u : 0u;
    s_mark1[w] = 0u;
  }
  __syncthreads();

  // -- 1. run table ----------------------------------------------------------
  const int seg = (B + THREADS - 1) / THREADS;
  const int lo = min(tid * seg, B), hi = min(lo + seg, B);
  int local = B;
  for (int i = lo; i < hi; ++i) {
    const int v = (s_blk[i] == 255 && i < n) ? B : i;
    local = min(local, v);
  }
  s_scan[tid] = local;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {  // inclusive suffix-min
    const int x = s_scan[tid];
    const int y = tid + d < THREADS ? s_scan[tid + d] : B;
    __syncthreads();
    s_scan[tid] = min(x, y);
    __syncthreads();
  }
  int run = tid + 1 < THREADS ? s_scan[tid + 1] : B;
  for (int i = hi - 1; i >= lo; --i) {
    const int v = (s_blk[i] == 255 && i < n) ? B : i;
    run = min(run, v);
    ffrun[i] = run - i;
  }
  __syncthreads();

  // -- 2. candidate header at every offset -----------------------------------
  for (int i = tid; i < B; i += THREADS) {
    const int byte = s_blk[i];
    const int lit_nib = byte >> 4;
    const bool has_lx = lit_nib == 15;
    const int r1 = ffrun[min(i + 1, B - 1)];
    const int term1 = i + 1 + r1;
    const int t1b = s_blk[min(term1, nm1)];
    const int lit_len = has_lx ? r1 * 255 + t1b + 15 : lit_nib;
    const int lit_start = i + 1 + (has_lx ? 1 + r1 : 0);
    const int ls_end = lit_start + lit_len;
    const int m_nib = byte & 15;
    const bool has_mx = m_nib == 15;
    const int o0 = min(ls_end, nm1);
    const int off = s_blk[o0] | (s_blk[min(o0 + 1, nm1)] << 8);
    const int r2 = ffrun[min(ls_end + 2, n)];
    const int term2 = ls_end + 2 + r2;
    const int t2b = s_blk[min(term2, nm1)];
    const int mlen = has_mx ? r2 * 255 + t2b + 19 : m_nib + 4;
    const int next = ls_end + 2 + (has_mx ? r2 + 1 : 0);
    lit_start_o[row + i] = lit_start;
    lit_len_o[row + i] = lit_len;
    ls_end_o[row + i] = ls_end;
    off_o[row + i] = off;
    mlen_o[row + i] = mlen;
    flags_o[row + i] = (int)(has_lx && term1 >= n) | ((int)(has_mx && term2 >= n) << 1);
    cur[i] = i < n ? min(next, n) : i;
  }
  __syncthreads();

  // -- 3. chain select: 16 doubling rounds ------------------------------------
  uint32_t* mold = s_mark0;
  uint32_t* mnew = s_mark1;
  for (int r = 0; r < 16; ++r) {
    for (int w = tid; w < W; w += THREADS) mnew[w] = mold[w];
    __syncthreads();
    int changed = 0;
    for (int i = tid; i < B; i += THREADS) {
      const int j = cur[i];
      if (bit_of(mold, i)) atomicOr(&mnew[j >> 5], 1u << (j & 31));
      const int jj = cur[j];
      nxt[i] = jj;
      changed |= jj != j;
    }
    __syncthreads();
    for (int w = tid; w < W; w += THREADS) changed |= mnew[w] != mold[w];
    const int any = __syncthreads_or(changed);
    uint32_t* t = mold; mold = mnew; mnew = t;
    int* tj = cur; cur = nxt; nxt = tj;
    if (!any) break;
  }
  for (int i = tid; i < B; i += THREADS)
    is_start[row + i] = i < n ? bit_of(mold, i) : 0;
}

}  // namespace

// blocks (M, B) uint8, n (M,) int32 (0 <= n < B) -> seven (M, B) int32 rows
// (is_start, lit_start, lit_len, ls_end, off, mlen, flags); three (M, B)
// int32 scratch rows (run table, two chain maps) from the wrapper.
extern "C" int plan_speculative_launch(const void* blocks, const void* n,
                                       void* is_start, void* lit_start,
                                       void* lit_len, void* ls_end, void* off,
                                       void* mlen, void* flags, void* ffrun,
                                       void* jump_a, void* jump_b, int M, int B,
                                       void* stream) {
  const int W = (B + 31) / 32;
  const int smem = ((B + 15) / 16) * 16 + 2 * W * 4 + THREADS * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      plan_speculative_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  plan_speculative_kernel<<<M, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int*)n, (int*)is_start, (int*)lit_start,
      (int*)lit_len, (int*)ls_end, (int*)off, (int*)mlen, (int*)flags,
      (int*)ffrun, (int*)jump_a, (int*)jump_b, B);
  return (int)cudaGetLastError();
}
