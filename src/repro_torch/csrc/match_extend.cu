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
// prefix-AND over a whole tile of positions, the block resident in VMEM.  A
// thread here stops at the first mismatch instead, which gives the same
// count.  Every read index is clamped to [0, B-1] as the plain version's
// gathers are: `cand` is garbage (negative, or past the row) where ~valid,
// and the kernel must not read outside its row for any input.  Index sums
// are formed in 64 bits, so a candidate near INT_MAX cannot wrap.
//
// Bound: bytes.  The function reads M * P valid bytes and writes M * P int32
// lengths; it needs a candidate only where valid, and of each row only the
// bytes its compares reach (at most max_match - 4 per valid position, none
// past n - LAST_LITERALS), which L1 and L2 hold, since a block row is 64 KB.
// Both depend on the data.  One thread per position, a 2-D grid
// (position tiles x rows); the candidate side of the compare is a random
// read, served from cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_MATCH = 4;
constexpr int LAST_LITERALS = 5;

__global__ void __launch_bounds__(THREADS)
match_extend_kernel(const uint8_t* __restrict__ blocks,
                    const int* __restrict__ cand,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ ns, int* __restrict__ out,
                    int B, int P, int max_match) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int m = blockIdx.y;
  const size_t o = (size_t)m * P + p;
  if (!valid[o]) {
    out[o] = 0;
    return;
  }
  const uint8_t* row = blocks + (size_t)m * B;
  long long max_extra = (long long)ns[m] - LAST_LITERALS - ((long long)p + MIN_MATCH);
  max_extra = max(0LL, min(max_extra, (long long)(max_match - MIN_MATCH)));
  const long long c = cand[o];
  const long long last = B - 1;
  int e = 0;
  for (long long j = 0; j < max_extra; ++j) {
    const long long pi = min((long long)p + MIN_MATCH + j, last);
    const long long ci = max(0LL, min(c + MIN_MATCH + j, last));
    if (__ldg(row + pi) != __ldg(row + ci)) break;
    ++e;
  }
  out[o] = MIN_MATCH + e;
}

}  // namespace

// blocks (M, B) uint8, cand (M, P) int32, valid (M, P) bool/uint8, ns (M,)
// int32 -> lengths (M, P) int32; B >= 1, max_match >= 4.
extern "C" int match_extend_launch(const void* blocks, const void* cand,
                                   const void* valid, const void* ns, void* out,
                                   int M, int B, int P, int max_match,
                                   void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, M);
  match_extend_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int*)cand, (const uint8_t*)valid,
      (const int*)ns, (int*)out, B, P, max_match);
  return (int)cudaGetLastError();
}
