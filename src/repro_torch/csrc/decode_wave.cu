// Pointer-doubling block decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel `decode_wave_pallas` (_decode_wave_kernel,
// src/repro/kernels/decode_wave.py).  Per block (one row of the batch):
//
//     repeat `rounds` times:  ptr[k] = ptr[ptr[k]]        (all k at once)
//     out[k] = k < total ? block[lit_blk[ptr[k]]] : 0
//
// Doubling is a global fixed-point iteration over the block: round r reads
// entries that round r-1 wrote anywhere in the table.  The TPU kernel keeps
// the int32 table (256 KB) in VMEM and runs one grid step per block.  Here
// one CTA takes one block.  Every position is < 65536, so the table fits in
// dynamic shared memory as uint16 (128 KB) beside the block's bytes (64 KB).
//
// Exact round semantics: in each round every thread first gathers
// ptr[ptr[k]] for its 64 entries into registers (two uint16 per 32-bit
// register), then a barrier, then all write back — so every read of a
// round sees the previous round's table, at any `rounds`, including too few
// to resolve a chain.  A round that changes no entry leaves the table at a
// fixed point, so the loop may stop there: the result is the same.
//
// Bounds: `ptr` is clipped to [0, K-1] on load (the caller's precondition;
// `ops.decode_gather` clips it).  `lit_blk` is read as `jnp.take` reads it:
// a value in [-B, -1] wraps by B, any other value outside [0, B) gives byte
// 0 (the reference's INT32_MIN fill, cast to uint8).  Nothing is read
// outside the row.
//
// Bound: bytes.  The function must read the block (B), lit_blk and ptr
// (4K each) and write K bytes per row; the rounds run in shared memory.
// What the design leaves on the table: one CTA per block, so a micro-batch
// of M blocks busies M of the 132 SMs; and the doubling rounds are latency
// bound (two dependent shared-memory gathers per entry and round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int PER = 64;               // entries per thread; THREADS * PER = 65536
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a CTA may use

__global__ void __launch_bounds__(THREADS, 1)
decode_wave_kernel(const uint8_t* __restrict__ blocks,
                   const int* __restrict__ lit_blk,
                   const int* __restrict__ ptr, const int* __restrict__ total,
                   uint8_t* __restrict__ out, int B, int K, int rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_ptr = reinterpret_cast<uint16_t*>(smem);
  uint8_t* s_blk = smem + 2 * (size_t)K;

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int* prow = ptr + (size_t)m * K;
  const uint8_t* brow = blocks + (size_t)m * B;
  for (int k = tid; k < K; k += THREADS) {
    const int p = min(max(prow[k], 0), K - 1);
    s_ptr[k] = (uint16_t)p;
  }
  for (int i = tid; i < B; i += THREADS) s_blk[i] = brow[i];
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    uint32_t nv[PER / 2];
    int changed = 0;
#pragma unroll
    for (int j = 0; j < PER / 2; ++j) {
      const int k0 = tid + 2 * j * THREADS;
      const int k1 = k0 + THREADS;
      uint32_t lo = 0, hi = 0;
      if (k0 < K) {
        const uint32_t a = s_ptr[k0];
        lo = s_ptr[a];
        changed |= lo != a;
      }
      if (k1 < K) {
        const uint32_t a = s_ptr[k1];
        hi = s_ptr[a];
        changed |= hi != a;
      }
      nv[j] = lo | (hi << 16);
    }
    if (!__syncthreads_or(changed)) break;  // every thread leaves together
#pragma unroll
    for (int j = 0; j < PER / 2; ++j) {
      const int k0 = tid + 2 * j * THREADS;
      const int k1 = k0 + THREADS;
      if (k0 < K) s_ptr[k0] = (uint16_t)(nv[j] & 0xffffu);
      if (k1 < K) s_ptr[k1] = (uint16_t)(nv[j] >> 16);
    }
    __syncthreads();
  }

  const int* lrow = lit_blk + (size_t)m * K;
  const int tot = total[m];
  uint8_t* orow = out + (size_t)m * K;
  for (int k = tid; k < K; k += THREADS) {
    uint8_t b = 0;
    if (k < tot) {
      int s = lrow[s_ptr[k]];
      if (s < 0) s += B;  // no overflow: s >= INT_MIN and B > 0
      if (s >= 0 && s < B) b = s_blk[s];
    }
    orow[k] = b;
  }
}

}  // namespace

// blocks (M, B) uint8, lit_blk (M, K) int32, ptr (M, K) int32, total (M,)
// int32 -> out (M, K) uint8.  K <= 65536 and 2K + B (rounded up to 16) must
// fit the CTA's dynamic shared memory; the wrapper checks both.
extern "C" int decode_wave_launch(const void* blocks, const void* lit_blk,
                                  const void* ptr, const void* total, void* out,
                                  int M, int B, int K, int rounds,
                                  void* stream) {
  const int smem = 2 * K + ((B + 15) / 16) * 16;
  if (K > THREADS * PER || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  decode_wave_kernel<<<M, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int*)lit_blk, (const int*)ptr,
      (const int*)total, (uint8_t*)out, B, K, rounds);
  return (int)cudaGetLastError();
}
