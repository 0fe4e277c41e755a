// Word build + Fibonacci hash at every position, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fibhash_kernel` / `fibhash_pallas`
// (src/repro/kernels/fibhash.py): per position p of a block row,
//   word(p) = little-endian 4 bytes at p..p+3          (uint32)
//   hash(p) = (word * 2654435761 mod 2^32) >> (32 - hash_bits)
// stored as int32: the word as the bit pattern of its uint32 value, the hash
// in [0, 2^hash_bits).
//
// The TPU kernel takes four pre-shifted (P,) int32 byte streams so that its
// body is pure elementwise VPU work.  Here there is no such constraint: each
// thread reads its own four bytes of the one uint8 row (neighbouring threads
// read neighbouring bytes, so a warp's loads fall in two 32-byte sectors and
// the three re-reads hit L1), and no shifted copies are ever built.
//
// Bound: bytes.  The function reads M * B bytes and writes 2 * M * P int32,
// eight bytes out for each byte in, with a multiply and a shift per position.
// One thread per position, a 2-D grid (position tiles x rows), coalesced
// 4-byte stores: the kernel is a streaming pass and nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t HASH_PRIME = 2654435761u;

__global__ void __launch_bounds__(THREADS)
fibhash_kernel(const uint8_t* __restrict__ blocks, int* __restrict__ words,
               int* __restrict__ hashes, int B, int P, int shift) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const uint8_t* row = blocks + (size_t)blockIdx.y * B;
  // p + 3 <= P + 2 <= B - 1: the wrapper checks P <= B - 3.
  const uint32_t w = (uint32_t)row[p] | ((uint32_t)row[p + 1] << 8) |
                     ((uint32_t)row[p + 2] << 16) | ((uint32_t)row[p + 3] << 24);
  const size_t o = (size_t)blockIdx.y * P + p;
  words[o] = (int)w;                          // the uint32 bit pattern
  hashes[o] = (int)((w * HASH_PRIME) >> shift);  // unsigned: wraps, logical shift
}

}  // namespace

// blocks (M, B) uint8 -> words (M, P) int32, hashes (M, P) int32;
// P <= B - 3, 1 <= hash_bits <= 32 (a shift by 32 would be undefined).
extern "C" int fibhash_launch(const void* blocks, void* words, void* hashes,
                              int M, int B, int P, int hash_bits, void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, M);
  fibhash_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (int*)words, (int*)hashes, B, P, 32 - hash_bits);
  return (int)cudaGetLastError();
}
