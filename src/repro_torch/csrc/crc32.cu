// CRC-32 (IEEE 802.3, reflected; zlib's and binascii's) of data[m, :n[m]]
// for every row, for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: in the JAX package it is the graph
// stage `crc32_bytes` (src/repro/kernels/ops.py), a `lax.scan` of K/8
// slice-by-8 steps with a masked byte tail.  Eager PyTorch has no scan, and
// a Python loop of 8192 steps per block would dominate the verified read
// path, so the stage gets a kernel.
//
// The CRC register after a stream is linear in the stream over GF(2):
// F(0, a || b) = A^len(b) F(0, a) ^ F(0, b), where A^L, "append L zero
// bytes", is multiplication by x^(8L) modulo the polynomial (zlib's
// `crc32_combine`).  So the row is cut into 256-byte pieces, one per thread;
// every thread computes its piece's register from zero with slice-by-8
// tables in shared memory, and the pieces are combined pairwise up a tree
// (a CTA covers 64 KiB).  Appending L zero bytes costs one 32-step
// carry-less multiply per set bit of L, by x^(8 * 2^k) from a 32-entry
// constant table.  The initial register 0xFFFFFFFF is the same as
// complementing the first four bytes of a stream of four or more bytes
// (rows with n < 4 are done byte by byte); the result is complemented.
//
// Rows of any length in one launch: a row longer than 64 KiB gets several
// CTAs (grid.x), each writes its 64 KiB register and length to scratch, and
// the CTA that finishes last (a per-row ticket, after a memory fence) combines
// them with the same tree.  A per-block batch (M rows of 64 KiB) is one CTA
// per row.
//
// Bound: bytes — each valid byte read once; a slice-by-8 step is 8 shared
// table lookups for 8 bytes.  Left on the table: a thread reads its own
// 256 contiguous bytes (16-byte loads, not coalesced across the warp), and
// the tables are rebuilt in each CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 256;                 // bytes per thread
constexpr int SPAN = THREADS * PT;      // bytes per CTA
constexpr uint32_t POLY = 0xEDB88320u;

// x^(2^k) modulo the polynomial, reflected (zlib's x2n_table).
__constant__ uint32_t X2N[32] = {
    0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,
    0xedb88320u, 0xb1e6b092u, 0xa06a2517u, 0xed627daeu, 0x88d14467u,
    0xd7bbfe6au, 0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,
    0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u, 0x31fec169u,
    0x9fec022au, 0x6c8dedc4u, 0x15d6874du, 0x5fde7a4eu, 0xbad90e37u,
    0x2e4e5eefu, 0x4eaba214u, 0xa8a472c0u, 0x429a969eu, 0x148d302au,
    0xc40ba6d0u, 0xc4e22c3cu};

__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    if ((a >> i) & 1u) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ POLY : b >> 1;
  }
  return p;
}

// The register r followed by `len` zero bytes (x^(2^k) repeats with period
// 32 in k, as zlib's x2nmodp relies on).
__device__ uint32_t shift_zeros(uint32_t r, long long len) {
  for (int k = 0; len != 0; ++k, len >>= 1)
    if (len & 1) r = multmodp(X2N[(k + 3) & 31], r);
  return r;
}

__device__ __forceinline__ uint32_t step8(uint32_t (*T)[256], uint32_t c,
                                          uint32_t w0, uint32_t w1) {
  const uint32_t x = c ^ w0;
  return T[7][x & 0xff] ^ T[6][(x >> 8) & 0xff] ^ T[5][(x >> 16) & 0xff] ^
         T[4][x >> 24] ^ T[3][w1 & 0xff] ^ T[2][(w1 >> 8) & 0xff] ^
         T[1][(w1 >> 16) & 0xff] ^ T[0][w1 >> 24];
}

// Tree-combine the per-thread (register, length) pairs in s_r / s_len;
// thread 0 ends with the whole range's register in s_r[0].
__device__ void tree_combine(uint32_t* s_r, long long* s_len) {
  const int tid = threadIdx.x;
  for (int s = 1; s < THREADS; s <<= 1) {
    if ((tid & (2 * s - 1)) == 0) {
      const long long lr = s_len[tid + s];
      if (lr != 0) {
        s_r[tid] = shift_zeros(s_r[tid], lr) ^ s_r[tid + s];
        s_len[tid] += lr;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
crc32_kernel(const uint8_t* __restrict__ data, const int* __restrict__ ns,
             long long* __restrict__ out, uint32_t* part_r, long long* part_len,
             int* ticket, long long K) {
  __shared__ uint32_t T[8][256];
  __shared__ uint32_t s_r[THREADS];
  __shared__ long long s_len[THREADS];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int m = blockIdx.y;
  const uint8_t* row = data + (size_t)m * (size_t)K;
  const long long n = min((long long)max(ns[m], 0), K);

  {
    uint32_t c = (uint32_t)tid;
    for (int b = 0; b < 8; ++b) c = (c & 1u) ? (c >> 1) ^ POLY : c >> 1;
    T[0][tid] = c;
  }
  __syncthreads();
  for (int s = 1; s < 8; ++s) {
    const uint32_t p = T[s - 1][tid];
    T[s][tid] = (p >> 8) ^ T[0][p & 0xff];
    __syncthreads();
  }

  const long long start = (long long)g * SPAN + (long long)tid * PT;
  const long long len = max(0LL, min((long long)PT, n - start));
  uint32_t c = 0;
  const bool head = n >= 4 && start < 4;  // bytes 0..3 are complemented
  if (len == PT && !head &&
      (reinterpret_cast<uintptr_t>(row + start) & 15) == 0) {
    const uint4* p4 = reinterpret_cast<const uint4*>(row + start);
#pragma unroll 4
    for (int j = 0; j < PT / 16; ++j) {
      const uint4 v = __ldg(p4 + j);
      c = step8(T, c, v.x, v.y);
      c = step8(T, c, v.z, v.w);
    }
  } else {
    for (long long j = 0; j < len; ++j) {
      uint32_t b = row[start + j];
      if (head && start + j < 4) b ^= 0xffu;
      c = T[0][(c ^ b) & 0xff] ^ (c >> 8);
    }
  }
  s_r[tid] = c;
  s_len[tid] = len;
  __syncthreads();
  tree_combine(s_r, s_len);

  if (G > 1) {
    if (tid == 0) {
      part_r[(size_t)m * G + g] = s_r[0];
      part_len[(size_t)m * G + g] = s_len[0];
      __threadfence();
      s_last = atomicAdd(&ticket[m], 1) == G - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // The last CTA of the row combines the G partial registers: thread t
    // takes a run of q consecutive ones, then the tree.
    const int q = (G + THREADS - 1) / THREADS;
    uint32_t r = 0;
    long long l = 0;
    for (int j = tid * q; j < min(G, tid * q + q); ++j) {
      const long long lj = __ldcg(part_len + (size_t)m * G + j);
      if (lj != 0) {
        r = shift_zeros(r, lj) ^ __ldcg(part_r + (size_t)m * G + j);
        l += lj;
      }
    }
    s_r[tid] = r;
    s_len[tid] = l;
    __syncthreads();
    tree_combine(s_r, s_len);
    if (tid == 0) ticket[m] = 0;
  }
  if (tid == 0) {
    uint32_t crc;
    if (n >= 4) {
      crc = ~s_r[0];
    } else {
      uint32_t s = 0xffffffffu;
      for (int j = 0; j < n; ++j) s = T[0][(s ^ row[j]) & 0xff] ^ (s >> 8);
      crc = ~s;
    }
    out[m] = (long long)crc;
  }
}

}  // namespace

// data (M, K) uint8, n (M,) int32 (0 <= n <= K) -> out (M,) int64 holding
// the unsigned CRC.  Scratch from the wrapper: part_r (M * G) uint32,
// part_len (M * G) int64 and ticket (M,) int32 zeroed, G = ceil(K / 65536).
extern "C" int crc32_launch(const void* data, const void* n, void* out,
                            void* part_r, void* part_len, void* ticket, int M,
                            long long K, void* stream) {
  const long long G = K <= 0 ? 1 : (K + SPAN - 1) / SPAN;
  if (G > 2147483647LL || M > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)G, (unsigned)M);
  crc32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)n, (long long*)out, (uint32_t*)part_r,
      (long long*)part_len, (int*)ticket, K);
  return (int)cudaGetLastError();
}
