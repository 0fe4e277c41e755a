// CRC-32 (IEEE 802.3, reflected; zlib's and binascii's) of data[m, :n[m]]
// for every row, for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: in the JAX package it is the graph
// stage `crc32_bytes` (src/repro/kernels/ops.py), a `lax.scan` of K/8
// slice-by-8 steps with a masked byte tail.  Eager PyTorch has no scan, and
// a Python loop of 8192 steps per block would dominate the verified read
// path, so the stage gets a kernel.
//
// The register of a zero-initialised CRC (CRC0) is linear in the stream
// over GF(2), leading zero bytes leave it at zero, and "append L zero bytes"
// is multiplication by x^(8L) modulo the polynomial (zlib's crc32_combine).
// The design rests on three consequences:
//
//  * Right alignment.  Row m is read as a virtual stream of E bytes, E a
//    whole number of CTA spans, with the row's n bytes at its END (E - n
//    leading zero bytes, which change nothing).  Every CTA's span then ends
//    a fixed multiple of the span before the stream's end, whatever n is.
//    The preset 0xFFFFFFFF is the same as complementing bytes 0..3 of a row
//    of four or more bytes; rows with n < 4 are finished byte by byte.
//  * Coalesced lane streams with the stride folded into the tables.  In
//    each of `iters` steps a CTA reads STRIDE = THREADS * PIECE contiguous
//    bytes, thread t the 16 at offset 16 t (16-byte loads, neighbouring
//    threads on neighbouring addresses).  Thread t keeps the register of
//    its own stream: its pieces with the other threads' bytes taken as
//    zeros.  A step folds the register into the piece's first four bytes
//    and reads sixteen tables, T_j[b] = CRC0(b at position j, then STRIDE -
//    1 - j zero bytes): one shared-memory lookup per byte, the stride's
//    zeros included.  The tables (17 KB with the byte table) and the
//    constants below come from the wrapper in one global buffer, made once
//    per device (`kernels/crc32.py`); each CTA copies the tables with
//    16-byte loads.
//  * One carry-less multiply per combine.  Thread t's stream ends 16 t bytes
//    past its CTA's span, and the span ends L_g = (G - 1 - g) * span bytes
//    before the virtual end, so its register is multiplied by
//    x^(-128 t) * x^(8 L_g) (the first constant from the buffer, the
//    second the product of X2N[k] = x^(2^k) over the set bits of L_g, one
//    factor per lane of a warp, made while the loads are in flight; a
//    multiply is four byte selections of b * x^j joined by three x^8 steps
//    through the byte table, and b * x^j of the thread's constant is made
//    before its data arrive).  Registers so shifted to the row's end
//    combine by XOR, in any
//    order: across the CTA by shuffles, then across the CTAs of the row by
//    atomicXor into a per-device buffer (2 M words, zero between launches)
//    whose last arrival, counted by a ticket beside it, writes the result
//    and sets both words back to zero.  One launch, no second pass, no
//    scratch to clear per call.  (A cluster of 8 CTAs per row combining
//    through distributed shared memory measured no faster at M = 8 and
//    slower at M = 64, with the same CTAs.)
//
// Layout of a launch: span = STRIDE * iters bytes per CTA, G = ceil(K /
// span) CTAs per row along x, iters the smallest power of two (at most
// MAX_ITERS) for which M * G <= CTAS_PER_SM * SMs, or G = 1: every CTA
// copies the tables, so a launch takes no more CTAs than fill the card
// twice.  A batch of 8 rows of 64 KiB is 16 CTAs of 4 KiB per row; 64 rows,
// 4 CTAs of 16 KiB.  CTAs whose span lies wholly in the leading zeros read
// nothing.
//
// Rows need no alignment: a piece is cut from the two aligned 16-byte
// chunks around it by funnel shifts (the shift is the same for every piece
// of a row); only the chunks that hold bytes of the row are read.  The
// pieces that touch row bytes 0..3 or the leading zeros are read byte by
// byte.
//
// Bound: bytes, each byte of the row read once.  What bounds it now: on a
// 64 MiB row, instruction throughput and memory latency, which more loads
// in flight (batches of 8, double buffering) and CTAs of 512 did not cut,
// plus the bank conflicts of the table lookups on random bytes (zero bytes,
// which meet none, run faster: tools/torch_kernel_compare.py); on a batch
// of 64 KiB rows, latency (the table copy and the loads, the carry-less
// multiplies, the atomics of the combine).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 16;                   // bytes per thread per step
constexpr int STRIDE = THREADS * PIECE;     // bytes per CTA per step
constexpr int MAX_ITERS = 32;               // steps per CTA, at most
constexpr int CTAS_PER_SM = 2;              // a launch's CTAs, at most, per SM
constexpr int BYTE_OFF = PIECE * 256;       // table buffer: the byte table (x^8 steps)
constexpr int INV_OFF = BYTE_OFF + 256;     // table buffer: x^(-128 t), t < THREADS
constexpr int TABLE_WORDS = INV_OFF + THREADS;
constexpr uint32_t POLY = 0xEDB88320u;
constexpr uint32_t ONE = 0x80000000u;       // x^0, reflected

// x^(2^k) modulo the polynomial, reflected (zlib's x2n_table).
__constant__ uint32_t X2N[32] = {
    0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,
    0xedb88320u, 0xb1e6b092u, 0xa06a2517u, 0xed627daeu, 0x88d14467u,
    0xd7bbfe6au, 0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,
    0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u, 0x31fec169u,
    0x9fec022au, 0x6c8dedc4u, 0x15d6874du, 0x5fde7a4eu, 0xbad90e37u,
    0x2e4e5eefu, 0x4eaba214u, 0xa8a472c0u, 0x429a969eu, 0x148d302au,
    0xc40ba6d0u, 0xc4e22c3cu};

// b(x) * x^j for j < 8 (reflected: x^0 is bit 31).
struct Powers {
  uint32_t v[8];
};

__device__ __forceinline__ Powers powers(uint32_t b) {
  Powers w;
  w.v[0] = b;
#pragma unroll
  for (int j = 1; j < 8; ++j) w.v[j] = (w.v[j - 1] >> 1) ^ (POLY & (0u - (w.v[j - 1] & 1u)));
  return w;
}

// a(x) * b(x) modulo the polynomial, reflected (zlib's multmodp), from
// b * x^j (j < 8): a's four bytes of coefficients each select an XOR of
// those, joined by Horner steps of x^8, v * x^8 = (v >> 8) ^ T0[v & 0xff]
// (T0 the byte table, in shared memory).  About a third of the latency of
// the bit-serial loop.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, const Powers& b, const uint32_t* T0) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[k] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) q[k] ^= b.v[j] & (0u - ((a >> (31 - 8 * k - j)) & 1u));
  }
  uint32_t p = q[3];
#pragma unroll
  for (int k = 2; k >= 0; --k) p = ((p >> 8) ^ T0[p & 0xff]) ^ q[k];
  return p;
}

// The 16 bytes of a row at [i0, i0 + 16) as four little-endian words, the
// row's bytes 0..3 complemented when n >= 4 and bytes outside [0, n) zero.
__device__ __forceinline__ void load_piece(const uint8_t* row, long long i0,
                                           long long n, uint32_t w[4]) {
  if (i0 >= 4) {  // inside the row, past its head (i0 + 16 <= n always)
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + i0);
    const uint32_t s = (uint32_t)(a & 15);
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(a - s));
    uint32_t W[8] = {lo.x, lo.y, lo.z, lo.w, 0u, 0u, 0u, 0u};
    if (s) {
      const uint4 hi = __ldg(reinterpret_cast<const uint4*>(a - s + 16));
      W[4] = hi.x; W[5] = hi.y; W[6] = hi.z; W[7] = hi.w;
    }
    if (s & 8) {
      W[0] = W[2]; W[1] = W[3]; W[2] = W[4]; W[3] = W[5]; W[4] = W[6]; W[5] = W[7];
    }
    if (s & 4) {
      W[0] = W[1]; W[1] = W[2]; W[2] = W[3]; W[3] = W[4]; W[4] = W[5];
    }
    const uint32_t sh = 8 * (s & 3);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(W[k], W[k + 1], sh);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0u;
  if (i0 + PIECE <= 0) return;  // all leading zeros
  for (int k = 0; k < PIECE; ++k) {
    const long long i = i0 + k;
    if (i < 0 || i >= n) continue;
    uint32_t b = row[i];
    if (n >= 4 && i < 4) b ^= 0xffu;
    w[k >> 2] |= b << (8 * (k & 3));
  }
}

// Pieces it0 .. it0 + 3 of a thread's stream (those below iters).
__device__ __forceinline__ void load_batch(const uint8_t* row, long long base, long long n,
                                           int it0, int iters, uint32_t w[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (it0 + u < iters)
      load_piece(row, base + (long long)(it0 + u) * STRIDE + PIECE * threadIdx.x, n, w[u]);
}

// One step of a lane stream: the register folded into the piece's first
// four bytes, then one lookup per byte in the stride-folded tables.
__device__ __forceinline__ uint32_t step(const uint32_t (*T)[256], uint32_t r,
                                         const uint32_t w[4]) {
  const uint32_t x = w[0] ^ r;
  return T[0][x & 0xff] ^ T[1][(x >> 8) & 0xff] ^ T[2][(x >> 16) & 0xff] ^
         T[3][x >> 24] ^ T[4][w[1] & 0xff] ^ T[5][(w[1] >> 8) & 0xff] ^
         T[6][(w[1] >> 16) & 0xff] ^ T[7][w[1] >> 24] ^ T[8][w[2] & 0xff] ^
         T[9][(w[2] >> 8) & 0xff] ^ T[10][(w[2] >> 16) & 0xff] ^
         T[11][w[2] >> 24] ^ T[12][w[3] & 0xff] ^ T[13][(w[3] >> 8) & 0xff] ^
         T[14][(w[3] >> 16) & 0xff] ^ T[15][w[3] >> 24];
}

// The row's CRC from its register R (CRC0 of the row with bytes 0..3
// complemented); rows with n < 4 byte by byte from the preset.
__device__ uint32_t finish(uint32_t R, const uint8_t* row, long long n) {
  if (n >= 4) return ~R;
  uint32_t s = 0xffffffffu;
  for (int j = 0; j < n; ++j) {
    s ^= row[j];
    for (int b = 0; b < 8; ++b) s = (s >> 1) ^ (POLY & (0u - (s & 1u)));
  }
  return ~s;
}

__global__ void __launch_bounds__(THREADS)
crc32_kernel(const uint8_t* __restrict__ data, const int* __restrict__ ns,
             long long* __restrict__ out, const uint32_t* __restrict__ tables,
             uint32_t* acc, long long K, int G, int iters, int lg_span) {
  __shared__ __align__(16) uint32_t T[PIECE + 1][256];  // stride-folded tables, byte table
  __shared__ uint32_t s_warp[THREADS / 32];
  __shared__ uint32_t s_mult;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m = blockIdx.x / G;
  const int g = (int)(blockIdx.x % G);
  const long long span = 1LL << lg_span;
  const uint8_t* row = data + m * K;
  const long long n = min((long long)max(ns[m], 0), K);
  const long long lead = (long long)G * span - n;     // leading zero bytes
  const long long base = (long long)g * span - lead;  // row index of the span's start
  const bool live = base + span > 0;

  uint32_t r = 0;
  if (live) {
    // Constants: x^(-128 t) for this thread; x^(8 L_g), L_g = j * span with
    // j = G - 1 - g, one factor x^(2^(k + lg_span + 3)) per set bit k of j,
    // multiplied together across warp 0 (only the lanes below j's width).
    // The first pieces' loads go out before the table barrier.
    uint32_t w[4][4];
    load_batch(row, base, n, 0, iters, w);
    const uint32_t inv = __ldg(tables + INV_OFF + tid);
    for (int q = tid; q < (PIECE + 1) * 256 / 4; q += THREADS)
      reinterpret_cast<uint4*>(&T[0][0])[q] =
          __ldg(reinterpret_cast<const uint4*>(tables) + q);
    uint32_t f = ONE;
    if (warp == 0) {
      const uint32_t j = (uint32_t)(G - 1 - g);
      if ((j >> lane) & 1u) f = X2N[(lane + lg_span + 3) & 31];
    }
    __syncthreads();  // T, including the byte table the multiplies use
    if (warp == 0) {
      const uint32_t j = (uint32_t)(G - 1 - g);
      const int width = 32 - __clz((int)max(j, 1u));
      for (int d = 1; d < width; d <<= 1)
        f = mulmod(__shfl_xor_sync(0xffffffffu, f, d), powers(f), T[PIECE]);
      if (lane == 0) s_mult = f;
    }
    __syncthreads();
    // x^(-128 t) * x^(8 L_g), as powers for the one multiply at the end
    const Powers kt = powers(mulmod(s_mult, powers(inv), T[PIECE]));

    // The lane stream: 4 pieces loaded, then 4 steps.
    for (int it0 = 0; it0 < iters; it0 += 4) {
      if (it0) load_batch(row, base, n, it0, iters, w);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (it0 + u < iters) r = step(T, r, w[u]);
    }
    r = mulmod(r, kt, T[PIECE]);
  }
  // XOR across the CTA, then across the row's CTAs through acc.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) r ^= __shfl_xor_sync(0xffffffffu, r, d);
  if (lane == 0) s_warp[warp] = r;
  __syncthreads();
  if (tid == 0) {
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) x ^= s_warp[w];
    // acc[m] and the ticket acc[M + m] are zero on entry; the last CTA of
    // the row to arrive takes the sum and zeroes both.
    const long long M = gridDim.x / G;
    atomicXor(acc + m, x);
    __threadfence();
    if (atomicAdd(acc + M + m, 1u) == (unsigned)(G - 1)) {
      __threadfence();
      const uint32_t v = atomicExch(acc + m, 0u);
      acc[M + m] = 0u;
      out[m] = (long long)finish(v, row, n);
    }
  }
}

// SMs of device `dev`, asked once per device and kept by the ordinal
// cudaGetDevice gives on every launch (the cards of one box may differ, and
// a mesh launches on several; 0 in the table: not asked yet).
constexpr int MAX_DEVICES = 64;

int sm_count(int dev) {
  static std::atomic<int> known[MAX_DEVICES];
  int n = dev >= 0 && dev < MAX_DEVICES ? known[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < MAX_DEVICES) known[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Steps per CTA: the smallest power of two (at most MAX_ITERS) for which
// the launch has at most CTAS_PER_SM CTAs per SM of `dev`, or one CTA
// covers a row.
int iters_for(int dev, int M, long long K) {
  const int sms = sm_count(dev);
  int it = 1;
  while (it < MAX_ITERS && (long long)STRIDE * it < K &&
         (long long)M * ((K + (long long)STRIDE * it - 1) / ((long long)STRIDE * it)) >
             (long long)CTAS_PER_SM * sms)
    it *= 2;
  return it;
}

}  // namespace

// Words of the table buffer the launch reads (built by the wrapper).
extern "C" int crc32_table_words() { return TABLE_WORDS; }

// data (M, K) uint8 (any alignment), n (M,) int32 (0 <= n <= K) -> out (M,)
// int64 holding the unsigned CRC.  tables: TABLE_WORDS uint32 (16-byte
// aligned).  acc: 2 M uint32, zero; the launch leaves it zero.
extern "C" int crc32_launch(const void* data, const void* n, void* out,
                            const void* tables, void* acc, int M, long long K,
                            void* stream) {
  if (M < 1 || K < 0 || acc == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  const int iters = iters_for(dev, M, K);
  int lg_span = 0;
  while ((1 << lg_span) < STRIDE * iters) ++lg_span;
  const long long span = 1LL << lg_span;
  const long long G = K <= 0 ? 1 : (K + span - 1) / span;
  if (G * M > 2147483647LL) return (int)cudaErrorInvalidValue;
  crc32_kernel<<<(unsigned)(G * M), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int*)n, (long long*)out,
      (const uint32_t*)tables, (uint32_t*)acc, K, (int)G, iters, lg_span);
  return (int)cudaGetLastError();
}
