// Device-side LZ4 byte emission (inverse scatter) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_emit_scatter_kernel` / `emit_scatter_pallas`
// (src/repro/kernels/emit_scatter.py): output byte k looks up its covering
// sequence seg[k], reads that sequence's 8 layout fields and derives its
// byte from r = k - start alone — token, literal-length extension, literal
// (one gather from the input block), offset low/high, match-length
// extension; 0 at and past `total`.
//
// Bound: bytes.  Per block the function reads seg (4 K bytes), the field
// table (32 S bytes) and the input block, and writes K bytes; the arithmetic
// is a handful of integer ops per byte.  The design: one thread per 4 output
// bytes, so `seg` is read as one 16-byte vector and the output is written as
// one 32-bit word per thread (coalesced); the field gathers of neighbouring
// bytes hit the same sequence almost always and are served from L1/L2;
// bytes past `total` skip every gather.  Output is uint8 directly (the TPU
// version writes int32 lanes and casts afterwards).
//
// C++ `%` truncates toward zero where the reference floors, so the
// extension-byte terminators use an explicit floor modulus.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_FIELDS = 8;
enum { F_START, F_ANCHOR, F_LIT, F_LIT_EXT, F_MLX, F_MATCH_EXT, F_OFF, F_HAS_MATCH };

__device__ __forceinline__ int floor_mod255(int x) {
  const int r = x % 255;
  return r < 0 ? r + 255 : r;
}

__device__ __forceinline__ uint32_t emit_one(const uint8_t* __restrict__ blk,
                                             const int* __restrict__ f,
                                             int S, int B, int seg, int k,
                                             int total) {
  if (k >= total) return 0u;
  seg = min(max(seg, 0), S - 1);
  const int st = f[F_START * S + seg];
  const int lit = f[F_LIT * S + seg];
  const int le = f[F_LIT_EXT * S + seg];
  const int r = k - st;
  int b;
  if (r == 0) {
    const int mlx = f[F_MLX * S + seg];
    const int hm = f[F_HAS_MATCH * S + seg];
    b = (min(lit, 15) << 4) | (hm > 0 ? min(mlx, 15) : 0);
  } else if (r <= le) {
    b = r < le ? 255 : floor_mod255(lit - 15);
  } else if (r <= le + lit) {
    const int anc = f[F_ANCHOR * S + seg];
    b = blk[min(max(anc + r - 1 - le, 0), B - 1)];
  } else {
    const int lit_end = 1 + le + lit;
    if (r <= lit_end + 1) {
      const int off = f[F_OFF * S + seg];
      b = r == lit_end ? (off & 0xFF) : ((off >> 8) & 0xFF);
    } else {
      const int mlx = f[F_MLX * S + seg];
      const int me = f[F_MATCH_EXT * S + seg];
      b = (r - (lit_end + 2) < me - 1) ? 255 : floor_mod255(mlx - 15);
    }
  }
  return (uint32_t)b & 0xFFu;
}

// K % 4 == 0: one thread per 4 output bytes, vector load / word store.
__global__ void __launch_bounds__(THREADS)
emit_scatter_kernel_x4(const uint8_t* __restrict__ blocks,
                       const int* __restrict__ seg,
                       const int* __restrict__ fields,
                       const int* __restrict__ total, uint8_t* __restrict__ out,
                       int B, int K, int S) {
  const int m = blockIdx.y;
  const int k0 = (blockIdx.x * THREADS + threadIdx.x) * 4;
  if (k0 >= K) return;
  const int tot = total[m];
  uint32_t word = 0u;
  if (k0 < tot) {
    const uint8_t* blk = blocks + (size_t)m * B;
    const int* f = fields + (size_t)m * N_FIELDS * S;
    const int4 sg = *reinterpret_cast<const int4*>(seg + (size_t)m * K + k0);
    word = emit_one(blk, f, S, B, sg.x, k0, tot) |
           (emit_one(blk, f, S, B, sg.y, k0 + 1, tot) << 8) |
           (emit_one(blk, f, S, B, sg.z, k0 + 2, tot) << 16) |
           (emit_one(blk, f, S, B, sg.w, k0 + 3, tot) << 24);
  }
  *reinterpret_cast<uint32_t*>(out + (size_t)m * K + k0) = word;
}

// Any K: one thread per output byte.
__global__ void __launch_bounds__(THREADS)
emit_scatter_kernel_x1(const uint8_t* __restrict__ blocks,
                       const int* __restrict__ seg,
                       const int* __restrict__ fields,
                       const int* __restrict__ total, uint8_t* __restrict__ out,
                       int B, int K, int S) {
  const int m = blockIdx.y;
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  out[(size_t)m * K + k] = (uint8_t)emit_one(
      blocks + (size_t)m * B, fields + (size_t)m * N_FIELDS * S, S, B,
      seg[(size_t)m * K + k], k, total[m]);
}

}  // namespace

// blocks (M, B) uint8, seg (M, K) int32, fields (M, 8, S) int32,
// total (M,) int32 -> out (M, K) uint8.  seg and out must be 16-byte
// aligned at their base for the K % 4 == 0 path (torch allocations are).
extern "C" int emit_scatter_launch(const void* blocks, const void* seg,
                                   const void* fields, const void* total,
                                   void* out, int M, int B, int K, int S,
                                   void* stream) {
  if (K % 4 == 0) {
    const dim3 grid((K / 4 + THREADS - 1) / THREADS, M);
    emit_scatter_kernel_x4<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int*)seg, (const int*)fields,
        (const int*)total, (uint8_t*)out, B, K, S);
  } else {
    const dim3 grid((K + THREADS - 1) / THREADS, M);
    emit_scatter_kernel_x1<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int*)seg, (const int*)fields,
        (const int*)total, (uint8_t*)out, B, K, S);
  }
  return (int)cudaGetLastError();
}
