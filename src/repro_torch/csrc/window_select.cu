// Single-match window select (the free-pointer scan) for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: in the JAX package it is the graph
// stage `_select_sequential` (src/repro/core/jax_compressor.py), a
// `lax.scan` over the W = P / pws windows carrying the free pointer.  Eager
// PyTorch has no scan, and a Python loop of W steps per micro-batch would
// dominate the write path, so the stage gets a small kernel.
//
// Per window, in order: the earliest position that is valid and >= the free
// pointer is selected and the free pointer moves to pos + length; a window
// with no such position reports its base position and the raw length there
// (what argmax of an all-false row gives the reference) and leaves the free
// pointer alone.
//
// Bound: bytes on paper (read M * P valid bytes and M * P int32 lengths,
// write 9 bytes per window), but the carry makes the W steps of one block
// strictly sequential, so one block cannot go faster than W dependent steps.
// The design: one CTA per block; all threads stage a tile of TILE positions
// into shared memory with coalesced loads (validity packed to one bit per
// position with __ballot_sync), one thread walks the tile's windows with
// bit operations (mask, find-first-set) on the packed words, and all threads
// flush the tile's results with coalesced stores.  Parallelism comes from
// the micro-batch: M CTAs on M SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // positions staged per round; pws must divide it

__global__ void __launch_bounds__(THREADS)
window_select_kernel(const uint8_t* __restrict__ valid,
                     const int* __restrict__ lengths,
                     uint8_t* __restrict__ emit_out, int* __restrict__ pos_out,
                     int* __restrict__ len_out, int P, int pws) {
  __shared__ int s_len[TILE];
  __shared__ uint32_t s_mask[TILE / 32];
  __shared__ int s_pos[TILE];
  __shared__ int s_sel[TILE];
  __shared__ uint8_t s_emit[TILE];

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int W = P / pws;
  const uint8_t* vrow = valid + (size_t)m * P;
  const int* lrow = lengths + (size_t)m * P;
  int fp = 0;  // the free pointer; live in thread 0 only

  for (int t0 = 0; t0 < P; t0 += TILE) {
    const int tl = min(TILE, P - t0);
    // Stage the tile.  TILE % THREADS == 0, so every warp runs every trip
    // with all lanes and the full-mask ballot is well defined.
    for (int i = tid; i < TILE; i += THREADS) {
      bool v = false;
      int l = 0;
      if (i < tl) {
        v = vrow[t0 + i] != 0;
        l = lrow[t0 + i];
      }
      s_len[i] = l;
      const uint32_t bal = __ballot_sync(0xffffffffu, v);
      if ((tid & 31) == 0) s_mask[i >> 5] = bal;
    }
    __syncthreads();

    const int nw = tl / pws;
    if (tid == 0) {
      for (int w = 0; w < nw; ++w) {
        const int base = w * pws;        // tile-relative
        const int absbase = t0 + base;
        const int start = max(fp - absbase, 0);  // first eligible offset
        int idx = -1;
        if (start < pws) {
          if (pws <= 32) {
            uint32_t bits = s_mask[base >> 5] >> (base & 31);
            if (pws < 32) bits &= (1u << pws) - 1u;
            bits &= 0xffffffffu << start;
            if (bits) idx = __ffs(bits) - 1;
          } else {
            for (int j = start >> 5; j < (pws >> 5) && idx < 0; ++j) {
              uint32_t bits = s_mask[(base >> 5) + j];
              if (j == (start >> 5)) bits &= 0xffffffffu << (start & 31);
              if (bits) idx = (j << 5) + __ffs(bits) - 1;
            }
          }
        }
        const bool e = idx >= 0;
        if (!e) idx = 0;
        const int l = s_len[base + idx];
        s_emit[w] = e ? 1 : 0;
        s_pos[w] = absbase + idx;
        s_sel[w] = l;
        if (e) fp = absbase + idx + l;
      }
    }
    __syncthreads();

    const size_t o = (size_t)m * W + t0 / pws;
    for (int i = tid; i < nw; i += THREADS) {
      emit_out[o + i] = s_emit[i];
      pos_out[o + i] = s_pos[i];
      len_out[o + i] = s_sel[i];
    }
    // The next round's staging writes s_len / s_mask only; thread 0 cannot
    // overwrite the result arrays before the next barrier, which every
    // thread reaches after its flush.
  }
}

}  // namespace

// valid (M, P) bool/uint8, lengths (M, P) int32 -> emit (M, W) bool (as
// bytes), pos (M, W) int32, length (M, W) int32; W = P / pws, pws a power
// of two that divides 2048.
extern "C" int window_select_launch(const void* valid, const void* lengths,
                                    void* emit, void* pos, void* length,
                                    int M, int P, int pws, void* stream) {
  window_select_kernel<<<M, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const int*)lengths, (uint8_t*)emit, (int*)pos,
      (int*)length, P, pws);
  return (int)cudaGetLastError();
}
