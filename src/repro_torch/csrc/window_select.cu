// Single-match window select (the free-pointer scan) for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: in the JAX package it is the graph
// stage `_select_sequential` (src/repro/core/jax_compressor.py), a
// `lax.scan` over the W = P / pws windows carrying the free pointer.
//
// Per window, in order: the earliest position that is valid and >= the free
// pointer is selected and the free pointer moves to pos + length; a window
// with no such position reports its base position and the raw length there
// (what argmax of an all-false row gives the reference) and leaves the free
// pointer alone.
//
// Bound: bytes (read M * P valid bytes and M * P int32 lengths, write 9
// bytes per window).  What stands between the kernel and it is the carry:
// taken literally, the W steps of one block are strictly sequential.  The
// design breaks the carry with the JAX package's associative form
// (`_select_associative`), done in chunks inside one launch:
//
//  * State.  The state entering window w is d = clamp(fp - w * pws, 0, R - 1)
//    with R = max(1, largest length at a valid position of the block).  The
//    clip is exact for any data: after a selection at idx < pws with length
//    l the next window's d is idx + l - pws <= l - 1 <= R - 1, a window with
//    no selection only lowers d, and every d <= 0 behaves as 0.  R is found
//    while the block is staged, never assumed (the plain version accepts any
//    lengths, so nothing like max_match bounds it).
//  * Staging.  A block is spread over a thread block cluster of CLUSTER
//    CTAs (M * CLUSTER CTAs, two per SM).  Each CTA stages the windows of
//    its eighth of the block into shared memory: validity packed to one bit
//    per position (__ballot_sync), and per position the state that
//    selecting it leads to, max(pos % pws + l - pws, 0), as a byte (R <= CAP
//    keeps it below 255; a length below 0 gives state 0 like a length of
//    0).  A window step is then a masked word, one find-first-set and one
//    byte read.
//  * Phase 1.  The CTA's windows are cut into chunks of max(1, CHUNK_POS /
//    pws) windows; for every chunk and every entry state r < R a thread walks
//    the chunk (mask, find-first-set on the packed words) and records the
//    exit state: the chunk's transfer table, R bytes in shared memory.
//  * Phase 2.  For every r in parallel, the CTA composes its chunk tables in
//    order, recording each chunk's entry state for a CTA entry of r, and
//    publishes the composite.  After a cluster barrier each CTA resolves its
//    own entry state by applying the composites of the CTAs before it (at
//    most CLUSTER - 1 reads of distributed shared memory).
//  * Phase 3.  Each chunk walks again from its true entry state and records
//    the state entering each window; then one thread per window finds its
//    selection and writes emit / pos / length with coalesced stores (the
//    raw length is read back from the row, which is in L2).
//
// A block whose R exceeds CAP, or a P too large for the shared-memory
// budget, takes the sequential walk of the first design instead, inside the
// same launch: CTA 0 of the cluster stages TILE positions at a time and one
// thread walks the windows.  It is exact for any lengths, including ones
// whose free pointer wraps int32 as the plain version's does.
//
// What bounds it now: phase 1's W * R window steps per block (R = 36 at
// max_match 36), about 37K per CTA, which keep the SM's schedulers busy; the
// CTA with the most of them sets the launch's time.  Staging runs at about
// the card's memory rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int CLUSTER = 8;      // CTAs per block, one thread block cluster
constexpr int CHUNK_POS = 128;  // positions per chunk (at least one window)
constexpr int CAP = 255;        // largest R the chunked form takes
constexpr int TSTRIDE = 256;    // row stride of the transfer tables (> CAP)
constexpr int TILE = 2048;      // sequential path: positions per round
constexpr int SMEM_MAX = 232448;
constexpr int STATIC_SMEM = 1024;  // room left for the static shared arrays

// Index (0..pws-1) of the first valid position of the window at `base`
// (staged-relative) at or after offset d < pws, or -1.
__device__ __forceinline__ int first_valid(const uint32_t* bits, int base,
                                           int pws, int d) {
  if (pws <= 32) {
    uint32_t w = bits[base >> 5] >> (base & 31);
    if (pws < 32) w &= (1u << pws) - 1u;
    w &= 0xffffffffu << d;
    return w ? __ffs(w) - 1 : -1;
  }
  for (int j = d >> 5; j < (pws >> 5); ++j) {
    uint32_t w = bits[(base >> 5) + j];
    if (j == (d >> 5)) w &= 0xffffffffu << (d & 31);
    if (w) return (j << 5) + __ffs(w) - 1;
  }
  return -1;
}

// The state after selecting the valid position at staged offset pos with
// length l: max(pos % pws + l - pws, 0), l clamped below at 0 (the same
// state) and above at 255 (only reached when R > CAP, the sequential walk).
__device__ __forceinline__ int next_state(int pos, int l, int pws) {
  return max((pos & (pws - 1)) + min(max(l, 0), 255) - pws, 0);
}

// The state entering the next window, from state d entering the window at
// `base`.  nx[pos] is the state after selecting pos: max(idx + l - pws, 0)
// with idx = pos % pws, which the invariant keeps below R.
__device__ __forceinline__ int step(const uint32_t* bits, const uint8_t* nx,
                                    int base, int pws, int d) {
  if (pws <= 32) {  // uniform: the window is one masked word
    const uint32_t pmask = pws == 32 ? 0xffffffffu : (1u << pws) - 1u;
    const uint32_t m =
        d < pws ? ((bits[base >> 5] >> (base & 31)) & pmask) >> d : 0u;
    return m ? nx[base + d + __ffs(m) - 1] : max(d - pws, 0);
  }
  if (d >= pws) return d - pws;
  const int idx = first_valid(bits, base, pws, d);
  return idx < 0 ? 0 : nx[base + idx];
}

// The first design: one thread walks the block's windows in order.
__device__ void select_sequential(const uint8_t* vrow, const int* lrow,
                                  uint8_t* emit_o, int* pos_o, int* len_o,
                                  int P, int pws, uint8_t* smem) {
  int* s_len = reinterpret_cast<int*>(smem);
  int* s_pos = s_len + TILE;
  int* s_sel = s_pos + TILE;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_sel + TILE);
  uint8_t* s_emit = reinterpret_cast<uint8_t*>(s_mask + TILE / 32);
  const int tid = threadIdx.x;
  int fp = 0;  // the free pointer; live in thread 0 only

  for (int t0 = 0; t0 < P; t0 += TILE) {
    const int tl = min(TILE, P - t0);
    // TILE % THREADS == 0: every warp runs every trip with all lanes.
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
        const int base = w * pws;
        const int absbase = t0 + base;
        // The offset in 64 bits: a wrapped (negative) free pointer leaves
        // every position eligible, as in the plain version, and an int32
        // difference would overflow there.
        const long long rel = (long long)fp - absbase;
        const int start = rel <= 0 ? 0 : (int)min(rel, (long long)pws);
        const int idx0 = start < pws ? first_valid(s_mask, base, pws, start) : -1;
        const bool e = idx0 >= 0;
        const int idx = e ? idx0 : 0;
        const int l = s_len[base + idx];
        s_emit[w] = e ? 1 : 0;
        s_pos[w] = absbase + idx;
        s_sel[w] = l;
        if (e) fp = (int)((unsigned)(absbase + idx) + (unsigned)l);  // int32 wrap
      }
    }
    __syncthreads();
    const int o = t0 / pws;
    for (int i = tid; i < nw; i += THREADS) {
      emit_o[o + i] = s_emit[i];
      pos_o[o + i] = s_pos[i];
      len_o[o + i] = s_sel[i];
    }
    // The next round's staging writes s_len / s_mask only; thread 0 cannot
    // overwrite the results before the next barrier.
  }
}

// Where each array of the chunked form sits in dynamic shared memory.
struct Layout {
  int wpc, cpos, nchunk, cpr;  // windows and positions per chunk, chunks, chunks per CTA
  size_t nx_off, tab_off, ent_off, st_off, bytes;
};

__host__ __device__ inline Layout layout_of(int P, int pws) {
  Layout L;
  L.wpc = CHUNK_POS / pws > 1 ? CHUNK_POS / pws : 1;
  L.cpos = L.wpc * pws;                    // a multiple of 128: pws is a power of two
  L.nchunk = (P / pws + L.wpc - 1) / L.wpc;
  L.cpr = (L.nchunk + CLUSTER - 1) / CLUSTER;
  const size_t span = (size_t)L.cpr * L.cpos;  // positions one CTA stages, at most
  L.nx_off = span / 8;                     // after span / 32 validity words
  L.tab_off = L.nx_off + span;             // next state per position, a byte
  L.ent_off = L.tab_off + (size_t)L.cpr * TSTRIDE;  // transfer tables
  L.st_off = L.ent_off + (size_t)L.cpr * TSTRIDE;   // chunk entry states
  L.bytes = L.st_off + (size_t)L.cpr * L.wpc;       // state entering each window
  return L;
}

__global__ void __launch_bounds__(THREADS, 2)
window_select_kernel(const uint8_t* __restrict__ valid,
                     const int* __restrict__ lengths,
                     uint8_t* __restrict__ emit_out, int* __restrict__ pos_out,
                     int* __restrict__ len_out, int P, int pws, int chunked) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_rmax;              // this CTA's largest valid length
  __shared__ int s_R, s_entry;
  __shared__ uint8_t s_comp[TSTRIDE];  // composite of this CTA's chunks

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int W = P / pws;
  const uint8_t* vrow = valid + (size_t)m * P;
  const int* lrow = lengths + (size_t)m * P;
  const size_t orow = (size_t)m * W;

  const Layout L = layout_of(P, pws);
  const int c0 = min(rank * L.cpr, L.nchunk), c1 = min(c0 + L.cpr, L.nchunk);
  const int nc = c1 - c0;                          // this CTA's chunks
  const int w0 = c0 * L.wpc, w1 = min(c1 * L.wpc, W);  // ... windows
  const int p0 = w0 * pws, np = (w1 - w0) * pws;   // ... positions
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_nx = smem + L.nx_off;
  uint8_t* s_tab = smem + L.tab_off;
  uint8_t* s_ent = smem + L.ent_off;
  uint8_t* s_st = smem + L.st_off;

  if (tid == 0) s_rmax = 1;
  __syncthreads();
  if (chunked) {
    const int span = (np + 31) & ~31;
    int lmax = 1;
    // Stage: four independent loads per thread in flight, then pack.  The
    // trip count is uniform and span a multiple of 32, so every warp runs
    // each ballot with all lanes.
    for (int i0 = 0; i0 < span; i0 += 4 * THREADS) {
      bool v[4];
      int l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid;
        v[u] = false;
        l[u] = 0;
        if (i < np) {
          v[u] = __ldg(vrow + p0 + i) != 0;
          l[u] = __ldg(lrow + p0 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS + tid;
        const uint32_t bal = __ballot_sync(0xffffffffu, v[u]);
        if (i < span) {
          if ((tid & 31) == 0) s_bits[i >> 5] = bal;
          s_nx[i] = v[u] ? (uint8_t)next_state(i, l[u], pws) : 0;
        }
        if (v[u]) lmax = max(lmax, l[u]);
      }
    }
    lmax = __reduce_max_sync(0xffffffffu, lmax);
    if ((tid & 31) == 0) atomicMax(&s_rmax, lmax);
  }
  __syncthreads();
  cluster.sync();  // every CTA's s_rmax is final
  if (tid < 32) {  // one lane per CTA of the cluster reads its maximum
    int r = 1;
    if (tid < CLUSTER) r = *cluster.map_shared_rank(&s_rmax, (unsigned)tid);
    r = __reduce_max_sync(0xffffffffu, r);
    if (tid == 0) s_R = r;
  }
  __syncthreads();
  const int R = s_R;  // the same in every CTA of the cluster
  if (!chunked || R > CAP) {
    cluster.sync();  // no CTA leaves while another still reads its s_rmax
    if (rank == 0)
      select_sequential(vrow, lrow, emit_out + orow, pos_out + orow,
                        len_out + orow, P, pws, smem);
    return;
  }

  // -- phase 1: transfer table of every chunk, every entry state -------------
  for (int k = tid; k < nc * R; k += THREADS) {
    const int c = k / R, r = k - c * R;
    const int wa = (c0 + c) * L.wpc, wb = min(wa + L.wpc, W);
    int d = r;
    for (int w = wa; w < wb; ++w) d = step(s_bits, s_nx, (w - w0) * pws, pws, d);
    s_tab[c * TSTRIDE + r] = (uint8_t)d;
  }
  __syncthreads();

  // -- phase 2: compose this CTA's chunks; resolve its entry -----------------
  for (int r = tid; r < R; r += THREADS) {
    int d = r;
    for (int c = 0; c < nc; ++c) {
      s_ent[c * TSTRIDE + r] = (uint8_t)d;
      d = s_tab[c * TSTRIDE + d];
    }
    s_comp[r] = (uint8_t)d;
  }
  __syncthreads();
  cluster.sync();  // every CTA's composite is final
  if (tid == 0) {
    int d = 0;  // the free pointer starts at 0, the first window's base
    for (int j = 0; j < rank; ++j) d = *cluster.map_shared_rank(&s_comp[d], j);
    s_entry = d;
  }
  __syncthreads();

  // -- phase 3: walk each chunk from its true entry; one thread per window ---
  const int entry = s_entry;
  for (int c = tid; c < nc; c += THREADS) {
    const int wa = (c0 + c) * L.wpc, wb = min(wa + L.wpc, W);
    int d = s_ent[c * TSTRIDE + entry];
    for (int w = wa; w < wb; ++w) {
      s_st[w - w0] = (uint8_t)d;
      d = step(s_bits, s_nx, (w - w0) * pws, pws, d);
    }
  }
  __syncthreads();
  for (int w = w0 + tid; w < w1; w += THREADS) {
    const int d = s_st[w - w0];
    const int base = (w - w0) * pws;
    const int idx0 = d < pws ? first_valid(s_bits, base, pws, d) : -1;
    const int pos = p0 + base + (idx0 >= 0 ? idx0 : 0);
    emit_out[orow + w] = idx0 >= 0 ? 1 : 0;
    pos_out[orow + w] = pos;
    len_out[orow + w] = __ldg(lrow + pos);
  }
  cluster.sync();  // no CTA leaves while another may still read its s_comp
}

}  // namespace

// valid (M, P) bool/uint8, lengths (M, P) int32 -> emit (M, W) bool (as
// bytes), pos (M, W) int32, length (M, W) int32; W = P / pws, pws a power
// of two that divides 2048.
extern "C" int window_select_launch(const void* valid, const void* lengths,
                                    void* emit, void* pos, void* length,
                                    int M, int P, int pws, void* stream) {
  const size_t seq_bytes = (size_t)TILE * 13 + TILE / 8;
  const size_t fast_bytes = layout_of(P, pws).bytes;
  const int chunked = fast_bytes + STATIC_SMEM <= (size_t)SMEM_MAX;
  const size_t smem = chunked && fast_bytes > seq_bytes ? fast_bytes : seq_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      window_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, window_select_kernel, (const uint8_t*)valid,
                         (const int*)lengths, (uint8_t*)emit, (int*)pos,
                         (int*)length, P, pws, chunked);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
