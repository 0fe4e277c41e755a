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
// the int32 table (256 KB) in VMEM and runs one grid step per block.  Here a
// block is spread over a thread block cluster of C CTAs: the largest C of
// CLUSTER, CLUSTER / 2, ..., CLUSTER_MIN for which M * C CTAs fit the SMs in
// one wave (clusters of 16 measured slower than 8 even where 16 M CTAs
// fit, and fewer, larger slices cross CTAs less once the SMs are full):
//
//  * Layout.  CTA r owns the slice [r * S, r * S + S) of the K entries, S
//    the smallest power of two >= max(ceil(K / C), MIN_SLICE).  Its shared
//    memory holds two uint16 copies of its slice of the table (`cur`, `next`;
//    every position is < 65536) and `lb`, one byte per own entry j:
//    byte(block[lit_blk[j]]), read once from device memory (lit_blk
//    coalesced, the payload row through the read-only cache) with the
//    `jnp.take` rules below.  Nothing else of the row is staged.
//  * A round.  For each own entry k: a = cur[k] (local, 16-byte loads), then
//    cur[a] from the CTA that owns a (`map_shared_rank`, distributed shared
//    memory, its own CTA's included: a branch to a plain shared load
//    measured slower), written to next[k] (16-byte stores).  A CTA whose
//    entries changed stamps r + 1 into the flag of parity r & 1 of every CTA
//    of the cluster (remote stores, off the critical path); one cluster
//    barrier; then every CTA reads its own flag and all take the same
//    decision: stop when no entry of the block changed (the table is at a
//    fixed point, so the result is that of all `rounds`).  A flag of parity
//    r & 1 is written again only after the next barrier, which every reader
//    of round r has passed, so the stamps need no reset.  Reads of round r
//    all precede the barrier, writes of round r + 1 into the same buffer
//    follow it: one barrier per round, no per-thread array of gathered
//    values.
//  * Output.  out[k] = k < total ? lb[cur[k]] : 0, lb read from the owner
//    of cur[k], 16 bytes per thread and store where K % 16 == 0.  A last
//    cluster barrier keeps every CTA's shared memory alive until no CTA
//    reads it any more.
//
// Bounds: `ptr` is clipped to [0, K-1] on load (the caller's precondition;
// `ops.decode_gather` clips it).  `lit_blk` is read as `jnp.take` reads it:
// a value in [-B, -1] wraps by B, any other value outside [0, B) gives byte
// 0 (the reference's INT32_MIN fill, cast to uint8).  Nothing is read
// outside the row.  Entries of the last slice past K start as 0 so every
// pointer stays inside [0, K) and they never count as a change.
//
// Wider tables (K > MAX_K = 65,536: an `out_cap` wider than the engine's
// default) take a second kernel in the same launch: one CTA per row, the
// pointer table as int32 in two copies in a scratch buffer in device memory
// (the wrapper's), ping-ponged, one CTA barrier per round (`__syncthreads_or`
// of "anything changed", so it stops at the same fixed point), and the
// output read from lit_blk and the row at the resolved source.  It is
// correct, not fast: no engine path with the default caps reaches it.
//
// Bound: bytes.  The function must read the block (B), lit_blk and ptr
// (4K each) and write K bytes per row; the rounds run in shared memory.
// What bounds it now: the rounds, each a dependent local-then-remote
// shared-memory gather per entry followed by a cluster barrier.  Random
// maps that run all 16 rounds (hops mostly to other CTAs) are slower than
// a design that keeps the whole table in one CTA; chains that point
// backwards, as valid blocks do, are faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;          // per CTA, where two CTAs share an SM
constexpr int THREADS_ALONE = 1024;   // where one CTA's shared memory fills it
constexpr int CLUSTER = 8;            // CTAs per block, at most
constexpr int CLUSTER_MIN = 2;        // ... at least
constexpr int MIN_SLICE = 16;      // slice lengths: powers of two >= this
constexpr int MAX_K = 65536;       // uint16 positions
constexpr int HEADER = 16;         // the two round flags, padded to 16 bytes
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int slice_log2(int K, int C) {
  const int per = (K + C - 1) / C;
  int lg = 0;
  while ((1 << lg) < per || (1 << lg) < MIN_SLICE) ++lg;
  return lg;
}

__host__ __device__ inline int smem_bytes(int lg) { return HEADER + 5 * (1 << lg); }

__device__ __forceinline__ uint8_t literal_byte(const uint8_t* brow, int s, int B) {
  if (s < 0) s += B;  // no overflow: s >= INT_MIN and B >= 0
  return (s >= 0 && s < B) ? __ldg(brow + s) : (uint8_t)0;
}

__global__ void __launch_bounds__(THREADS_ALONE, 1)
decode_wave_kernel(const uint8_t* __restrict__ blocks,
                   const int* __restrict__ lit_blk,
                   const int* __restrict__ ptr, const int* __restrict__ total,
                   uint8_t* __restrict__ out, int B, int K, int rounds, int lg,
                   int vec_in) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / C;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int S = 1 << lg;
  const int k0 = rank << lg;
  const int len = max(0, min(S, K - k0));  // own entries; the rest is padding

  int* s_flag = reinterpret_cast<int*>(smem);
  uint16_t* buf0 = reinterpret_cast<uint16_t*>(smem + HEADER);
  uint16_t* buf1 = buf0 + S;
  uint8_t* s_lb = reinterpret_cast<uint8_t*>(buf1 + S);

  const int* prow = ptr + (size_t)m * K + k0;
  const int* lrow = lit_blk + (size_t)m * K + k0;
  const uint8_t* brow = blocks + (size_t)m * B;

  // -- stage: the slice of ptr (clipped, as uint16) and of the literal bytes
  if (tid < 2) s_flag[tid] = 0;
#pragma unroll 4
  for (int k = tid * 4; k < S; k += nthr * 4) {
    int p[4], s[4];
    if (vec_in && k + 4 <= len) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(prow + k));
      const int4 b = __ldg(reinterpret_cast<const int4*>(lrow + k));
      p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
      s[0] = b.x; s[1] = b.y; s[2] = b.z; s[3] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool own = k + i < len;
        p[i] = own ? __ldg(prow + k + i) : 0;
        s[i] = own ? __ldg(lrow + k + i) : -1 - B;  // padding: byte 0, never read
      }
    }
    uint32_t pw[2], lw = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t c = (uint32_t)min(max(p[i], 0), K - 1);
      if (i & 1) pw[i >> 1] |= c << 16; else pw[i >> 1] = c;
      lw |= (uint32_t)literal_byte(brow, s[i], B) << (8 * i);
    }
    *reinterpret_cast<uint2*>(buf0 + k) = make_uint2(pw[0], pw[1]);
    *reinterpret_cast<uint32_t*>(s_lb + k) = lw;
  }
  cluster.sync();  // every CTA's slice and literal bytes are in place

  // -- rounds: next[k] = cur[cur[k]], one cluster barrier each ---------------
  uint16_t* cur = buf0;
  uint16_t* nxt = buf1;
  const int lane = tid & 31;
  for (int r = 0; r < rounds; ++r) {
    bool changed = false;
    for (int k = tid * 8; k < len; k += nthr * 8) {
      const uint4 a4 = *reinterpret_cast<const uint4*>(cur + k);
      const uint32_t aw[4] = {a4.x, a4.y, a4.z, a4.w};
      uint32_t vw[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t a = (aw[i >> 1] >> (16 * (i & 1))) & 0xffffu;
        const uint32_t v =
            *cluster.map_shared_rank(cur + (a & (uint32_t)(S - 1)), (int)(a >> lg));
        changed |= (k + i < len) && v != a;
        if (i & 1) vw[i >> 1] |= v << 16; else vw[i >> 1] = v;
      }
      *reinterpret_cast<uint4*>(nxt + k) = make_uint4(vw[0], vw[1], vw[2], vw[3]);
    }
    // A warp with a change stamps the round into every CTA's flag (lane j
    // writes CTA j's); after the barrier each CTA reads its own copy.
    if (__any_sync(0xffffffffu, changed) && lane < C)
      *cluster.map_shared_rank(s_flag + (r & 1), lane) = r + 1;
    cluster.sync();
    uint16_t* t = cur; cur = nxt; nxt = t;
    if (s_flag[r & 1] != r + 1) break;  // the same decision in every CTA
  }

  // -- output: lb of the resolved source, from its owner ---------------------
  const int tot = total[m];
  uint8_t* orow = out + (size_t)m * K + k0;
  const bool vec_out = (K & 15) == 0 && ((uintptr_t)out & 15) == 0;
  for (int k = tid * 16; k < len; k += nthr * 16) {
    const uint4 lo = *reinterpret_cast<const uint4*>(cur + k);
    const uint4 hi = *reinterpret_cast<const uint4*>(cur + k + 8);
    const uint32_t aw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t ow[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t a = (aw[i >> 1] >> (16 * (i & 1))) & 0xffffu;
      uint32_t b = 0;
      if (k + i < len && k0 + k + i < tot)
        b = *cluster.map_shared_rank(s_lb + (a & (uint32_t)(S - 1)), (int)(a >> lg));
      ow[i >> 2] |= b << (8 * (i & 3));
    }
    if (vec_out && k + 16 <= len) {
      *reinterpret_cast<uint4*>(orow + k) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    } else {
      for (int i = 0; i < 16 && k + i < len; ++i)
        orow[k + i] = (uint8_t)(ow[i >> 2] >> (8 * (i & 3)));
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its memory
}

// Tables wider than MAX_K: one CTA per row, the two int32 copies of the
// table in `scratch` (2 * M * K int32).  Entries written in this launch are
// read with plain loads (not __ldg): a CTA barrier makes its own global
// stores visible to its threads.
__global__ void __launch_bounds__(THREADS_ALONE, 1)
decode_wave_wide_kernel(const uint8_t* __restrict__ blocks,
                        const int* __restrict__ lit_blk,
                        const int* __restrict__ ptr, const int* __restrict__ total,
                        uint8_t* __restrict__ out, int* __restrict__ scratch,
                        int B, int K, int rounds) {
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)m * K;
  int* cur = scratch + row;
  int* nxt = scratch + (size_t)gridDim.x * K + row;
  for (int k = tid; k < K; k += THREADS_ALONE)
    cur[k] = min(max(__ldg(ptr + row + k), 0), K - 1);
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (int k = tid; k < K; k += THREADS_ALONE) {
      const int a = cur[k];
      const int v = cur[a];
      nxt[k] = v;
      changed |= v != a;
    }
    const int any = __syncthreads_or(changed);
    int* t = cur; cur = nxt; nxt = t;
    if (!any) break;  // a fixed point: the remaining rounds change nothing
  }
  const int tot = total[m];
  const uint8_t* brow = blocks + (size_t)m * B;
  for (int k = tid; k < K; k += THREADS_ALONE)
    out[row + k] = k < tot ? literal_byte(brow, __ldg(lit_blk + row + cur[k]), B) : (uint8_t)0;
}

// Threads per CTA: a CTA that needs more than half of an SM's shared
// memory has the SM to itself, so it takes all its threads.
int threads_for(int smem) { return 2 * smem > SMEM_MAX ? THREADS_ALONE : THREADS; }

// Whether the card can schedule a cluster of C CTAs with `smem` bytes of
// shared memory each (cudaOccupancyMaxActiveClusters), asked once per (C,
// smem) pair and remembered.
bool cluster_fits(int C, int smem) {
  static int known_c[8], known_smem[8], known_ok[8], n_known = 0;
  for (int i = 0; i < n_known; ++i)
    if (known_c[i] == C && known_smem[i] == smem) return known_ok[i];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(threads_for(smem));
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const bool ok = cudaOccupancyMaxActiveClusters(&n, decode_wave_kernel, &cfg) ==
                      cudaSuccess && n > 0;
  cudaGetLastError();  // clear the error of a refused query
  if (n_known < 8) {
    known_c[n_known] = C;
    known_smem[n_known] = smem;
    known_ok[n_known++] = ok;
  }
  return ok;
}

// The CTAs per block (cluster size) a launch of M blocks takes.
int cluster_for(int M) {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int C = CLUSTER;
  while (C > CLUSTER_MIN && M * C > sms) C /= 2;
  return C;
}

}  // namespace

// blocks (M, B) uint8, lit_blk (M, K) int32, ptr (M, K) int32, total (M,)
// int32 -> out (M, K) uint8.  K >= 1; scratch: 2 * M * K int32 where
// K > MAX_K (null otherwise).
extern "C" int decode_wave_launch(const void* blocks, const void* lit_blk,
                                  const void* ptr, const void* total, void* out,
                                  void* scratch, int M, int B, int K, int rounds,
                                  void* stream) {
  if (K < 1 || B < 0 || M < 1) return (int)cudaErrorInvalidValue;
  if (K > MAX_K) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    decode_wave_wide_kernel<<<M, THREADS_ALONE, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (const int*)lit_blk, (const int*)ptr,
        (const int*)total, (uint8_t*)out, (int*)scratch, B, K, rounds);
    return (int)cudaGetLastError();
  }
  const int C = cluster_for(M);
  const int lg = slice_log2(K, C);
  const int smem = smem_bytes(lg);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decode_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (!cluster_fits(C, smem)) return (int)cudaErrorInvalidConfiguration;
  const int vec_in = (K & 3) == 0 && (((uintptr_t)ptr | (uintptr_t)lit_blk) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * C);
  cfg.blockDim = dim3(threads_for(smem));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_wave_kernel, (const uint8_t*)blocks,
                         (const int*)lit_blk, (const int*)ptr,
                         (const int*)total, (uint8_t*)out, B, K, rounds, lg,
                         vec_in);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
