// Chain validation and decode layout for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one.  It replaces the stock graph
// stages that follow the header kernel in `plan_decode` of the JAX package
// (src/repro/kernels/ops.py): `plan_speculative`'s checks, cumsum and
// compaction of the chain into plan columns, and `_decode_layout`'s span
// maps and gathers, which the port ran as about a hundred stock torch ops a
// dispatch (scatters with one sentinel slot that every dead offset of a row
// hits, scans, gathers over (M, out_cap)).  From the seven (M, B) header
// fields of `plan_speculative.cu` it writes each row's status (the host
// planner's error code, the uncapped literal-run and match counts, the
// decoded size, the overflow flag), its decode total (the size where the row
// is clean, else 0) and `decode_wave`'s two (M, out_cap) int32 inputs.
// Field for field it is `ref.plan_layout_ref`.
//
// The layout needs no compaction into columns and no span maps.  Chain node
// x emits its literals at output offset prev_total (the sum of the nodes
// before it) and its match right after them; the ranges of a clean chain
// tile [0, out_size), so the node that covers output byte k is the last one
// whose prev_total is at most k.
//
// Bound: bytes.  A row reads is_start below n (4 B an offset), the fields at
// its chain nodes, and writes 8 B an output byte: at the engine's caps under
// 1 MB a row, a few microseconds a dispatch at 3.35 TB/s.  One thread block
// cluster of CLUSTER CTAs takes a row, so that a dispatch of 8 rows still
// spreads over 64 SMs, and every phase is a pass over a slice:
//
//  1. Scan.  Each CTA owns a slice of [0, n) and walks it in tiles of PER
//     offsets a thread (16-byte loads of is_start).  A started offset loads
//     lit_len, ls_end and mlen, and adds lit_len (+ mlen unless final) to
//     the running sum; a block scan gives each node its offset within the
//     slice, and the node goes to the CTA's list in device scratch as
//     (offset, sum before it).  The literal-run and match counts and the
//     final flag are summed alongside.
//  2. Checks.  After a cluster barrier each CTA reads the others' slice sums
//     and counts through distributed shared memory: the slice's base, the
//     row's out_size and counts (int32, wrapping as the stock ops do).  Each
//     node of the slice then runs the eight checks in the host planner's
//     order with its prev_total, keeps the first failing code, and the CTA
//     takes the lowest failing offset's (offset, code) with a shared-memory
//     atomic min.  The node's list entry is rewritten as what the writes
//     read: (prev_total, lit_len, lit_start, off).  A thread takes four
//     nodes at a time, so that their loads are in flight together.
//  3. Status.  After a second barrier the lowest key over the cluster is the
//     row's code (9 where no final node and no failing check); rank 0 writes
//     the status and the total.
//  4. Writes.  Each CTA owns a slice of [0, out_cap).  For a clean row, two
//     warp searches (a 32-way split a step over the sorted prev_totals of
//     one CTA's list) find the nodes that cover the slice's first and last
//     byte below out_size; the entries between are copied to shared memory
//     in windows of WCAP (one window at the engine's caps: a node other than
//     the final one covers at least 4 bytes), and each thread takes groups
//     of 4 output bytes, one binary search in the window a group, and
//     writes them with 16-byte stores.  The rest of the slice, and all of an
//     unclean row, gets ptr = k, lit_blk = 0.
//
// Every length is taken: slices are looped over in tiles and windows, so
// any B and out_cap run through this one path; the node lists take at most
// one entry an offset (B x 4 int32 a row, allocated by the wrapper).
// The layout of a clean row assumes what `plan_speculative`'s fields give:
// lit_len >= 0 and mlen >= 4 at every node, so the sums do not decrease.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;        // CTAs per row, one thread block cluster
constexpr int PER = 16;           // offsets a thread in one tile of the scan
constexpr int TILE = THREADS * PER;
constexpr int WCAP = 2056;        // chain nodes in one window of the writes
constexpr int N_STATUS = 5;
constexpr int ERR_MISSING_TOKEN = 9;
constexpr unsigned FULL = 0xffffffffu;

struct Slice {   // one CTA's part of a row, read by the others
  int count;     // chain nodes
  unsigned sum;  // their lit_len + mlen, wrapping
  int n_lit, n_match, final_ok;
};

// a + b with two's-complement wrap, as the stock ops' int32 sums
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// Exclusive block scan of (c, s); the block's totals in (tc, ts).
__device__ void block_scan(int& c, unsigned& s, int& tc, unsigned& ts,
                           int* s_wc, unsigned* s_ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ic = c;
  unsigned is = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int oc = __shfl_up_sync(FULL, ic, d);
    const unsigned os = __shfl_up_sync(FULL, is, d);
    if (lane >= d) {
      ic += oc;
      is += os;
    }
  }
  if (lane == 31) {
    s_wc[warp] = ic;
    s_ws[warp] = is;
  }
  __syncthreads();
  if (warp == 0) {
    int vc = lane < WARPS ? s_wc[lane] : 0;
    unsigned vs = lane < WARPS ? s_ws[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int oc = __shfl_up_sync(FULL, vc, d);
      const unsigned os = __shfl_up_sync(FULL, vs, d);
      if (lane >= d) {
        vc += oc;
        vs += os;
      }
    }
    if (lane < WARPS) {
      s_wc[lane] = vc;
      s_ws[lane] = vs;
    }
  }
  __syncthreads();
  c = (warp ? s_wc[warp - 1] : 0) + ic - c;
  s = (warp ? s_ws[warp - 1] : 0u) + is - s;
  tc = s_wc[WARPS - 1];
  ts = s_ws[WARPS - 1];
  __syncthreads();  // the next call rewrites s_wc, s_ws
}

// The last t in [0, cnt) with list[t].x <= x, given list[0].x <= x and the
// .x non-decreasing: one warp, a 32-way split a step.
__device__ int warp_last_le(const int4* list, int cnt, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cnt;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int t = lo + lane * step;
    const bool ok = t < hi && __ldcg(&list[t].x) <= x;
    const unsigned ball = __ballot_sync(FULL, ok);
    lo += (31 - __clz(ball)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// Writes (lit_blk, ptr) = f(p, hint) for p in [lo, hi): aligned groups of 4
// with 16-byte stores when `vec`, the ragged ends (or all, without `vec`)
// one at a time.  `hint` starts at -1 for each group and f may keep state in
// it for the next byte of the group.
template <class F>
__device__ void write_range(int* lb, int* pt, int lo, int hi, bool vec, F f) {
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  int vlo = hi, vhi = hi;
  if (vec) {
    vlo = min((lo + 3) & ~3, hi);
    vhi = max(vlo, hi & ~3);
  }
  for (int p = lo + tid; p < vlo; p += THREADS) {
    int h = -1;
    const int2 v = f(p, h);
    lb[p] = v.x;
    pt[p] = v.y;
  }
  for (int p = vhi + tid; p < hi; p += THREADS) {
    int h = -1;
    const int2 v = f(p, h);
    lb[p] = v.x;
    pt[p] = v.y;
  }
  for (int q = (vlo >> 2) + tid; q < (vhi >> 2); q += THREADS) {
    int h = -1;
    const int p = q << 2;
    const int2 v0 = f(p, h), v1 = f(p + 1, h), v2 = f(p + 2, h), v3 = f(p + 3, h);
    reinterpret_cast<int4*>(lb)[q] = make_int4(v0.x, v1.x, v2.x, v3.x);
    reinterpret_cast<int4*>(pt)[q] = make_int4(v0.y, v1.y, v2.y, v3.y);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
plan_layout_kernel(const int* __restrict__ is_start, const int* __restrict__ lit_start,
                   const int* __restrict__ lit_len, const int* __restrict__ ls_end,
                   const int* __restrict__ off, const int* __restrict__ mlen,
                   const int* __restrict__ flags, const int* __restrict__ ns,
                   const int* __restrict__ max_outs, int* __restrict__ status,
                   int* __restrict__ total, int* __restrict__ lit_blk,
                   int* __restrict__ ptr, int4* __restrict__ scratch, int B,
                   int out_cap, int max_lit, int max_match) {
  __shared__ int s_wc[WARPS];
  __shared__ unsigned s_ws[WARPS];
  __shared__ Slice s_slice;               // this CTA's, read by the others
  __shared__ Slice s_all[CLUSTER];        // every CTA's, copied here
  __shared__ unsigned s_base[CLUSTER];    // output offset of each CTA's first node
  __shared__ int s_cpre[CLUSTER];         // nodes before each CTA's
  __shared__ unsigned long long s_key;    // lowest (offset << 4 | code)
  __shared__ unsigned long long s_keys[CLUSTER];
  __shared__ int s_clean, s_out_size, s_g[2], s_hi;
  __shared__ int win_S[WCAP], win_ll[WCAP], win_src[WCAP], win_off[WCAP];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)m * B;
  const int n = ns[m], max_out = max_outs[m];
  const int nn = min(max(n, 0), B);   // is_start is read below n only
  const int L = ((nn + CLUSTER - 1) / CLUSTER + 3) & ~3;   // offsets per slice
  const int s0 = min(rank * L, nn), s1 = min(s0 + L, nn);
  int4* list = scratch + row + s0;    // this CTA's nodes, in offset order

  if (tid == 0) {
    s_slice = Slice{0, 0u, 0, 0, 0};
    s_key = ~0ull;
  }
  __syncthreads();

  // -- 1. scan: this slice's nodes, their running sum, the counts -----------
  const bool vec_in = (B & 3) == 0 && (reinterpret_cast<uintptr_t>(is_start) & 15) == 0;
  int count = 0, n_lit = 0, n_match = 0, final_ok = 0;
  unsigned sum = 0;
  for (int t0 = s0; t0 < s1; t0 += TILE) {
    const int i0 = t0 + tid * PER;
    int st[PER];
    if (vec_in && i0 + PER <= s1) {
      const int4* p4 = reinterpret_cast<const int4*>(is_start + row + i0);
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const int4 v = __ldg(p4 + q);
        st[4 * q] = v.x;
        st[4 * q + 1] = v.y;
        st[4 * q + 2] = v.z;
        st[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < PER; ++q)
        st[q] = i0 + q < s1 ? __ldg(is_start + row + i0 + q) : 0;
    }
    int c[PER];
    unsigned mask = 0;
    int tc = 0;
    unsigned ts = 0;
    // The fields of the started offsets, eight offsets' loads at a time.
#pragma unroll
    for (int h = 0; h < PER; h += 8) {
      int ll[8], ls[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        ll[q] = 0;
        ls[q] = n;
        if (st[h + q] > 0) {
          ll[q] = __ldg(lit_len + row + i0 + h + q);
          ls[q] = __ldg(ls_end + row + i0 + h + q);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[h + q] = 0;
        if (st[h + q] > 0) {
          const bool nonfinal = ls[q] != n;
          c[h + q] = wadd(ll[q], nonfinal ? __ldg(mlen + row + i0 + h + q) : 0);
          mask |= 1u << (h + q);
          ++tc;
          ts += (unsigned)c[h + q];
          n_lit += ll[q] > 0;
          n_match += nonfinal;
          final_ok |= !nonfinal;
        }
      }
    }
    int bc;
    unsigned bs;
    block_scan(tc, ts, bc, bs, s_wc, s_ws);
    int at = count + tc;
    unsigned before = sum + ts;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (mask >> q & 1u) {
        list[at++] = make_int4(i0 + q, (int)before, 0, 0);
        before += (unsigned)c[q];
      }
    }
    count += bc;
    sum += bs;
  }
  if (tid == 0) {
    s_slice.count = count;
    s_slice.sum = sum;
  }
  if (n_lit) atomicAdd(&s_slice.n_lit, n_lit);
  if (n_match) atomicAdd(&s_slice.n_match, n_match);
  if (final_ok) atomicOr(&s_slice.final_ok, 1);
  cluster.sync();

  // -- 2. checks: every node of the slice, with its prev_total ---------------
  if (tid < CLUSTER) s_all[tid] = *cluster.map_shared_rank(&s_slice, tid);
  __syncthreads();
  if (tid == 0) {
    unsigned b = 0;
    int cp = 0;
    for (int j = 0; j < CLUSTER; ++j) {
      s_base[j] = b;
      s_cpre[j] = cp;
      b += s_all[j].sum;
      cp += s_all[j].count;
    }
  }
  __syncthreads();
  const unsigned base = s_base[rank];
  // UNROLL nodes a thread at a time, their loads issued together; each
  // entry becomes (prev_total, lit_len, lit_start, off): what the writes read.
  constexpr int UNROLL = 4;
  for (int x0 = 0; x0 < count; x0 += UNROLL * THREADS) {
    int i[UNROLL], prev[UNROLL], ll[UNROLL], ls[UNROLL], o[UNROLL], ml[UNROLL],
        fl[UNROLL], src[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int x = x0 + u * THREADS + tid;
      i[u] = -1;
      if (x < count) {
        const int4 v = __ldcg(list + x);
        i[u] = v.x;
        prev[u] = (int)(base + (unsigned)v.y);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i[u] >= 0) {
        const size_t at = row + i[u];
        ll[u] = __ldg(lit_len + at);
        ls[u] = __ldg(ls_end + at);
        o[u] = __ldg(off + at);
        ml[u] = __ldg(mlen + at);
        fl[u] = __ldg(flags + at);
        src[u] = __ldg(lit_start + at);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i[u] < 0) continue;
      const bool nonfinal = ls[u] != n;
      const int before = wadd(prev[u], ll[u]);
      int code = 0;
      if (fl[u] & 1) code = 1;                                      // truncated lit len
      else if (ls[u] > n) code = 2;                                 // truncated literals
      else if (wadd(prev[u], ll[u]) > max_out) code = 3;            // output exceeds limit
      else if (nonfinal && wadd(ls[u], 2) > n) code = 4;            // truncated offset
      else if (nonfinal && o[u] == 0) code = 5;                     // zero offset
      else if (nonfinal && o[u] > before) code = 6;                 // offset beyond output
      else if (nonfinal && (fl[u] & 2)) code = 7;                   // truncated match len
      else if (nonfinal && wadd(before, ml[u]) > max_out) code = 8;  // exceeds limit
      if (code) atomicMin(&s_key, (unsigned long long)i[u] << 4 | (unsigned)code);
      list[x0 + u * THREADS + tid] = make_int4(prev[u], ll[u], src[u], o[u]);
    }
  }
  __threadfence();
  cluster.sync();

  // -- 3. status: the lowest failing offset's code over the cluster ---------
  if (tid < CLUSTER) s_keys[tid] = *cluster.map_shared_rank(&s_key, tid);
  __syncthreads();
  if (tid == 0) {
    unsigned long long key = ~0ull;
    int lits = 0, matches = 0, fin = 0;
    for (int j = 0; j < CLUSTER; ++j) {
      key = min(key, s_keys[j]);
      lits += s_all[j].n_lit;
      matches += s_all[j].n_match;
      fin |= s_all[j].final_ok;
    }
    const int out_size = (int)(s_base[CLUSTER - 1] + s_all[CLUSTER - 1].sum);
    const int code = key != ~0ull ? (int)(key & 15u) : fin ? 0 : ERR_MISSING_TOKEN;
    const int over = lits > max_lit || matches > max_match || out_size > out_cap;
    s_clean = code == 0 && !over;
    s_out_size = out_size;
    if (rank == 0) {
      int* srow = status + (size_t)m * N_STATUS;
      srow[0] = code;
      srow[1] = lits;
      srow[2] = matches;
      srow[3] = out_size;
      srow[4] = over;
      total[m] = s_clean ? out_size : 0;
    }
  }
  __syncthreads();

  // -- 4. writes: this CTA's slice of the output row ----------------------
  const int Q = ((out_cap + CLUSTER - 1) / CLUSTER + 3) & ~3;
  const int a = min(rank * Q, out_cap), b = min(a + Q, out_cap);
  const int e = s_clean ? max(a, min(b, s_out_size)) : a;   // [a, e): the chain's bytes
  int* lb = lit_blk + (size_t)m * out_cap;
  int* pt = ptr + (size_t)m * out_cap;
  const bool vec = (out_cap & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(lit_blk) | reinterpret_cast<uintptr_t>(ptr)) & 15) == 0;
  const int4* lists = scratch + row;
  auto slice_of = [&](int j) { return min(j * L, nn); };
  if (e > a) {
    // The node covering a byte: the last CTA whose first node starts at or
    // before it, then a search in that CTA's list.
    if (warp < 2) {
      const int x = warp == 0 ? a : e - 1;
      int j = CLUSTER - 1;
      while (j > 0 && !(s_all[j].count > 0 && (int)s_base[j] <= x)) --j;
      const int t = warp_last_le(lists + slice_of(j), s_all[j].count, x);
      if (lane == 0) s_g[warp] = s_cpre[j] + t;
    }
    __syncthreads();
    const int g0 = s_g[0], g1 = s_g[1];
    auto node = [&](int g) {
      int j = CLUSTER - 1;
      while (j > 0 && !(s_all[j].count > 0 && s_cpre[j] <= g)) --j;
      return __ldcg(lists + slice_of(j) + (g - s_cpre[j]));
    };
    for (int g = g0; g <= g1; g += WCAP) {
      const int cnt = min(WCAP, g1 - g + 1);
      // The window's nodes, 4 a thread with their loads issued together;
      // entry cnt gives the range's end.
      for (int w0 = 0; w0 <= cnt; w0 += 4 * THREADS) {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = w0 + u * THREADS + tid;
          if (w < cnt || (w == cnt && g + cnt <= g1)) v[u] = node(g + w);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int w = w0 + u * THREADS + tid;
          if (w < cnt) {
            win_S[w] = v[u].x;
            win_ll[w] = v[u].y;
            win_src[w] = v[u].z;
            win_off[w] = v[u].w;
          } else if (w == cnt) {
            s_hi = g + cnt <= g1 ? v[u].x : e;
          }
        }
      }
      __syncthreads();
      const int lo = g == g0 ? a : win_S[0];
      write_range(lb, pt, lo, s_hi, vec, [&](int p, int& w) {
        if (w < 0) {   // the last window node starting at or before p
          int l = 0, h = cnt;
          while (h - l > 1) {
            const int mid = (l + h) >> 1;
            if (win_S[mid] <= p) l = mid;
            else h = mid;
          }
          w = l;
        }
        while (w + 1 < cnt && win_S[w + 1] <= p) ++w;
        const int S = win_S[w];
        if (p - S < win_ll[w]) return make_int2(win_src[w] + (p - S), p);
        return make_int2(0, min(max(p - win_off[w], 0), out_cap - 1));
      });
      __syncthreads();   // the next window overwrites this one
    }
  }
  write_range(lb, pt, e, b, vec, [](int p, int&) { return make_int2(0, p); });
  cluster.sync();   // no CTA leaves while another may still read its keys
}

}  // namespace

// fields: seven (M, B) int32 rows of plan_speculative (is_start, lit_start,
// lit_len, ls_end, off, mlen, flags); n, max_out (M,) int32 -> status
// (M, 5) int32, total (M,) int32, lit_blk and ptr (M, out_cap) int32.
// scratch: M * B int4 (each row's chain nodes).
extern "C" int plan_layout_launch(const void* is_start, const void* lit_start,
                                  const void* lit_len, const void* ls_end,
                                  const void* off, const void* mlen,
                                  const void* flags, const void* n,
                                  const void* max_out, void* status, void* total,
                                  void* lit_blk, void* ptr, void* scratch, int M,
                                  int B, int out_cap, int max_lit, int max_match,
                                  void* stream) {
  if (M < 1 || B < 1 || out_cap < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)M * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, plan_layout_kernel, (const int*)is_start, (const int*)lit_start,
      (const int*)lit_len, (const int*)ls_end, (const int*)off, (const int*)mlen,
      (const int*)flags, (const int*)n, (const int*)max_out, (int*)status,
      (int*)total, (int*)lit_blk, (int*)ptr, (int4*)scratch, B, out_cap, max_lit,
      max_match);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
