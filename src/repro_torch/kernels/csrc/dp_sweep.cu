// Batched min-plus DP sweep of the placement path, f64, for Hopper (sm_90a).
//
// Replaces the jitted XLA kernel repro/core/batch_dp.py:75
// (_build_kernel.sweep, not a Pallas kernel), which reproduces the numpy
// oracle repro/core/ould.py::_sparse_run row by row.  For S rows (one
// request source each), M layers and k candidate nodes a layer:
//   c0[b]      = (Ks * spb[src, cand0[b]] + pen0[b]) + cc[0, cand0[b]]
//   t_j[a, b]  = (Kv[j-1] * spb[cand_{j-1}[a], cand_j[b]] + pen_j[b]) + cc[j, cand_j[b]]
//   step[a, b] = c[a] + t_j[a, b]
//   back_j[b]  = numpy's argmin over a of step[., b], c'[b] = step[back, b]
// with pen = 0 where the candidate is feasible and +inf where not, and the
// cc terms only when a compute cost is given.
//
// Bit-identity: every product and sum is __dmul_rn / __dadd_rn, each rounded
// on its own in the oracle's order (nvcc would otherwise contract a * b + c
// into an FMA).  Only the argmin is taken in another order, and it does not
// depend on the order: the kernel takes the least (value, index) pair
// under a total order (`before`, below) -- a NaN before every number, the
// smaller index first between two NaNs; otherwise the smaller value, the
// smaller index first on equality (so +0 and -0 tie).  Its minimum over a
// column is the same however a is split among lanes and tiles and in
// whatever order partial minima merge, and it is numpy's argmin: the first
// NaN if the column holds one, else the first minimum, and a = 0 on a
// column of +inf.  The order compares integer keys (`order_key`: every NaN
// lowest, -0 as +0, otherwise the double's bits made monotone); while no
// value with its sign bit set or a NaN has been formed (the placement
// path: never), a value's key is its bits and none is computed.  Within a
// lane a only grows, so the lane keeps the first of equal keys with a
// strict <.  The carried cost is the winning step's value, so it is
// step[back, b] bit for bit.
//
// What bounds it on the card: bytes, by the roofline (the distinct spb
// entries the rows gather, the candidates, the back-pointers;
// chip_smoke.py computes it from each run's inputs, well under a
// microsecond on the placement path), but in practice latency.  The M-1
// layers are a chain, each needing the whole previous layer's costs: the
// floor of any design is one gather round plus M-1 times (a shared-memory
// read, a lane's dependent adds and compares, a warp's merges and a
// barrier).  A row's gathers are scattered 8-byte reads, which an SM serves
// far below its bandwidth, so a row's (M-1) k^2 of them cost that many
// cycles and more unless fewer are made.  The rest is instruction latency:
// a row is a few warps, each running chains of dependent instructions.
//
// Design.  A block sweeps `rows` rows side by side, each on k * stagers
// threads.
//  1. Staging.  The transitions do not depend on the carried cost, only on
//     the candidates, which are all known at launch: they are staged into
//     shared memory ahead of the serial pass, column-major at an odd pitch,
//     so that neighbouring threads of a column read neighbouring words and
//     neighbouring columns other banks.  Thread (cs, q) stages column cs,
//     predecessors q, q + stagers, ...  Where the whole sweep fits (the
//     placement path: k 16-65), every layer is staged before the pass: the
//     thread loads kGather spb entries at once into registers and stores t
//     for their layer and for each later layer whose candidate pair
//     (cand_{j-1}, cand_j) repeats it, which gathers nothing.  A row that
//     keeps one candidate set through all layers gathers k^2 entries, not
//     (M-1) k^2; the placement path's first launches hold only such rows,
//     its later launches (re-batches after commits, whose layers' feasible
//     sets differ) a mix, and chip_smoke.py prints the share.  Otherwise the layers are
//     cut into tiles of `tile` predecessors that stream through a ring of
//     `slots`: cp.async copies tile i + ahead (no registers held) while
//     tile i is reduced, and each thread forms t in place for the entries
//     it copied.
//  2. The serial pass runs on a row's first k * lanes threads.  Column b is
//     owned by `lanes` neighbouring lanes (a power of two near k / 8), and
//     lane l folds a = l, l + lanes, ... of each tile
//     into a running pair, kChunk steps at once (their reads and adds
//     overlap) reduced by a tree.  At a layer's last tile the group merges
//     its pairs with xor shuffles, and lane 0 writes c'[b] into the other
//     half of the double-buffered costs and the back-pointer.  One barrier
//     a tile (a layer, where layers are whole tiles); no division in the
//     loops (tile cursors step instead).
// The candidates (as int32 node ids), feasibility bits and Kv are staged
// into shared memory first, kGather loads a thread in flight, so a
// gather's address costs no device read.  Where they do not fit beside a
// ring of two tiles (5 M k bytes a row: M past ~690 at k 65, ~38 at k
// 1024), the ring build reads them from device memory instead (`resident`
// off), so that any M runs.  Two builds by block size (up to kSmallBlock
// threads with twice a 1024-thread block's registers) and two by staging
// (whole or ring).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallBlock = 544;  // the most threads whose block still gets 120 registers a
                                  // thread: 65,536 an SM / 120 = 546, down to a whole warp
constexpr int kMaxSmem = 232448;  // H100: the dynamic shared memory a block can opt into
constexpr int kChunk = 8;         // a lane's steps folded at once
constexpr int kGather = 16;       // a thread's loads in flight at once while staging

struct Params {
  const double* spb;
  long long n;
  const double* kv;
  double ks;
  const long long* srcs;
  const long long* cand;
  const bool* valid;
  const double* cc;
  int n_rows, m, k;
  int rows, stagers, lanes, tile, slots, ahead;  // the host plan
  bool resident;  // candidates, feasibility bits and Kv staged into shared memory
  double* final_cost;
  long long* backs;
};

// A value's place in the merge order as an integer: every NaN lowest, -0
// as +0, and otherwise the bits made monotone (a negative value's magnitude
// bits flipped).  +inf maps below LLONG_MAX, the empty pair's key.
__device__ __forceinline__ long long order_key(double v) {
  const long long bits = __double_as_longlong(v);
  long long x = bits == LLONG_MIN ? 0 : bits;                     // -0
  x ^= (x >> 63) & LLONG_MAX;                                     // a negative's magnitude
  return (bits & LLONG_MAX) > 0x7ff0000000000000LL ? LLONG_MIN : x;  // NaN
}

// The merge order, a total order on (key, index); see the note above.
__device__ __forceinline__ bool before(long long key, int i, long long other, int j) {
  return key < other || (key == other && i < j);
}

// A value whose sign bit is set or that is a NaN: the one kind whose key is
// not its bits.  While a sweep has formed none, its sums have none either
// (non-negative plus non-negative), and the fold uses the bits as keys.
__device__ __forceinline__ bool odd_value(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v)) > 0x7ff0000000000000ULL;
}

// A lane's next kChunk steps of a tile, a = a + u * lanes (those at or
// past `left` steps masked), folded into its running pair: the steps' reads
// and adds overlap, a tree over their ascending a picks the first least key
// (the later half wins only on a strictly smaller key), and the running
// pair takes the chunk's winner only on a strictly smaller key.  c and t
// point at the lane's first step.  kFull: keys by order_key; else the bits
// are the keys (no odd value formed yet).
template <bool kFull>
__device__ __forceinline__ void fold(const double* c, const double* t, int a, int left,
                                     int lanes, long long& key, double& best, int& arg) {
  double v[kChunk];
  long long kx[kChunk];
  int pos[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {  // past `left`: a real entry read, then masked
    const int o = min(u * lanes, left - 1);
    v[u] = __dadd_rn(c[o], t[o]);
  }
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const long long key_u = kFull ? order_key(v[u]) : __double_as_longlong(v[u]);
    kx[u] = u * lanes < left ? key_u : LLONG_MAX;
    pos[u] = u;
  }
#pragma unroll
  for (int span = 1; span < kChunk; span *= 2)
#pragma unroll
    for (int u = 0; u + span < kChunk; u += 2 * span)
      if (kx[u + span] < kx[u]) {
        kx[u] = kx[u + span];
        pos[u] = pos[u + span];
        if (kFull) v[u] = v[u + span];
      }
  if (kx[0] < key) {
    key = kx[0];
    arg = a + pos[0] * lanes;
    best = kFull ? v[0] : __longlong_as_double(kx[0]);
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tile of the sweep: layer jj + 1, its ti-th run of `tile` predecessors,
// in ring slot `slot`.  Cursors step; nothing divides in the loops.
struct Tile {
  int jj, ti, slot;
  __device__ __forceinline__ void next(int tpl, int ns) {
    if (++ti == tpl) {
      ti = 0;
      ++jj;
    }
    if (++slot == ns) slot = 0;
  }
};

// Shared-memory layout of a block, in this order (8-byte words first;
// kvs, cnd and vld only where resident):
//   kvs  [m]                           Kv
//   cost [rows][2][k]                  carried costs, double-buffered
//   dif  [rows] uint64                 bit x: cand_x differs from cand_{x-1} (x < 64)
//   slab [slots][rows][k][pitch]       staged transitions, column-major
//   ccp  [slots][rows][k * stagers]    each staging thread's compute-cost term (cc only)
//   cnd  [rows][m][k] int32            candidate node ids
//   vld  [rows][m][k] uint8            feasibility bits
__host__ __device__ inline int pitch_of(int tile) { return tile | 1; }

__host__ __device__ inline size_t smem_bytes(int m, int k, int rows, int stagers, int tile,
                                             int slots, bool has_cc, bool resident) {
  const size_t per_slot = static_cast<size_t>(k) * pitch_of(tile)
                          + (has_cc ? static_cast<size_t>(k) * stagers : 0);
  const size_t mm = resident ? static_cast<size_t>(m) : 0;
  return 8 * (mm + static_cast<size_t>(rows) * (2 * k + 1 + slots * per_slot))
         + static_cast<size_t>(rows) * mm * 5 * static_cast<size_t>(k);
}

// kRing: tiles stream through the ring during the pass (ahead < tiles);
// otherwise every tile is staged before it, and the pass holds no staging
// code (and the candidates are always resident).
template <int kThreads, bool kRing>
__global__ void __launch_bounds__(kThreads) dp_sweep_kernel(const Params p) {
  extern __shared__ double smem[];
  const int k = p.k, m = p.m, Q = p.stagers, L = p.lanes, TA = p.tile, NS = p.slots;
  const int rows = p.rows, TP = pitch_of(TA), RT = k * Q;  // RT: threads a row
  const bool has_cc = p.cc != nullptr;
  const int tid = threadIdx.x;
  const int r = min(tid / RT, rows - 1);  // padding threads past rows * RT: not live
  const int lt = tid - r * RT;            // thread within its row
  const long long row = static_cast<long long>(blockIdx.x) * rows + r;
  const bool live = tid < rows * RT && row < p.n_rows;
  const int cs = lt / Q, q = lt - cs * Q;    // staging: column cs, predecessors q + u * Q
  const int b = lt / L, lane = lt - b * L;    // the pass: column b, predecessors lane + u * L
  const bool red = live && lt < k * L;
  const bool red_warp = __any_sync(0xffffffffu, red);  // this warp joins the merges
  const int tpl = (k + TA - 1) / TA;                    // tiles a layer
  const int n_tiles = (m - 1) * tpl;
  const int ahead = kRing ? p.ahead : n_tiles;
  const bool whole = !kRing;  // every tile staged before the pass; slot = tile
  const bool resident = !kRing || p.resident;
  const int mm = resident ? m : 0;  // the layers of candidates, bits and Kv in shared memory
  const double inf = __longlong_as_double(0x7ff0000000000000LL);

  double* kvs = smem;
  double* cost = kvs + mm + static_cast<size_t>(r) * 2 * k;
  auto* dif =
      reinterpret_cast<unsigned long long*>(kvs + mm + static_cast<size_t>(rows) * 2 * k) + r;
  double* slab = kvs + mm + static_cast<size_t>(rows) * (2 * k + 1);
  const size_t slot_dbl = static_cast<size_t>(rows) * k * TP;
  double* ccp = slab + NS * slot_dbl;
  int* cnd_all = reinterpret_cast<int*>(ccp + (has_cc ? static_cast<size_t>(NS) * rows * RT : 0));
  int* cnd = cnd_all + static_cast<size_t>(r) * mm * k;
  unsigned char* vld =
      reinterpret_cast<unsigned char*>(cnd_all + static_cast<size_t>(rows) * mm * k)
      + static_cast<size_t>(r) * mm * k;
  const long long* cand_row = p.cand + (live ? row : 0) * m * k;
  const bool* valid_row = p.valid + (live ? row : 0) * m * k;
  auto cand_at = [&](int e) {  // candidate e = layer * k + column of the row
    return resident ? cnd[e] : static_cast<int>(__ldg(cand_row + e));
  };
  auto feasible = [&](int e) {
    return resident ? vld[e] != 0
                    : __ldg(reinterpret_cast<const unsigned char*>(valid_row) + e) != 0;
  };
  auto kv_at = [&](int jj) { return resident ? kvs[jj] : __ldg(p.kv + jj); };

  // Stage the row's candidates, feasibility bits and Kv, kGather of each a
  // thread in flight at once; then, where every tile is staged at once,
  // which layers' candidates repeat the layer before.
  if (resident)
    for (int i = tid; i < m - 1; i += blockDim.x) kvs[i] = p.kv[i];
  const long long src = live ? p.srcs[row] : 0;
  if (live && resident) {
    const long long* cr = cand_row;
    const bool* vr = valid_row;
    for (int e0 = lt; e0 < m * k; e0 += RT * kGather) {
      long long cv[kGather];
      bool vv[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int e = min(e0 + u * RT, m * k - 1);
        cv[u] = cr[e];
        vv[u] = vr[e];
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (e0 + u * RT < m * k) {
          cnd[e0 + u * RT] = static_cast<int>(cv[u]);
          vld[e0 + u * RT] = vv[u];
        }
    }
  }
  if (live && lt == 0) *dif = 0;
  __syncthreads();
  // Bit jj: layer jj + 1's candidate pair is layer jj's, so its tiles gather
  // nothing and are formed with the tiles they repeat (from layer 63 on,
  // every layer gathers).
  unsigned long long rep = 0;
  if (whole) {
    unsigned long long mine = 0;
    if (live)
      for (int x = 1 + q; x < min(m, 64); x += Q)
        if (cnd[x * k + cs] != cnd[(x - 1) * k + cs]) mine |= 1ull << x;
    if (mine) atomicOr(dif, mine);
    __syncthreads();
    const int top = min(m - 2, 62);  // the last layer index jj that can repeat
    if (live && top >= 1)
      rep = ~*dif & ~(*dif >> 1) & ((2ull << top) - 1) & ~1ull;
  }
  auto repeats = [&](int jj) { return jj < 63 && (rep >> jj & 1); };
  auto run_of = [&](int jj) {  // layer jj + 1 and the layers after it that repeat it
    return jj + 1 < 64 ? __ffsll(static_cast<long long>(~(rep >> (jj + 1)))) : 1;
  };
  bool odd = false;  // this thread formed an odd value (odd_value)
  auto cc_at = [&](int slot) { return ccp + (static_cast<size_t>(slot) * rows + r) * RT + lt; };
  auto column = [&](int slot, int c) {
    return slab + slot * slot_dbl + (static_cast<size_t>(r) * k + c) * TP;
  };

  auto issue = [&](Tile t, int count) {  // cp.async the spb entries and cc terms of tiles
    for (int n = 0; n < count; ++n, t.next(tpl, NS)) {
      const int a0 = t.ti * TA, ta = min(TA, k - a0), j = t.jj + 1;
      const int cb = cand_at(j * k + cs);
      if (has_cc) cp_async8(cc_at(t.slot), p.cc + j * p.n + cb);
      if (whole || repeats(t.jj)) continue;  // a whole sweep gathers in `form`
      double* dst = column(t.slot, cs);
      const int prev = t.jj * k + a0;
      for (int al = q; al < ta; al += Q)
        cp_async8(dst + al, p.spb + static_cast<long long>(cand_at(prev + al)) * p.n + cb);
    }
  };
  // t in place, once this thread's copies have landed.  A whole sweep
  // gathers its spb entries here, kGather at once into registers, and forms
  // each of them for every layer that repeats its tile.
  auto form = [&](Tile t, int count) {
    if (!whole) cp_async_wait_all();
    for (int n = 0; n < count; ++n, t.next(tpl, NS)) {
      if (repeats(t.jj)) continue;     // formed with the tile it repeats
      const int run = run_of(t.jj);  // this tile and the tiles that repeat it, a layer apart
      const int a0 = t.ti * TA, ta = min(TA, k - a0);
      const double* raw = column(t.slot, cs);
      const int prev = t.jj * k + a0;
      const double* col = p.spb + cand_at((t.jj + 1) * k + cs);
      for (int base = q; base < ta; base += Q * kGather) {
        double s[kGather];  // all reads first, so that they overlap
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int al = min(base + u * Q, ta - 1);
          s[u] = whole ? __ldg(col + static_cast<long long>(cand_at(prev + al)) * p.n) : raw[al];
        }
        if (whole && has_cc) cp_async_wait_all();
        for (int x = 0; x < run; ++x) {
          const int jj = t.jj + x, slot = t.slot + x * tpl;  // x > 0 only where slot = tile
          const double kvj = kv_at(jj), pen = feasible((jj + 1) * k + cs) ? 0.0 : inf;
          const double ccv = has_cc ? *cc_at(slot) : 0.0;
          double* dst = column(slot, cs);
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            if (base + u * Q >= ta) break;
            double v = __dadd_rn(__dmul_rn(kvj, s[u]), pen);
            if (has_cc) v = __dadd_rn(v, ccv);
            odd |= odd_value(v);
            dst[base + u * Q] = v;
          }
        }
      }
    }
  };

  // Layer 0, by each column's lane 0: its loads fly with the first tiles'.
  double carried = 0.0;
  if (live && ahead > 0) issue(Tile{0, 0, 0}, ahead);
  const int cb0 = red ? cand_at(b) : 0;
  const double s0 = red && lane == 0 ? p.spb[src * p.n + cb0] : 0.0;
  const double cc0 = red && lane == 0 && has_cc ? p.cc[cb0] : 0.0;
  if (live && ahead > 0) form(Tile{0, 0, 0}, ahead);
  if (red && lane == 0) {
    double c = __dadd_rn(__dmul_rn(p.ks, s0), feasible(b) ? 0.0 : inf);
    if (has_cc) c = __dadd_rn(c, cc0);
    odd |= odd_value(c);
    cost[b] = c;
    carried = c;
  }

  long long* back = p.backs + row * k + b;  // layer jj's at back[jj * back_step]
  const long long back_step = static_cast<long long>(p.n_rows) * k;
  int cur = 0;
  double best = inf;
  long long key = LLONG_MAX;  // (LLONG_MAX, INT_MAX): the empty pair, after every real one
  int arg = INT_MAX;
  Tile now{0, 0, 0};  // tile i
  Tile fetch{ahead / tpl, ahead % tpl, NS > 0 ? ahead % NS : 0};  // tile i + ahead
  bool full = false;  // fold by order_key: an odd value was formed
  for (int i = 0; i < n_tiles; ++i, now.next(tpl, NS)) {
    // Tile i formed, slot (i - 1) % NS free, the last layer's costs written.
    const bool any_odd = __syncthreads_or(odd);
    full = full || any_odd;
    const bool more = kRing && live && i + ahead < n_tiles;
    if (more) issue(fetch, 1);
    if (red) {
      const int a0 = now.ti * TA, ta = min(TA, k - a0);
      const double* c_prev = cost + cur * k;
      const double* tr = column(now.slot, b);
      for (int base = lane; base < ta; base += L * kChunk) {
        if (full)
          fold<true>(c_prev + a0 + base, tr + base, a0 + base, ta - base, L, key, best, arg);
        else
          fold<false>(c_prev + a0 + base, tr + base, a0 + base, ta - base, L, key, best, arg);
      }
    }
    if (now.ti == tpl - 1) {  // the layer's last tile: merge the group's pairs
      if (red_warp) {
        for (int off = L >> 1; off > 0; off >>= 1) {
          const long long okey = __shfl_xor_sync(0xffffffffu, key, off);
          const int oi = __shfl_xor_sync(0xffffffffu, arg, off);
          double ov = __longlong_as_double(okey);  // unless full, a value is its key
          if (full) ov = __shfl_xor_sync(0xffffffffu, best, off);
          if (before(okey, oi, key, arg)) {
            key = okey;
            best = ov;
            arg = oi;
          }
        }
      }
      if (red && lane == 0) {
        cost[(cur ^ 1) * k + b] = best;
        back[now.jj * back_step] = arg;
        carried = best;
      }
      key = LLONG_MAX;
      arg = INT_MAX;
      cur ^= 1;
    }
    if (kRing && more) {
      form(fetch, 1);
      fetch.next(tpl, NS);
    }
  }
  if (red && lane == 0) p.final_cost[row * k + b] = carried;
}

// Blocks of up to kSmallBlock threads (every launch with k <= 544) get
// twice the registers of a 1024-thread block; each with and without the
// ring.
using Kernel = void (*)(Params);
const Kernel kKernels[] = {
    dp_sweep_kernel<kSmallBlock, false>, dp_sweep_kernel<kSmallBlock, true>,
    dp_sweep_kernel<kMaxThreads, false>, dp_sweep_kernel<kMaxThreads, true>};

}  // namespace

// spb (n, n) f64; kv (>= m - 1) f64; srcs (n_rows,) int64; cand and valid
// (n_rows, m, k) int64 and bool; cc (m, n) f64 or null.  Writes final_cost
// (n_rows, k) f64 and backs (m - 1, n_rows, k) int64.  The launch is the
// host plan (kernels/dp_sweep.py::sweep_plan): `rows` rows of
// k * `stagers` threads a block (`threads` in all, a multiple of 32), the
// first k * `lanes` of a row in the pass, a ring of `slots` tiles of `tile`
// predecessors with `ahead` staged before the pass, the candidates in
// shared memory or not (`resident`; always where every tile is staged
// ahead), `smem` dynamic shared bytes; this entry checks it and returns
// cudaErrorInvalidValue where it does not fit.  Returns a cudaError_t.
extern "C" int dp_sweep_f64(const void* spb, long long n, const void* kv, double ks,
                            const void* srcs, const void* cand, const void* valid,
                            const void* cc, int n_rows, int m, int k, int rows, int stagers,
                            int lanes, int tile, int slots, int ahead, int resident,
                            int threads, long long smem, void* final_cost, void* backs,
                            void* stream) {
  if (n_rows == 0) return 0;
  const int n_tiles = tile >= 1 ? (m - 1) * ((k + tile - 1) / tile) : 0;
  const bool ok =
      k >= 1 && m >= 1 && rows >= 1 && lanes >= 1 && (lanes & (lanes - 1)) == 0
      && stagers >= lanes && stagers <= 32
      && (stagers & (stagers - 1)) == 0 && tile >= 1 && tile <= k
      && threads == (rows * k * stagers + 31) / 32 * 32 && threads <= kMaxThreads
      && slots >= 0 && ahead >= 0 && ahead <= n_tiles
      && (n_tiles == 0 || (slots >= 1 && (ahead == n_tiles ? slots == n_tiles : ahead < slots)))
      && (resident == 1 || (resident == 0 && ahead < n_tiles))
      && smem == static_cast<long long>(
             smem_bytes(m, k, rows, stagers, tile, slots, cc != nullptr, resident != 0))
      && smem <= kMaxSmem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long opted_in = 0;  // the opt-in above 48 KB, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !(opted_in >> dev & 1)) {
    for (const Kernel f : kKernels) {
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (dev < 64) opted_in |= 1ull << dev;
  }
  Params p{static_cast<const double*>(spb), n, static_cast<const double*>(kv), ks,
           static_cast<const long long*>(srcs), static_cast<const long long*>(cand),
           static_cast<const bool*>(valid), static_cast<const double*>(cc), n_rows, m, k,
           rows, stagers, lanes, tile, slots, ahead, resident != 0,
           static_cast<double*>(final_cost), static_cast<long long*>(backs)};
  const unsigned grid = static_cast<unsigned>((n_rows + rows - 1) / rows);
  const Kernel kernel = kKernels[(threads > kSmallBlock ? 2 : 0) + (ahead < n_tiles ? 1 : 0)];
  kernel<<<grid, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
