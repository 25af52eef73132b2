// Batched min-plus DP sweep of the placement path, f64, for Hopper (sm_90a).
//
// Replaces the jitted XLA kernel repro/core/batch_dp.py::_build_kernel.sweep
// (not a Pallas kernel), which reproduces the numpy oracle
// repro/core/ould.py::_sparse_run row by row.  For S rows (one request
// source each), M layers and k candidate nodes a layer:
//   c0[b]      = (Ks * spb[src, cand0[b]] + pen0[b]) + cc[0, cand0[b]]
//   step[a, b] = c[a] + ((Kv[j-1] * spb[cand_{j-1}[a], cand_j[b]] + pen_j[b])
//                        + cc[j, cand_j[b]])
//   back_j[b]  = the first a with the least step[a, b] (the first NaN if the
//                column holds one: numpy's argmin), c'[b] = step[back, b]
// with pen = 0 where the candidate is feasible and +inf where not, and the
// cc terms only when a compute cost is given.
//
// Bit-identity: every product and sum is __dmul_rn / __dadd_rn, each rounded
// on its own in the oracle's order.  nvcc contracts a * b + c into an FMA by
// default (--fmad=true, which build.py's shared flags keep); these
// intrinsics are never contracted.  a runs 0..k-1 in ascending order with a
// strict <, so ties go to the first minimum, and a column of +inf keeps
// a = 0, as numpy's argmin does.
//
// Bound on the card: a row's work is (M-1) k^2 gathers of spb entries and
// four f64 operations each, so its roofline bound is bytes (the gathered
// entries, the candidates and the back-pointers; chip_smoke.py computes it
// from each run's inputs).  But the placement path launches few rows (one
// per distinct source) and each layer is k dependent steps after a barrier,
// so the kernel waits on latency, far above that bound.
// Design (simple first): one launch runs the whole M-layer sweep.  A block
// holds `rows` rows (blockDim.y) of k threads (blockDim.x), one thread per
// current candidate b.  The row's carried costs and the previous layer's
// candidates (as row offsets cand * N into spb) sit in shared memory,
// double-buffered across layers with one barrier a layer.  Each thread
// scans a = 0..k-1 reading c[a] and the offset from shared memory (a
// broadcast) and its spb entry from device memory (spb, 8 MB at N = 1024,
// stays in the 50 MB L2 across rows), gathering kGather entries before it
// uses the first, so their latencies overlap instead of adding up.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGather = 8;  // spb entries a thread has in flight at once

// numpy's argmin order: a NaN beats every number and the first NaN stays;
// otherwise only a strictly smaller value replaces the best so far.
// (x != x is true only for a NaN.)
__device__ __forceinline__ bool replaces(double v, double best) {
  return best == best && (v != v || v < best);
}

__global__ void dp_sweep_kernel(const double* __restrict__ spb, long long n,
                                const double* __restrict__ kv, double ks,
                                const long long* __restrict__ srcs,
                                const long long* __restrict__ cand,
                                const bool* __restrict__ valid,
                                const double* __restrict__ cc, int n_rows, int m, int k,
                                double* __restrict__ final_cost,
                                long long* __restrict__ backs) {
  extern __shared__ double smem[];
  const int rows = blockDim.y;
  const int b = threadIdx.x, r = threadIdx.y;
  // [2][rows][k] carried costs, then [2][rows][k] row offsets cand * n
  double* cost = smem;
  long long* base = reinterpret_cast<long long*>(smem + 2 * rows * k);
  const long long row = static_cast<long long>(blockIdx.x) * rows + r;
  const bool live = row < n_rows;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const bool has_cc = cc != nullptr;

  if (live) {
    const long long off = row * m * k + b;
    const long long cb = cand[off];
    double c = __dadd_rn(__dmul_rn(ks, spb[srcs[row] * n + cb]), valid[off] ? 0.0 : inf);
    if (has_cc) c = __dadd_rn(c, cc[cb]);
    cost[r * k + b] = c;
    base[r * k + b] = cb * n;
  }
  __syncthreads();
  int cur = 0;
  for (int j = 1; j < m; ++j) {
    const int nxt = cur ^ 1;
    if (live) {
      const long long off = (row * m + j) * k + b;
      const long long cb = cand[off];
      const double pen = valid[off] ? 0.0 : inf;
      const double kvj = kv[j - 1];
      const double ccb = has_cc ? cc[static_cast<long long>(j) * n + cb] : 0.0;
      const double* c_prev = cost + (cur * rows + r) * k;
      const long long* b_prev = base + (cur * rows + r) * k;
      double best = 0.0;
      int arg = 0;
      for (int a0 = 0; a0 < k; a0 += kGather) {
        // The gathers first, all kGather in flight at once; then the scan.
        double g[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u)
          g[u] = a0 + u < k ? spb[b_prev[a0 + u] + cb] : 0.0;
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int a = a0 + u;
          if (a >= k) break;
          double t = __dadd_rn(__dmul_rn(kvj, g[u]), pen);
          if (has_cc) t = __dadd_rn(t, ccb);
          const double v = __dadd_rn(c_prev[a], t);
          if (a == 0 || replaces(v, best)) {
            best = v;
            arg = a;
          }
        }
      }
      cost[(nxt * rows + r) * k + b] = best;
      base[(nxt * rows + r) * k + b] = cb * n;
      backs[(static_cast<long long>(j - 1) * n_rows + row) * k + b] = arg;
    }
    __syncthreads();  // layer j's costs are complete before layer j + 1 reads them
    cur = nxt;
  }
  if (live) final_cost[row * k + b] = cost[(cur * rows + r) * k + b];
}

}  // namespace

// spb (n, n) f64; kv (>= m - 1) f64; srcs (n_rows,) int64; cand and valid
// (n_rows, m, k) int64 and bool; cc (m, n) f64 or null.  Writes final_cost
// (n_rows, k) f64 and backs (m - 1, n_rows, k) int64.  `rows` rows of k
// threads a block.  Returns a cudaError_t.
extern "C" int dp_sweep_f64(const void* spb, long long n, const void* kv, double ks,
                            const void* srcs, const void* cand, const void* valid,
                            const void* cc, int n_rows, int m, int k, int rows,
                            void* final_cost, void* backs, void* stream) {
  if (n_rows == 0) return 0;
  if (k < 1 || m < 1 || rows < 1 || k * rows > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(k, rows);
  const unsigned grid = static_cast<unsigned>((n_rows + rows - 1) / rows);
  const size_t smem = 2 * static_cast<size_t>(rows) * k * (sizeof(double) + sizeof(long long));
  dp_sweep_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(spb), n, static_cast<const double*>(kv), ks,
      static_cast<const long long*>(srcs), static_cast<const long long*>(cand),
      static_cast<const bool*>(valid), static_cast<const double*>(cc), n_rows, m, k,
      static_cast<double*>(final_cost), static_cast<long long*>(backs));
  return static_cast<int>(cudaGetLastError());
}
