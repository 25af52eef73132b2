// RMSNorm forward and backward for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm.
// The backward (rmsnorm_bwd_kernel, rmsnorm_dscale_kernel; note at the
// backward's section below) has no TPU counterpart: the Pallas kernel has no
// VJP, so the reference trains through XLA's autodiff of
// repro/kernels/ref.py::rmsnorm, and that is what the backward computes.
//   y = x * rsqrt(mean(x^2, -1) + eps) * scale, sum of squares in f32,
//   written in x's dtype, in the reference's product order (x * r) * scale.
//
// Bound on the card: bytes.  Each row is read once and written once; the
// arithmetic is a few f32 operations per element.  Design: the vector path
// reads and writes 16 bytes a thread (8 bf16 or 4 f32), x, y and scale
// alike, scale in its own dtype.  A row is cut across a team of TPR threads
// (a power of two: part of a warp, a warp, or a few warps), each holding
// VPT 16-byte vectors of the row in registers (VPT is a template parameter,
// so the array stays in registers) from the load, through the sum of
// squares, to the normalise: x is read from device memory once and every
// load of a thread is issued before the first is used.  Neighbouring
// threads hold neighbouring vectors, so each access is coalesced.  A block
// holds several rows (ROWS = threads / TPR), so narrow rows still fill a
// block.  The team's sum is a shuffle tree, plus one shared-memory step
// when a team spans warps.  The grid is at most the blocks the card holds
// at once (the occupancy API, at the kernel's register count), and each
// block steps through its share of the rows: no second, partial wave.  The
// host plans the launch (kernels/rmsnorm.py::rmsnorm_plan): vector width,
// vectors per thread, threads and rows per block; a decode step's few rows
// get a block each.  Where a vector cannot be used (d not a multiple of the
// vector width, or x, y or scale not 16-byte aligned), the scalar path runs:
// one block of 256 threads per row with 2- or 4-byte loads, the row read
// twice (the second read from L1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScalarThreads = 256;
constexpr int kMaxVecThreads = 256;  // and at most 16 vectors a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- scalar path: any d, any alignment ------------------------------------

__device__ __forceinline__ float block_sum(float v, float* warp_part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float t = 0.f;
  #pragma unroll
  for (int w = 0; w < kScalarThreads / 32; ++w) t += warp_part[w];
  return t;
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(kScalarThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ y, int d, float eps) {
  __shared__ float warp_part[kScalarThreads / 32];
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float var = block_sum(ss, warp_part) / static_cast<float>(d);
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += kScalarThreads) {
    yr[i] = from_f<TX>((to_f(xr[i]) * r) * to_f(scale[i]));
  }
}

// ---- vector path: 16-byte accesses, the row in registers ------------------

// The V = 16 / sizeof(T) elements of one 16-byte vector, as f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
// bf16 -> f32 is a shift into the high half (no address taken, so nothing
// leaves the registers).
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  unpack2(u.x, f[0], f[1]); unpack2(u.y, f[2], f[3]);
  unpack2(u.z, f[4], f[5]); unpack2(u.w, f[6], f[7]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// V scale elements from element e (16-byte aligned in bytes of x's vector:
// 8 bf16 scale = one uint4, 8 f32 = two, 4 f32 = one, 4 bf16 = one uint2).
template <typename TS, int V>
__device__ __forceinline__ void load_scale(const TS* __restrict__ s, int e, float (&f)[V]) {
  if constexpr (sizeof(TS) * V == 8) {  // 4 bf16
    const uint2 u = *reinterpret_cast<const uint2*>(s + e);
    unpack2(u.x, f[0], f[1]);
    unpack2(u.y, f[2], f[3]);
  } else {
    #pragma unroll
    for (int h = 0; h < static_cast<int>(sizeof(TS) * V / 16); ++h) {
      const uint4 u = reinterpret_cast<const uint4*>(s + e)[h];
      constexpr int W = 16 / sizeof(TS);
      float g[W];
      unpack(u, g);
      #pragma unroll
      for (int k = 0; k < W; ++k) f[h * W + k] = g[k];
    }
  }
}

// tpr: threads per row, a power of two; the block holds blockDim.x / tpr
// rows at a time and steps through its share of the rows (the grid is at
// most what the card holds at once, so no block waits for a second wave).
// VPT: 16-byte vectors per thread (a row has at most VPT * tpr).
template <typename TX, typename TS, int VPT>
__global__ void __launch_bounds__(kMaxVecThreads)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   TX* __restrict__ y, int n, int d, int tpr, float eps) {
  constexpr int V = 16 / sizeof(TX);
  __shared__ float warp_part[kMaxVecThreads / 32];
  const int lane_r = threadIdx.x & (tpr - 1), rows = blockDim.x / tpr, nv = d / V;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows; base < n;
       base += static_cast<int64_t>(gridDim.x) * rows) {  // the same count for every thread
    const int64_t row = base + threadIdx.x / tpr;
    const bool live = row < n;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 v[VPT];
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {  // every load issued before the first use
      const int i = lane_r + k * tpr;
      v[k] = live && i < nv ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {
      float f[V];
      unpack(v[k], f);
      #pragma unroll
      for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
    }
    // The team's sum: shuffles within a warp (a team of tpr <= 32 lanes is
    // an aligned run of lanes, so xor offsets below tpr stay inside it),
    // then the team's warps through shared memory.
    for (int o = (tpr < 32 ? tpr : 32) >> 1; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (tpr > 32) {
      const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
      if ((threadIdx.x & 31) == 0) warp_part[warp] = ss;
      __syncthreads();
      ss = 0.f;
      const int w0 = (warp / per_row) * per_row;
      for (int w = 0; w < per_row; ++w) ss += warp_part[w0 + w];
      __syncthreads();  // read before the next rows rewrite it
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (live) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * d);
      #pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lane_r + k * tpr;
        if (i < nv) {
          float f[V], s[V];
          unpack(v[k], f);
          load_scale<TS, V>(scale, i * V, s);
          #pragma unroll
          for (int e = 0; e < V; ++e) f[e] = (f[e] * r) * s[e];
          yr[i] = pack(f);
        }
      }
    }
  }
}

// Blocks of the vector kernel the card holds at once: its SMs times what one
// SM holds at this block size (registers decide it), found once a block size.
template <typename TX, typename TS, int VPT>
int resident_blocks(int threads) {
  static int sms = 0, cached_threads = 0, per_sm = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  if (threads != cached_threads) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, rmsnorm_vec_kernel<TX, TS, VPT>, threads, 0) != cudaSuccess)
      per_sm = 0;
    cached_threads = threads;
  }
  return sms * per_sm;
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* y, int n, int d, float eps, int vec,
           int vpt, int threads, int rows, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  TX* yp = static_cast<TX*>(y);
  if (vec == 1) {
    if (threads != kScalarThreads || rows != 1) return static_cast<int>(cudaErrorInvalidValue);
    rmsnorm_kernel<TX, TS><<<n, kScalarThreads, 0, stream>>>(xp, sp, yp, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int tpr = threads / rows;
  if (vec != static_cast<int>(16 / sizeof(TX)) || d % vec || rows < 1 || threads % rows
      || (tpr & (tpr - 1)) || threads > kMaxVecThreads || threads % 32
      || static_cast<int64_t>(vpt) * tpr * vec < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int needed = (n + rows - 1) / rows;
#define RMS_VEC(K)                                                                      \
  case K: {                                                                             \
    const int held = resident_blocks<TX, TS, K>(threads);                               \
    rmsnorm_vec_kernel<TX, TS, K><<<held > 0 && held < needed ? held : needed, threads, 0, \
                                    stream>>>(xp, sp, yp, n, d, tpr, eps);              \
    break;                                                                              \
  }
  switch (vpt) {
    RMS_VEC(1) RMS_VEC(2) RMS_VEC(4) RMS_VEC(8) RMS_VEC(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RMS_VEC
  return static_cast<int>(cudaGetLastError());
}

// ---- backward --------------------------------------------------------------
//
// For y = (x * r) * s with r = rsqrt(mean(x^2) + eps), given g = dL/dy:
//   dx     = (g * s) * r - x * (r^3 * mean(g * s * x))
//   dscale = sum over rows of g * (x * r)
// in f32, dx written in x's dtype and dscale in scale's.
//
// Bound on the card: bytes (x and g read, dx written; a few f32 operations an
// element).  The first version (a block a row at a time, 256 threads, two
// blocks an SM, a block-wide reduction with two barriers a row, each row read
// twice, a (264, d) f32 partial) took 18.6-18.9 us at (2048, 2048) bf16 on an
// H100, 15.3-15.5 of them in the row kernel and 3.3 in the partials' sum,
// against a 7.51 us bound (PERF.md, the kernel table's row 1b).  Design now:
//   - A team of TPR threads (the fewest, from a warp to the block, that hold
//     the row in 2 16-byte vectors each; 4 where the block's 512 threads need
//     them: kernels/rmsnorm.py::rmsnorm_bwd_plan) owns a row at a time; a
//     block of 512 threads holds 512 / TPR teams, one block an SM, and the
//     teams step through the rows by the grid's stride.
//   - Each thread loads its VPT vectors of x and g once and keeps them in
//     registers through the row's reduction to the dx store.  The next row's
//     loads are issued before the current row's reduction, so two rows a team
//     are in flight and a team streams through its rows: at (2048, 2048) bf16
//     on an H100 the row kernel took 12.4 us with 128-thread teams (4 rows a
//     team) against 14.9 with 64-thread teams of 4 vectors a thread (2 rows a
//     team, all loads of the launch in one burst), and 16.0 with no loads
//     issued ahead.
//   - The row's two sums (x^2 and g*s*x) reduce by shuffles in each warp and,
//     where a team spans warps, through shared memory behind a named barrier
//     of the team's threads alone (double-buffered by row parity, one barrier
//     a row): no block-wide barrier inside the row loop.
//   - dscale: each thread adds g * (x * r) of its own columns into registers
//     across its team's rows; at the end the block's teams add their sums in
//     team order in shared memory and write one partial row a block (132 at
//     most on an H100: half the first version's partial bytes), and
//     rmsnorm_dscale_kernel sums the partials over blocks in a fixed order
//     with 16 row groups of unrolled loads a column.  No atomics anywhere, so
//     dscale repeats bit for bit, as the training loop's exact resume needs.

constexpr int kBwdThreads = 512;   // a block: 512 / TPR teams (kernels/rmsnorm.py: BWD_THREADS)
constexpr int kBwdMaxVpt = 4;      // vectors a thread holds (kernels/rmsnorm.py: BWD_VPT_CHOICES)

// One access of a row: a 16-byte vector, or (V 1) one element in u.x.
template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* __restrict__ p, int i, uint4& u) {
  if constexpr (V > 1) {
    u = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (sizeof(T) == 2) {
    u.x = __bfloat16_as_ushort(p[i]);
  } else {
    u.x = __float_as_uint(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack_raw(const uint4& u, float (&f)[V]) {
  if constexpr (V > 1) {
    unpack(u, f);
  } else {
    f[0] = __uint_as_float(sizeof(T) == 2 ? u.x << 16 : u.x);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, int i, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[i] = from_f<T>(f[0]);
  } else {
    reinterpret_cast<uint4*>(p)[i] = pack(f);
  }
}

template <typename TS, int V>
__device__ __forceinline__ void load_s(const TS* __restrict__ s, int e, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(s[e]);
  } else {
    load_scale<TS, V>(s, e, f);
  }
}

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// V: elements a thread moves per access (1, or 16 bytes' worth of TX); VPT:
// accesses a thread holds of a row (thread lr of a team takes vectors lr,
// lr + tpr, ...; a row has at most VPT * tpr of them); tpr: threads a team,
// a power of two from 32 to kBwdThreads.
template <typename TX, typename TS, int V, int VPT>
__global__ void __launch_bounds__(kBwdThreads, 1)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TX* __restrict__ g,
                   const TS* __restrict__ scale, TX* __restrict__ dx,
                   float* __restrict__ part, int n, int d, int tpr, float eps) {
  extern __shared__ float buf[];  // d floats: the block's teams' dscale sums, in team order
  __shared__ float red[2][kBwdThreads / 32][2];  // [row parity][warp][x^2 | g*s*x]
  const int nv = d / V, teams = blockDim.x / tpr, team = threadIdx.x / tpr;
  const int lr = threadIdx.x % tpr, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpt = tpr >> 5, w0 = team * wpt;  // the team's warps
  const int64_t stride = static_cast<int64_t>(gridDim.x) * teams;
  const float inv_d = 1.f / static_cast<float>(d);

  float acc[VPT][V];
  #pragma unroll
  for (int k = 0; k < VPT; ++k)
    #pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;

  int64_t row = static_cast<int64_t>(blockIdx.x) * teams + team;
  uint4 xv[VPT], gv[VPT];
  auto load_row = [&](int64_t r, uint4 (&xa)[VPT], uint4 (&ga)[VPT]) {
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lr + k * tpr;
      xa[k] = ga[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n && i < nv) {
        load_raw<TX, V>(x + r * d, i, xa[k]);
        load_raw<TX, V>(g + r * d, i, ga[k]);
      }
    }
  };
  load_row(row, xv, gv);
  for (int parity = 0; row < n; row += stride, parity ^= 1) {
    uint4 xn[VPT], gn[VPT];  // the next row's, in flight during this row's reduction
    load_row(row + stride, xn, gn);
    float ss = 0.f, dot = 0.f;
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lr + k * tpr;
      if (i < nv) {
        float xf[V], gf[V], sf[V];
        unpack_raw<TX, V>(xv[k], xf);
        unpack_raw<TX, V>(gv[k], gf);
        load_s<TS, V>(scale, i * V, sf);
        #pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          dot = fmaf(gf[e] * sf[e], xf[e], dot);
        }
      }
    }
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (wpt > 1) {  // the team's warps, in warp order, behind the team's own barrier
      if (lane == 0) {
        red[parity][warp][0] = ss;
        red[parity][warp][1] = dot;
      }
      team_barrier(1 + team, tpr);
      ss = 0.f;
      dot = 0.f;
      for (int w = w0; w < w0 + wpt; ++w) {
        ss += red[parity][w][0];
        dot += red[parity][w][1];
      }
    }
    // r by the forward's formula (its sum of squares may round otherwise)
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float c = r * r * r * (dot * inv_d);
    TX* dxr = dx + row * d;
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lr + k * tpr;
      if (i < nv) {
        float xf[V], gf[V], sf[V], out[V];
        unpack_raw<TX, V>(xv[k], xf);
        unpack_raw<TX, V>(gv[k], gf);
        load_s<TS, V>(scale, i * V, sf);
        #pragma unroll
        for (int e = 0; e < V; ++e) {
          out[e] = (gf[e] * sf[e]) * r - xf[e] * c;
          acc[k][e] += gf[e] * (xf[e] * r);
        }
        store_v<TX, V>(dxr, i, out);
      }
    }
    #pragma unroll
    for (int k = 0; k < VPT; ++k) {
      xv[k] = xn[k];
      gv[k] = gn[k];
    }
  }

  // The block's partial: team 0's sums, plus team 1's, ... in order.
  float* pr = part + static_cast<int64_t>(blockIdx.x) * d;
  for (int t = 0; t < teams; ++t) {
    if (team == t) {
      #pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lr + k * tpr;
        if (i < nv) {
          #pragma unroll
          for (int e = 0; e < V; ++e) {
            const float v = t == 0 ? acc[k][e] : buf[i * V + e] + acc[k][e];
            if (t + 1 == teams) pr[i * V + e] = v;
            else buf[i * V + e] = v;
          }
        }
      }
    }
    if (t + 1 < teams) __syncthreads();
  }
}

// dscale[j] = sum over the row kernel's blocks b of part[b, j], in a fixed
// order: a block of (16, 16) threads takes 16 columns; thread (j, y) sums
// blocks y, y + 16, ... (8 loads issued at a time), then thread (j, 0) adds
// the 16 sums in order.
template <typename TS>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ part, TS* __restrict__ dscale, int blocks,
                      int d) {
  __shared__ float red[16][17];
  const int col = blockIdx.x * 16 + threadIdx.x;
  float s = 0.f;
  if (col < d) {
    for (int b0 = threadIdx.y; b0 < blocks; b0 += 16 * 8) {
      float v[8];
      #pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + 16 * u;
        v[u] = b < blocks ? part[static_cast<int64_t>(b) * d + col] : 0.f;
      }
      #pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = 0.f;
    #pragma unroll
    for (int y = 0; y < 16; ++y) t += red[y][threadIdx.x];
    dscale[col] = from_f<TS>(t);
  }
}

template <typename TX, typename TS, int V, int VPT>
int launch_bwd(const void* x, const void* g, const void* scale, void* dx, void* dscale,
               void* part, int n, int d, float eps, int tpr, int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = rmsnorm_bwd_kernel<TX, TS, V, VPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kBwdThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(g), static_cast<const TS*>(scale),
      static_cast<TX*>(dx), static_cast<float*>(part), n, d, tpr, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_dscale_kernel<TS><<<(d + 15) / 16, dim3(16, 16), 0, stream>>>(
      static_cast<const float*>(part), static_cast<TS*>(dscale), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TS, int V>
int launch_bwd_vpt(const void* x, const void* g, const void* scale, void* dx, void* dscale,
                   void* part, int n, int d, float eps, int vpt, int tpr, int blocks,
                   cudaStream_t stream) {
  switch (vpt) {
    case 1: return launch_bwd<TX, TS, V, 1>(x, g, scale, dx, dscale, part, n, d, eps, tpr,
                                           blocks, stream);
    case 2: return launch_bwd<TX, TS, V, 2>(x, g, scale, dx, dscale, part, n, d, eps, tpr,
                                           blocks, stream);
    case 4: return launch_bwd<TX, TS, V, 4>(x, g, scale, dx, dscale, part, n, d, eps, tpr,
                                           blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TX, typename TS>
int launch_bwd_vec(const void* x, const void* g, const void* scale, void* dx, void* dscale,
                   void* part, int n, int d, float eps, int vec, int vpt, int tpr, int blocks,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  if (tpr < 32 || tpr > kBwdThreads || (tpr & (tpr - 1)) || blocks < 1 || vpt < 1
      || vpt > kBwdMaxVpt || (vec != 1 && (vec != V || d % V))
      || static_cast<int64_t>(vpt) * tpr * vec < d)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 1)
    return launch_bwd_vpt<TX, TS, 1>(x, g, scale, dx, dscale, part, n, d, eps, vpt, tpr,
                                     blocks, stream);
  return launch_bwd_vpt<TX, TS, V>(x, g, scale, dx, dscale, part, n, d, eps, vpt, tpr, blocks,
                                   stream);
}

}  // namespace

// x, g, dx: (n, d) in x's dtype; scale, dscale: (d,) in scale's dtype; part:
// (blocks, d) f32 scratch.  vec: elements per access (1, or 16 bytes' worth:
// then x, g, dx and scale 16-byte aligned and d a multiple of vec); vpt:
// accesses a thread holds (1, 2 or 4; vpt * tpr * vec >= d); tpr: threads on
// a row (a power of two, 32..512); blocks: the grid of rmsnorm_bwd_kernel,
// of 512 threads each.  Two kernels run, in order on the stream.  Returns a
// cudaError_t.
extern "C" int rmsnorm_bwd(const void* x, const void* g, const void* scale, void* dx,
                           void* dscale, void* part, int n, int d, float eps, int x_dtype,
                           int s_dtype, int vec, int vpt, int tpr, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && s_dtype == 0)
    return launch_bwd_vec<float, float>(x, g, scale, dx, dscale, part, n, d, eps, vec, vpt,
                                        tpr, blocks, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch_bwd_vec<float, __nv_bfloat16>(x, g, scale, dx, dscale, part, n, d, eps, vec,
                                                vpt, tpr, blocks, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch_bwd_vec<__nv_bfloat16, float>(x, g, scale, dx, dscale, part, n, d, eps, vec,
                                                vpt, tpr, blocks, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch_bwd_vec<__nv_bfloat16, __nv_bfloat16>(x, g, scale, dx, dscale, part, n, d,
                                                        eps, vec, vpt, tpr, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype codes: 0 = float32, 1 = bfloat16.  vec: elements per access (1 for
// the scalar path; else 16 bytes' worth); vpt: vectors per thread; threads
// and rows: per block.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int n, int d,
                           float eps, int x_dtype, int s_dtype, int vec, int vpt, int threads,
                           int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, scale, y, n, d, eps, vec, vpt, threads, rows, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, y, n, d, eps, vec, vpt, threads, rows, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, y, n, d, eps, vec, vpt, threads, rows, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n, d, eps, vec, vpt, threads,
                                                 rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
