// Chunked selective-state-space scan (Mamba-2 SSD) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py::ssd_scan_pallas.
//   x (B,S,H,P), a (B,S,H), b and c (B,S,H,N), h0 (B,H,P,N) or none
//   -> y (B,S,H,P) in x's dtype and h_final (B,H,P,N) in f32.
//   Recurrence per (batch, head): h_t = a_t h_{t-1} + x_t (x) b_t, y_t = h_t c_t,
//   evaluated in G chunks of Q steps.  Within a chunk, with cum_t the running
//   sum of log a (log a clamped at 1e-37):
//     y_t  = exp(cum_t) (c_t . h_start)                          inter-chunk
//          + sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) x_s        intra-chunk
//     h_end = h_start exp(cum_last) + h_in,
//     h_in  = sum_s x_s (x) b_s exp(cum_last - cum_s)            injected state.
//
// Bound on the card: bytes.  At the serving shape (B 4, S 1536, 50 heads of
// P 64, N 16, Q 256) a call moves ~110 MB against ~7.6 GFLOP of causal work.
//
// Design: the SSD's chunk-parallel decomposition.  The TPU kernel carries
// the state across chunks on its in-order grid; Hopper blocks run in no
// order, and one block per (batch, head) (200 at the serving shape, on 132
// SMs) leaves the card latency-bound.  So a call is three launches:
//   A. chunk states, one block per (batch, head, chunk): the chunk's
//      cumulative log decay (a block scan, written to a workspace), and its
//      injected state h_in, a (P x Q)(Q x N) product of f32 FMAs with each
//      step's x weighted by its decay to the chunk's end.  The chunk's x and
//      b stream into shared memory 128 steps a stage, two stages deep, by
//      16-byte cp.async where the rows allow it.  Each thread owns 4 x 4
//      entries of the state; when the state has fewer than 16 entries a
//      thread, groups of threads take interleaved steps and their sums are
//      added in shared memory.
//   B. the carry, one thread per state entry: h = h exp(total_g) + h_in[g]
//      over the chunks from h0, each chunk's start state written over its
//      h_in, and h_final.
//   C. outputs, one block per (batch, head, chunk, 64-row t tile), a
//      chunk's t tiles side by side (they read the same s tiles, so all but
//      the first read come from L2), the one with the most s tiles first:
//      the inter-chunk term from the chunk's start state, then, for each s
//      tile at or below the t tile, the 64 x 64 gate (C.B^T) exp(cum_t -
//      cum_s), formed only for s <= t (exp of an upper-triangle difference
//      overflows) and multiplied into X.  For bf16 x (the served model) this
//      runs on the tensor cores (ssd_output_tc_kernel, below); f32 x keeps
//      exact f32 FMAs on the CUDA cores (ssd_output_kernel), so the f32 sweep
//      holds the reference's 5e-5.
// A single step (S = 1, each decode step) takes none of this: a team of
// threads per (batch, head, p) holds the state row in registers, h = a h0
// + x b, y = h . c.  A ragged last chunk is simply shorter: nothing past S
// is read, written or added, which equals the TPU kernel's padding with
// a = 1 and zeros.  Inputs are read in place through their strides (no
// head-major copy), each in its own dtype (f32 or bf16).  The state path
// (passes A and B, the step) is f32 FMAs throughout.  The host plans the
// grids and the step's team (kernels/ssm_scan.py::ssd_plan); this file
// launches them, or refuses a grid too small for its work.  Decays are assumed in (0, 1], as the reference's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

using namespace ssd;

constexpr int kThreads = 256;
constexpr int T = 64;       // rows of a t tile and of an s tile
constexpr int TP = T + 4;   // row of the transposed C, B and gate tiles
constexpr int kMaxP = 128, kMaxN = 64;

struct Params {
  const void* x; const void* a; const void* b; const void* c; const void* h0;
  void* y; float* h_out;
  float* cum;  // (B*H*G, Q): running log decay within each chunk
  float* hs;   // (B*H*G, P*N): a chunk's injected state, then its start state
  int B, S, H, P, N, Q, G, NT;  // NT: t tiles per chunk
  long long x_sb, x_ss, x_sh;  // element strides; the last dim is contiguous
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sh;
  long long c_sb, c_ss, c_sh;
  int x_dt, a_dt, b_dt, c_dt, h0_dt;  // 0 = float32, 1 = bfloat16; y is in x's dtype
  bool x_vec;  // x's rows can be copied in 16-byte pieces (P, strides and pointer aligned)
  bool b_vec;  // likewise b's, and b is f32
};

__device__ __forceinline__ float ld(const void* p, long long i, int dt) {
  return dt ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, int dt, float v) {
  if (dt) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four consecutive values from shared memory as f32 (8-byte aligned for
// bf16, 16-byte for f32).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32: into the high half
  v[0] = __uint_as_float(u.x << 16); v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16); v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// ---- pass A: chunk states ---------------------------------------------------

// cum[t] = sum_{u<=t} log(max(a_u, 1e-37)) for the chunk's L steps, a block
// scan 256 steps at a time (warp shuffles, then the eight warp totals).
__device__ __forceinline__ void chunk_cum(const Params& p, long long ao, int c0, int L,
                                          float* cum, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {
    const int t = base + tid;
    float v = t < L ? logf(fmaxf(ld(p.a, ao + (c0 + t) * p.a_ss, p.a_dt), 1e-37f)) : 0.f;
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kThreads / 32 ? wsum[lane] : 0.f;
      #pragma unroll
      for (int o = 1; o < kThreads / 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < kThreads / 32) wsum[lane] = w;
    }
    __syncthreads();
    v += (warp ? wsum[warp - 1] : 0.f) + carry;
    if (t < L) cum[t] = v;
    carry += wsum[kThreads / 32 - 1];
    __syncthreads();  // wsum is rewritten by the next 256 steps
  }
}

constexpr int QA = 128;  // steps of a chunk that pass A holds per stage

template <typename XT, int CP, int NM>
struct StateLayout {  // shared memory of pass A, in bytes
  static constexpr int PP = 16 * CP, NN = 16 * NM, EB = (PP / 4) * (NN / 4);
  static constexpr int K = EB < kThreads ? kThreads / EB : 1;
  static constexpr int xs = 0;                                       // 2 x QA x PP, x's dtype
  static constexpr int bs = xs + 2 * QA * PP * int(sizeof(XT));      // 2 x QA x NN f32
  static constexpr int red = 0;  // (K-1) x 16 x EB f32, over the stages once they are read
  static constexpr int wsum = bs + 2 * QA * NN * 4;                  // kThreads / 32 f32
  static constexpr int cum = wsum + kThreads / 32 * 4;               // Q f32
  static_assert((K - 1) * 16 * EB * 4 <= wsum, "partial sums overflow the stages");
};

// One block per (batch, head, chunk).  The chunk's x and b come into shared
// memory QA steps at a time, two stages deep (16-byte cp.async where the
// rows allow it, so every copy of a stage is in flight at once), while the
// block scans the chunk's log decays.  Each thread owns 4 x 4 entries of
// the (P, N) state; when the state has fewer than 16 entries a thread, K
// groups of threads take interleaved steps and group 0 adds their sums.
// CP: P padded to PP = 16 CP; NM: N padded to NN = 16 NM.
template <typename XT, int CP, int NM>
__global__ void __launch_bounds__(kThreads, 3) ssd_chunk_state_kernel(const Params p) {
  using Lay = StateLayout<XT, CP, NM>;
  constexpr int PP = Lay::PP, NN = Lay::NN, EB = Lay::EB, K = Lay::K, QB = PP / 4;
  constexpr int BPT = EB > kThreads ? EB / kThreads : 1;  // entry blocks a thread owns
  constexpr int TB = EB / BPT;                            // threads of a group
  constexpr int XV = 16 / int(sizeof(XT));                // x values per 16-byte copy
  extern __shared__ float4 smem4[];
  char* const sm = reinterpret_cast<char*>(smem4);
  XT* const Xs = reinterpret_cast<XT*>(sm + Lay::xs);
  float* const Bs = reinterpret_cast<float*>(sm + Lay::bs);
  float* const red = reinterpret_cast<float*>(sm + Lay::red);
  float* const wsum = reinterpret_cast<float*>(sm + Lay::wsum);
  float* const cum = reinterpret_cast<float*>(sm + Lay::cum);

  const int tid = threadIdx.x, P = p.P, N = p.N;
  const int g = blockIdx.x % p.G;
  const long long bh = blockIdx.x / p.G, bi = bh / p.H, hi = bh % p.H;
  if (bh >= p.B * p.H) return;  // past the work: the grid may be rounded up
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0);
  const XT* const xg = static_cast<const XT*>(p.x) + bi * p.x_sb + hi * p.x_sh;
  const long long bo = bi * p.b_sb + hi * p.b_sh;

  // Steps [QA k, QA k + QA) of the chunk into stage k & 1; nothing past L
  // is read (zeros instead), and padding columns are zero.
  const auto stage = [&](int k) {
    const int r0 = k * QA, rows = min(QA, L - r0);
    XT* const xd = Xs + (k & 1) * QA * PP;
    float* const bd = Bs + (k & 1) * QA * NN;
    if (p.x_vec) {
      for (int i = tid; i < QA * (PP / XV); i += kThreads) {
        const int r = i / (PP / XV), q = (i % (PP / XV)) * XV;
        const bool ok = r < rows && q < P;
        cp_async16(xd + r * PP + q, ok ? xg + (c0 + r0 + r) * p.x_ss + q : xg, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < QA * PP; i += kThreads) {
        const int r = i / PP, q = i % PP;
        xd[i] = r < rows && q < P ? xg[(c0 + r0 + r) * p.x_ss + q] : from_f<XT>(0.f);
      }
    }
    if (p.b_vec) {
      const float* const bg = static_cast<const float*>(p.b) + bo;
      for (int i = tid; i < QA * (NN / 4); i += kThreads) {
        const int r = i / (NN / 4), n = (i % (NN / 4)) * 4;
        const bool ok = r < rows && n < N;
        cp_async16(bd + r * NN + n, ok ? bg + (c0 + r0 + r) * p.b_ss + n : bg, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < QA * NN; i += kThreads) {
        const int r = i / NN, n = i % NN;
        bd[i] = r < rows && n < N ? ld(p.b, bo + (c0 + r0 + r) * p.b_ss + n, p.b_dt) : 0.f;
      }
    }
    cp_async_commit();
  };

  stage(0);
  chunk_cum(p, bi * p.a_sb + hi * p.a_sh, c0, L, cum, wsum);
  const float cum_last = cum[L - 1];
  __syncthreads();  // every thread has read cum_last before cum becomes the weights
  for (int t = tid; t < L; t += kThreads) {
    const float v = cum[t];
    p.cum[static_cast<long long>(blockIdx.x) * p.Q + t] = v;
    cum[t] = expf(cum_last - v);  // the weight of step t's injection at the chunk's end
  }

  const int grp = tid / TB;
  float acc[BPT][4][4] = {};
  const int n_stages = (L + QA - 1) / QA;
  for (int k = 0; k < n_stages; ++k) {
    if (k + 1 < n_stages) {
      stage(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const XT* const xs = Xs + (k & 1) * QA * PP;
    const float* const bs = Bs + (k & 1) * QA * NN;
    const float* const w = cum + k * QA;
    const int rows = min(QA, L - k * QA);
    for (int r = grp; r < rows; r += K) {
      const float wr = w[r];
      #pragma unroll
      for (int u = 0; u < BPT; ++u) {
        const int e = tid % TB + u * TB, qb = e % QB, nb = e / QB;
        float xr[4], br[4];
        load4(xs + r * PP + 4 * qb, xr);
        load4(bs + r * NN + 4 * nb, br);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xw = xr[i] * wr;
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[u][i][j] = fmaf(xw, br[j], acc[u][i][j]);
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  // The groups' partial sums, added by group 0, then written as (P, N).
  if constexpr (K > 1) {
    const int e = tid % TB;
    if (grp > 0) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int j = 0; j < 4; ++j) red[((grp - 1) * 16 + 4 * i + j) * EB + e] = acc[0][i][j];
      }
    }
    __syncthreads();
    if (grp == 0) {
      for (int k = 1; k < K; ++k) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[0][i][j] += red[((k - 1) * 16 + 4 * i + j) * EB + e];
        }
      }
    }
  }
  if (grp == 0) {
    float* const out = p.hs + static_cast<long long>(blockIdx.x) * P * N;
    #pragma unroll
    for (int u = 0; u < BPT; ++u) {
      const int e = tid % TB + u * TB, qb = e % QB, nb = e / QB;
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * qb + i, n = 4 * nb + j;
          if (q < P && n < N) out[q * N + n] = acc[u][i][j];
        }
      }
    }
  }
}

// ---- pass B: the carry across chunks ---------------------------------------

// One thread per (batch, head, state entry).  Up to 8 chunks' decays and
// injections are loaded before any start state is stored, so a thread waits
// on one round of loads per 8 chunks, not one per chunk.
__global__ void __launch_bounds__(kThreads) ssd_carry_kernel(const Params p) {
  const int PN = p.P * p.N;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.B * p.H * PN) return;
  const int bh = idx / PN, e = idx - bh * PN;
  const float* const cum = p.cum + static_cast<long long>(bh) * p.G * p.Q;
  float* const hs = p.hs + static_cast<long long>(bh) * p.G * PN + e;
  float h = p.h0 ? ld(p.h0, idx, p.h0_dt) : 0.f;
  for (int g0 = 0; g0 < p.G; g0 += 8) {
    float total[8], inj[8];
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int g = g0 + k;
      if (g < p.G) {
        total[k] = cum[g * p.Q + min(p.Q, p.S - g * p.Q) - 1];
        inj[k] = hs[static_cast<long long>(g) * PN];
      }
    }
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int g = g0 + k;
      if (g < p.G) {
        hs[static_cast<long long>(g) * PN] = h;  // the chunk's start state, over its injection
        h = h * expf(total[k]) + inj[k];
      }
    }
  }
  p.h_out[idx] = h;
}

// ---- pass C: outputs ---------------------------------------------------------

// dst[n * TP + r] = src[off + r * ss + n] for the T rows of a tile (0 past
// the valid ones), N <= 16 NM.  Element k of a thread is (r, n) of the tile
// padded to 16 NM columns, so rows and columns come from shifts, not from
// divisions by N.
template <int NM>
__device__ __forceinline__ void stage_rows_t(float* dst, const void* src, long long off,
                                             long long ss, int dt, int rows, int N) {
  constexpr int W = 16 * NM, K = T * W / kThreads;
  float v[K];
  #pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / W, n = i % W;
    v[k] = n < N && r < rows ? ld(src, off + r * ss + n, dt) : 0.f;
  }
  #pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kThreads, n = i % W;
    if (n < N) dst[n * TP + i / W] = v[k];
  }
}

template <int CP>
__device__ __forceinline__ void load_cols(const float* row, float (&v)[CP]) {
  if constexpr (CP % 4 == 0) {
    #pragma unroll
    for (int k = 0; k < CP / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(row)[k];
      v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z; v[4 * k + 3] = f.w;
    }
  } else {
    #pragma unroll
    for (int j = 0; j < CP; ++j) v[j] = row[j];
  }
}

// f32 x, on the CUDA cores.  Thread (ty, tx) owns t rows 4ty..4ty+3 and the
// CP columns CP tx.. of P, so a step of the product reads one float4 of the
// (transposed) gate and CP contiguous floats of X from shared memory for
// 4 CP FMAs; the C.B^T products that form the gate are register-blocked the
// same way, and on the diagonal tile the product stops at the thread's last
// row.  CP: P columns per thread (16 CP >= P); NM: N <= 16 NM.
template <int CP, int NM>
__global__ void __launch_bounds__(kThreads, 2) ssd_output_kernel(const Params p) {
  constexpr int XP = 16 * CP;            // row of the X tile
  constexpr int KX = T * XP / kThreads;  // X-tile elements a thread stages
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int P = p.P, N = p.N, NP = N + 1;
  float* Gs = smem;              // T x TP, transposed: Gs[s * TP + t]
  float* Xs = Gs + T * TP;       // T x XP
  float* Cs = Xs + T * XP;       // N x TP, transposed: Cs[n * TP + t]
  float* Bs = Cs + N * TP;       // N x TP, transposed: Bs[n * TP + s]
  float* hs = Bs + N * TP;       // P x (N+1): the chunk's start state
  float* cum = hs + P * NP;      // the chunk's running log decay up to the t tile's end

  // Block order: a chunk's t tiles side by side (they read the same s tiles,
  // which then come from L2), the one with the most s tiles first.
  const int tt = p.NT - 1 - blockIdx.x % p.NT, chunk = blockIdx.x / p.NT;
  const int g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), t0 = tt * T;
  if (bh >= p.B * p.H || t0 >= L) return;  // past the work or a ragged last chunk's end
  const int lt = min(T, L - t0);
  const long long xo = bi * p.x_sb + hi * p.x_sh;
  const long long bo = bi * p.b_sb + hi * p.b_sh, co = bi * p.c_sb + hi * p.c_sh;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int t = tid; t < t0 + lt; t += kThreads)
    cum[t] = p.cum[static_cast<long long>(chunk) * p.Q + t];
  {
    const float* src = p.hs + static_cast<long long>(chunk) * P * N;
    for (int i = tid; i < P * N; i += kThreads) hs[(i / N) * NP + i % N] = src[i];
  }
  stage_rows_t<NM>(Cs, p.c, co + (c0 + t0) * p.c_ss, p.c_ss, p.c_dt, lt, N);
  __syncthreads();

  float acc[4][CP];  // y rows 4ty+i, columns CP tx + j; first the inter-chunk term
  {
    float e[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * ty + i;
      e[i] = t < L ? expf(cum[t]) : 0.f;
      #pragma unroll
      for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(Cs + n * TP + 4 * ty);
      #pragma unroll
      for (int j = 0; j < CP; ++j) {
        const int q = CP * tx + j;
        const float h = q < P ? hs[q * NP + n] : 0.f;
        acc[0][j] = fmaf(cv.x, h, acc[0][j]); acc[1][j] = fmaf(cv.y, h, acc[1][j]);
        acc[2][j] = fmaf(cv.z, h, acc[2][j]); acc[3][j] = fmaf(cv.w, h, acc[3][j]);
      }
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      #pragma unroll
      for (int j = 0; j < CP; ++j) acc[i][j] *= e[i];
    }
  }

  for (int s0 = 0; s0 <= t0; s0 += T) {
    const int ls = min(T, L - s0);
    __syncthreads();  // the previous s tile's reads of Bs, Xs and Gs are done
    stage_rows_t<NM>(Bs, p.b, bo + (c0 + s0) * p.b_ss, p.b_ss, p.b_dt, ls, N);
    {
      float v[KX];
      #pragma unroll
      for (int k = 0; k < KX; ++k) {  // (r, q) of the tile padded to XP columns
        const int i = tid + k * kThreads, r = i / XP, q = i % XP;
        v[k] = q < P && r < ls ? ld(p.x, xo + (c0 + s0 + r) * p.x_ss + q, p.x_dt) : 0.f;
      }
      #pragma unroll
      for (int k = 0; k < KX; ++k) Xs[tid + k * kThreads] = v[k];
    }
    __syncthreads();

    {  // gate rows 4ty+i, columns 4tx+j of this (t, s) tile pair, stored transposed
      float d[4][4] = {};
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(Cs + n * TP + 4 * ty);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + n * TP + 4 * tx);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w}, bc[4] = {bv.x, bv.y, bv.z, bv.w};
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          #pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = fmaf(cr[i], bc[j], d[i][j]);
        }
      }
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = 4 * tx + j, s = s0 + sl;
        float g4[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
          g4[i] = s <= t && t < L ? d[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
        *reinterpret_cast<float4*>(Gs + sl * TP + 4 * ty) = make_float4(g4[0], g4[1], g4[2], g4[3]);
      }
    }
    __syncthreads();

    // On the diagonal tile the gate is zero past a thread's last row.
    const int s_end = s0 == t0 ? min(ls, 4 * ty + 4) : ls;
    for (int s = 0; s < s_end; ++s) {
      const float4 gv = *reinterpret_cast<const float4*>(Gs + s * TP + 4 * ty);
      float xv[CP];
      load_cols<CP>(Xs + s * XP + CP * tx, xv);
      #pragma unroll
      for (int j = 0; j < CP; ++j) {
        acc[0][j] = fmaf(gv.x, xv[j], acc[0][j]); acc[1][j] = fmaf(gv.y, xv[j], acc[1][j]);
        acc[2][j] = fmaf(gv.z, xv[j], acc[2][j]); acc[3][j] = fmaf(gv.w, xv[j], acc[3][j]);
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= L) continue;
    const long long row = ((bi * p.S + c0 + t) * p.H + hi) * P;
    #pragma unroll
    for (int j = 0; j < CP; ++j) {
      const int q = CP * tx + j;
      if (q < P) st(p.y, row + q, p.x_dt, acc[i][j]);
    }
  }
}

// ---- pass C for bf16 x: tensor cores -------------------------------------------

// Four warps; warp w owns t rows 16w..16w+15 of the tile and all P columns.
// The products run as mma.sync m16n8k16 (bf16 operands, f32 sums).  An f32
// operand is split into a bf16 high part and the bf16 of its remainder,
// which together carry ~16 bits: C.B^T as C_hi B_hi + C_hi B_lo + C_lo B_hi
// (C_lo is zero for bf16 c), the gate G (f32, from the accumulator's
// registers, never through shared memory) as G_hi X + G_lo X, and the
// inter-chunk term as C_hi H_hi + C_hi H_lo + C_lo H_hi.  X is bf16 and
// exact.  So the loss to rounding stays far below y's own bf16 rounding;
// ref.ssd_scan_bf16_scheme is this arithmetic in f32.
constexpr int kTcThreads = 128;

template <int CP, int NM>
struct TcLayout {  // shared memory of the tensor-core output kernel, in bytes
  static constexpr int PP = 16 * CP, NN = 16 * NM;
  // padded rows, so that fragment loads and ldmatrix have no bank conflicts
  static constexpr int XR = PP + 8;  // bf16 row of an X tile
  static constexpr int BR = NN + 8;  // f32 row of a B tile
  static constexpr int HR = NN + 8;  // bf16 row of the start state
  static constexpr int xs = 0;                        // 2 stages x T x XR bf16
  static constexpr int bs = xs + 2 * T * XR * 2;      // 2 stages x T x BR f32
  static constexpr int hh = bs + 2 * T * BR * 4;      // PP x HR bf16: start state, hi
  static constexpr int hl = hh + PP * HR * 2;         // PP x HR bf16: start state, lo
  static constexpr int cum = hl + PP * HR * 2;        // Q f32
};

// The s tiles at or below the block's t tile stream through two stages of
// shared memory (16-byte cp.async where the rows allow it), the next tile's
// copy in flight while the current one is multiplied.  Off the diagonal
// tile every s precedes every t, so the gate's decay factors through the s
// tile's last step r: exp(cum_t - cum_s) = exp(cum_t - cum_r) exp(cum_r -
// cum_s), both factors at most 1 (no overflow); the second scales B's rows
// as they are split, the first the gate's rows: ten exponentials a thread
// for the tile instead of 32.  The diagonal tile takes exp(cum_t - cum_s)
// directly and masks s > t.
template <int CP, int NM>
__global__ void __launch_bounds__(kTcThreads, 5) ssd_output_tc_kernel(const Params p) {
  using Lay = TcLayout<CP, NM>;
  constexpr int PP = Lay::PP, NN = Lay::NN, XR = Lay::XR, BR = Lay::BR, HR = Lay::HR;
  constexpr int NT8 = PP / 8;  // n8 tiles of P
  extern __shared__ float4 smem4[];
  char* const sm = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* const Xs = reinterpret_cast<__nv_bfloat16*>(sm + Lay::xs);
  float* const Bs = reinterpret_cast<float*>(sm + Lay::bs);
  __nv_bfloat16* const Hh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::hh);
  __nv_bfloat16* const Hl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::hl);
  float* const cum = reinterpret_cast<float*>(sm + Lay::cum);

  // Block order: a chunk's t tiles side by side, the heaviest first.
  const int tt = p.NT - 1 - blockIdx.x % p.NT, chunk = blockIdx.x / p.NT;
  const int g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), t0 = tt * T;
  if (bh >= p.B * p.H || t0 >= L) return;  // past the work or a ragged last chunk's end
  const int lt = min(T, L - t0), P = p.P, N = p.N;
  const __nv_bfloat16* const xg = static_cast<const __nv_bfloat16*>(p.x) + bi * p.x_sb
                                  + hi * p.x_sh;
  const long long bo = bi * p.b_sb + hi * p.b_sh, co = bi * p.c_sb + hi * p.c_sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const bool c_split = p.c_dt == 0;  // an f32 c has a low part

  // s tile k into stage k & 1: rows past L and padding columns are zero.
  const auto stage = [&](int k) {
    const int s0 = k * T, ls = min(T, L - s0);
    __nv_bfloat16* const xd = Xs + (k & 1) * T * XR;
    float* const bd = Bs + (k & 1) * T * BR;
    if (p.x_vec) {
      #pragma unroll
      for (int m = 0; m < T * (PP / 8) / kTcThreads; ++m) {
        const int i = tid + m * kTcThreads, r = i / (PP / 8), q = (i % (PP / 8)) * 8;
        const bool ok = r < ls && q < P;
        cp_async16(xd + r * XR + q, ok ? xg + (c0 + s0 + r) * p.x_ss + q : xg, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < T * PP; i += kTcThreads) {
        const int r = i / PP, q = i % PP;
        xd[r * XR + q] = r < ls && q < P ? xg[(c0 + s0 + r) * p.x_ss + q] : __float2bfloat16(0.f);
      }
    }
    if (p.b_vec) {
      const float* const bg = static_cast<const float*>(p.b) + bo;
      #pragma unroll
      for (int m = 0; m < T * (NN / 4) / kTcThreads; ++m) {
        const int i = tid + m * kTcThreads, r = i / (NN / 4), n = (i % (NN / 4)) * 4;
        const bool ok = r < ls && n < N;
        cp_async16(bd + r * BR + n, ok ? bg + (c0 + s0 + r) * p.b_ss + n : bg, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < T * NN; i += kTcThreads) {
        const int r = i / NN, n = i % NN;
        bd[r * BR + n] = r < ls && n < N ? ld(p.b, bo + (c0 + s0 + r) * p.b_ss + n, p.b_dt) : 0.f;
      }
    }
    cp_async_commit();
  };
  stage(0);

  // The prologue's loads (the warp's rows of C, the chunk's start state and
  // running decays) are all issued before the first is used: one wait.
  float cv[NM][4][2];  // C at rows gr and gr + 8, k = 2tq.. and 2tq + 8..
  const int ra = t0 + 16 * warp + gr, rb = ra + 8;  // rows within the chunk
  #pragma unroll
  for (int ks = 0; ks < NM; ++ks) {
    #pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = f & 1 ? rb : ra, n = 16 * ks + 2 * tq + (f & 2 ? 8 : 0);
      const long long off = co + (c0 + r) * p.c_ss + n;
      cv[ks][f][0] = r < L && n < N ? ld(p.c, off, p.c_dt) : 0.f;
      cv[ks][f][1] = r < L && n + 1 < N ? ld(p.c, off + 1, p.c_dt) : 0.f;
    }
  }
  {  // the start state, split, as (p, n) rows; zero in the padding
    constexpr int KH = PP * NN / kTcThreads, KB = KH < 16 ? KH : 16;  // entries a thread splits
    const float* src = p.hs + static_cast<long long>(chunk) * P * N;
    for (int base = 0; base < KH; base += KB) {
      float hv[KB];
      #pragma unroll
      for (int m = 0; m < KB; ++m) {
        const int i = tid + (base + m) * kTcThreads, q = i / NN, n = i % NN;
        hv[m] = q < P && n < N ? src[q * N + n] : 0.f;
      }
      if (base == 0) {
        for (int t = tid; t < t0 + lt; t += kTcThreads)
          cum[t] = p.cum[static_cast<long long>(chunk) * p.Q + t];
      }
      #pragma unroll
      for (int m = 0; m < KB; ++m) {
        const int i = tid + (base + m) * kTcThreads, q = i / NN, n = i % NN;
        split_bf16(hv[m], Hh[q * HR + n], Hl[q * HR + n]);
      }
    }
  }
  uint32_t ca_h[NM][4], ca_l[NM][4];  // the warp's rows of C as A fragments
  #pragma unroll
  for (int ks = 0; ks < NM; ++ks) {
    #pragma unroll
    for (int f = 0; f < 4; ++f) split2(cv[ks][f][0], cv[ks][f][1], ca_h[ks][f], ca_l[ks][f]);
  }
  __syncthreads();

  float acc[NT8][4];  // y fragments: rows ra/rb, columns 8 nt + 2tq, +1; first the inter-chunk term
  {
    const float ea = ra < L ? expf(cum[ra]) : 0.f, eb = rb < L ? expf(cum[rb]) : 0.f;
    #pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      #pragma unroll
      for (int ks = 0; ks < NM; ++ks) {
        const int o0 = (8 * nt + gr) * HR + 16 * ks + 2 * tq, o1 = o0 + 8;
        const uint32_t h0 = *reinterpret_cast<const uint32_t*>(Hh + o0);
        const uint32_t h1 = *reinterpret_cast<const uint32_t*>(Hh + o1);
        mma_bf16(d, ca_h[ks], h0, h1);
        mma_bf16(d, ca_h[ks], *reinterpret_cast<const uint32_t*>(Hl + o0),
                 *reinterpret_cast<const uint32_t*>(Hl + o1));
        if (c_split) mma_bf16(d, ca_l[ks], h0, h1);
      }
      acc[nt][0] = d[0] * ea; acc[nt][1] = d[1] * ea;
      acc[nt][2] = d[2] * eb; acc[nt][3] = d[3] * eb;
    }
  }

  for (int k = 0; k <= tt; ++k) {
    const int s0 = k * T;
    if (k < tt) {
      stage(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* const xs = Xs + (k & 1) * T * XR;
    const float* const bs = Bs + (k & 1) * T * BR;

    // For each k16 slice of s (on the diagonal tile, only those at or
    // below the warp's last row): the gate's two n8 tiles for the warp's 16
    // rows, then acc += G X for the slice, G's A fragments taken from the
    // gate's accumulator registers.
    const bool diag = k == tt;
    const int kk_end = diag ? warp + 1 : 4;
    const float ref = diag ? 0.f : cum[s0 + T - 1];
    const float ua = !diag && ra < L ? expf(cum[ra] - ref) : 0.f;
    const float ub = !diag && rb < L ? expf(cum[rb] - ref) : 0.f;
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < kk_end) {
        float gt[2][4];
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h, sr = 8 * j + gr;  // sr: the B row (s) of the fragments
          const float vs = diag ? 1.f : expf(ref - cum[s0 + sr]);
          gt[h][0] = gt[h][1] = gt[h][2] = gt[h][3] = 0.f;
          #pragma unroll
          for (int ks = 0; ks < NM; ++ks) {
            const float2 q0 = *reinterpret_cast<const float2*>(bs + sr * BR + 16 * ks + 2 * tq);
            const float2 q1 = *reinterpret_cast<const float2*>(bs + sr * BR + 16 * ks + 8 + 2 * tq);
            uint32_t b0h, b0l, b1h, b1l;
            split2(q0.x * vs, q0.y * vs, b0h, b0l);
            split2(q1.x * vs, q1.y * vs, b1h, b1l);
            mma_bf16(gt[h], ca_h[ks], b0h, b1h);
            mma_bf16(gt[h], ca_h[ks], b0l, b1l);
            if (c_split) mma_bf16(gt[h], ca_l[ks], b0h, b1h);
          }
          if (diag) {
            #pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int t = f & 2 ? rb : ra, s = s0 + 8 * j + 2 * tq + (f & 1);
              gt[h][f] = s <= t && t < L ? gt[h][f] * expf(cum[t] - cum[s]) : 0.f;
            }
          } else {
            gt[h][0] *= ua; gt[h][1] *= ua; gt[h][2] *= ub; gt[h][3] *= ub;
          }
        }
        uint32_t ah[4], al[4];
        split2(gt[0][0], gt[0][1], ah[0], al[0]);
        split2(gt[0][2], gt[0][3], ah[1], al[1]);
        split2(gt[1][0], gt[1][1], ah[2], al[2]);
        split2(gt[1][2], gt[1][3], ah[3], al[3]);
        #pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_t(r, xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XR
                           + 16 * np + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], ah, r[0], r[1]);
          mma_bf16(acc[2 * np], al, r[0], r[1]);
          mma_bf16(acc[2 * np + 1], ah, r[2], r[3]);
          mma_bf16(acc[2 * np + 1], al, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

  __nv_bfloat16* const y = static_cast<__nv_bfloat16*>(p.y);
  #pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? rb : ra;
    if (t >= L) continue;
    const long long row = ((bi * p.S + c0 + t) * p.H + hi) * static_cast<long long>(P);
    #pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int q = 8 * nt + 2 * tq;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (q + 1 < P && !(P & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(y + row + q) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (q < P) y[row + q] = __float2bfloat16(v0);
        if (q + 1 < P) y[row + q + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---- one step (S = 1) --------------------------------------------------------

// A team of TPR threads per (batch, head, p) row of the state, thread k of
// the team on entries 4k..4k+3 (neighbouring threads on neighbouring 16
// bytes of h0 and h_out): h = a h0 + x b, then y = h . c summed over the
// team by shuffles.  No chunks, no scan, no shared memory.
template <int TPR>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(const Params p) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int row = idx / TPR, k = idx % TPR, N = p.N;
  const bool live = row < p.B * p.H * p.P;
  float yv = 0.f;
  if (live) {
    const int bh = row / p.P, q = row - bh * p.P, bi = bh / p.H, hi = bh - bi * p.H;
    const float av = ld(p.a, bi * p.a_sb + hi * p.a_sh, p.a_dt);
    const float xv = ld(p.x, bi * p.x_sb + hi * p.x_sh + q, p.x_dt);
    const long long bo = bi * p.b_sb + hi * p.b_sh, co = bi * p.c_sb + hi * p.c_sh;
    const long long so = static_cast<long long>(row) * N;
    float h[4], bv[4], cv[4];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {  // every load issued before the first use
      const int n = 4 * k + j;
      h[j] = n < N && p.h0 ? ld(p.h0, so + n, p.h0_dt) : 0.f;
      bv[j] = n < N ? ld(p.b, bo + n, p.b_dt) : 0.f;
      cv[j] = n < N ? ld(p.c, co + n, p.c_dt) : 0.f;
    }
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * k + j;
      if (n < N) {
        h[j] = h[j] * av + xv * bv[j];
        p.h_out[so + n] = h[j];
        yv = fmaf(h[j], cv[j], yv);
      }
    }
  }
  #pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, o);
  if (live && k == 0) st(p.y, row, p.x_dt, yv);  // y (B, 1, H, P) is row-major in (b, h, p)
}

// ---- launches ------------------------------------------------------------------

template <typename Kernel>
int launch_smem(Kernel kernel, int blocks, int threads, int bytes, const Params& p,
                cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int CP, int NM>
int launch_chunked(const Params& p, const int (&grid)[3], cudaStream_t stream) {
  int rc = launch_smem(ssd_chunk_state_kernel<XT, CP, NM>, grid[0], kThreads,
                       StateLayout<XT, CP, NM>::cum + 4 * p.Q, p, stream);
  if (rc) return rc;
  ssd_carry_kernel<<<grid[1], kThreads, 0, stream>>>(p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  if constexpr (sizeof(XT) == 2)
    return launch_smem(ssd_output_tc_kernel<CP, NM>, grid[2], kTcThreads,
                       TcLayout<CP, NM>::cum + 4 * p.Q, p, stream);
  else
    return launch_smem(ssd_output_kernel<CP, NM>, grid[2], kThreads,
                       4 * (T * TP + T * 16 * CP + 2 * p.N * TP + p.P * (p.N + 1) + p.Q), p,
                       stream);
}

template <typename XT, int CP>
int launch_n(const Params& p, const int (&grid)[3], cudaStream_t stream) {
  if (p.N <= 16) return launch_chunked<XT, CP, 1>(p, grid, stream);
  if (p.N <= 32) return launch_chunked<XT, CP, 2>(p, grid, stream);
  return launch_chunked<XT, CP, 4>(p, grid, stream);
}

template <typename XT>
int launch_p(const Params& p, const int (&grid)[3], cudaStream_t stream) {
  if (p.P <= 16) return launch_n<XT, 1>(p, grid, stream);
  if (p.P <= 32) return launch_n<XT, 2>(p, grid, stream);
  if (p.P <= 64) return launch_n<XT, 4>(p, grid, stream);
  return launch_n<XT, 8>(p, grid, stream);
}

// Rows of a tensor can be copied in 16-byte pieces: the row length, the
// strides and the pointer are all multiples of 16 bytes.
bool rows_of_16(const void* ptr, int elem_bytes, int row, long long s0, long long s1,
                long long s2) {
  const int k = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row % k == 0 && s0 % k == 0
         && s1 % k == 0 && s2 % k == 0;
}

}  // namespace

// y is contiguous (B,S,H,P) in x's dtype; h0 (or null) and h_out are
// contiguous (B,H,P,N), h_out in f32.  cum_ws (B*H*G*Q floats) and hs_ws
// (B*H*G*P*N floats) are the workspace of the chunked path (null for a
// single step).  grid: the blocks of each launch as the host planned them,
// (chunk states, carry, outputs), or (0, 0, step) when S = 1, with team
// threads on a state row; a grid too small for its work, or a team this
// file has no kernel for, is refused.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ssd_scan_fwd(
    const void* x, const void* a, const void* b, const void* c, const void* h0,
    void* y, void* h_out, void* cum_ws, void* hs_ws, int B, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sh,
    long long c_sb, long long c_ss, long long c_sh,
    int x_dt, int a_dt, int b_dt, int c_dt, int h0_dt,
    int grid_states, int grid_carry, int grid_out, int team, void* stream) {
  if (B == 0 || H == 0) return 0;
  const long long bh = static_cast<long long>(B) * H;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S < 1 || Q > S
      || bh * P * N * 16 >= (1LL << 31))  // 32-bit thread indices in the carry and step kernels
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (S + Q - 1) / Q, NT = (Q + T - 1) / T;
  Params p{x, a, b, c, h0, y, static_cast<float*>(h_out), static_cast<float*>(cum_ws),
           static_cast<float*>(hs_ws), B, S, H, P, N, Q, G, NT,
           x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
           x_dt, a_dt, b_dt, c_dt, h0_dt,
           rows_of_16(x, x_dt ? 2 : 4, P, x_sb, x_ss, x_sh),
           b_dt == 0 && rows_of_16(b, 4, N, b_sb, b_ss, b_sh)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    if (grid_states || grid_carry || 4 * team < N
        || static_cast<long long>(grid_out) * kThreads < bh * P * team)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (team) {
      case 1: ssd_step_kernel<1><<<grid_out, kThreads, 0, s>>>(p); break;
      case 2: ssd_step_kernel<2><<<grid_out, kThreads, 0, s>>>(p); break;
      case 4: ssd_step_kernel<4><<<grid_out, kThreads, 0, s>>>(p); break;
      case 8: ssd_step_kernel<8><<<grid_out, kThreads, 0, s>>>(p); break;
      case 16: ssd_step_kernel<16><<<grid_out, kThreads, 0, s>>>(p); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int grid[3] = {grid_states, grid_carry, grid_out};
  if (!cum_ws || !hs_ws || grid_states < bh * G
      || static_cast<long long>(grid_carry) * kThreads < bh * P * N || grid_out < bh * G * NT)
    return static_cast<int>(cudaErrorInvalidValue);
  return x_dt ? launch_p<__nv_bfloat16>(p, grid, s) : launch_p<float>(p, grid, s);
}
