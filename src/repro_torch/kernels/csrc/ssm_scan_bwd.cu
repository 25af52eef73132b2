// The chunked SSD scan's backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas scan (repro/kernels/ssm_scan.py::
// ssd_scan_pallas) has no VJP, and the reference trains hybrid blocks through
// XLA's autodiff of repro/kernels/chunked.py::ssd_scan_chunked.  This is the
// closed form of that gradient, whose plain version is
// kernels/ref.py::ssd_scan_bwd.
//   x (B,S,H,P), a (B,S,H), b and c (B,S,H,N), the output's gradient dy
//   (B,S,H,P), the final state's gradient dh_final (B,H,P,N) or none, and the
//   forward's workspace (each chunk's running log decay cum and start state)
//   -> dx, da, db, dc (contiguous, in their inputs' dtypes) and dh0.
//   Within a chunk, W_ts = exp(cum_t - cum_s) for s <= t, h_s the chunk's
//   start state and dh_e its end state's gradient:
//     dh_start = exp(total) dh_e + sum_t exp(cum_t) dy_t (x) c_t
//     dx_s = sum_{t>=s} (c_t.b_s) W_ts dy_t + exp(total - cum_s) dh_e b_s
//     db_s = sum_{t>=s} (dy_t.x_s) W_ts c_t + exp(total - cum_s) dh_e^T x_s
//     dc_t = sum_{s<=t} (dy_t.x_s) W_ts b_s + exp(cum_t) h_s^T dy_t
//     dlog a_u = sum_{t>=u} dcum_t + sum_{s<u} q_s + exp(total) <dh_e, h_s>,
//     dcum_t = sum_s M_ts - sum_t' M_t't + c_t.(dc's inter term),
//     q_s = b_s.(db's injection term),  M_ts = (c_t.b_s)(dy_t.x_s) W_ts,
//     da = dlog a / max(a, 1e-37)  (half at a tie with the clamp, as
//   jnp.maximum's gradient).  The total's gradient <dh_e, h_end> is taken
//   with the injection terms it would cancel left out, so a gradient that is
//   zero (no state before a step) comes out zero and not rounding noise.
//
// Bound on the card: operations.  At hymba's train shape (B 2, S 4096, 50
// heads of P 64, N 16, Q 256) a call moves ~0.1 GB against ~20 GFLOP of
// causal f32 products, which the CUDA cores' 67 TFLOP/s take longer to do
// than the memory takes to move.
//
// Design: the forward's three chunk-parallel passes, in reverse, and a
// fourth for da.  The forward's workspace (cum and the chunks' start states)
// is kept by the autograd Function and read here, not recomputed.
//   A'. one block per (batch, head, chunk): U = sum_t exp(cum_t) dy_t (x) c_t,
//       each thread on 4 x 4 entries of the (P, N) state, groups of threads
//       on interleaved steps where the state has fewer than 16 entries a
//       thread, their sums added in a fixed order.
//   B'. the reverse carry, one thread per state entry: over the chunks from
//       the last, from dh_final, dh_end of each chunk written over its U;
//       dh0.
//   C'. one block per (batch, head, chunk, 64-row tile) of the chunk: the
//       tile's rows as t (for dc: the earlier s tiles, then the inter-chunk
//       term) and as s (for dx and db: the later t tiles, then the injection
//       term), each (t, s) tile pair's C.B^T and DY.X^T formed in registers
//       (4 x 4 a thread), masked and weighted, staged in shared memory and
//       multiplied out; each row's dcum (row and column sums of M and the
//       inter-chunk term) and q (the injection term) summed in a fixed order
//       and written.  A tile pairs with the tiles before it and the tiles
//       after it, so every block of a chunk does its chunk's tile count plus
//       one pairs.
//   D'. one block per (batch, head, chunk): exp(total) <dh_end, h_start> as
//       a block sum in a fixed order, the exclusive cumulative sum of q (a
//       block scan from the chunk's start, written over q), the reverse
//       cumulative sum of dcum (a block scan from its end), and da.
// No float atomics: every sum is in a fixed order, so two calls agree bit for
// bit.  A ragged last chunk ends at S, as in the forward.  Every product is
// f32 FMAs on the CUDA cores; inputs are read in their own dtypes (f32 or
// bf16) through their strides, dy contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int T = 64;       // rows of a tile
constexpr int TP = T + 4;   // row of a transposed tile in shared memory
constexpr int TA = 32;      // steps pass A' stages at a time
constexpr int kMaxP = 128, kMaxN = 64;

struct Params {
  const void* x; const void* a; const void* b; const void* c;
  const void* dy; const void* dhf;          // dy contiguous (B,S,H,P); dhf (B,H,P,N) or null
  const float* cum;                         // (B*H*G, Q): the forward's running log decays
  const float* hs;                          // (B*H*G, P*N): the forward's chunk start states
  void* dx; void* da; void* db; void* dc; void* dh0;  // contiguous; dh0 may be null
  float* dh;                                // (B*H*G, P*N): U, then each chunk's dh_end
  float* dcum;                              // (B*H*G, Q)
  float* qs;                                // (B*H*G, Q)
  int B, S, H, P, N, Q, G, NT;
  long long x_sb, x_ss, x_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sh;
  long long c_sb, c_ss, c_sh;
  int x_dt, a_dt, b_dt, c_dt, dy_dt, dhf_dt, dh0_dt;  // 0 = float32, 1 = bfloat16
};

__device__ __forceinline__ float ld(const void* p, long long i, int dt) {
  return dt ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, int dt, float v) {
  if (dt) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---- pass A': each chunk's sum_t exp(cum_t) dy_t (x) c_t -------------------------

template <int CP, int NM>
struct StateShape {
  static constexpr int PP = 16 * CP, NN = 16 * NM, QB = PP / 4, EB = QB * (NN / 4);
  static constexpr int BPT = EB > kThreads ? EB / kThreads : 1;  // entry blocks a thread owns
  static constexpr int TB = EB / BPT;                            // threads of a group
  static constexpr int K = kThreads / TB;                        // groups
};

template <int CP, int NM>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(const Params p) {
  using Sh = StateShape<CP, NM>;
  constexpr int PP = Sh::PP, NN = Sh::NN, QB = Sh::QB, BPT = Sh::BPT, TB = Sh::TB, K = Sh::K;
  __shared__ __align__(16) float Ds[TA * PP];
  __shared__ __align__(16) float Cs[TA * NN];
  __shared__ float w[TA];
  __shared__ float red[(K > 1 ? K - 1 : 1) * 16 * TB];

  const int tid = threadIdx.x, P = p.P, N = p.N;
  const int chunk = blockIdx.x, g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  if (bh >= static_cast<long long>(p.B) * p.H) return;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0);
  const float* const cum = p.cum + static_cast<long long>(chunk) * p.Q;
  const long long co = bi * p.c_sb + hi * p.c_sh;
  const int grp = tid / TB;
  float acc[BPT][4][4] = {};
  for (int t0 = 0; t0 < L; t0 += TA) {
    const int rows = min(TA, L - t0);
    __syncthreads();  // the previous rows' reads are done
    for (int i = tid; i < TA * PP; i += kThreads) {
      const int r = i / PP, q = i % PP;
      Ds[i] = r < rows && q < P
                  ? ld(p.dy, ((bi * p.S + c0 + t0 + r) * p.H + hi) * P + q, p.dy_dt) : 0.f;
    }
    for (int i = tid; i < TA * NN; i += kThreads) {
      const int r = i / NN, n = i % NN;
      Cs[i] = r < rows && n < N ? ld(p.c, co + (c0 + t0 + r) * p.c_ss + n, p.c_dt) : 0.f;
    }
    if (tid < TA) w[tid] = tid < rows ? expf(cum[t0 + tid]) : 0.f;
    __syncthreads();
    for (int r = grp; r < rows; r += K) {
      const float wr = w[r];
      #pragma unroll
      for (int u = 0; u < BPT; ++u) {
        const int e = tid % TB + u * TB, qb = e % QB, nb = e / QB;
        const float4 dv = ld4(Ds + r * PP + 4 * qb), cv = ld4(Cs + r * NN + 4 * nb);
        const float d4[4] = {dv.x * wr, dv.y * wr, dv.z * wr, dv.w * wr};
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[u][i][j] = fmaf(d4[i], c4[j], acc[u][i][j]);
        }
      }
    }
  }
  if constexpr (K > 1) {  // the groups' sums, added by group 0 in group order
    const int e = tid % TB;
    __syncthreads();
    if (grp > 0) {
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int j = 0; j < 4; ++j) red[((grp - 1) * 16 + 4 * i + j) * TB + e] = acc[0][i][j];
      }
    }
    __syncthreads();
    if (grp == 0) {
      for (int k = 1; k < K; ++k) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[0][i][j] += red[((k - 1) * 16 + 4 * i + j) * TB + e];
        }
      }
    }
  }
  if (grp == 0) {
    float* const out = p.dh + static_cast<long long>(chunk) * P * N;
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

// ---- pass B': the reverse carry ------------------------------------------------------

// One thread per (batch, head, state entry), over the chunks from the last:
// dh_end of each chunk over its U, then dh = dh exp(total) + U; dh0.
__global__ void __launch_bounds__(kThreads) ssd_bwd_carry_kernel(const Params p) {
  const int PN = p.P * p.N;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.B * p.H * PN) return;
  const int bh = idx / PN, e = idx - bh * PN;
  const float* const cum = p.cum + static_cast<long long>(bh) * p.G * p.Q;
  float* const dh = p.dh + static_cast<long long>(bh) * p.G * PN + e;
  float h = p.dhf ? ld(p.dhf, idx, p.dhf_dt) : 0.f;
  for (int g = p.G - 1; g >= 0; --g) {
    const float total = cum[g * p.Q + min(p.Q, p.S - g * p.Q) - 1];
    const float u = dh[static_cast<long long>(g) * PN];
    dh[static_cast<long long>(g) * PN] = h;
    h = h * expf(total) + u;
  }
  if (p.dh0) st(p.dh0, idx, p.dh0_dt, h);
}

// ---- pass C': dx, db, dc and dcum by tiles ------------------------------------------

// dst[w * TP + r] = src[off + r * ss + w] for the T rows of a tile: zero past
// ``rows`` and in the padding columns W..WP.
template <int WP>
__device__ __forceinline__ void stage_t(float* dst, const void* src, long long off, long long ss,
                                        int dt, int rows, int W) {
  for (int i = threadIdx.x; i < T * WP; i += kThreads) {
    const int r = i / WP, w = i % WP;
    dst[w * TP + r] = r < rows && w < W ? ld(src, off + r * ss + w, dt) : 0.f;
  }
}

template <int CP, int NM>
struct TileLayout {  // shared memory of pass C', in floats
  static constexpr int PP = 16 * CP, NN = 16 * NM;
  static constexpr int Po = 0;                 // PP x TP: the tile's own P-wide rows, transposed
  static constexpr int No = Po + PP * TP;      // NN x TP: its own N-wide rows, transposed
  static constexpr int Pt = No + NN * TP;      // PP x TP: the other tile's P-wide rows; a state
  static constexpr int Nt = Pt + PP * TP;      // NN x TP: the other tile's N-wide rows
  static constexpr int Es = Nt + NN * TP;      // T x TP: E^T, (dy.x) W, [other][own]
  static constexpr int Fs = Es + T * TP;       // T x TP: F^T, (c.b) W, [other][own]
  static constexpr int cumo = Fs + T * TP;     // T: the own rows' cum
  static constexpr int cumt = cumo + T;        // T: the other rows' cum
  static constexpr int dcum = cumt + T;        // T: the own rows' dcum from the t side
  static constexpr int floats = dcum + T;
};

// The (own, other) tile pair's products, thread (ty, tx) on own rows 4ty+i
// and other rows 4tx+j: d = Po^T Pt over P, cb = No^T Nt over N.
__device__ __forceinline__ void pair_products(const float* Po, const float* No, const float* Pt,
                                              const float* Nt, int P, int N, int ty, int tx,
                                              float (&d)[4][4], float (&cb)[4][4]) {
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    #pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = cb[i][j] = 0.f;
  }
  for (int k = 0; k < P; ++k) {
    const float4 u = ld4(Po + k * TP + 4 * ty), v = ld4(Pt + k * TP + 4 * tx);
    const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      #pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = fmaf(uu[i], vv[j], d[i][j]);
    }
  }
  for (int k = 0; k < N; ++k) {
    const float4 u = ld4(No + k * TP + 4 * ty), v = ld4(Nt + k * TP + 4 * tx);
    const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      #pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(uu[i], vv[j], cb[i][j]);
    }
  }
}

// A value summed over the 16 threads of a row of threads (tx), in a fixed
// butterfly order; every thread of the row gets the sum.
__device__ __forceinline__ float row_sum(float v) {
  #pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread (ty, tx) owns the tile's rows 4ty..4ty+3; of a P-wide row the
// columns tx + 16 k, of an N-wide row tx + 16 k.
template <int CP, int NM>
__global__ void __launch_bounds__(kThreads) ssd_bwd_tile_kernel(const Params p) {
  using Lay = TileLayout<CP, NM>;
  constexpr int PP = Lay::PP, NN = Lay::NN;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  float* const Po = sm + Lay::Po;
  float* const No = sm + Lay::No;
  float* const Pt = sm + Lay::Pt;
  float* const Nt = sm + Lay::Nt;
  float* const Es = sm + Lay::Es;
  float* const Fs = sm + Lay::Fs;
  float* const cumo = sm + Lay::cumo;
  float* const cumt = sm + Lay::cumt;
  float* const dcum_t = sm + Lay::dcum;

  const int tile = blockIdx.x % p.NT, chunk = blockIdx.x / p.NT;
  const int g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), r0 = tile * T;
  if (bh >= static_cast<long long>(p.B) * p.H || r0 >= L) return;  // a ragged chunk's end
  const int P = p.P, N = p.N, lr = min(T, L - r0), nvt = (L + T - 1) / T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* const cum = p.cum + static_cast<long long>(chunk) * p.Q;
  const long long xo = bi * p.x_sb + hi * p.x_sh, bo = bi * p.b_sb + hi * p.b_sh;
  const long long co = bi * p.c_sb + hi * p.c_sh;
  const long long dyo = (bi * p.S * p.H + hi) * P, dy_ss = static_cast<long long>(p.H) * P;
  const float total = cum[L - 1];
  float dq[4];  // this thread's part of its rows' dcum

  // -- the tile's rows as t: dc over the s tiles at or before it --------------
  stage_t<PP>(Po, p.dy, dyo + (c0 + r0) * dy_ss, dy_ss, p.dy_dt, lr, P);
  stage_t<NN>(No, p.c, co + (c0 + r0) * p.c_ss, p.c_ss, p.c_dt, lr, N);
  for (int r = tid; r < T; r += kThreads) cumo[r] = r < lr ? cum[r0 + r] : 0.f;
  float dcv[4][NM] = {}, rs[4] = {};
  for (int j = 0; j <= tile; ++j) {
    const int s0 = j * T, ls = min(T, L - s0);
    __syncthreads();  // the previous pair's reads of Pt, Nt and Es are done
    stage_t<PP>(Pt, p.x, xo + (c0 + s0) * p.x_ss, p.x_ss, p.x_dt, ls, P);
    stage_t<NN>(Nt, p.b, bo + (c0 + s0) * p.b_ss, p.b_ss, p.b_dt, ls, N);
    for (int r = tid; r < T; r += kThreads) cumt[r] = r < ls ? cum[s0 + r] : 0.f;
    __syncthreads();
    float d[4][4], cb[4][4];
    pair_products(Po, No, Pt, Nt, P, N, ty, tx, d, cb);
    #pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int sl = 4 * tx + jj, s = s0 + sl;
      float e4[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = r0 + 4 * ty + i;
        const float w = s <= t && t < L ? expf(cumo[4 * ty + i] - cumt[sl]) : 0.f;
        e4[i] = d[i][jj] * w;
        rs[i] = fmaf(e4[i], cb[i][jj], rs[i]);
      }
      *reinterpret_cast<float4*>(Es + sl * TP + 4 * ty) = make_float4(e4[0], e4[1], e4[2], e4[3]);
    }
    __syncthreads();
    for (int s = 0; s < ls; ++s) {  // dc_t += sum_s E_ts b_s
      const float4 ev = ld4(Es + s * TP + 4 * ty);
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const float bv = Nt[(tx + 16 * k) * TP + s];
        dcv[0][k] = fmaf(ev.x, bv, dcv[0][k]); dcv[1][k] = fmaf(ev.y, bv, dcv[1][k]);
        dcv[2][k] = fmaf(ev.z, bv, dcv[2][k]); dcv[3][k] = fmaf(ev.w, bv, dcv[3][k]);
      }
    }
  }
  // the inter-chunk term: dc_t += exp(cum_t) h_start^T dy_t, h_start into Pt as (P, NN)
  __syncthreads();
  {
    const float* src = p.hs + static_cast<long long>(chunk) * P * N;
    for (int i = tid; i < P * NN; i += kThreads) {
      const int q = i / NN, n = i % NN;
      Pt[i] = n < N ? src[q * N + n] : 0.f;
    }
  }
  __syncthreads();
  {
    float inter[4][NM] = {};
    for (int q = 0; q < P; ++q) {
      const float4 dv = ld4(Po + q * TP + 4 * ty);
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const float h = Pt[q * NN + tx + 16 * k];
        inter[0][k] = fmaf(dv.x, h, inter[0][k]); inter[1][k] = fmaf(dv.y, h, inter[1][k]);
        inter[2][k] = fmaf(dv.z, h, inter[2][k]); inter[3][k] = fmaf(dv.w, h, inter[3][k]);
      }
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float e = r < lr ? expf(cumo[r]) : 0.f;
      dq[i] = rs[i];
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const int n = tx + 16 * k;
        inter[i][k] *= e;
        dq[i] = fmaf(No[n * TP + r], inter[i][k], dq[i]);  // + c_t . (the inter term)
        if (r < lr && n < N)
          st(p.dc, ((bi * p.S + c0 + r0 + r) * p.H + hi) * N + n, p.c_dt, dcv[i][k] + inter[i][k]);
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = row_sum(dq[i]);
    if (tx == 0) dcum_t[4 * ty + i] = v;
  }

  // -- the tile's rows as s: dx and db over the t tiles at or after it --------
  __syncthreads();  // the t side's reads of Po, No and Pt are done
  stage_t<PP>(Po, p.x, xo + (c0 + r0) * p.x_ss, p.x_ss, p.x_dt, lr, P);
  stage_t<NN>(No, p.b, bo + (c0 + r0) * p.b_ss, p.b_ss, p.b_dt, lr, N);
  float dxv[4][CP] = {}, dbv[4][NM] = {}, cs[4] = {};
  for (int j = tile; j < nvt; ++j) {
    const int t0 = j * T, lt = min(T, L - t0);
    __syncthreads();
    stage_t<PP>(Pt, p.dy, dyo + (c0 + t0) * dy_ss, dy_ss, p.dy_dt, lt, P);
    stage_t<NN>(Nt, p.c, co + (c0 + t0) * p.c_ss, p.c_ss, p.c_dt, lt, N);
    for (int r = tid; r < T; r += kThreads) cumt[r] = r < lt ? cum[t0 + r] : 0.f;
    __syncthreads();
    float d[4][4], cb[4][4];
    pair_products(Po, No, Pt, Nt, P, N, ty, tx, d, cb);
    #pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int tl = 4 * tx + jj, t = t0 + tl;
      float e4[4], f4[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = r0 + 4 * ty + i;
        const float w = s <= t && t < L ? expf(cumt[tl] - cumo[4 * ty + i]) : 0.f;
        e4[i] = d[i][jj] * w;
        f4[i] = cb[i][jj] * w;
        cs[i] = fmaf(e4[i], cb[i][jj], cs[i]);
      }
      *reinterpret_cast<float4*>(Es + tl * TP + 4 * ty) = make_float4(e4[0], e4[1], e4[2], e4[3]);
      *reinterpret_cast<float4*>(Fs + tl * TP + 4 * ty) = make_float4(f4[0], f4[1], f4[2], f4[3]);
    }
    __syncthreads();
    for (int t = 0; t < lt; ++t) {  // dx_s += sum_t F_ts dy_t, db_s += sum_t E_ts c_t
      const float4 fv = ld4(Fs + t * TP + 4 * ty), ev = ld4(Es + t * TP + 4 * ty);
      #pragma unroll
      for (int k = 0; k < CP; ++k) {
        const float v = Pt[(tx + 16 * k) * TP + t];
        dxv[0][k] = fmaf(fv.x, v, dxv[0][k]); dxv[1][k] = fmaf(fv.y, v, dxv[1][k]);
        dxv[2][k] = fmaf(fv.z, v, dxv[2][k]); dxv[3][k] = fmaf(fv.w, v, dxv[3][k]);
      }
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const float v = Nt[(tx + 16 * k) * TP + t];
        dbv[0][k] = fmaf(ev.x, v, dbv[0][k]); dbv[1][k] = fmaf(ev.y, v, dbv[1][k]);
        dbv[2][k] = fmaf(ev.z, v, dbv[2][k]); dbv[3][k] = fmaf(ev.w, v, dbv[3][k]);
      }
    }
  }
  // the injection terms: dx_s += w_s dh_end b_s, db_s += w_s dh_end^T x_s,
  // w_s = exp(total - cum_s); dh_end into Pt as (P, NN)
  __syncthreads();
  {
    const float* src = p.dh + static_cast<long long>(chunk) * P * N;
    for (int i = tid; i < P * NN; i += kThreads) {
      const int q = i / NN, n = i % NN;
      Pt[i] = n < N ? src[q * N + n] : 0.f;
    }
  }
  __syncthreads();
  {
    float sx[4][CP] = {}, sb[4][NM] = {};
    for (int n = 0; n < N; ++n) {
      const float4 bv = ld4(No + n * TP + 4 * ty);
      #pragma unroll
      for (int k = 0; k < CP; ++k) {
        const int q = tx + 16 * k;
        const float h = q < P ? Pt[q * NN + n] : 0.f;
        sx[0][k] = fmaf(bv.x, h, sx[0][k]); sx[1][k] = fmaf(bv.y, h, sx[1][k]);
        sx[2][k] = fmaf(bv.z, h, sx[2][k]); sx[3][k] = fmaf(bv.w, h, sx[3][k]);
      }
    }
    for (int q = 0; q < P; ++q) {
      const float4 xv = ld4(Po + q * TP + 4 * ty);
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const float h = Pt[q * NN + tx + 16 * k];
        sb[0][k] = fmaf(xv.x, h, sb[0][k]); sb[1][k] = fmaf(xv.y, h, sb[1][k]);
        sb[2][k] = fmaf(xv.z, h, sb[2][k]); sb[3][k] = fmaf(xv.w, h, sb[3][k]);
      }
    }
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float w = r < lr ? expf(total - cumo[r]) : 0.f;
      const long long row = (bi * p.S + c0 + r0 + r) * p.H + hi;
      dq[i] = 0.f;
      #pragma unroll
      for (int k = 0; k < CP; ++k) {
        const int q = tx + 16 * k;
        if (r < lr && q < P) st(p.dx, row * P + q, p.x_dt, fmaf(w, sx[i][k], dxv[i][k]));
      }
      #pragma unroll
      for (int k = 0; k < NM; ++k) {
        const int n = tx + 16 * k;
        const float inj = w * sb[i][k];
        dq[i] = fmaf(No[n * TP + r], inj, dq[i]);  // q_s = b_s . (the injection term)
        if (r < lr && n < N) st(p.db, row * N + n, p.b_dt, dbv[i][k] + inj);
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float col = row_sum(cs[i]), q = row_sum(dq[i]);
    const int r = 4 * ty + i;
    if (tx == 0 && r < lr) {
      const long long at = static_cast<long long>(chunk) * p.Q + r0 + r;
      p.dcum[at] = dcum_t[r] - col;
      p.qs[at] = q;
    }
  }
}

// ---- pass D': da -----------------------------------------------------------------

// An inclusive scan of v over the block's 256 threads in thread order (warp
// shuffles, then the eight warp totals); ``total`` gets the sum of all.
__device__ __forceinline__ float block_scan(float v, float* wsum, float& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  v += warp ? wsum[warp - 1] : 0.f;
  total = wsum[kThreads / 32 - 1];
  __syncthreads();  // wsum is rewritten by the next scan
  return v;
}

// One block per (batch, head, chunk): z = exp(total) <dh_end, h_start>, the
// exclusive cumulative sum of q from the chunk's start (over q), then from the
// chunk's end dlog a_u = sum_{t>=u} dcum_t + q_u + z, 256 steps at a time, and
// da = dlog a / max(a, 1e-37), halved at a tie with the clamp.
__global__ void __launch_bounds__(kThreads) ssd_bwd_da_kernel(const Params p) {
  __shared__ float wsum[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  if (bh >= static_cast<long long>(p.B) * p.H) return;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), PN = p.P * p.N;
  const float* const dh = p.dh + static_cast<long long>(chunk) * PN;
  const float* const hs = p.hs + static_cast<long long>(chunk) * PN;
  const float* const cum = p.cum + static_cast<long long>(chunk) * p.Q;
  float z = 0.f;
  for (int e = tid; e < PN; e += kThreads) z = fmaf(dh[e], hs[e], z);
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
  if (lane == 0) wsum[warp] = z;
  __syncthreads();
  z = 0.f;
  #pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) z += wsum[k];
  z *= expf(cum[L - 1]);
  __syncthreads();  // wsum is reused by the scans

  float* const q = p.qs + static_cast<long long>(chunk) * p.Q;
  float carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {  // q_u <- sum_{s<u} q_s
    const int t = base + tid;
    const float v = t < L ? q[t] : 0.f;
    float piece;
    const float incl = block_scan(v, wsum, piece);
    if (t < L) q[t] = incl - v + carry;
    carry += piece;
  }
  __syncthreads();  // every q_u is written before another thread reads it

  const float* const dcum = p.dcum + static_cast<long long>(chunk) * p.Q;
  const float lim = 1e-37f;
  carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {  // from the chunk's end
    const int t = L - 1 - (base + tid);
    float piece;
    const float v = block_scan(t >= 0 ? dcum[t] : 0.f, wsum, piece) + carry;
    if (t >= 0) {
      const float av = ld(p.a, bi * p.a_sb + (c0 + t) * p.a_ss + hi * p.a_sh, p.a_dt);
      const float f = av > lim ? 1.f : (av == lim ? 0.5f : 0.f);
      st(p.da, (bi * p.S + c0 + t) * p.H + hi, p.a_dt, (v + q[t] + z) / fmaxf(av, lim) * f);
    }
    carry += piece;
  }
}

// ---- launches ----------------------------------------------------------------------

template <int CP, int NM>
int launch_nm(const Params& p, const int (&grid)[4], cudaStream_t stream) {
  ssd_bwd_state_kernel<CP, NM><<<grid[0], kThreads, 0, stream>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  ssd_bwd_carry_kernel<<<grid[1], kThreads, 0, stream>>>(p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const int bytes = 4 * TileLayout<CP, NM>::floats;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_tile_kernel<CP, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_bwd_tile_kernel<CP, NM><<<grid[2], kThreads, bytes, stream>>>(p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ssd_bwd_da_kernel<<<grid[3], kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int launch_n(const Params& p, const int (&grid)[4], cudaStream_t stream) {
  if (p.N <= 16) return launch_nm<CP, 1>(p, grid, stream);
  if (p.N <= 32) return launch_nm<CP, 2>(p, grid, stream);
  return launch_nm<CP, 4>(p, grid, stream);
}

}  // namespace

// dx, da, db, dc are contiguous in x's, a's, b's and c's dtypes; dy is
// contiguous (B,S,H,P); dh_final and dh0 contiguous (B,H,P,N), dh0 in h0's
// dtype (null: no h0).  cum (B*H*G*Q) and hs (B*H*G*P*N) are the forward's
// workspace after its carry; dh_ws (B*H*G*P*N) and dcum_ws (2*B*H*G*Q: dcum,
// then q) are this call's.  grid: the blocks of the four launches as the
// host planned them (A', B', C', D'); a grid too small for its work is
// refused.  dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd(
    const void* x, const void* a, const void* b, const void* c, const void* dy,
    const void* dh_final, const void* cum, const void* hs,
    void* dx, void* da, void* db, void* dc, void* dh0, void* dh_ws, void* dcum_ws,
    int B, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sh,
    long long c_sb, long long c_ss, long long c_sh,
    int x_dt, int a_dt, int b_dt, int c_dt, int dy_dt, int dhf_dt, int dh0_dt,
    int grid_state, int grid_carry, int grid_tiles, int grid_da, void* stream) {
  if (B == 0 || H == 0) return 0;
  const long long bh = static_cast<long long>(B) * H;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S < 1 || Q > S
      || bh * P * N * 16 >= (1LL << 31) || !cum || !hs || !dh_ws || !dcum_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (S + Q - 1) / Q, NT = (Q + T - 1) / T;
  if (grid_state < bh * G || static_cast<long long>(grid_carry) * kThreads < bh * P * N
      || grid_tiles < bh * G * NT || grid_da < bh * G)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, a, b, c, dy, dh_final, static_cast<const float*>(cum),
                 static_cast<const float*>(hs), dx, da, db, dc, dh0,
                 static_cast<float*>(dh_ws), static_cast<float*>(dcum_ws),
                 static_cast<float*>(dcum_ws) + bh * G * Q,
                 B, S, H, P, N, Q, G, NT,
                 x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
                 x_dt, a_dt, b_dt, c_dt, dy_dt, dhf_dt, dh0_dt};
  const int grid[4] = {grid_state, grid_carry, grid_tiles, grid_da};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch_n<1>(p, grid, s);
  if (P <= 32) return launch_n<2>(p, grid, s);
  if (P <= 64) return launch_n<4>(p, grid, s);
  return launch_n<8>(p, grid, s);
}
