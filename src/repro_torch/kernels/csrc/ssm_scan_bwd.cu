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
// Bound on the card: bytes.  At hymba's train shape (B 2, S 4096, 50 heads
// of P 64, N 16, Q 256) a call moves 239 MB (each input read once, each
// output written once: 71 us at 3.35 TB/s) against 21.9 GFLOP of causal
// products, which take 22 us at the bf16 tensor-core peak but 327 us on the
// CUDA cores' f32 FMAs.  So the products must run on the tensor cores, and
// each tile pair's must be formed once.
//
// Design: the forward's three chunk-parallel passes, in reverse, and a
// fourth for da.  The forward's workspace (cum and the chunks' start states)
// is kept by the autograd Function and read here, not recomputed.  For bf16
// x and dy (the trained model) the two passes with products run on the
// tensor cores (ssm_scan_bwd_tc.cu, a library of its own so its
// instantiations compile beside these; the carry and da are shared,
// ssd_bwd_common.cuh); f32 x keeps exact f32 FMAs on the CUDA cores (this
// file), so the f32 sweep holds the reference's 5e-5, as the forward splits
// its output pass.
//   A'. one block per (batch, head, chunk): U = sum_t exp(cum_t) dy_t (x) c_t.
//       bf16: a (P x Q)(Q x N) product on the tensor cores
//       (ssd_bwd_state_tc_kernel), the weighted dy split into bf16 high and
//       low parts, the chunk's dy streamed through a two-stage ring of
//       16-byte cp.async copies.  f32: ssd_bwd_state_kernel, FMAs, each
//       thread on 4 x 4 entries of the state, groups of threads on
//       interleaved steps where the state has fewer than 16 entries a thread.
//   B'. the reverse carry, one thread per state entry: over the chunks from
//       the last, from dh_final, dh_end of each chunk written over its U;
//       dh0.
//   C'. bf16: one block per (batch, head, chunk) (ssd_bwd_chunk_tc_kernel)
//       walks the chunk's lower-triangle 64-row tile pairs once each, s
//       tiles outer, t tiles at or after the s tile inner (Q 256: 4 tiles,
//       10 pairs).  Warp w owns s rows 16w..16w+15 of the s tile: per pair
//       it forms D^T = X_s DY_t^T and (C B^T)^T = B_s C_t^T on the tensor
//       cores, a 16-column slice of t at a time, weights them by W^T (masked
//       to t >= s before the f32 values are split: exp of an upper-triangle
//       difference overflows; off the diagonal through the s tile's last
//       row r, exp(cum_t - cum_r) exp(cum_r - cum_s), both at most 1), and
//       multiplies the slice straight out of its accumulator registers into
//       dx_s += F^T DY_t and db_s += E^T C_t, held in registers for the
//       whole s tile.  E^T goes to shared memory once, split, for dc_t += E
//       B_s (the one product whose rows are t), which each warp takes for
//       16 t rows, into f32 sums in shared memory for the chunk's rows,
//       final at the t tile's diagonal pair.  The pairs' sums of M = E o
//       (C B^T) over s (for dcum_t, through shared memory in warp order) and
//       over t (for dcum_s, in registers) come from the same accumulators.
//       The inter-chunk term of dc and the injection terms of dx and db are
//       tensor-core products too, with the state split.  The next pair's DY
//       and the next s tile's X come by 16-byte cp.async into a second
//       stage while this pair computes; its C and B (f32 or bf16, split
//       into bf16 high and low parts) are loaded into registers meanwhile
//       and stored split after it.  f32: ssd_bwd_tile_kernel, a block per
//       (batch, head, chunk, 64-row tile) pairing its tile with the tiles
//       before it (as t) and after it (as s), f32 FMAs.  A bf16 call whose
//       C' block needs more shared memory than a block has (P 128 and N 64
//       at Q 256) is refused, not sent to the CUDA cores.
//   D'. one block per (batch, head, chunk): exp(total) <dh_end, h_start> as
//       a block sum in a fixed order, the exclusive cumulative sum of q (a
//       block scan from the chunk's start, written over q), the reverse
//       cumulative sum of dcum (a block scan from its end), and da.
// Every tensor-core product takes bf16 operands: x, dy and a bf16 c are
// exact; an f32 operand (b, an f32 c, the weighted E and F, the chunk sums'
// weighted dy, the states) is a bf16 high part plus the bf16 of its
// remainder, the low-by-low product dropped, which carries ~16 bits, far
// below the outputs' bf16 rounding; kernels/ref.py::ssd_scan_bwd_bf16_scheme
// is this arithmetic in f32.  No float atomics: every sum is in a fixed
// order, so two calls agree bit for bit.  A ragged last chunk ends at S, as
// in the forward.  Inputs are read in their own dtypes through their
// strides, dy contiguous.
#include "ssd_bwd_common.cuh"

namespace {

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

// ---- launches ----------------------------------------------------------------------

// The four passes on the CUDA cores.
template <int CP, int NM>
int launch_nm(const Params& p, const int (&grid)[4], cudaStream_t stream) {
  int rc = launch_smem(ssd_bwd_state_kernel<CP, NM>, grid[0], kThreads, 0, p, stream);
  if (rc) return rc;
  ssd_bwd_carry_kernel<<<grid[1], kThreads, 0, stream>>>(p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  rc = launch_smem(ssd_bwd_tile_kernel<CP, NM>, grid[2], kThreads,
                   4 * TileLayout<CP, NM>::floats, p, stream);
  if (rc) return rc;
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
// host planned them (A', B', C', D'; C' a block per chunk and tile); a grid
// too small for its work is refused.  dtype codes: 0 = float32, 1 =
// bfloat16; x and dy must be float32 here (bf16 x and dy take the tensor
// cores' passes, ssm_scan_bwd_tc.cu's ssd_scan_bwd_tc, with the same
// arguments).  Returns a cudaError_t.
extern "C" int ssd_scan_bwd(SSD_BWD_ARGS) {
  if (B == 0 || H == 0) return 0;
  Params p;
  const int rc = x_dt != 0 || dy_dt != 0 ? static_cast<int>(cudaErrorInvalidValue)
                                         : bwd_params(p, (Q + T - 1) / T, SSD_BWD_NAMES);
  if (rc) return rc;
  const int grid[4] = {grid_state, grid_carry, grid_tiles, grid_da};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch_n<1>(p, grid, s);
  if (P <= 32) return launch_n<2>(p, grid, s);
  if (P <= 64) return launch_n<4>(p, grid, s);
  return launch_n<8>(p, grid, s);
}
