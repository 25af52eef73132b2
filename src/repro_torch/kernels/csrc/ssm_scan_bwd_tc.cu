// The SSD scan backward's tensor-core passes for Hopper (sm_90a): bf16 x and
// dy, the trained model's.
//
// Replaces no TPU kernel (see ssm_scan_bwd.cu: the reference trains the scan
// through XLA's autodiff of its chunked form).  The same call as
// ssm_scan_bwd.cu's ssd_scan_bwd, whose note gives the closed form, the
// bound and the design: here passes A' (ssd_bwd_state_tc_kernel, the chunk
// sums as a tensor-core product) and C' (ssd_bwd_chunk_tc_kernel, a block a
// chunk forming each lower-triangle tile pair once), with the shared carry
// and da of ssd_bwd_common.cuh.  A source of its own so its instantiations
// compile beside the CUDA cores' ones.
#include "ssd_bwd_common.cuh"

namespace {

// ---- the tensor-core passes for bf16 x and dy (A' and C') ----------------------------

constexpr int kTcThreads = 128;  // four warps

// Rows [r0, r0 + T) of a chunk of a bf16 (rows, P) operand with row stride
// ss into a shared tile of T rows of pitch R, zero past the chunk's L rows
// and in the pad columns P..PP: by 16-byte cp.async where the rows allow it.
template <int PP, int R>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long ss, int r0, int L, int P, bool vec) {
  const int lr = min(T, L - r0);
  if (vec) {
    for (int i = threadIdx.x; i < T * (PP / 8); i += kTcThreads) {
      const int r = i / (PP / 8), q = (i % (PP / 8)) * 8;
      const bool ok = r < lr && q < P;
      cp_async16(dst + r * R + q, ok ? src + (r0 + r) * ss + q : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < T * PP; i += kTcThreads) {
      const int r = i / PP, q = i % PP;
      dst[r * R + q] = r < lr && q < P ? src[(r0 + r) * ss + q] : __float2bfloat16(0.f);
    }
  }
}

// Rows [r0, r0 + T) of an f32 or bf16 (rows, N) operand into registers
// (zero past L and N), then into shared memory split into bf16 high and low
// tiles of pitch R: loaded before a pair's products, stored after them.  The
// registers hold the values' bits as loaded, so nothing waits on the loads
// until the store.
template <int NN>
struct SplitRows {
  static constexpr int K = T * NN / kTcThreads;  // values a thread carries
  uint32_t v[K];
  int dt;
  __device__ __forceinline__ void load(const void* src, long long off, long long ss, int dtype,
                                       int r0, int L, int N) {
    const int lr = min(T, L - r0);
    dt = dtype;
    #pragma unroll
    for (int m = 0; m < K; ++m) {
      const int i = threadIdx.x + m * kTcThreads, r = i / NN, n = i % NN;
      const long long at = off + (r0 + r) * ss + n;
      v[m] = !(r < lr && n < N) ? 0u
             : dt ? static_cast<uint32_t>(static_cast<const unsigned short*>(src)[at])
                  : static_cast<const uint32_t*>(src)[at];
    }
  }
  template <int R>
  __device__ __forceinline__ void store(__nv_bfloat16* hi, __nv_bfloat16* lo) const {
    #pragma unroll
    for (int m = 0; m < K; ++m) {
      const int i = threadIdx.x + m * kTcThreads, r = i / NN, n = i % NN;
      split_bf16(__uint_as_float(dt ? v[m] << 16 : v[m]), hi[r * R + n], lo[r * R + n]);
    }
  }
};

// A chunk's (P, N) f32 state into shared memory as (PP, R)-pitched bf16 high
// and low parts, zero in the padding.
template <int PP, int NN, int R>
__device__ __forceinline__ void stage_state(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                            const float* src, int P, int N) {
  for (int i = threadIdx.x; i < PP * NN; i += kTcThreads) {
    const int q = i / NN, n = i % NN;
    split_bf16(q < P && n < N ? src[q * N + n] : 0.f, hi[q * R + n], lo[q * R + n]);
  }
}

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

template <int CP, int NM>
struct StateTcLayout {  // shared memory of ssd_bwd_state_tc_kernel, in bytes
  static constexpr int PP = 16 * CP, NN = 16 * NM;
  static constexpr int XR = PP + 8, CR = NN + 8;  // padded bf16 rows: no ldmatrix bank conflicts
  static constexpr int WM = CP < 4 ? CP : 4;      // warps across P's 16-row tiles
  static constexpr int KW = kTcThreads / 32 / WM; // warps across the chunk's steps
  static constexpr int MW = CP / WM;              // P tiles a warp owns
  static constexpr int dys = 0;                   // 2 stages x T x XR: dy
  static constexpr int ch = dys + 2 * T * XR * 2; // 2 stages x T x CR: c, high
  static constexpr int cl = ch + 2 * T * CR * 2;  //                      c, low
  static constexpr int red = cl + 2 * T * CR * 2; // (KW - 1) x WM x 16 x NN f32: partial sums
  static constexpr int cum = red + (KW - 1) * WM * 16 * NN * 4;  // then Q f32
};

// Pass A' on the tensor cores: U (P x N) = sum_t (exp(cum_t) dy_t)^T c_t,
// A = the weighted dy transposed (split), B = c (split where f32).  Warp w
// owns P tiles w % WM, w % WM + WM, .. over the steps of k16 slices
// congruent to w / WM mod KW; the KW partial sums are added in warp order.
template <int CP, int NM>
__global__ void __launch_bounds__(kTcThreads, 4) ssd_bwd_state_tc_kernel(const Params p) {
  using Lay = StateTcLayout<CP, NM>;
  constexpr int PP = Lay::PP, NN = Lay::NN, XR = Lay::XR, CR = Lay::CR;
  constexpr int WM = Lay::WM, KW = Lay::KW, MW = Lay::MW;
  extern __shared__ float4 smem4[];
  char* const sm = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* const DYs = reinterpret_cast<__nv_bfloat16*>(sm + Lay::dys);
  __nv_bfloat16* const Ch = reinterpret_cast<__nv_bfloat16*>(sm + Lay::ch);
  __nv_bfloat16* const Cl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::cl);
  float* const red = reinterpret_cast<float*>(sm + Lay::red);
  float* const cum = reinterpret_cast<float*>(sm + Lay::cum);

  const int chunk = blockIdx.x, g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  if (bh >= static_cast<long long>(p.B) * p.H) return;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), nt = (L + T - 1) / T, P = p.P, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int mw = warp % WM, kg = warp / WM;
  const __nv_bfloat16* const dyg = static_cast<const __nv_bfloat16*>(p.dy)
                                   + ((bi * p.S + c0) * p.H + hi) * P;
  const long long dy_ss = static_cast<long long>(p.H) * P;
  const long long co = bi * p.c_sb + hi * p.c_sh + c0 * p.c_ss;
  const bool c_split = p.c_dt == 0;

  SplitRows<NN> cv;
  stage_bf16<PP, XR>(DYs, dyg, dy_ss, 0, L, P, p.dy_vec);
  cp_async_commit();
  cv.load(p.c, co, p.c_ss, p.c_dt, 0, L, N);
  for (int t = tid; t < nt * T; t += kTcThreads)
    cum[t] = t < L ? expf(p.cum[static_cast<long long>(chunk) * p.Q + t]) : 0.f;  // exp(cum_t)
  cv.template store<CR>(Ch, Cl);

  float acc[MW][2 * NM][4] = {};
  for (int k = 0; k < nt; ++k) {
    const int stg = k & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k is in shared memory; tile k - 1's reads are done
    if (k + 1 < nt) {
      stage_bf16<PP, XR>(DYs + (stg ^ 1) * T * XR, dyg, dy_ss, (k + 1) * T, L, P, p.dy_vec);
      cp_async_commit();
      cv.load(p.c, co, p.c_ss, p.c_dt, (k + 1) * T, L, N);
    }
    const __nv_bfloat16* const dys = DYs + stg * T * XR;
    const __nv_bfloat16* const chs = Ch + stg * T * CR;
    const __nv_bfloat16* const cls = Cl + stg * T * CR;
    #pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if ((4 * k + ks) % KW != kg) continue;
      const int t = k * T + 16 * ks + 2 * tq;  // this thread's steps: t, t + 1, t + 8, t + 9
      const float e0 = cum[t], e1 = cum[t + 1], e8 = cum[t + 8], e9 = cum[t + 9];
      uint32_t cb[NM][4], cbl[NM][4];
      #pragma unroll
      for (int np = 0; np < NM; ++np) {
        const int o = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * CR + 16 * np + (lane >> 4) * 8;
        ldsm_x4_t(cb[np], chs + o);
        if (c_split) ldsm_x4_t(cbl[np], cls + o);
      }
      #pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int pt = mw + WM * m;
        uint32_t r[4];  // (dy^T) at p rows gr, gr + 8 and steps 2tq.., 2tq + 8..
        ldsm_x4_t(r, dys + (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * XR + 16 * pt
                         + ((lane >> 3) & 1) * 8);
        uint32_t ah[4], al[4];
        const float2 v0 = bf16x2_to_f2(r[0]), v1 = bf16x2_to_f2(r[1]);
        const float2 v2 = bf16x2_to_f2(r[2]), v3 = bf16x2_to_f2(r[3]);
        split2(v0.x * e0, v0.y * e1, ah[0], al[0]);
        split2(v1.x * e0, v1.y * e1, ah[1], al[1]);
        split2(v2.x * e8, v2.y * e9, ah[2], al[2]);
        split2(v3.x * e8, v3.y * e9, ah[3], al[3]);
        #pragma unroll
        for (int np = 0; np < NM; ++np) {
          mma_bf16(acc[m][2 * np], ah, cb[np][0], cb[np][1]);
          mma_bf16(acc[m][2 * np], al, cb[np][0], cb[np][1]);
          mma_bf16(acc[m][2 * np + 1], ah, cb[np][2], cb[np][3]);
          mma_bf16(acc[m][2 * np + 1], al, cb[np][2], cb[np][3]);
          if (c_split) {
            mma_bf16(acc[m][2 * np], ah, cbl[np][0], cbl[np][1]);
            mma_bf16(acc[m][2 * np + 1], ah, cbl[np][2], cbl[np][3]);
          }
        }
      }
    }
    if (k + 1 < nt) cv.template store<CR>(Ch + (stg ^ 1) * T * CR, Cl + (stg ^ 1) * T * CR);
  }

  if constexpr (KW > 1) {  // the step groups' partial sums, added in group order
    if (kg > 0) {
      float* const dst = red + ((kg - 1) * WM + mw) * 16 * NN;
      #pragma unroll
      for (int nt8 = 0; nt8 < 2 * NM; ++nt8) {
        #pragma unroll
        for (int f = 0; f < 4; ++f)
          dst[(gr + (f & 2 ? 8 : 0)) * NN + 8 * nt8 + 2 * tq + (f & 1)] = acc[0][nt8][f];
      }
    }
    __syncthreads();
    if (kg > 0) return;
    for (int k = 1; k < KW; ++k) {
      const float* const src = red + ((k - 1) * WM + mw) * 16 * NN;
      #pragma unroll
      for (int nt8 = 0; nt8 < 2 * NM; ++nt8) {
        #pragma unroll
        for (int f = 0; f < 4; ++f)
          acc[0][nt8][f] += src[(gr + (f & 2 ? 8 : 0)) * NN + 8 * nt8 + 2 * tq + (f & 1)];
      }
    }
  }
  float* const out = p.dh + static_cast<long long>(chunk) * P * N;
  #pragma unroll
  for (int m = 0; m < MW; ++m) {
    #pragma unroll
    for (int nt8 = 0; nt8 < 2 * NM; ++nt8) {
      #pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int q = 16 * (mw + WM * m) + gr + (f & 2 ? 8 : 0), n = 8 * nt8 + 2 * tq + (f & 1);
        if (q < P && n < N) out[q * N + n] = acc[m][nt8][f];
      }
    }
  }
}

template <int CP, int NM>
struct ChunkTcLayout {  // shared memory of ssd_bwd_chunk_tc_kernel, in bytes
  static constexpr int PP = 16 * CP, NN = 16 * NM;
  // padded bf16 rows, so that ldmatrix has no bank conflicts
  static constexpr int XR = PP + 8;  // a row of X or DY
  static constexpr int CR = NN + 8;  // a row of split B or C, or of a split state's (p, n)
  static constexpr int ER = T + 8;   // a row of E^T
  static constexpr int xs = 0;                      // 2 x T x XR: X, by the s tile's parity
  static constexpr int dys = xs + 2 * T * XR * 2;   // 2 x T x XR: DY, by the pair's parity
  static constexpr int ch = dys + 2 * T * XR * 2;   // 2 x T x CR: C high, by the pair's parity
  static constexpr int cl = ch + 2 * T * CR * 2;    //             C low
  static constexpr int bh = cl + 2 * T * CR * 2;    // 2 x T x CR: B high, by the s tile's parity
  static constexpr int bl = bh + 2 * T * CR * 2;    //             B low
  static constexpr int eh = bl + 2 * T * CR * 2;    // T x ER: E^T high, [s][t]
  static constexpr int el = eh + T * ER * 2;        //         E^T low
  static constexpr int sh = el + T * ER * 2;        // PP x CR: the start state, then dh_end, high
  static constexpr int sl = sh + PP * CR * 2;       //          low
  static constexpr int part = sl + PP * CR * 2;     // 4 x T f32: each warp's sums of M over s
  static constexpr int cum = part + 4 * T * 4;      // then rows f32 cum, rows f32 dcum,
  static __host__ __device__ constexpr int bytes(int rows) {  // rows x NN f32 dc
    return cum + 4 * rows * (2 + NN);
  }
};

// Pass C' on the tensor cores, one block per (batch, head, chunk).  The
// pairs (t tile i, s tile j), i >= j, in the order j = 0.., i = j..; warp w
// owns s rows 16w.. of tile j.  Per pair, a 16-column slice kk of t at a
// time: D^T (16 x 16) = X_s DY_t^T over P, CB^T = B_s C_t^T over N, W^T;
// E^T = D^T W^T and F^T = CB^T W^T split from the accumulators into A
// fragments for dx_s += F^T DY_t and db_s += E^T C_t, and E^T stored split
// for dc_t += E B_s.  Then each warp takes 16 t rows of tile i for dc (from
// the inter-chunk term at j = 0; written out at the diagonal pair, its last)
// and their dcum sums of M over s, in warp order.  At the s tile's last pair:
// the injection terms, dx, db, and the s rows' dcum and q.
template <int CP, int NM>
__global__ void __launch_bounds__(kTcThreads, 2) ssd_bwd_chunk_tc_kernel(const Params p) {
  using Lay = ChunkTcLayout<CP, NM>;
  constexpr int PP = Lay::PP, NN = Lay::NN, XR = Lay::XR, CR = Lay::CR, ER = Lay::ER;
  extern __shared__ float4 smem4[];
  char* const sm = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* const Xs = reinterpret_cast<__nv_bfloat16*>(sm + Lay::xs);
  __nv_bfloat16* const DYs = reinterpret_cast<__nv_bfloat16*>(sm + Lay::dys);
  __nv_bfloat16* const Ch = reinterpret_cast<__nv_bfloat16*>(sm + Lay::ch);
  __nv_bfloat16* const Cl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::cl);
  __nv_bfloat16* const Bh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::bh);
  __nv_bfloat16* const Bl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::bl);
  __nv_bfloat16* const Eh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::eh);
  __nv_bfloat16* const El = reinterpret_cast<__nv_bfloat16*>(sm + Lay::el);
  __nv_bfloat16* const Sh = reinterpret_cast<__nv_bfloat16*>(sm + Lay::sh);
  __nv_bfloat16* const Sl = reinterpret_cast<__nv_bfloat16*>(sm + Lay::sl);
  float* const part = reinterpret_cast<float*>(sm + Lay::part);
  float* const cum = reinterpret_cast<float*>(sm + Lay::cum);
  float* const dcum = cum + p.NT * T;
  float* const dcs = dcum + p.NT * T;  // (NT T, NN): the chunk's dc sums

  const int chunk = blockIdx.x, g = chunk % p.G;
  const long long bh = chunk / p.G, bi = bh / p.H, hi = bh % p.H;
  if (bh >= static_cast<long long>(p.B) * p.H) return;
  const int c0 = g * p.Q, L = min(p.Q, p.S - c0), nt = (L + T - 1) / T, P = p.P, N = p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* const xg = static_cast<const __nv_bfloat16*>(p.x) + bi * p.x_sb
                                  + hi * p.x_sh + c0 * p.x_ss;
  const __nv_bfloat16* const dyg = static_cast<const __nv_bfloat16*>(p.dy)
                                   + ((bi * p.S + c0) * p.H + hi) * P;
  const long long dy_ss = static_cast<long long>(p.H) * P;
  const long long bo = bi * p.b_sb + hi * p.b_sh + c0 * p.b_ss;
  const long long co = bi * p.c_sb + hi * p.c_sh + c0 * p.c_ss;
  const long long row0 = (bi * p.S + c0) * p.H + hi;  // the chunk's first (b, s, h) row
  const bool b_split = p.b_dt == 0, c_split = p.c_dt == 0;
  const float* const cumg = p.cum + static_cast<long long>(chunk) * p.Q;
  const float total = cumg[L - 1];

  stage_bf16<PP, XR>(Xs, xg, p.x_ss, 0, L, P, p.x_vec);
  stage_bf16<PP, XR>(DYs, dyg, dy_ss, 0, L, P, p.dy_vec);
  cp_async_commit();
  SplitRows<NN> cv, bv;
  cv.load(p.c, co, p.c_ss, p.c_dt, 0, L, N);
  bv.load(p.b, bo, p.b_ss, p.b_dt, 0, L, N);
  for (int t = tid; t < nt * T; t += kTcThreads) cum[t] = t < L ? cumg[t] : 0.f;
  stage_state<PP, NN, CR>(Sh, Sl, p.hs + static_cast<long long>(chunk) * P * N, P, N);
  cv.template store<CR>(Ch, Cl);
  bv.template store<CR>(Bh, Bl);

  float dxa[2 * CP][4], dba[2 * NM][4], srow[2];  // the warp's s rows of the s tile
  int j = 0, i = 0;
  for (int pi = 0;; ++pi) {
    const int stg = pi & 1, sp = j & 1, s0 = j * T, t0 = i * T;
    const bool diag = i == j;  // the s tile's first pair, and the t tile's last
    int nj = j, ni = i + 1;
    if (ni == nt) nj = ni = j + 1;
    const bool more = nj < nt;
    if (diag) {
      #pragma unroll
      for (int n8 = 0; n8 < 2 * CP; ++n8) dxa[n8][0] = dxa[n8][1] = dxa[n8][2] = dxa[n8][3] = 0.f;
      #pragma unroll
      for (int n8 = 0; n8 < 2 * NM; ++n8) dba[n8][0] = dba[n8][1] = dba[n8][2] = dba[n8][3] = 0.f;
      srow[0] = srow[1] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // this pair's tiles are in place; the last pair's reads are done
    if (more) {  // the next pair's tiles: DY (and X) in flight, C (and B) in registers
      stage_bf16<PP, XR>(DYs + (stg ^ 1) * T * XR, dyg, dy_ss, ni * T, L, P, p.dy_vec);
      if (nj != j) stage_bf16<PP, XR>(Xs + (sp ^ 1) * T * XR, xg, p.x_ss, nj * T, L, P, p.x_vec);
      cp_async_commit();
      cv.load(p.c, co, p.c_ss, p.c_dt, ni * T, L, N);
      if (nj != j) bv.load(p.b, bo, p.b_ss, p.b_dt, nj * T, L, N);
    }
    const __nv_bfloat16* const xs = Xs + sp * T * XR;
    const __nv_bfloat16* const dys = DYs + stg * T * XR;
    const __nv_bfloat16* const chs = Ch + stg * T * CR;
    const __nv_bfloat16* const cls = Cl + stg * T * CR;
    const __nv_bfloat16* const bhs = Bh + sp * T * CR;
    const __nv_bfloat16* const bls = Bl + sp * T * CR;

    // the warp's s rows as A fragments: X over P, B (split) over N
    uint32_t xa[CP][4], bah[NM][4], bal[NM][4];
    #pragma unroll
    for (int ks = 0; ks < CP; ++ks)
      ldsm_x4(xa[ks], xs + (16 * warp + (lane & 15)) * XR + 16 * ks + (lane >> 4) * 8);
    #pragma unroll
    for (int ks = 0; ks < NM; ++ks) {
      const int o = (16 * warp + (lane & 15)) * CR + 16 * ks + (lane >> 4) * 8;
      ldsm_x4(bah[ks], bhs + o);
      if (b_split) ldsm_x4(bal[ks], bls + o);
    }
    const int sa = s0 + 16 * warp + gr, sb = sa + 8;  // the thread's s rows in the chunk
    const float ref = diag ? 0.f : cum[s0 + T - 1];   // off the diagonal: the s tile's last step
    const float va = diag ? 1.f : expf(ref - cum[sa]), vb = diag ? 1.f : expf(ref - cum[sb]);

    #pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float colm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // sums of M over the thread's s rows
      if (!diag || kk >= warp) {  // on the diagonal, slices before the warp's rows are all t < s
        float dd[2][4] = {}, cb[2][4] = {};
        #pragma unroll
        for (int ks = 0; ks < CP; ++ks) {  // D^T = X_s DY_t^T
          uint32_t r[4];
          ldsm_x4(r, dys + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * XR + 16 * ks
                         + ((lane >> 3) & 1) * 8);
          mma_bf16(dd[0], xa[ks], r[0], r[1]);
          mma_bf16(dd[1], xa[ks], r[2], r[3]);
        }
        #pragma unroll
        for (int ks = 0; ks < NM; ++ks) {  // CB^T = B_s C_t^T
          const int o = (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * CR + 16 * ks
                        + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, chs + o);
          mma_bf16(cb[0], bah[ks], r[0], r[1]);
          mma_bf16(cb[1], bah[ks], r[2], r[3]);
          if (b_split) {
            mma_bf16(cb[0], bal[ks], r[0], r[1]);
            mma_bf16(cb[1], bal[ks], r[2], r[3]);
          }
          if (c_split) {
            ldsm_x4(r, cls + o);
            mma_bf16(cb[0], bah[ks], r[0], r[1]);
            mma_bf16(cb[1], bah[ks], r[2], r[3]);
          }
        }
        float e[2][4], f[2][4];
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          #pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = t0 + 16 * kk + 8 * h + 2 * tq + c;
            float wa, wb;
            if (diag) {
              wa = sa <= t && t < L ? expf(cum[t] - cum[sa]) : 0.f;
              wb = sb <= t && t < L ? expf(cum[t] - cum[sb]) : 0.f;
            } else {
              const float u = t < L ? expf(cum[t] - ref) : 0.f;
              wa = u * va;
              wb = u * vb;
            }
            e[h][c] = dd[h][c] * wa;
            e[h][c + 2] = dd[h][c + 2] * wb;
            f[h][c] = cb[h][c] * wa;
            f[h][c + 2] = cb[h][c + 2] * wb;
            const float ma = e[h][c] * cb[h][c], mb = e[h][c + 2] * cb[h][c + 2];
            srow[0] += ma;
            srow[1] += mb;
            colm[h][c] = ma + mb;
          }
        }
        uint32_t eh[4], el[4], fh[4], fl[4];  // A fragments of the slice: rows s, k = t
        split2(e[0][0], e[0][1], eh[0], el[0]);
        split2(e[0][2], e[0][3], eh[1], el[1]);
        split2(e[1][0], e[1][1], eh[2], el[2]);
        split2(e[1][2], e[1][3], eh[3], el[3]);
        split2(f[0][0], f[0][1], fh[0], fl[0]);
        split2(f[0][2], f[0][3], fh[1], fl[1]);
        split2(f[1][0], f[1][1], fh[2], fl[2]);
        split2(f[1][2], f[1][3], fh[3], fl[3]);
        {  // E^T into shared memory for dc
          const int ra = (16 * warp + gr) * ER + 16 * kk + 2 * tq, rb = ra + 8 * ER;
          *reinterpret_cast<uint32_t*>(Eh + ra) = eh[0];
          *reinterpret_cast<uint32_t*>(Eh + rb) = eh[1];
          *reinterpret_cast<uint32_t*>(Eh + ra + 8) = eh[2];
          *reinterpret_cast<uint32_t*>(Eh + rb + 8) = eh[3];
          *reinterpret_cast<uint32_t*>(El + ra) = el[0];
          *reinterpret_cast<uint32_t*>(El + rb) = el[1];
          *reinterpret_cast<uint32_t*>(El + ra + 8) = el[2];
          *reinterpret_cast<uint32_t*>(El + rb + 8) = el[3];
        }
        #pragma unroll
        for (int np = 0; np < CP; ++np) {  // dx_s += F^T DY_t
          uint32_t r[4];
          ldsm_x4_t(r, dys + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XR + 16 * np
                           + (lane >> 4) * 8);
          mma_bf16(dxa[2 * np], fh, r[0], r[1]);
          mma_bf16(dxa[2 * np], fl, r[0], r[1]);
          mma_bf16(dxa[2 * np + 1], fh, r[2], r[3]);
          mma_bf16(dxa[2 * np + 1], fl, r[2], r[3]);
        }
        #pragma unroll
        for (int np = 0; np < NM; ++np) {  // db_s += E^T C_t
          const int o = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * CR + 16 * np
                        + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, chs + o);
          mma_bf16(dba[2 * np], eh, r[0], r[1]);
          mma_bf16(dba[2 * np], el, r[0], r[1]);
          mma_bf16(dba[2 * np + 1], eh, r[2], r[3]);
          mma_bf16(dba[2 * np + 1], el, r[2], r[3]);
          if (c_split) {
            ldsm_x4_t(r, cls + o);
            mma_bf16(dba[2 * np], eh, r[0], r[1]);
            mma_bf16(dba[2 * np + 1], eh, r[2], r[3]);
          }
        }
      }
      // the warp's sums of M over its 16 s rows, for the slice's t: over gr
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = colm[h][c];
          #pragma unroll
          for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (gr == 0) part[warp * T + 16 * kk + 8 * h + 2 * tq + c] = v;
        }
      }
    }
    __syncthreads();  // E^T and the warps' sums of M are in place

    {  // dc and dcum for t rows 16w.. of tile i
      const int ta = t0 + 16 * warp + gr, tb = ta + 8;  // in the chunk
      float acc[2 * NM][4];
      float ci[2] = {0.f, 0.f};  // c_t . (the inter-chunk term), j = 0
      if (j == 0) {  // exp(cum_t) DY_t h_start, h_start split
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) acc[n8][0] = acc[n8][1] = acc[n8][2] = acc[n8][3] = 0.f;
        #pragma unroll
        for (int ks = 0; ks < CP; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, dys + (16 * warp + (lane & 15)) * XR + 16 * ks + (lane >> 4) * 8);
          #pragma unroll
          for (int np = 0; np < NM; ++np) {
            const int o = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * CR + 16 * np
                          + (lane >> 4) * 8;
            uint32_t r[4];
            ldsm_x4_t(r, Sh + o);
            mma_bf16(acc[2 * np], a, r[0], r[1]);
            mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
            ldsm_x4_t(r, Sl + o);
            mma_bf16(acc[2 * np], a, r[0], r[1]);
            mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
          }
        }
        const float ea = ta < L ? expf(cum[ta]) : 0.f, eb = tb < L ? expf(cum[tb]) : 0.f;
        const int ra = (16 * warp + gr) * CR, rb = ra + 8 * CR;
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) {
          acc[n8][0] *= ea; acc[n8][1] *= ea; acc[n8][2] *= eb; acc[n8][3] *= eb;
          const int n = 8 * n8 + 2 * tq;
          const float2 ha = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(chs + ra + n));
          const float2 la = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(cls + ra + n));
          const float2 hb = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(chs + rb + n));
          const float2 lb = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(cls + rb + n));
          ci[0] = fmaf(ha.x + la.x, acc[n8][0], fmaf(ha.y + la.y, acc[n8][1], ci[0]));
          ci[1] = fmaf(hb.x + lb.x, acc[n8][2], fmaf(hb.y + lb.y, acc[n8][3], ci[1]));
        }
        #pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          ci[0] += __shfl_xor_sync(0xffffffffu, ci[0], o);
          ci[1] += __shfl_xor_sync(0xffffffffu, ci[1], o);
        }
      } else {
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) {
          const float2 u = *reinterpret_cast<const float2*>(dcs + ta * NN + 8 * n8 + 2 * tq);
          const float2 v = *reinterpret_cast<const float2*>(dcs + tb * NN + 8 * n8 + 2 * tq);
          acc[n8][0] = u.x; acc[n8][1] = u.y; acc[n8][2] = v.x; acc[n8][3] = v.y;
        }
      }
      const int kend = diag ? warp + 1 : 4;  // on the diagonal, s slices at or before the rows'
      for (int ks = 0; ks < kend; ++ks) {    // dc_t += E B_s
        const int o = (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * ER + 16 * warp
                      + ((lane >> 3) & 1) * 8;
        uint32_t ah[4], al[4];
        ldsm_x4_t(ah, Eh + o);
        ldsm_x4_t(al, El + o);
        #pragma unroll
        for (int np = 0; np < NM; ++np) {
          const int ob = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * CR + 16 * np
                         + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, bhs + ob);
          mma_bf16(acc[2 * np], ah, r[0], r[1]);
          mma_bf16(acc[2 * np], al, r[0], r[1]);
          mma_bf16(acc[2 * np + 1], ah, r[2], r[3]);
          mma_bf16(acc[2 * np + 1], al, r[2], r[3]);
          if (b_split) {
            ldsm_x4_t(r, bls + ob);
            mma_bf16(acc[2 * np], ah, r[0], r[1]);
            mma_bf16(acc[2 * np + 1], ah, r[2], r[3]);
          }
        }
      }
      if (diag) {  // the t tile's last pair: dc is final
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = half ? tb : ta;
          if (t >= L) continue;
          #pragma unroll
          for (int n8 = 0; n8 < 2 * NM; ++n8) {
            #pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int n = 8 * n8 + 2 * tq + c;
              if (n < N) st(p.dc, (row0 + static_cast<long long>(t) * p.H) * N + n, p.c_dt,
                            acc[n8][2 * half + c]);
            }
          }
        }
      } else {
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) {
          *reinterpret_cast<float2*>(dcs + ta * NN + 8 * n8 + 2 * tq) =
              make_float2(acc[n8][0], acc[n8][1]);
          *reinterpret_cast<float2*>(dcs + tb * NN + 8 * n8 + 2 * tq) =
              make_float2(acc[n8][2], acc[n8][3]);
        }
      }
      if (tq == 0) {  // the rows' sums of M over this s tile, in warp order
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * warp + gr + 8 * half;
          const float v = ((part[r] + part[T + r]) + part[2 * T + r]) + part[3 * T + r];
          dcum[t0 + r] = j == 0 ? v + ci[half] : dcum[t0 + r] + v;
        }
      }
    }
    if (more) {  // the next pair's C (and the next s tile's B), split
      cv.template store<CR>(Ch + (stg ^ 1) * T * CR, Cl + (stg ^ 1) * T * CR);
      if (nj != j) bv.template store<CR>(Bh + (sp ^ 1) * T * CR, Bl + (sp ^ 1) * T * CR);
    }

    if (i == nt - 1) {  // the s tile's last pair: the injection terms, dx, db, dcum_s, q
      __syncthreads();  // dcum's t side for these rows is in place; h_start is read
      if (j == 0) {
        stage_state<PP, NN, CR>(Sh, Sl, p.dh + static_cast<long long>(chunk) * P * N, P, N);
        __syncthreads();
      }
      const float wa = sa < L ? expf(total - cum[sa]) : 0.f;
      const float wb = sb < L ? expf(total - cum[sb]) : 0.f;
      #pragma unroll
      for (int np = 0; np < CP; ++np) {  // dx_s += w_s B_s dh_end^T (dh_end split)
        float ix[2][4] = {};
        #pragma unroll
        for (int ks = 0; ks < NM; ++ks) {
          const int o = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * CR + 16 * ks
                        + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, Sh + o);
          mma_bf16(ix[0], bah[ks], r[0], r[1]);
          mma_bf16(ix[1], bah[ks], r[2], r[3]);
          if (b_split) {
            mma_bf16(ix[0], bal[ks], r[0], r[1]);
            mma_bf16(ix[1], bal[ks], r[2], r[3]);
          }
          ldsm_x4(r, Sl + o);
          mma_bf16(ix[0], bah[ks], r[0], r[1]);
          mma_bf16(ix[1], bah[ks], r[2], r[3]);
        }
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          dxa[2 * np + h][0] = fmaf(wa, ix[h][0], dxa[2 * np + h][0]);
          dxa[2 * np + h][1] = fmaf(wa, ix[h][1], dxa[2 * np + h][1]);
          dxa[2 * np + h][2] = fmaf(wb, ix[h][2], dxa[2 * np + h][2]);
          dxa[2 * np + h][3] = fmaf(wb, ix[h][3], dxa[2 * np + h][3]);
        }
      }
      float ib[2 * NM][4] = {};  // X_s dh_end (dh_end split)
      #pragma unroll
      for (int ks = 0; ks < CP; ++ks) {
        #pragma unroll
        for (int np = 0; np < NM; ++np) {
          const int o = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * CR + 16 * np
                        + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, Sh + o);
          mma_bf16(ib[2 * np], xa[ks], r[0], r[1]);
          mma_bf16(ib[2 * np + 1], xa[ks], r[2], r[3]);
          ldsm_x4_t(r, Sl + o);
          mma_bf16(ib[2 * np], xa[ks], r[0], r[1]);
          mma_bf16(ib[2 * np + 1], xa[ks], r[2], r[3]);
        }
      }
      float q[2] = {0.f, 0.f};  // b_s . (the injection term of db)
      {
        const int ra = (16 * warp + gr) * CR, rb = ra + 8 * CR;
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) {
          const int n = 8 * n8 + 2 * tq;
          const float2 ha = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(bhs + ra + n));
          const float2 la = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(bls + ra + n));
          const float2 hb = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(bhs + rb + n));
          const float2 lb = bf16x2_to_f2(*reinterpret_cast<const uint32_t*>(bls + rb + n));
          ib[n8][0] *= wa; ib[n8][1] *= wa; ib[n8][2] *= wb; ib[n8][3] *= wb;
          q[0] = fmaf(ha.x + la.x, ib[n8][0], fmaf(ha.y + la.y, ib[n8][1], q[0]));
          q[1] = fmaf(hb.x + lb.x, ib[n8][2], fmaf(hb.y + lb.y, ib[n8][3], q[1]));
        }
      }
      #pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        q[0] += __shfl_xor_sync(0xffffffffu, q[0], o);
        q[1] += __shfl_xor_sync(0xffffffffu, q[1], o);
        srow[0] += __shfl_xor_sync(0xffffffffu, srow[0], o);
        srow[1] += __shfl_xor_sync(0xffffffffu, srow[1], o);
      }
      __nv_bfloat16* const dx = static_cast<__nv_bfloat16*>(p.dx);
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = half ? sb : sa;
        if (s >= L) continue;
        const long long row = row0 + static_cast<long long>(s) * p.H;
        #pragma unroll
        for (int n8 = 0; n8 < 2 * CP; ++n8) {
          const int c = 8 * n8 + 2 * tq;
          const float v0 = dxa[n8][2 * half], v1 = dxa[n8][2 * half + 1];
          if (c + 1 < P && !(P & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(dx + row * P + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (c < P) dx[row * P + c] = __float2bfloat16(v0);
            if (c + 1 < P) dx[row * P + c + 1] = __float2bfloat16(v1);
          }
        }
        #pragma unroll
        for (int n8 = 0; n8 < 2 * NM; ++n8) {
          #pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = 8 * n8 + 2 * tq + c;
            if (n < N) st(p.db, row * N + n, p.b_dt, dba[n8][2 * half + c] + ib[n8][2 * half + c]);
          }
        }
        if (tq == 0) {
          const long long at = static_cast<long long>(chunk) * p.Q + s;
          p.dcum[at] = dcum[s] - srow[half];
          p.qs[at] = q[half];
        }
      }
    }
    if (!more) break;
    j = nj;
    i = ni;
  }
}

// ---- launches ----------------------------------------------------------------------

// The four passes, A' and C' on the tensor cores.
template <int CP, int NM>
int launch_nm(const Params& p, const int (&grid)[4], cudaStream_t stream) {
  const int rows = p.NT * T;
  int rc = launch_smem(ssd_bwd_state_tc_kernel<CP, NM>, grid[0], kTcThreads,
                       StateTcLayout<CP, NM>::cum + 4 * rows, p, stream);
  if (rc) return rc;
  ssd_bwd_carry_kernel<<<grid[1], kThreads, 0, stream>>>(p);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  rc = launch_smem(ssd_bwd_chunk_tc_kernel<CP, NM>, grid[2], kTcThreads,
                   ChunkTcLayout<CP, NM>::bytes(rows), p, stream);
  if (rc) return rc;
  ssd_bwd_da_kernel<<<grid[3], kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int CP_, int NM_>
struct Width {
  static constexpr int CP = CP_, NM = NM_;
};

// f on the instantiated widths (16 CP, 16 NM) that hold P and N, the first
// of: (1, 1) for P 16 and N 8 (the test sweep), (4, 1) for hymba's P 64 and
// N 16, (8, 2) and (8, 4) up to P 128 and N 64.  A narrower P or N is
// padded with zeros up to its width.
template <typename F>
int with_width(int P, int N, F&& f) {
  if (P <= 16 && N <= 16) return f(Width<1, 1>{});
  if (P <= 64 && N <= 16) return f(Width<4, 1>{});
  if (N <= 32) return f(Width<8, 2>{});
  return f(Width<8, 4>{});
}

}  // namespace

// Shared memory of C''s block at (P, N, Q): its widths, Q rounded up to
// whole tiles.  A call that needs more than ssd_scan_bwd_tc_max_bytes() is
// refused.
extern "C" int ssd_scan_bwd_tc_bytes(int P, int N, int Q) {
  const int rows = (Q + T - 1) / T * T;
  return with_width(P, N, [&](auto w) {
    return ChunkTcLayout<decltype(w)::CP, decltype(w)::NM>::bytes(rows);
  });
}

extern "C" int ssd_scan_bwd_tc_max_bytes() { return kMaxSmem; }

// ssm_scan_bwd.cu's ssd_scan_bwd for bf16 x and dy: C' a block per (batch,
// head, chunk).  A call with other dtypes, or whose C' needs more shared
// memory than a block has, is refused.  Returns a cudaError_t.
extern "C" int ssd_scan_bwd_tc(SSD_BWD_ARGS) {
  if (B == 0 || H == 0) return 0;
  Params p;
  const int rc = x_dt != 1 || dy_dt != 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1
                         || ssd_scan_bwd_tc_bytes(P, N, Q) > kMaxSmem
                     ? static_cast<int>(cudaErrorInvalidValue)
                     : bwd_params(p, 1, SSD_BWD_NAMES);
  if (rc) return rc;
  const int grid[4] = {grid_state, grid_carry, grid_tiles, grid_da};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(P, N, [&](auto w) {
    return launch_nm<decltype(w)::CP, decltype(w)::NM>(p, grid, s);
  });
}
