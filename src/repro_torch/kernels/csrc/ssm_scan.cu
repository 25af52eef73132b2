// Chunked selective-state-space scan (Mamba-2 SSD) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py::ssd_scan_pallas.
//   x (B,S,H,P), a (B,S,H), b and c (B,S,H,N), h0 (B,H,P,N) or none
//   -> y (B,S,H,P) in x's dtype and h_final (B,H,P,N) in f32.
//   Recurrence per (batch, head): h_t = a_t h_{t-1} + x_t (x) b_t, y_t = h_t c_t,
//   evaluated in chunks of Q steps.  Within a chunk, with cum_t the running
//   sum of log a (log a clamped at 1e-37):
//     y_t  = exp(cum_t) (c_t . h_start)                          inter-chunk
//          + sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s) x_s        intra-chunk
//     h_end = h_start exp(cum_last) + sum_s x_s (x) b_s exp(cum_last - cum_s).
//
// Bound on the card: bytes.  At the serving shape (B 4, S 1536, 50 heads of
// P 64, N 16, Q 256) a call moves ~110 MB against ~7.6 GFLOP of causal work.
//
// Design.  The TPU kernel carries the state across chunks in VMEM scratch,
// which is legal there because its grid runs in order.  Hopper blocks run in
// no order, so one block of 256 threads owns one (batch, head) and loops over
// the chunks itself, with the (P, N) f32 state in shared memory.  The (Q, Q)
// gate of a chunk (256 KB at Q 256) does not fit a block's shared memory, so
// it is formed 64 x 64 at a time: a t tile of 64 rows visits the s tiles at
// or below it, each gate entry is formed only for s <= t (exp of an
// upper-triangle difference would overflow), and the tile's product with X
// accumulates in registers.  Thread (ty, tx) owns t rows 4ty..4ty+3 and the
// CP columns CP tx.. of P, so a step of the product reads one float4 of the
// (transposed) gate and CP contiguous floats of X from shared memory for
// 4 CP FMAs; the C.B products that form the gate are register-blocked the
// same way.  The last t tile of a chunk visits every s tile, so it also adds
// the chunk's injections to the next state, whose entries (CP tx + j,
// ty + 16 m) a thread keeps in registers.  The kernel is bound by latency
// (200 blocks at the serving shape, two per SM), so it is kept within 128
// registers (templated on CP and NM = ceil(N / 16), so a thread holds only
// the state entries N needs), tiles are staged through registers with every
// load issued before the first store, and a staged element's row and column
// come from shifts (the tile padded to 16 CP or 16 NM columns), not from
// divisions by the runtime P or N.  A ragged
// last chunk is simply shorter: nothing past S is read, written or added,
// which equals the TPU kernel's padding with a = 1 and zeros.  Inputs are
// read in place through their strides (no head-major copy), each in its own
// dtype (f32 or bf16), and all arithmetic is f32 FMAs on the CUDA cores, so
// the f32 sweep holds the reference's 5e-5; tensor cores and a two-pass
// chunk-parallel scan are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int T = 64;       // rows of a t tile and of an s tile
constexpr int TP = T + 4;   // row of the transposed C, B and gate tiles
constexpr int kMaxP = 128, kMaxN = 64;

struct Params {
  const void* x; const void* a; const void* b; const void* c; const void* h0;
  void* y; float* h_out;
  int S, H, P, N, Q;
  long long x_sb, x_ss, x_sh;  // element strides; the last dim is contiguous
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sh;
  long long c_sb, c_ss, c_sh;
  int x_dt, a_dt, b_dt, c_dt, h0_dt;  // 0 = float32, 1 = bfloat16; y is in x's dtype
};

__device__ __forceinline__ float ld(const void* p, long long i, int dt) {
  return dt ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

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

int smem_floats(int P, int N, int Q, int CP) {
  return T * TP + T * 16 * CP + 2 * N * TP + Q + P * (N + 1) + T;
}

// CP: P columns per thread (16 CP >= P); NM: state columns n = ty + 16 m
// per thread (16 NM >= N).  At most 128 registers, so two blocks share an SM.
template <int CP, int NM>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Params p) {
  constexpr int XP = 16 * CP;            // row of the X tile
  constexpr int KX = T * XP / kThreads;  // X-tile elements a thread stages
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int P = p.P, N = p.N, NP = N + 1, PN = P * N;
  float* Gs = smem;              // T x TP, transposed: Gs[s * TP + t]
  float* Xs = Gs + T * TP;       // T x XP
  float* Cs = Xs + T * XP;       // N x TP, transposed: Cs[n * TP + t]
  float* Bs = Cs + N * TP;       // N x TP, transposed: Bs[n * TP + s]
  float* cum = Bs + N * TP;      // Q: running log decay within the chunk
  float* hs = cum + p.Q;         // P x (N+1): the state at the chunk's start
  float* ws = hs + P * NP;       // T: exp(cum_last - cum_s) of the s tile

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bi = blockIdx.x / p.H, hi = blockIdx.x % p.H;
  const long long xo = bi * p.x_sb + hi * p.x_sh, ao = bi * p.a_sb + hi * p.a_sh;
  const long long bo = bi * p.b_sb + hi * p.b_sh, co = bi * p.c_sb + hi * p.c_sh;

  // State entry k of a thread: (q, n) of the state padded to 16 CP x 16 NM.
  constexpr int KS = CP * NM;
  const auto state_q = [](int k) { return (threadIdx.x + k * kThreads) / (16 * NM); };
  const auto state_n = [](int k) { return (threadIdx.x + k * kThreads) % (16 * NM); };
  if (p.h0) {  // the initial state, every load issued before the first store
    float v[KS];
    #pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int q = state_q(k), n = state_n(k);
      v[k] = q < P && n < N ? ld(p.h0, static_cast<long long>(blockIdx.x) * PN + q * N + n,
                                 p.h0_dt) : 0.f;
    }
    #pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int q = state_q(k), n = state_n(k);
      if (q < P && n < N) hs[q * NP + n] = v[k];
    }
  } else {
    for (int i = tid; i < P * NP; i += kThreads) hs[i] = 0.f;
  }

  for (int c0 = 0; c0 < p.S; c0 += p.Q) {
    const int L = min(p.Q, p.S - c0);
    __syncthreads();  // the previous chunk's reads of cum and its hs writes are done
    for (int t = tid; t < L; t += kThreads)
      cum[t] = logf(fmaxf(ld(p.a, ao + (c0 + t) * p.a_ss, p.a_dt), 1e-37f));
    __syncthreads();
    if (tid < 32) {   // inclusive scan of log a in place, 32 steps at a time
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int t = base + tid;
        float v = t < L ? cum[t] : 0.f;
        #pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (t < L) cum[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];
    const int n_tiles = (L + T - 1) / T;

    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * T;
      const bool last = tt == n_tiles - 1;
      stage_rows_t<NM>(Cs, p.c, co + (c0 + t0) * p.c_ss, p.c_ss, p.c_dt, min(T, L - t0), N);
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
      float hn[NM][CP];  // the next state (q = CP tx + j, n = ty + 16 m), last t tile only
      if (last) {
        const float decay = expf(cum_last);
        #pragma unroll
        for (int m = 0; m < NM; ++m) {
          #pragma unroll
          for (int j = 0; j < CP; ++j) {
            const int q = CP * tx + j, n = ty + 16 * m;
            hn[m][j] = q < P && n < N ? hs[q * NP + n] * decay : 0.f;
          }
        }
      }

      for (int s0 = 0; s0 <= t0; s0 += T) {
        const int ls = min(T, L - s0);
        __syncthreads();  // the previous s tile's reads of Bs, Xs, Gs and ws are done
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
        if (last && tid < T) ws[tid] = tid < ls ? expf(cum_last - cum[s0 + tid]) : 0.f;
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
            float g[4];
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = t0 + 4 * ty + i;
              g[i] = s <= t && t < L ? d[i][j] * expf(cum[t] - cum[s]) : 0.f;
            }
            *reinterpret_cast<float4*>(Gs + sl * TP + 4 * ty) = make_float4(g[0], g[1], g[2], g[3]);
          }
        }
        __syncthreads();

        for (int s = 0; s < ls; ++s) {
          const float4 gv = *reinterpret_cast<const float4*>(Gs + s * TP + 4 * ty);
          float xv[CP];
          load_cols<CP>(Xs + s * XP + CP * tx, xv);
          #pragma unroll
          for (int j = 0; j < CP; ++j) {
            acc[0][j] = fmaf(gv.x, xv[j], acc[0][j]); acc[1][j] = fmaf(gv.y, xv[j], acc[1][j]);
            acc[2][j] = fmaf(gv.z, xv[j], acc[2][j]); acc[3][j] = fmaf(gv.w, xv[j], acc[3][j]);
          }
          if (last) {
            const float w = ws[s];
            #pragma unroll
            for (int m = 0; m < NM; ++m) {
              if (ty + 16 * m < N) {
                const float bw = Bs[(ty + 16 * m) * TP + s] * w;
                #pragma unroll
                for (int j = 0; j < CP; ++j) hn[m][j] = fmaf(xv[j], bw, hn[m][j]);
              }
            }
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
          if (q >= P) continue;
          if (p.x_dt) static_cast<__nv_bfloat16*>(p.y)[row + q] = __float2bfloat16(acc[i][j]);
          else static_cast<float*>(p.y)[row + q] = acc[i][j];
        }
      }
      if (last) {
        __syncthreads();  // every read of the chunk-start state is done
        #pragma unroll
        for (int m = 0; m < NM; ++m) {
          #pragma unroll
          for (int j = 0; j < CP; ++j) {
            const int q = CP * tx + j, n = ty + 16 * m;
            if (q < P && n < N) hs[q * NP + n] = hn[m][j];
          }
        }
      }
    }
  }
  __syncthreads();
  #pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int q = state_q(k), n = state_n(k);
    if (q < P && n < N)
      p.h_out[static_cast<long long>(blockIdx.x) * PN + q * N + n] = hs[q * NP + n];
  }
}

template <int CP, int NM>
int launch(const Params& p, int n_blocks, cudaStream_t stream) {
  const int bytes = smem_floats(p.P, p.N, p.Q, CP) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<CP, NM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ssd_scan_kernel<CP, NM><<<n_blocks, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int launch_n(const Params& p, int n_blocks, cudaStream_t stream) {
  if (p.N <= 16) return launch<CP, 1>(p, n_blocks, stream);
  if (p.N <= 32) return launch<CP, 2>(p, n_blocks, stream);
  return launch<CP, 4>(p, n_blocks, stream);
}

}  // namespace

// y is contiguous (B,S,H,P) in x's dtype; h0 (or null) and h_out are
// contiguous (B,H,P,N), h_out in f32.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ssd_scan_fwd(
    const void* x, const void* a, const void* b, const void* c, const void* h0,
    void* y, void* h_out, int B, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sh,
    long long c_sb, long long c_ss, long long c_sh,
    int x_dt, int a_dt, int b_dt, int c_dt, int h0_dt, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, a, b, c, h0, y, static_cast<float*>(h_out), S, H, P, N, Q,
           x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
           x_dt, a_dt, b_dt, c_dt, h0_dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = B * H;
  if (P <= 16) return launch_n<1>(p, n_blocks, s);
  if (P <= 32) return launch_n<2>(p, n_blocks, s);
  if (P <= 64) return launch_n<4>(p, n_blocks, s);
  return launch_n<8>(p, n_blocks, s);
}
