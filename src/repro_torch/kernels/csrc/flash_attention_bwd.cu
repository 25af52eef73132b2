// Flash-attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the Pallas kernel repro/kernels/flash_attention.py
// has no VJP, and the reference trains through XLA's autodiff of
// repro/kernels/ref.py::attention.  The port's ground rules keep a CUDA
// tensor off the plain version, so this is the backward the port trains
// attention with; its plain version is ref.attention_bwd, the closed form:
//   P = exp(S*scale - lse), D = rowsum(dO o O), dV = P^T dO,
//   dS = P o (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q,
// dK and dV summed over the g query heads of each KV head.  Masked pairs
// carry no logit gradient; in a row with no valid key every key weighs
// 1/Skv (the forward's uniform softmax over -1e30), so dV gets dO/Skv there.
//
// Kernels, launched in order on the caller's stream (D = rowsum(dO o O)):
//   bf16: (c) flash_bwd_dq_bf16_kernel, one block per (batch, query head,
//         128 queries), which also forms D for its rows and stores it; then
//         (b) flash_bwd_dkdv_bf16_kernel, one block per (batch, KV head, 128
//         keys), which reads it.
//   f32:  (a) flash_bwd_dsum_kernel, D in f32, one warp a row; then (b)
//         flash_bwd_dkdv_f32_kernel and (c) flash_bwd_dq_f32_kernel.
// (b) loops over the g query heads of its group and, for each, over the
// query tiles that the causal and window masks leave, in a fixed order; dK
// and dV stay in f32 registers and are stored once.  GQA needs no atomics,
// and nothing is summed in an order that changes between runs.  (c) loops
// over the key tiles the masks leave; dQ in f32 registers.  Both recompute P
// from the forward's lse (flash_attention.cu writes it beside o) rather than
// storing it, and skip tiles the masks empty with the forward's tile_range.
// No float atomics anywhere, so a gradient repeats bit for bit from run to
// run (the reduced loop's exact resume needs it).
//
// Bound on the card: operations.  At internlm2's train shape (B 2, S 4096,
// 16 query heads over 8 KV heads of 128, causal) the five products are
// ~0.34 TFLOP on ~0.2 GB.
//
// bf16 (Hopper's tensor cores through wgmma, tiles by TMA, warp-specialised;
// the pieces, shared with the forward, in hopper.cuh):
//   Each block of (b) and (c) is three warpgroups: a producer (one warp
//   issues the TMA loads, with its registers cut by setmaxnreg) and two
//   consumers (their registers raised) that run the products.  Operands sit
//   in shared memory as TMA lays them out in its 128-byte swizzle, 64-column
//   panels of 64-row boxes (head dims 120 and 96 take two panels, the pad
//   columns zero-filled by TMA and never stored); wgmma reads them through
//   matrix descriptors, K-major for S and dP, MN-major for the gradients'
//   right-hand operands.  Streamed tiles go through a ring of stages on
//   mbarriers (full: TMA's bytes landed; empty: every consumer warp is done).
//   Inside a consumer, S and dP are two commit groups, so P's exponentials
//   run while dP's products do; P and dS are packed and issued as wgmma's
//   register A operand a k-step of 16 at a time, so the next step's packing
//   runs while this one's products do.  Each goes in as a bf16 high part cut
//   from its f32 bits plus the bf16 of the remainder (two products, ~16
//   bits, as the forward's P.V keeps).
//   (b) K and V resident; each consumer owns 64 keys, the wgmma M.  Q and dO
//       tiles of 64 queries, with their lse and D, stream for every (head of
//       the group, query tile) pair, in a fixed order.  S^T = K Q^T and dP^T
//       = V dO^T (both operands in shared memory, N 64), P^T and dS^T in f32
//       registers, then dV += P^T dO and dK += dS^T Q.  dK and dV stay in
//       registers (64 + 64 a thread at head dim 128).
//   (c) Q and dO resident; each consumer owns 64 queries; K and V tiles of
//       128 keys stream ([panel][row box], so a panel's 128 rows run on for
//       the N-128 products).  S and dP (N 128), then dQ += dS K.  The
//       consumers form their rows' D first (four threads a row, a fixed
//       order; O read while the tiles land, dO from its resident tile).
//       dQ in its own kernel keeps the gradient free of atomics.
// f32: the CUDA cores, exact f32 FMAs, as the forward's f32 kernel: tiles of
// 32 queries by 32 keys, thread (ty, tx) owns queries 2ty, 2ty+1 and keys
// tx + 8j of a tile's P and dS, then keys (b) or queries (c) 2ty, 2ty+1 and
// head-dim columns tx + 8c of the gradient it accumulates.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;  // key_range, tile_range and the bf16 building blocks

struct Params {
  const void* q; const void* k; const void* v;  // strided as the forward takes them
  const void* o; const void* dO;                // contiguous (B,Sq,Hq,DV)
  const float* lse;                             // (B,Hq,Sq), the forward's
  float* dsum;                                  // (B,Hq,Sq), kernel (a)'s output
  void* dq; void* dk; void* dv;                 // contiguous, the inputs' shapes
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window, kv_offset;  // window <= 0: none
};

// The first query tile at or after qt (tiles of bq rows) whose key range
// holds key tile kt (of bk keys), or n_qt.
__device__ __forceinline__ int next_visit(const Params& p, int qt, int n_qt, int kt, int bq,
                                          int bk) {
  for (; qt < n_qt; ++qt) {
    int tb, te;
    tile_range(p, qt * bq, bq, bk, &tb, &te);
    if (kt >= tb && kt < te) break;
  }
  return qt;
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO o O) of the f32 path, one warp a (b, i, h) row, summed
// in a fixed order (the bf16 path forms it in (c)).

constexpr int kDsumThreads = 256;

__device__ __forceinline__ void dsum_store(const Params& p, long long row, float s) {
  const int h = static_cast<int>(row % p.Hq);  // row = (b * Sq + i) * Hq + h
  const long long bi = row / p.Hq;
  const int i = static_cast<int>(bi % p.Sq), b = static_cast<int>(bi / p.Sq);
  p.dsum[(static_cast<long long>(b) * p.Hq + h) * p.Sq + i] = s;
}

__global__ void __launch_bounds__(kDsumThreads) flash_bwd_dsum_kernel(const Params p, int DV) {
  const long long row = (static_cast<long long>(blockIdx.x) * kDsumThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.Sq * p.Hq) return;
  const float* o = static_cast<const float*>(p.o) + row * DV;
  const float* d = static_cast<const float*>(p.dO) + row * DV;
  float s = 0.f;
  for (int c = lane; c < DV; c += 32) s = fmaf(o[c], d[c], s);
  #pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dsum_store(p, row, s);
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores.

namespace f32 {

constexpr int kThreads = 128;
constexpr int BQ = 32;  // queries a tile
constexpr int BK = 32;  // keys a tile

// Shared memory, in floats: Q (BQ x DK+1), dO (BQ x DV+1), K (BK x DK+1),
// V (BK x DV+1), P and dS (BQ x BK+1 each), the tile's lse and D.
template <int DK, int DV> struct Smem {
  static constexpr int q = 0, dO = q + BQ * (DK + 1), k = dO + BQ * (DV + 1),
                       v = k + BK * (DK + 1), P = v + BK * (DV + 1), dS = P + BQ * (BK + 1),
                       lse = dS + BQ * (BK + 1), dsum = lse + BQ, total = dsum + BQ;
};

// Rows [r0, r0 + n) of a (rows, D) f32 operand with row stride ss into a
// shared tile of pitch D + 1, zero past `limit`.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ss, int r0,
                                          int n, int limit, int tid) {
  for (int idx = tid; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = r0 + r;
    dst[r * (D + 1) + c] = i < limit ? src[i * ss + c] : 0.f;
  }
}

// Query tile q0 of head h: Q, dO, lse and D into shared memory.
template <int DK, int DV>
__device__ __forceinline__ void load_queries(const Params& p, float* smem, int b, int h, int q0,
                                             int tid) {
  using L = Smem<DK, DV>;
  load_rows<DK>(smem + L::q, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                q0, BQ, p.Sq, tid);
  load_rows<DV>(smem + L::dO,
                static_cast<const float*>(p.dO) + static_cast<long long>(b) * p.Sq * p.Hq * DV
                    + h * DV,
                static_cast<long long>(p.Hq) * DV, q0, BQ, p.Sq, tid);
  if (tid < BQ) {
    const int i = q0 + tid;
    const long long idx = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
    smem[L::lse + tid] = i < p.Sq ? p.lse[idx] : 0.f;
    smem[L::dsum + tid] = i < p.Sq ? p.dsum[idx] : 0.f;
  }
}

// Key tile k0 of KV head kvh: K and V into shared memory.
template <int DK, int DV>
__device__ __forceinline__ void load_keys(const Params& p, float* smem, int b, int kvh, int k0,
                                          int tid) {
  using L = Smem<DK, DV>;
  load_rows<DK>(smem + L::k, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss,
                k0, BK, p.Skv, tid);
  load_rows<DV>(smem + L::v, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss,
                k0, BK, p.Skv, tid);
}

// P and dS of the staged (query tile q0, key tile k0) into shared memory,
// query-major.  Thread (ty, tx): queries 2ty + i, keys tx + 8j.
template <int DK, int DV>
__device__ __forceinline__ void tile_p_ds(const Params& p, float* smem, int q0, int k0,
                                          int tid) {
  using L = Smem<DK, DV>;
  const float* Qs = smem + L::q;
  const float* dOs = smem + L::dO;
  const float* Ks = smem + L::k;
  const float* Vs = smem + L::v;
  const int ty = tid >> 3, tx = tid & 7;
  float s[2][4], dp[2][4];
  #pragma unroll
  for (int i = 0; i < 2; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  #pragma unroll 8
  for (int d = 0; d < DK; ++d) {
    float qv[2], kv[4];
    #pragma unroll
    for (int i = 0; i < 2; ++i) qv[i] = Qs[(2 * ty + i) * (DK + 1) + d];
    #pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 8 * j) * (DK + 1) + d];
    #pragma unroll
    for (int i = 0; i < 2; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
  #pragma unroll 8
  for (int c = 0; c < DV; ++c) {
    float gv[2], vv[4];
    #pragma unroll
    for (int i = 0; i < 2; ++i) gv[i] = dOs[(2 * ty + i) * (DV + 1) + c];
    #pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 8 * j) * (DV + 1) + c];
    #pragma unroll
    for (int i = 0; i < 2; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
  }
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i, qi = q0 + r;
    int lo = 0, hi = -1;
    if (qi < p.Sq) key_range(p, qi + p.kv_offset, &lo, &hi);
    const float lse = smem[L::lse + r], dd = smem[L::dsum + r];
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j, kj = k0 + c;
      float pw = 0.f, ds = 0.f;
      if (qi < p.Sq && kj < p.Skv) {
        if (kj >= lo && kj <= hi) {
          pw = expf(s[i][j] * p.scale - lse);
          ds = pw * (dp[i][j] - dd);
        } else if (hi < lo) {
          pw = 1.f / p.Skv;  // no valid key in the row: uniform, no logit gradient
        }
      }
      smem[L::P + r * (BK + 1) + c] = pw;
      smem[L::dS + r * (BK + 1) + c] = ds;
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32_kernel(const Params p) {
  using L = Smem<DK, DV>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int b = blockIdx.x / p.Hkv, kvh = blockIdx.x % p.Hkv, g = p.Hq / p.Hkv;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  load_keys<DK, DV>(p, smem, b, kvh, k0, tid);
  float dk[2][DK / 8], dv[2][DV / 8];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    #pragma unroll
    for (int c = 0; c < DK / 8; ++c) dk[i][c] = 0.f;
    #pragma unroll
    for (int c = 0; c < DV / 8; ++c) dv[i][c] = 0.f;
  }
  for (int hi = 0; hi < g; ++hi) {
    const int h = kvh * g + hi;
    for (int qt = next_visit(p, 0, n_qt, kt, BQ, BK); qt < n_qt;
         qt = next_visit(p, qt + 1, n_qt, kt, BQ, BK)) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads are done
      load_queries<DK, DV>(p, smem, b, h, q0, tid);
      __syncthreads();
      tile_p_ds<DK, DV>(p, smem, q0, k0, tid);
      __syncthreads();
      // dV[k] += sum_q P[q][k] dO[q]; dK[k] += sum_q dS[q][k] Q[q] (keys 2ty + i)
      #pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pk[2], sk[2];
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          pk[i] = smem[L::P + qq * (BK + 1) + 2 * ty + i];
          sk[i] = smem[L::dS + qq * (BK + 1) + 2 * ty + i];
        }
        #pragma unroll
        for (int c = 0; c < DV / 8; ++c) {
          const float gv = smem[L::dO + qq * (DV + 1) + tx + 8 * c];
          #pragma unroll
          for (int i = 0; i < 2; ++i) dv[i][c] = fmaf(pk[i], gv, dv[i][c]);
        }
        #pragma unroll
        for (int c = 0; c < DK / 8; ++c) {
          const float qv = smem[L::q + qq * (DK + 1) + tx + 8 * c];
          #pragma unroll
          for (int i = 0; i < 2; ++i) dk[i][c] = fmaf(sk[i], qv, dk[i][c]);
        }
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key >= p.Skv) continue;
    const long long row = (static_cast<long long>(b) * p.Skv + key) * p.Hkv + kvh;
    float* dkr = static_cast<float*>(p.dk) + row * DK;
    float* dvr = static_cast<float*>(p.dv) + row * DV;
    #pragma unroll
    for (int c = 0; c < DK / 8; ++c) dkr[tx + 8 * c] = dk[i][c] * p.scale;
    #pragma unroll
    for (int c = 0; c < DV / 8; ++c) dvr[tx + 8 * c] = dv[i][c];
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const Params p) {
  using L = Smem<DK, DV>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / (p.Hq / p.Hkv);
  load_queries<DK, DV>(p, smem, b, h, q0, tid);
  int kt_begin, kt_end;
  tile_range(p, q0, BQ, BK, &kt_begin, &kt_end);
  float dq[2][DK / 8];
  #pragma unroll
  for (int i = 0; i < 2; ++i)
    #pragma unroll
    for (int c = 0; c < DK / 8; ++c) dq[i][c] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    load_keys<DK, DV>(p, smem, b, kvh, k0, tid);
    __syncthreads();
    tile_p_ds<DK, DV>(p, smem, q0, k0, tid);
    __syncthreads();
    // dQ[q] += sum_k dS[q][k] K[k] (queries 2ty + i)
    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sq[2];
      #pragma unroll
      for (int i = 0; i < 2; ++i) sq[i] = smem[L::dS + (2 * ty + i) * (BK + 1) + kk];
      #pragma unroll
      for (int c = 0; c < DK / 8; ++c) {
        const float kv = smem[L::k + kk * (DK + 1) + tx + 8 * c];
        #pragma unroll
        for (int i = 0; i < 2; ++i) dq[i][c] = fmaf(sq[i], kv, dq[i][c]);
      }
    }
  }
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * ty + i;
    if (row >= p.Sq) continue;
    float* dqr =
        static_cast<float*>(p.dq) + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * DK;
    #pragma unroll
    for (int c = 0; c < DK / 8; ++c) dqr[tx + 8 * c] = dq[i][c] * p.scale;
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Smem<DK, DV>::total * sizeof(float);
  int e = set_smem(flash_bwd_dkdv_f32_kernel<DK, DV>, bytes);
  if (e) return e;
  flash_bwd_dkdv_f32_kernel<DK, DV>
      <<<dim3(p.B * p.Hkv, (p.Skv + BK - 1) / BK), kThreads, bytes, stream>>>(p);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if (p.Sq == 0) return 0;  // dK and dV are zero; there is no dQ
  if ((e = set_smem(flash_bwd_dq_f32_kernel<DK, DV>, bytes))) return e;
  flash_bwd_dq_f32_kernel<DK, DV>
      <<<dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on Hopper's tensor cores: wgmma fed by TMA, warp-specialised blocks.

namespace hop {

using namespace hopper;  // the block shape, TMA, mbarriers, descriptors, wgmma
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;    // streamed tiles in the ring

// Shared memory of (b), in bytes from a 1024-aligned base: K and V (two row
// boxes of the block's 128 keys, each box NP panels), kStages stages of the
// Q and dO tiles (one row box), kStages x the tile's lse (log2 units) and D,
// then the barriers (K/V, kStages full, kStages empty).  A tile is laid out
// [row box][panel], each panel 64 rows of 128 bytes in TMA's 128-byte swizzle.
template <int DK, int DV> struct KvSmem {
  static constexpr int NPK = panels<DK>(), NPV = panels<DV>();
  static constexpr int stage = (NPK + NPV) * kBox;
  static constexpr int k = 0, v = k + 2 * NPK * kBox, ring = v + 2 * NPV * kBox,
                       rows = ring + kStages * stage, bars = rows + kStages * 2 * kRows * 4,
                       total = bars + (1 + 2 * kStages) * 8;
};
// (c): Q and dO (two row boxes of the block's 128 queries), kStages stages of
// the K and V tiles of 128 keys, laid out [panel][row box] (each panel's 128
// rows in a run, for the 128-wide products), then the barriers (Q/dO, full,
// empty).
constexpr int kKeysQ = 2 * kRows;       // keys of (c)'s streamed tile
constexpr int kPanelQ = 2 * kBox;       // bytes of one of its panels
template <int DK, int DV> struct QSmem {
  static constexpr int NPK = panels<DK>(), NPV = panels<DV>();
  static constexpr int stage = (NPK + NPV) * kPanelQ;
  static constexpr int q = 0, dO = q + 2 * NPK * kBox, ring = dO + 2 * NPV * kBox,
                       bars = ring + kStages * stage, total = bars + (1 + 2 * kStages) * 8;
};

// The four operands' TMA descriptors, kernel parameters (__grid_constant__).
struct Maps {
  CUtensorMap q, k, v, dO;
};

// (a, b) as a bf16 pair `hi` cut from their f32 bits (their upper halves)
// and the bf16 pair of what the cut left, `lo`: hi + lo carries a and b to
// ~2^-16 of their size, with one conversion a pair (rounding hi takes two).
__device__ __forceinline__ void split_cut(float a, float b, unsigned& hi, unsigned& lo) {
  const unsigned ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  lo = pack_bf16(a - __uint_as_float(ua & 0xffff0000u), b - __uint_as_float(ub & 0xffff0000u));
}

// The A operands (high and low bf16 parts) of k-step kq (16 columns) from an
// m64nN accumulator: its n-tiles 2kq and 2kq + 1.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&x)[R], int kq, unsigned (&hi)[4],
                                         unsigned (&lo)[4]) {
  const float* x0 = x + 8 * kq;
  split_cut(x0[0], x0[1], hi[0], lo[0]);
  split_cut(x0[2], x0[3], hi[1], lo[1]);
  split_cut(x0[4], x0[5], hi[2], lo[2]);
  split_cut(x0[6], x0[7], hi[3], lo[3]);
}

// A query's value from a tile's 64 (lse or D) for accumulator entry i of an
// m64n64 product whose N is the queries: a float2 load serves entries
// 4j..4j+3 (two queries, the same two for both rows).
__device__ __forceinline__ float per_query(const float* v, int i, int lane) {
  const float2 x = reinterpret_cast<const float2*>(v)[(i >> 2) * 4 + (lane & 3)];
  return i & 1 ? x.y : x.x;
}

// Store a warp's 16 rows of an m64nN accumulator times `mul` as bf16 pairs,
// the first D columns; row r of the warp goes to base + row * row_stride if
// it lies below `limit`.
template <int N, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], float mul, bf16* base,
                                           long long row_stride, int row0, int limit, int lane) {
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= limit) continue;
    bf16* out = base + row * row_stride + ((lane & 3) << 1);
    #pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (j * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// (b) dK and dV: one block a (batch, KV head, 128 keys).
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = KvSmem<DK, DV>;
  constexpr int NPK = L::NPK, NPV = L::NPV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  float* rows = reinterpret_cast<float*>(sm + L::rows);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.y, k0 = kt * 2 * kRows;
  const int b = blockIdx.x / p.Hkv, kvh = blockIdx.x % p.Hkv, g = p.Hq / p.Hkv;
  const int n_qt = (p.Sq + kRows - 1) / kRows;
  // (head of the group, query tile) in visiting order: every head visits the
  // same query tiles, those whose key range meets this block's keys.
  const int first = next_visit(p, 0, n_qt, kt, kRows, 2 * kRows);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);               // the producer warp's lanes
      mbar_init(empty + s, 4 * kConsumers);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one warp keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * (NPK + NPV) * kBox);
        for (int r = 0; r < 2; ++r) {
          for (int c = 0; c < NPK; ++c)
            tma_load(sm + L::k + (r * NPK + c) * kBox, &maps.k, kv_bar, 64 * c, kvh,
                     k0 + kRows * r, b);
          for (int c = 0; c < NPV; ++c)
            tma_load(sm + L::v + (r * NPV + c) * kBox, &maps.v, kv_bar, 64 * c, kvh,
                     k0 + kRows * r, b);
        }
      }
      int hi = first < n_qt ? 0 : g, qt = first;
      for (int it = 0; hi < g; ++it) {
        const int st = it % kStages, h = kvh * g + hi, q0 = qt * kRows;
        mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        float* r2 = rows + st * 2 * kRows;
        for (int r = lane; r < kRows; r += 32) {
          const int i = q0 + r;
          const long long idx = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
          r2[r] = i < p.Sq ? p.lse[idx] * kLog2e : __int_as_float(0x7f800000);
          r2[kRows + r] = i < p.Sq ? p.dsum[idx] : 0.f;
        }
        if (lane == 0) {
          unsigned char* stage = sm + L::ring + st * L::stage;
          mbar_expect_tx(full + st, (NPK + NPV) * kBox);
          for (int c = 0; c < NPK; ++c)
            tma_load(stage + c * kBox, &maps.q, full + st, 64 * c, h, q0, b);
          for (int c = 0; c < NPV; ++c)
            tma_load(stage + (NPK + c) * kBox, &maps.dO, full + st, 64 * c, h, q0, b);
        } else {
          mbar_arrive(full + st);
        }
        qt = next_visit(p, qt + 1, n_qt, kt, kRows, 2 * kRows);
        if (qt == n_qt) {
          ++hi;
          qt = first;
        }
      }
    }
  } else {  // consumers: warpgroup w owns keys k0 + 64w ..
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, w4 = (threadIdx.x >> 5) & 3;
    const int kw0 = k0 + kRows * w, kt_w = 2 * kt + w;
    const unsigned char* sKw = sm + L::k + w * NPK * kBox;
    const unsigned char* sVw = sm + L::v + w * NPV * kBox;
    float dk[32 * NPK], dv[32 * NPV];
    zero(dk);
    zero(dv);
    const float sl2 = p.scale * kLog2e;
    const int key_l = w4 * 16 + (lane >> 2);  // this thread's keys: key_l, key_l + 8
    mbar_wait(kv_bar, 0);
    int hi = first < n_qt ? 0 : g, qt = first;
    for (int it = 0; hi < g; ++it) {
      const int st = it % kStages, q0 = qt * kRows;
      // whether the masks leave this warpgroup any pair of the tile (every
      // pair where the tile is whole, the common case)
      const bool whole = whole_tile(p, q0, kRows, kw0, kRows);
      bool active = whole;
      if (!whole) {
        int tb, te;
        tile_range(p, q0, kRows, kRows, &tb, &te);
        active = kw0 < p.Skv && kt_w >= tb && kt_w < te;
      }
      mbar_wait(full + st, (it / kStages) & 1);
      __syncwarp();
      if (active) {
        const unsigned char* sQ = sm + L::ring + st * L::stage;
        const unsigned char* sdO = sQ + NPK * kBox;
        const float* lse2 = rows + st * 2 * kRows;
        const float* dd = lse2 + kRows;
        // [4j + e]: key key_l + 8(e>>1), query 8j + 2(lane&3) + (e&1)
        float sT[32], dpT[32];  // the first k-step overwrites
        wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < 4 * NPK; ++ks)  // S^T = K Q^T
          wgmma_ss_n64(sT, kmajor(sKw, ks), kmajor(sQ, ks), ks);
        wgmma_commit();
        #pragma unroll
        for (int ks = 0; ks < 4 * NPV; ++ks)  // dP^T = V dO^T
          wgmma_ss_n64(dpT, kmajor(sVw, ks), kmajor(sdO, ks), ks);
        wgmma_commit();
        wgmma_wait<1>();  // S^T has landed; dP^T may still be running
        reg_fence(sT);
        unsigned uniform = 0;  // bit i: entry i's query has no valid key (no logit gradient)
        if (whole) {
          #pragma unroll
          for (int i = 0; i < 32; ++i)
            sT[i] = fast_exp2(fmaf(sT[i], sl2, -per_query(lse2, i, lane)));
        } else {
          #pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int ql = (i >> 2) * 8 + ((lane & 3) << 1) + (i & 1), qi = q0 + ql;
            const int kpos = kw0 + key_l + (((i >> 1) & 1) << 3);
            float pw = 0.f;
            if (qi < p.Sq && kpos < p.Skv) {
              int lo, hi_k;
              key_range(p, qi + p.kv_offset, &lo, &hi_k);
              if (kpos >= lo && kpos <= hi_k) {
                pw = fast_exp2(fmaf(sT[i], sl2, -per_query(lse2, i, lane)));
              } else if (hi_k < lo) {
                pw = 1.f / p.Skv;  // no valid key in the row: uniform, no logit gradient
                uniform |= 1u << i;
              }
            }
            sT[i] = pw;
          }
        }
        // dV += P^T dO, P^T in two bf16 parts, a k-step of 16 queries at a
        // time: the next step's parts are packed while this one's run
        reg_fence(dv);
        #pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          unsigned a_hi[4], a_lo[4];
          acc_to_a(sT, kq, a_hi, a_lo);
          wgmma_fence();
          wgmma_rs<64 * NPV>(dv, a_hi, mnmajor(sdO, kq));
          wgmma_rs<64 * NPV>(dv, a_lo, mnmajor(sdO, kq));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed; dV's products may still be running
        reg_fence(dpT);
        reg_fence(dk);
        #pragma unroll
        for (int kq = 0; kq < 4; ++kq) {  // dS^T = P^T o (dP^T - D), then dK += dS^T Q
          #pragma unroll
          for (int i = 8 * kq; i < 8 * kq + 8; ++i)
            dpT[i] = (uniform >> i) & 1u ? 0.f : sT[i] * (dpT[i] - per_query(dd, i, lane));
          unsigned a_hi[4], a_lo[4];
          acc_to_a(dpT, kq, a_hi, a_lo);
          wgmma_fence();
          wgmma_rs<64 * NPK>(dk, a_hi, mnmajor(sQ, kq));
          wgmma_rs<64 * NPK>(dk, a_lo, mnmajor(sQ, kq));
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);  // this warp is done with the stage
      qt = next_visit(p, qt + 1, n_qt, kt, kRows, 2 * kRows);
      if (qt == n_qt) {
        ++hi;
        qt = first;
      }
    }
    const long long key_stride = static_cast<long long>(p.Hkv);
    bf16* dkb =
        static_cast<bf16*>(p.dk) + (static_cast<long long>(b) * p.Skv * p.Hkv + kvh) * DK;
    bf16* dvb =
        static_cast<bf16*>(p.dv) + (static_cast<long long>(b) * p.Skv * p.Hkv + kvh) * DV;
    store_rows<64 * NPK, DK>(dk, p.scale, dkb, key_stride * DK, kw0 + w4 * 16, p.Skv, lane);
    store_rows<64 * NPV, DV>(dv, 1.f, dvb, key_stride * DV, kw0 + w4 * 16, p.Skv, lane);
  }
}

// (c) dQ: one block a (batch, query head, 128 queries).
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = QSmem<DK, DV>;
  constexpr int NPK = L::NPK, NPV = L::NPV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / (p.Hq / p.Hkv);
  int kt_begin, kt_end;  // the key tiles of 128 that any of the block's rows visits
  tile_range(p, q0, 2 * kRows, kKeysQ, &kt_begin, &kt_end);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * (NPK + NPV) * kBox);
      for (int r = 0; r < 2; ++r) {
        for (int c = 0; c < NPK; ++c)
          tma_load(sm + L::q + (r * NPK + c) * kBox, &maps.q, q_bar, 64 * c, h, q0 + kRows * r,
                   b);
        for (int c = 0; c < NPV; ++c)
          tma_load(sm + L::dO + (r * NPV + c) * kBox, &maps.dO, q_bar, 64 * c, h,
                   q0 + kRows * r, b);
      }
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, st = it % kStages;
        mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        unsigned char* stage = sm + L::ring + st * L::stage;
        mbar_expect_tx(full + st, L::stage);
        for (int r = 0; r < 2; ++r) {
          for (int c = 0; c < NPK; ++c)
            tma_load(stage + c * kPanelQ + r * kBox, &maps.k, full + st, 64 * c, kvh,
                     kt * kKeysQ + kRows * r, b);
          for (int c = 0; c < NPV; ++c)
            tma_load(stage + (NPK + c) * kPanelQ + r * kBox, &maps.v, full + st, 64 * c, kvh,
                     kt * kKeysQ + kRows * r, b);
        }
      }
    }
  } else {  // consumers: warpgroup w owns queries q0 + 64w ..
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, w4 = (threadIdx.x >> 5) & 3;
    const int qw0 = q0 + kRows * w;
    const unsigned char* sQw = sm + L::q + w * NPK * kBox;
    const unsigned char* sdOw = sm + L::dO + w * NPV * kBox;
    int tb, te;  // this warpgroup's own key tiles
    tile_range(p, qw0, kRows, kKeysQ, &tb, &te);
    if (qw0 >= p.Sq) te = tb;  // no row of its own: it only passes the stages on
    // This thread's rows: r = 0 (row0) and r = 1 (+8).
    const int row0 = qw0 + w4 * 16 + (lane >> 2);
    float lse2[2], dd[2];
    int lo[2], hi[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      const long long idx = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
      lse2[r] = i < p.Sq ? p.lse[idx] * kLog2e : __int_as_float(0x7f800000);
      key_range(p, i + p.kv_offset, &lo[r], &hi[r]);
      if (i >= p.Sq) hi[r] = -1, lo[r] = 0;  // a row past Sq: no valid key, no gradient
    }
    float dq[32 * NPK];
    zero(dq);
    const float sl2 = p.scale * kLog2e;
    // D = rowsum(dO o O) of this thread's rows: the row's four threads take
    // its 16-byte chunks in turn and sum in a fixed order, O from device
    // memory (loaded while the block's tiles land), dO from the resident
    // tile (TMA's swizzle: chunk c of a 128-byte row r sits at c ^ (r % 8));
    // stored for (b), which runs next
    constexpr int kChunks = (DV / 8 + 3) / 4;  // a thread's chunks of a row
    uint4 oc[2][kChunks];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      const uint4* o = reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.o) + ((static_cast<long long>(b) * p.Sq + i) * p.Hq + h) * DV);
      #pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const int c = (lane & 3) + 4 * m;
        oc[r][m] = i < p.Sq && c < DV / 8 ? o[c] : make_uint4(0, 0, 0, 0);
      }
    }
    mbar_wait(q_bar, 0);
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rb = w4 * 16 + (lane >> 2) + 8 * r;  // the row within its box
      float sum = 0.f;
      #pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        const int c = (lane & 3) + 4 * m;
        if (c < DV / 8) {
          const uint4 g = *reinterpret_cast<const uint4*>(
              sdOw + (c >> 3) * kBox + rb * 128 + (((c & 7) ^ (rb & 7)) << 4));
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&oc[r][m]);
          const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&g);
          #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(x2[e]), d = __bfloat1622float2(y2[e]);
            sum = fmaf(a.x, d.x, sum);
            sum = fmaf(a.y, d.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int i = row0 + 8 * r;
      dd[r] = sum;
      if (i < p.Sq && (lane & 3) == 0)
        p.dsum[(static_cast<long long>(b) * p.Hq + h) * p.Sq + i] = sum;
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int it = kt - kt_begin, st = it % kStages, k0 = kt * kKeysQ;
      mbar_wait(full + st, (it / kStages) & 1);
      __syncwarp();
      if (kt >= tb && kt < te) {
        const unsigned char* sK = sm + L::ring + st * L::stage;
        const unsigned char* sV = sK + NPK * kPanelQ;
        // [4j + e]: row row0 + 8(e>>1), key 8j + 2(lane&3) + (e&1)
        float s[64], dp[64];  // the first k-step overwrites
        wgmma_fence();
        #pragma unroll
        for (int ks = 0; ks < 4 * NPK; ++ks)  // S = Q K^T
          wgmma_ss_n128(s, kmajor(sQw, ks), kmajor(sK, ks, kPanelQ), ks);
        wgmma_commit();
        #pragma unroll
        for (int ks = 0; ks < 4 * NPV; ++ks)  // dP = dO V^T
          wgmma_ss_n128(dp, kmajor(sdOw, ks), kmajor(sV, ks, kPanelQ), ks);
        wgmma_commit();
        wgmma_wait<1>();  // S has landed; dP may still be running
        reg_fence(s);
        if (whole_tile(p, qw0, kRows, k0, kKeysQ)) {
          #pragma unroll
          for (int i = 0; i < 64; ++i) s[i] = fast_exp2(fmaf(s[i], sl2, -lse2[(i >> 1) & 1]));
        } else {
          #pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int r = (i >> 1) & 1;
            const int kpos = k0 + (i >> 2) * 8 + ((lane & 3) << 1) + (i & 1);
            s[i] = kpos >= lo[r] && kpos <= hi[r] ? fast_exp2(fmaf(s[i], sl2, -lse2[r])) : 0.f;
          }
        }
        wgmma_wait<0>();
        reg_fence(dp);
        reg_fence(dq);
        #pragma unroll
        for (int kq = 0; kq < 8; ++kq) {  // dS = P o (dP - D), then dQ += dS K, dS in two parts
          #pragma unroll
          for (int i = 8 * kq; i < 8 * kq + 8; ++i) s[i] *= dp[i] - dd[(i >> 1) & 1];
          unsigned a_hi[4], a_lo[4];
          acc_to_a(s, kq, a_hi, a_lo);
          wgmma_fence();
          wgmma_rs<64 * NPK>(dq, a_hi, mnmajor(sK, kq, kPanelQ));
          wgmma_rs<64 * NPK>(dq, a_lo, mnmajor(sK, kq, kPanelQ));
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    bf16* dqb = static_cast<bf16*>(p.dq) + (static_cast<long long>(b) * p.Sq * p.Hq + h) * DK;
    store_rows<64 * NPK, DK>(dq, p.scale, dqb, static_cast<long long>(p.Hq) * DK,
                             qw0 + w4 * 16, p.Sq, lane);
  }
}


template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  if (p.Sq == 0) {  // no query: dK and dV are zero, and there is no dQ
    const size_t rows = static_cast<size_t>(p.B) * p.Skv * p.Hkv * 2;
    int e = static_cast<int>(cudaMemsetAsync(p.dk, 0, rows * DK, stream));
    return e ? e : static_cast<int>(cudaMemsetAsync(p.dv, 0, rows * DV, stream));
  }
  Maps m;
  const long long do_ss = static_cast<long long>(p.Hq) * DV;
  if (!make_map(&m.q, p.q, DK, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb)
      || !make_map(&m.k, p.k, DK, p.Hkv, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb)
      || !make_map(&m.v, p.v, DV, p.Hkv, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb)
      || !make_map(&m.dO, p.dO, DV, p.Hq, p.Sq, p.B, DV, do_ss, do_ss * p.Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kv_bytes = KvSmem<DK, DV>::total + 1024, q_bytes = QSmem<DK, DV>::total + 1024;
  // (c) first: it also forms D, which (b) reads
  int e = set_smem(flash_bwd_dq_bf16_kernel<DK, DV>, q_bytes);
  if (e) return e;
  flash_bwd_dq_bf16_kernel<DK, DV><<<dim3(p.B * p.Hq, (p.Sq + 2 * kRows - 1) / (2 * kRows)),
                                     kThreads, q_bytes, stream>>>(m, p);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if ((e = set_smem(flash_bwd_dkdv_bf16_kernel<DK, DV>, kv_bytes))) return e;
  flash_bwd_dkdv_bf16_kernel<DK, DV><<<dim3(p.B * p.Hkv, (p.Skv + 2 * kRows - 1) / (2 * kRows)),
                                       kThreads, kv_bytes, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

template <int DK, int DV>
int launch_d(const Params& p, int dtype, cudaStream_t s) {
  if (dtype == 0) return f32::launch<DK, DV>(p, s);
  if (dtype == 1) return hop::launch<DK, DV>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v strided as flash_attention_fwd
// takes them (bf16: 16-byte aligned bases, strides multiples of 8); o and dO
// contiguous (B,Sq,Hq,DV) and 16-byte aligned; lse and dsum f32 (B,Hq,Sq);
// dq, dk, dv contiguous in the inputs' shapes and dtype.  Launches, in order
// on `stream`, (c) then (b) in bf16 and (a), (b), (c) in f32; dsum is D,
// the f32 workspace they share.  (DK, DV) is one of (32,32), (64,64),
// (128,128), (120,120), (96,96) and (96,64), and in f32 (16,16).  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const float* lse,
    const void* dO, void* dq, void* dk, void* dv, float* dsum,
    int B, int Sq, int Skv, int Hq, int Hkv, int DK, int DV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, int kv_offset, int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Skv == 0) return 0;
  if (dtype == 1) {
    const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (long long st : strides)
      if (st % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    const void* ptrs[4] = {q, k, v, dO};
    for (const void* ptr : ptrs)
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Params p{q, k, v, o, dO, lse, dsum, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, window,
           kv_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq > 0 && dtype == 0) {
    const long long threads = static_cast<long long>(B) * Sq * Hq * 32;
    const unsigned blocks = static_cast<unsigned>((threads + kDsumThreads - 1) / kDsumThreads);
    flash_bwd_dsum_kernel<<<blocks, kDsumThreads, 0, s>>>(p, DV);
    const int e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  if (DK == DV) {
    switch (DK) {
      case 32: return launch_d<32, 32>(p, dtype, s);
      case 64: return launch_d<64, 64>(p, dtype, s);
      case 128: return launch_d<128, 128>(p, dtype, s);
      case 120: return launch_d<120, 120>(p, dtype, s);
      case 96: return launch_d<96, 96>(p, dtype, s);
      case 16:  // the reduced configs' heads, f32 only
        return dtype == 0 ? f32::launch<16, 16>(p, s) : static_cast<int>(cudaErrorInvalidValue);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (DK == 96 && DV == 64) return launch_d<96, 64>(p, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
