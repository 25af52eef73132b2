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
// Three kernels, launched in order on the caller's stream:
//   (a) flash_bwd_dsum_kernel: D = rowsum(dO o O) in f32, (B,Hq,Sq), one warp a row.
//   (b) flash_bwd_dkdv_*_kernel: one block per (batch, KV head, tile of keys).
//       It loops over the g query heads of its group and, for each, over the
//       query tiles that the causal and window masks leave, in a fixed order;
//       dK and dV stay in f32 registers and are stored once.  GQA needs no
//       atomics, and nothing is summed in an order that changes between runs.
//   (c) flash_bwd_dq_*_kernel: one block per (batch, query head, query tile),
//       looping over the key tiles the masks leave; dQ in f32 registers.
// Both (b) and (c) recompute P from the forward's lse (flash_attention.cu
// writes it beside o) rather than storing it, and skip tiles the masks
// empty with the forward's tile_range.  No float atomics anywhere, so a
// gradient repeats bit for bit from run to run (the reduced loop's exact
// resume needs it).
//
// Bound on the card: operations.  At internlm2's train shape (B 2, S 4096,
// 16 query heads over 8 KV heads of 128, causal) the five products are
// ~0.34 TFLOP on ~0.2 GB.
//
// bf16 (the tensor cores, mma.sync m16n8k16 with f32 accumulators, the
// forward's building blocks):
//   (b) 4 warps own 64 keys, 16 each.  K and V stay in shared memory for the
//       block; Q and dO tiles (and the tile's lse and D) are staged by
//       16-byte cp.async into a ring of two, the next tile loading while this
//       one computes.  A warp forms S^T = K Q^T and dP^T = V dO^T for its 16
//       keys, P^T and dS^T in f32 registers, then dV += P^T dO and dK +=
//       dS^T Q with P^T and dS^T reused in registers as the A operand (the
//       m16n8 accumulator layout of two adjacent query tiles is m16n8k16's A
//       layout).  Each goes in as a bf16 high part and the bf16 of its
//       remainder, two products, so it keeps ~16 bits, as the forward's P.V
//       does.  Query tiles of 32 at head dims past 96 (the accumulators of
//       dK and dV take 128 registers a thread at 128), else 64.
//   (c) 4 warps own 64 query rows, 16 each; Q and dO stay in shared memory,
//       K and V tiles of 64 keys stream through a ring of two.  S = Q K^T and
//       dP = dO V^T, then dQ += dS K with dS split into two bf16 parts.
//   Head dim 120 is padded to 128 in shared memory only (zero-filled), as in
//   the forward; the pad's output n-tile is never computed or stored.
// f32: the CUDA cores, exact f32 FMAs, as the forward's f32 kernel: tiles of
// 32 queries by 32 keys, thread (ty, tx) owns queries 2ty, 2ty+1 and keys
// tx + 8j of a tile's P and dS, then keys (b) or queries (c) 2ty, 2ty+1 and
// head-dim columns tx + 8c of the gradient it accumulates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

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

// Every (key tile, query tile) pair valid: no mask, no ragged key edge.
// Rows past Sq are zero-filled with lse +inf, so they weigh 0 either way.
__device__ __forceinline__ bool whole_tile(const Params& p, int q0, int bq, int k0, int bk) {
  const int qa_first = q0 + p.kv_offset, qa_last = min(q0 + bq, p.Sq) - 1 + p.kv_offset;
  return k0 + bk <= p.Skv && (!p.causal || k0 + bk - 1 <= qa_first) &&
         (p.window <= 0 || k0 > qa_last - p.window);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO o O), one warp a (b, i, h) row, summed in a fixed order.

constexpr int kDsumThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDsumThreads) flash_bwd_dsum_kernel(const Params p, int DV) {
  const long long row = (static_cast<long long>(blockIdx.x) * kDsumThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.Sq * p.Hq) return;
  const T* o = static_cast<const T*>(p.o) + row * DV;
  const T* d = static_cast<const T*>(p.dO) + row * DV;
  float s = 0.f;
  for (int c = lane; c < DV; c += 32) s = fmaf(to_f32(o[c]), to_f32(d[c]), s);
  #pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {  // row = (b * Sq + i) * Hq + h
    const int h = static_cast<int>(row % p.Hq);
    const long long bi = row / p.Hq;
    const int i = static_cast<int>(bi % p.Sq), b = static_cast<int>(bi / p.Sq);
    p.dsum[(static_cast<long long>(b) * p.Hq + h) * p.Sq + i] = s;
  }
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
// bf16 on the tensor cores.

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // tiles in the cp.async ring
constexpr int BK = 64;      // keys: (b)'s block, 16 a warp; (c)'s streamed tile
constexpr int BQ = 64;      // (c)'s block of query rows, 16 a warp

using bf16 = __nv_bfloat16;

// (b)'s query tile: 32 where the dK and dV accumulators are wide.
template <int DK, int DV> __host__ __device__ constexpr int bq_kv() {
  return padded<DK>() + padded<DV>() > 192 ? 32 : 64;
}

// (b): K and V tiles, then kStages stages of a Q and a dO tile (bf16), then
// kStages x the tile's lse (log2 units) and D (f32).
template <int DK, int DV> __host__ __device__ constexpr int dkdv_stage_elems() {
  return bq_kv<DK, DV>() * (pitch<DK>() + pitch<DV>());
}
template <int DK, int DV> __host__ __device__ constexpr int dkdv_smem_bytes() {
  return (BK * (pitch<DK>() + pitch<DV>()) + kStages * dkdv_stage_elems<DK, DV>()) * 2
         + 2 * kStages * bq_kv<DK, DV>() * 4;
}
// (c): Q and dO tiles, then kStages stages of a K and a V tile.
template <int DK, int DV> __host__ __device__ constexpr int dq_stage_elems() {
  return BK * (pitch<DK>() + pitch<DV>());
}
template <int DK, int DV> __host__ __device__ constexpr int dq_smem_bytes() {
  return (BQ * (pitch<DK>() + pitch<DV>()) + kStages * dq_stage_elems<DK, DV>()) * 2;
}

// The A operands (high and low parts) of one k-step of 16 from the
// accumulators of two adjacent n-tiles x0 and x1.
__device__ __forceinline__ void acc_to_a(const float (&x0)[4], const float (&x1)[4],
                                         unsigned (&hi)[4], unsigned (&lo)[4]) {
  split_bf16(x0[0], x0[1], hi[0], lo[0]);
  split_bf16(x0[2], x0[3], hi[1], lo[1]);
  split_bf16(x1[0], x1[1], hi[2], lo[2]);
  split_bf16(x1[2], x1[3], hi[3], lo[3]);
}

// ldmatrix addresses (lane's row, column) for the three operand shapes:
//   A of rows m0.. from an [m][k] tile;  B of two n-tiles from an [n][k]
//   tile (non-trans);  B of two n-tiles from a [k][n] tile (trans).
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int pitch_, int m0, int k0,
                                              int lane) {
  return t + (m0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch_ + k0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ const bf16* bn_addr(const bf16* t, int pitch_, int n0, int k0,
                                               int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch_ + k0 + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ const bf16* bk_addr(const bf16* t, int pitch_, int k0, int n0,
                                               int lane) {
  return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch_ + n0 + ((lane >> 4) << 3);
}

// acc[NT] (16 rows by NT n-tiles of 8) += A(16 x 16*KS, ldmatrix from `a`)
// . B(from `bt`, [n][k] rows: non-trans), over ks k-steps.
template <int NT, int KS>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[NT][4], const bf16* a, int pa, int m0,
                                            const bf16* bt, int pb, int lane) {
  #pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned af[4];
    ldsm_x4(af, smem_addr(a_addr(a, pa, m0, kk * 16, lane)));
    #pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, smem_addr(bn_addr(bt, pb, np * 16, kk * 16, lane)));
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[NO] (16 rows by NO n-tiles of 8, NO = D / 8, the pad's tile skipped)
// += X(16 x 16*KS, f32 accumulators x[2*KS], split hi + lo) . B(from `bt`,
// [k][n] rows: trans).
template <int NO, int KS>
__device__ __forceinline__ void mma_acc_kn(float (&acc)[NO][4], const float (&x)[2 * KS][4],
                                           const bf16* bt, int pb, int lane) {
  #pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned hi[4], lo[4];
    acc_to_a(x[2 * kk], x[2 * kk + 1], hi, lo);
    #pragma unroll
    for (int dp = 0; dp < (NO + 1) / 2; ++dp) {
      unsigned bf[4];
      ldsm_x4_trans(bf, smem_addr(bk_addr(bt, pb, kk * 16, dp * 16, lane)));
      mma_bf16(acc[2 * dp], hi, bf[0], bf[1]);
      if (2 * dp + 1 < NO) mma_bf16(acc[2 * dp + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[2 * dp], lo, bf[0], bf[1]);
      if (2 * dp + 1 < NO) mma_bf16(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
}

// Store rows of a warp's f32 accumulators (16 rows by NO n-tiles) times
// `mul` as bf16 pairs; row r of the warp goes to dst + row_off(r) if valid.
template <int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], float mul, bf16* base,
                                           long long row_stride, int row0, int limit,
                                           int lane) {
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= limit) continue;
    bf16* out = base + row * row_stride + ((lane & 3) << 1);
    #pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv_bf16_kernel(const Params p) {
  constexpr int QT = bq_kv<DK, DV>();                  // queries a tile
  constexpr int PK = pitch<DK>(), PV = pitch<DV>();
  constexpr int KSK = padded<DK>() / 16, KSV = padded<DV>() / 16;
  constexpr int NQ = QT / 8;                           // query n-tiles
  constexpr int NOK = DK / 8, NOV = DV / 8;            // output n-tiles
  constexpr int STAGE = dkdv_stage_elems<DK, DV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);        // BK x PK
  bf16* sV = sK + BK * PK;                             // BK x PV
  bf16* ring = sV + BK * PV;                           // kStages x (Q: QT x PK, dO: QT x PV)
  float* sLse = reinterpret_cast<float*>(ring + kStages * STAGE);  // kStages x QT, log2 units
  float* sD = sLse + kStages * QT;                     // kStages x QT

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.y, k0 = kt * BK;
  const int b = blockIdx.x / p.Hkv, kvh = blockIdx.x % p.Hkv, g = p.Hq / p.Hkv;
  const int n_qt = (p.Sq + QT - 1) / QT;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dob = static_cast<const bf16*>(p.dO) + static_cast<long long>(b) * p.Sq * p.Hq * DV;
  const long long do_ss = static_cast<long long>(p.Hq) * DV;

  // (head of the group, query tile) in visiting order: every head visits
  // the same query tiles, those whose key range holds this key tile.
  const int first_qt = next_visit(p, 0, n_qt, kt, QT, BK);
  auto stage_load = [&](int st, int hi, int qt) {
    const int h = kvh * g + hi, q0 = qt * QT;
    bf16* sQ = ring + st * STAGE;
    load_rows<DK, kThreads>(sQ, qb + h * p.q_sh, p.q_ss, q0, QT, p.Sq, tid);
    load_rows<DV, kThreads>(sQ + QT * PK, dob + h * DV, do_ss, q0, QT, p.Sq, tid);
    if (tid < QT) {
      const int i = q0 + tid;
      const long long idx = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
      sLse[st * QT + tid] = i < p.Sq ? p.lse[idx] * kLog2e : __int_as_float(0x7f800000);
      sD[st * QT + tid] = i < p.Sq ? p.dsum[idx] : 0.f;
    }
  };

  load_rows<DK, kThreads>(sK, static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh,
                          p.k_ss, k0, BK, p.Skv, tid);
  load_rows<DV, kThreads>(sV, static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh,
                          p.v_ss, k0, BK, p.Skv, tid);
  int h_cur = first_qt < n_qt ? 0 : g, qt_cur = first_qt;
  if (h_cur < g) stage_load(0, h_cur, qt_cur);
  cp_async_commit();

  float dk_acc[NOK][4], dv_acc[NOV][4];
  #pragma unroll
  for (int j = 0; j < NOK; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = 0.f;
  #pragma unroll
  for (int j = 0; j < NOV; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[j][e] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const int key_l = warp * 16 + (lane >> 2);  // this thread's accumulator keys: key_l, key_l + 8

  for (int it = 0; h_cur < g; ++it) {
    int h_nxt = h_cur, qt_nxt = next_visit(p, qt_cur + 1, n_qt, kt, QT, BK);
    if (qt_nxt == n_qt) {
      ++h_nxt;
      qt_nxt = first_qt;
    }
    cp_async_wait<0>();  // this tile has landed for this thread ...
    __syncthreads();      // ... and for all; the other stage's reads are done
    if (h_nxt < g) stage_load((it + 1) & 1, h_nxt, qt_nxt);
    cp_async_commit();
    const int st = it & 1, q0 = qt_cur * QT;
    const bf16* sQ = ring + st * STAGE;
    const bf16* sdO = sQ + QT * PK;
    const float* lse2 = sLse + st * QT;
    const float* dsm = sD + st * QT;

    // [query n-tile][e]: key row key_l + 8(e>>1), query 2(lane&3) + (e&1)
    float sT[NQ][4], dpT[NQ][4];
    #pragma unroll
    for (int j = 0; j < NQ; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    mma_rows_nk<NQ, KSK>(sT, sK, PK, warp * 16, sQ, PK, lane);    // S^T = K Q^T
    mma_rows_nk<NQ, KSV>(dpT, sV, PV, warp * 16, sdO, PV, lane);  // dP^T = V dO^T

    if (whole_tile(p, q0, QT, k0, BK)) {
      #pragma unroll
      for (int j = 0; j < NQ; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + ((lane & 3) << 1) + (e & 1);
          const float pw = fast_exp2(fmaf(sT[j][e], sl2, -lse2[ql]));
          sT[j][e] = pw;
          dpT[j][e] = pw * (dpT[j][e] - dsm[ql]);
        }
    } else {
      #pragma unroll
      for (int j = 0; j < NQ; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + ((lane & 3) << 1) + (e & 1), qi = q0 + ql;
          const int kpos = k0 + key_l + ((e >> 1) << 3);
          float pw = 0.f, ds = 0.f;
          if (qi < p.Sq && kpos < p.Skv) {
            int lo, hi;
            key_range(p, qi + p.kv_offset, &lo, &hi);
            if (kpos >= lo && kpos <= hi) {
              pw = fast_exp2(fmaf(sT[j][e], sl2, -lse2[ql]));
              ds = pw * (dpT[j][e] - dsm[ql]);
            } else if (hi < lo) {
              pw = 1.f / p.Skv;  // no valid key in the row: uniform, no logit gradient
            }
          }
          sT[j][e] = pw;
          dpT[j][e] = ds;
        }
    }
    mma_acc_kn<NOV, QT / 16>(dv_acc, sT, sdO, PV, lane);  // dV += P^T dO
    mma_acc_kn<NOK, QT / 16>(dk_acc, dpT, sQ, PK, lane);  // dK += dS^T Q
    h_cur = h_nxt;
    qt_cur = qt_nxt;
  }
  cp_async_wait<0>();

  const long long key_stride = static_cast<long long>(p.Hkv);
  bf16* dkb = static_cast<bf16*>(p.dk) + (static_cast<long long>(b) * p.Skv * p.Hkv + kvh) * DK;
  bf16* dvb = static_cast<bf16*>(p.dv) + (static_cast<long long>(b) * p.Skv * p.Hkv + kvh) * DV;
  store_rows<NOK>(dk_acc, p.scale, dkb, key_stride * DK, k0 + warp * 16, p.Skv, lane);
  store_rows<NOV>(dv_acc, 1.f, dvb, key_stride * DV, k0 + warp * 16, p.Skv, lane);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int PK = pitch<DK>(), PV = pitch<DV>();
  constexpr int KSK = padded<DK>() / 16, KSV = padded<DV>() / 16;
  constexpr int NK = BK / 8;    // key n-tiles
  constexpr int NOK = DK / 8;   // output n-tiles
  constexpr int STAGE = dq_stage_elems<DK, DV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x PK
  bf16* sdO = sQ + BQ * PK;                      // BQ x PV
  bf16* ring = sdO + BQ * PV;                    // kStages x (K: BK x PK, V: BK x PV)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / (p.Hq / p.Hkv);
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_rows<DK, kThreads>(sQ, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                          p.q_ss, q0, BQ, p.Sq, tid);
  load_rows<DV, kThreads>(sdO, static_cast<const bf16*>(p.dO)
                                   + static_cast<long long>(b) * p.Sq * p.Hq * DV + h * DV,
                          static_cast<long long>(p.Hq) * DV, q0, BQ, p.Sq, tid);
  int kt_begin, kt_end;
  tile_range(p, q0, BQ, BK, &kt_begin, &kt_end);
  if (kt_begin < kt_end) {
    load_rows<DK, kThreads>(ring, kp, p.k_ss, kt_begin * BK, BK, p.Skv, tid);
    load_rows<DV, kThreads>(ring + BK * PK, vp, p.v_ss, kt_begin * BK, BK, p.Skv, tid);
  }
  cp_async_commit();

  // This thread's rows: r = 0 (warp row lane/4) and r = 1 (+8).
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dd[2];
  int lo[2], hi[2];
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    const long long idx = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
    lse2[r] = i < p.Sq ? p.lse[idx] * kLog2e : __int_as_float(0x7f800000);
    dd[r] = i < p.Sq ? p.dsum[idx] : 0.f;
    key_range(p, i + p.kv_offset, &lo[r], &hi[r]);
    if (i >= p.Sq) hi[r] = -1, lo[r] = 0;  // a row past Sq: no valid key, no gradient
  }
  float dq_acc[NOK][4];
  #pragma unroll
  for (int j = 0; j < NOK; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin, k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_end) {
      bf16* nxt = ring + ((it + 1) & 1) * STAGE;
      load_rows<DK, kThreads>(nxt, kp, p.k_ss, k0 + BK, BK, p.Skv, tid);
      load_rows<DV, kThreads>(nxt + BK * PK, vp, p.v_ss, k0 + BK, BK, p.Skv, tid);
    }
    cp_async_commit();
    const bf16* sK = ring + (it & 1) * STAGE;
    const bf16* sV = sK + BK * PK;

    float s[NK][4], dp[NK][4];  // [key n-tile][e]: row row0 + 8(e>>1), key 2(lane&3) + (e&1)
    #pragma unroll
    for (int j = 0; j < NK; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_nk<NK, KSK>(s, sQ, PK, warp * 16, sK, PK, lane);    // S = Q K^T
    mma_rows_nk<NK, KSV>(dp, sdO, PV, warp * 16, sV, PV, lane);  // dP = dO V^T

    if (whole_tile(p, q0, BQ, k0, BK)) {
      #pragma unroll
      for (int j = 0; j < NK; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[j][e] = fast_exp2(fmaf(s[j][e], sl2, -lse2[r])) * (dp[j][e] - dd[r]);
        }
    } else {
      #pragma unroll
      for (int j = 0; j < NK; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, kpos = k0 + j * 8 + ((lane & 3) << 1) + (e & 1);
          s[j][e] = kpos >= lo[r] && kpos <= hi[r]
                        ? fast_exp2(fmaf(s[j][e], sl2, -lse2[r])) * (dp[j][e] - dd[r])
                        : 0.f;
        }
    }
    mma_acc_kn<NOK, BK / 16>(dq_acc, s, sK, PK, lane);  // dQ += dS K
  }
  cp_async_wait<0>();

  bf16* dqb = static_cast<bf16*>(p.dq) + (static_cast<long long>(b) * p.Sq * p.Hq + h) * DK;
  store_rows<NOK>(dq_acc, p.scale, dqb, static_cast<long long>(p.Hq) * DK, q0 + warp * 16, p.Sq,
                  lane);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kv_bytes = dkdv_smem_bytes<DK, DV>(), q_bytes = dq_smem_bytes<DK, DV>();
  int e = set_smem(flash_bwd_dkdv_bf16_kernel<DK, DV>, kv_bytes);
  if (e) return e;
  flash_bwd_dkdv_bf16_kernel<DK, DV>
      <<<dim3(p.B * p.Hkv, (p.Skv + BK - 1) / BK), kThreads, kv_bytes, stream>>>(p);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if (p.Sq == 0) return 0;  // dK and dV are zero; there is no dQ
  if ((e = set_smem(flash_bwd_dq_bf16_kernel<DK, DV>, q_bytes))) return e;
  flash_bwd_dq_bf16_kernel<DK, DV>
      <<<dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), kThreads, q_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int DK, int DV>
int launch_d(const Params& p, int dtype, cudaStream_t s) {
  if (dtype == 0) return f32::launch<DK, DV>(p, s);
  if (dtype == 1) return tc::launch<DK, DV>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v strided as flash_attention_fwd
// takes them (bf16: 16-byte aligned bases, strides multiples of 8); o and dO
// contiguous (B,Sq,Hq,DV) and 16-byte aligned; lse and dsum f32 (B,Hq,Sq);
// dq, dk, dv contiguous in the inputs' shapes and dtype.  Launches (a), (b)
// and (c) in order on `stream`.  (DK, DV) is one of (32,32), (64,64),
// (128,128), (120,120), (96,96) and (96,64).  Returns a cudaError_t.
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
  if (Sq > 0) {
    const long long threads = static_cast<long long>(B) * Sq * Hq * 32;
    const unsigned blocks = static_cast<unsigned>((threads + kDsumThreads - 1) / kDsumThreads);
    if (dtype == 0)
      flash_bwd_dsum_kernel<float><<<blocks, kDsumThreads, 0, s>>>(p, DV);
    else
      flash_bwd_dsum_kernel<__nv_bfloat16><<<blocks, kDsumThreads, 0, s>>>(p, DV);
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
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (DK == 96 && DV == 64) return launch_d<96, 64>(p, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
