// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
//   q (B,Sq,Hq,D), k and v (B,Skv,Hkv,D) -> o (B,Sq,Hq,D) in q's dtype.
//   Online softmax in f32; causal, sliding `window` and `kv_offset` masks;
//   masked logits are -1e30 (not -inf) and the denominator is clamped at 1e-30,
//   so a row with no valid key averages V exactly as the plain version does.
//   Query head h reads KV head h / g in place: the TPU kernel's per-group
//   copy of K and V (jnp.repeat) is never made.  The ragged Sq and Skv edges
//   are masked here rather than padded in device memory.
//
// Bound on the card: operations.  Causal prefill at B 4, S 1024, 16 heads of
// 128 does ~17 GFLOP on ~50 MB, well above the H100's ~295 flop/byte ridge.
// This first version is simple and exact: f32 FMAs on the CUDA cores (the
// f32 parity sweep holds at 3e-5, which TF32 or bf16 tensor-core products
// would not), tiles staged in shared memory as f32, and key tiles skipped
// where the causal or window mask empties them for the whole query block.
// wgmma/TMA and bf16 tensor-core products are a later change.
//
// Tiling: a block of 128 threads owns 64 query rows of one (batch, q-head);
// thread (ty, tx) = (tid / 8, tid % 8) owns rows 4*ty..4*ty+3, logit columns
// tx + 8*j of each 32-key tile, and output columns tx + 8*c.  The eight
// threads of a row sit in one eight-lane group of a warp, so row max and row
// sum are three shuffles.  Row pitches are padded by one float so the
// shared-memory reads of a warp fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window, kv_offset;  // window <= 0: none
};

// Valid keys of the query at absolute position qpos are [lo, hi] (empty if hi < lo).
__device__ __forceinline__ void key_range(const Params& p, int qpos, int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  *hi = p.causal ? min(qpos, p.Skv - 1) : p.Skv - 1;
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x (D+1), pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);    // BK x D
  float* Ps = Vs + BK * D;          // BQ x (BK+1)

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  // Heaviest (last) causal query tiles are launched first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / p.Hq, h = blockIdx.y % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = q0 + r;
    Qs[r * (D + 1) + c] = i < p.Sq ? to_f(q[i * p.q_ss + c]) * p.scale : 0.f;
  }

  // Key tiles this block must visit.  Valid-key bounds are monotone in the
  // query position, so the block's first and last valid rows give them.  If
  // any valid row has no valid key at all, every key counts (the plain
  // version's uniform softmax over -1e30), so the whole range is visited.
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  int lo0, hi0, lo1, hi1;
  key_range(p, q0 + p.kv_offset, &lo0, &hi0);
  key_range(p, last_row + p.kv_offset, &lo1, &hi1);
  int kt_begin = 0, kt_end = (p.Skv + BK - 1) / BK;
  if (hi0 >= lo0 && hi1 >= lo1) {
    kt_begin = lo0 / BK;
    kt_end = hi1 / BK + 1;
  }

  float m[4], l[4], acc[4][D / 8];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, j = k0 + r;
      const bool in = j < p.Skv;
      Ks[r * (D + 1) + c] = in ? to_f(k[j * p.k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(v[j * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
      #pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + p.kv_offset;
      float mx = kNegInf;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool valid = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                           (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = valid ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      #pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Keys past Skv do not exist; masked keys inside it weigh exp(-1e30 - m).
        const float pj = (k0 + tx + 8 * j) < p.Skv ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 8 * j] = pj;
        rs += pj;
      }
      #pragma unroll
      for (int o = 1; o < 8; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      #pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + kk];
      #pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const float vv = Vs[kk * D + tx + 8 * c];
        #pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* o = static_cast<T*>(p.o);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D;
    #pragma unroll
    for (int c = 0; c < D / 8; ++c) orow[tx + 8 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.Hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The output is contiguous (B,Sq,Hq,D).
// Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Skv, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, int kv_offset, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  Params p{q, k, v, o, B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, scale, causal, window, kv_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
