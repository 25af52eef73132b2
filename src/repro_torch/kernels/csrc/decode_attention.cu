// Decode attention (flash-decode, one query token per sequence) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::decode_attention.
//   q (B,Hq,D), k_cache and v_cache (B,Smax,Hkv,D), lens int32 (B,) -> o (B,Hq,D).
//   Slot s of sequence b is valid iff s < min(lens[b], Smax): validity is by
//   slot, so ring-buffer (sliding-window) caches work unchanged.  Masked
//   logits are -1e30 and the denominator is clamped at 1e-30, as in the
//   reference; a sequence with no valid slot averages V over all Smax slots,
//   as the plain version's uniform softmax does.
//
// Bound on the card: bytes.  Every valid K and V slot is read once (at B 4,
// ~1088 slots, 8 KV heads of 128 in bf16 that is ~17.8 MB a call) against
// 4*g*D flops per slot.  Design: one block of 256 threads per (batch, KV
// head), so the g query heads of a KV head share one pass over its cache;
// 64-slot tiles are loaded with all threads (coalesced along D), kept as f32
// in shared memory, and only tiles below the valid length are read.  It does
// not split the cache across blocks (split-K), so B*Hkv blocks run; that and
// overlapping the loads with the arithmetic are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BK = 64;
constexpr int kMaxAcc = 8;  // accumulators per thread: g*D <= 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

int smem_bytes(int g, int D) {
  return static_cast<int>(sizeof(float)) *
         (g * D + BK * (D + 1) + BK * D + g * BK + 3 * g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lens, T* __restrict__ o,
              int Hq, int Hkv, int Smax, float scale) {
  const int g = Hq / Hkv;
  extern __shared__ float smem[];
  float* Qs = smem;                 // g x D, pre-scaled
  float* Ks = Qs + g * D;           // BK x (D+1)
  float* Vs = Ks + BK * (D + 1);    // BK x D
  float* Ps = Vs + BK * D;          // g x BK
  float* m_s = Ps + g * BK;         // g
  float* l_s = m_s + g;             // g
  float* a_s = l_s + g;             // g: this tile's rescale

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const long long row = static_cast<long long>(Hkv) * D;  // one cache slot
  const T* kb = kc + static_cast<long long>(b) * Smax * row + kvh * D;
  const T* vb = vc + static_cast<long long>(b) * Smax * row + kvh * D;
  const T* qb = q + (static_cast<long long>(b) * Hq + kvh * g) * D;

  for (int idx = tid; idx < g * D; idx += kThreads) Qs[idx] = to_f(qb[idx]) * scale;
  for (int hh = tid; hh < g; hh += kThreads) {
    m_s[hh] = kNegInf;
    l_s[hh] = 0.f;
  }
  const int L = min(lens[b], Smax);
  // With no valid slot every slot counts (uniform softmax over -1e30).
  const int n_tiles = ((L > 0 ? L : Smax) + BK - 1) / BK;

  float acc[kMaxAcc];
  #pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Qs/m_s ready; the previous tile's reads are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, s = k0 + r;
      const bool in = s < Smax;
      Ks[r * (D + 1) + c] = in ? to_f(kb[s * row + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[s * row + c]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < g * BK; idx += kThreads) {
      const int hh = idx / BK, j = idx % BK;
      float dot = 0.f;
      #pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(Qs[hh * D + d], Ks[j * (D + 1) + d], dot);
      Ps[idx] = k0 + j < L ? dot : kNegInf;
    }
    __syncthreads();
    for (int hh = warp; hh < g; hh += kWarps) {
      float s0 = Ps[hh * BK + lane], s1 = Ps[hh * BK + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_old = m_s[hh];
      const float m_new = fmaxf(m_old, mx);
      // Slots past Smax do not exist; invalid slots weigh exp(-1e30 - m).
      const float p0 = (k0 + lane) < Smax ? expf(s0 - m_new) : 0.f;
      const float p1 = (k0 + lane + 32) < Smax ? expf(s1 - m_new) : 0.f;
      Ps[hh * BK + lane] = p0;
      Ps[hh * BK + lane + 32] = p1;
      float sum = p0 + p1;
      for (int o2 = 16; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[hh] = alpha;
        l_s[hh] = l_s[hh] * alpha + sum;
        m_s[hh] = m_new;
      }
    }
    __syncthreads();
    #pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < g * D) {
        const int hh = idx / D, d = idx % D;
        float v = acc[a] * a_s[hh];
        #pragma unroll 8
        for (int j = 0; j < BK; ++j) v = fmaf(Ps[hh * BK + j], Vs[j * D + d], v);
        acc[a] = v;
      }
    }
  }
  __syncthreads();
  T* ob = o + (static_cast<long long>(b) * Hq + kvh * g) * D;
  #pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < g * D) ob[idx] = from_f<T>(acc[a] / fmaxf(l_s[idx / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* lens, void* o,
           int B, int Hq, int Hkv, int Smax, float scale, cudaStream_t stream) {
  const int bytes = smem_bytes(Hq / Hkv, D);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<T, D><<<B * Hkv, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lens,
      static_cast<T*>(o), Hq, Hkv, Smax, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kc, const void* vc, const int* lens, void* o,
               int B, int Hq, int Hkv, int Smax, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, kc, vc, lens, o, B, Hq, Hkv, Smax, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, lens, o, B, Hq, Hkv, Smax, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, lens, o, B, Hq, Hkv, Smax, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// All tensors contiguous; lens is int32 (B,) on the device.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* lens, void* o, int B, int Hq, int Hkv,
                                    int Smax, int D, float scale, int dtype, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (Hq % Hkv != 0 || (Hq / Hkv) * D > kMaxAcc * kThreads || Smax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  if (dtype == 0) return dispatch_d<float>(q, k_cache, v_cache, ln, o, B, Hq, Hkv, Smax, D, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k_cache, v_cache, ln, o, B, Hq, Hkv, Smax, D, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
