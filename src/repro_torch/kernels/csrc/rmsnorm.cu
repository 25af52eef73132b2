// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm.
//   y = x * rsqrt(mean(x^2, -1) + eps) * scale, sum of squares in f32,
//   written in x's dtype.
//
// Bound on the card: bytes.  Each row is read once for the sum of squares and
// once more for the normalise (the second read hits L1: a 2048-wide bf16 row
// is 4 KB), and written once; the arithmetic is a few f32 operations per
// element.  Design: one block of 256 threads per row, neighbouring threads on
// neighbouring elements (coalesced), a warp-shuffle tree for the sum, and no
// shared memory beyond the eight warp partials.  The feature dim stays whole
// in one block, as the TPU kernel keeps it whole in VMEM.  Scalar loads keep
// it simple; vector loads are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float block_sum(float v, float* warp_part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float t = 0.f;
  #pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += warp_part[w];
  return t;
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ y, int d, float eps) {
  __shared__ float warp_part[kThreads / 32];
  const int64_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  const float var = block_sum(ss, warp_part) / static_cast<float>(d);
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_f<TX>((to_f(xr[i]) * r) * to_f(scale[i]));
  }
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* y, int n, int d, float eps,
           cudaStream_t stream) {
  rmsnorm_kernel<TX, TS><<<n, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TX*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int n, int d,
                           float eps, int x_dtype, int s_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (x_dtype == 0 && s_dtype == 0) return launch<float, float>(x, scale, y, n, d, eps, s);
  if (x_dtype == 0 && s_dtype == 1) return launch<float, __nv_bfloat16>(x, scale, y, n, d, eps, s);
  if (x_dtype == 1 && s_dtype == 0) return launch<__nv_bfloat16, float>(x, scale, y, n, d, eps, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, n, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
