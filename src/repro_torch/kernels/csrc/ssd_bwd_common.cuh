// The SSD scan backward's shared part, included by both of its sources
// (ssm_scan_bwd.cu: the CUDA cores' passes for f32 x; ssm_scan_bwd_tc.cu: the
// tensor cores' for bf16 x and dy), each built into a library of its own so
// the two compile side by side: the call's parameters, the reverse carry
// (B'), da (D'), and the entry's checks.  The design is in ssm_scan_bwd.cu's
// note.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

// Both entries' arguments, as ssm_scan_bwd.cu's entry note describes them.
#define SSD_BWD_ARGS \
    const void* x, const void* a, const void* b, const void* c, const void* dy, \
    const void* dh_final, const void* cum, const void* hs, \
    void* dx, void* da, void* db, void* dc, void* dh0, void* dh_ws, void* dcum_ws, \
    int B, int S, int H, int P, int N, int Q, \
    long long x_sb, long long x_ss, long long x_sh, \
    long long a_sb, long long a_ss, long long a_sh, \
    long long b_sb, long long b_ss, long long b_sh, \
    long long c_sb, long long c_ss, long long c_sh, \
    int x_dt, int a_dt, int b_dt, int c_dt, int dy_dt, int dhf_dt, int dh0_dt, \
    int grid_state, int grid_carry, int grid_tiles, int grid_da, void* stream
#define SSD_BWD_NAMES \
    x, a, b, c, dy, dh_final, cum, hs, dx, da, db, dc, dh0, dh_ws, dcum_ws, B, S, H, P, N, Q, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh, x_dt, a_dt, b_dt, c_dt, dy_dt, dhf_dt, dh0_dt, grid_state, grid_carry, grid_tiles, grid_da, stream

namespace {

using namespace ssd;

constexpr int kThreads = 256;
constexpr int T = 64;       // rows of a tile
constexpr int TP = T + 4;   // row of a transposed tile in shared memory
constexpr int TA = 32;      // steps pass A' stages at a time
constexpr int kMaxP = 128, kMaxN = 64;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

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
  bool x_vec, dy_vec;  // rows copied in 16-byte pieces (bf16, P and strides aligned)
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

// Rows of a tensor can be copied in 16-byte pieces: the row length, the
// strides and the pointer are all multiples of 16 bytes.
bool rows_of_16(const void* ptr, int elem_bytes, int row, long long s0, long long s1,
                long long s2) {
  const int k = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row % k == 0 && s0 % k == 0
         && s1 % k == 0 && s2 % k == 0;
}

// A call's checks (sizes, workspaces, grids: C' takes ``tiles`` blocks a
// (batch, head, chunk)) and its Params; a cudaError_t, 0 when p is set.
int bwd_params(Params& p, int tiles, SSD_BWD_ARGS) {
  (void)stream;
  const long long bh = static_cast<long long>(B) * H;
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || S < 1 || Q > S
      || bh * P * N * 16 >= (1LL << 31) || !cum || !hs || !dh_ws || !dcum_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = (S + Q - 1) / Q, NT = (Q + T - 1) / T;
  if (grid_state < bh * G || static_cast<long long>(grid_carry) * kThreads < bh * P * N
      || grid_tiles < bh * G * tiles || grid_da < bh * G)
    return static_cast<int>(cudaErrorInvalidValue);
  p = Params{x, a, b, c, dy, dh_final, static_cast<const float*>(cum),
             static_cast<const float*>(hs), dx, da, db, dc, dh0,
             static_cast<float*>(dh_ws), static_cast<float*>(dcum_ws),
             static_cast<float*>(dcum_ws) + bh * G * Q,
             B, S, H, P, N, Q, G, NT,
             x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
             x_dt, a_dt, b_dt, c_dt, dy_dt, dhf_dt, dh0_dt,
             rows_of_16(x, 2, P, x_sb, x_ss, x_sh),
             rows_of_16(dy, 2, P, static_cast<long long>(S) * H * P,
                        static_cast<long long>(H) * P, P)};
  return 0;
}

}  // namespace
