// Decode attention (split-K flash-decode, one query token per sequence) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::decode_attention.
//   q (B,Hq,DK), k_cache (B,Smax,Hkv,DK), v_cache (B,Smax,Hkv,DV), lengths
//   -> o (B,Hq,DV).  (DK, DV) is (32,32), (64,64), (128,128), (120,120),
//   (96,96) or MLA's (96,64).
//   The caches are read through their (batch, slot, head) strides, the head
//   dim contiguous, so MLA's v may stay a slice of the re-expanded latent.
//   Slot s of sequence b is valid iff s < min(len_b, Smax): validity is by
//   slot, so ring-buffer (sliding-window) caches work unchanged.  Masked
//   logits are -1e30 and the denominator is clamped at 1e-30, as in the
//   reference; a sequence with no valid slot averages V over all Smax slots,
//   as the plain version's uniform softmax does.  The lengths are one int for
//   the whole batch, or an int32 (B,) tensor on the device.
//
// Bound on the card: bytes.  Every valid K and V slot is read once (at B 4,
// 1088 slots, 8 KV heads of 128 in bf16 that is ~17.8 MB a call) against
// 4*g*D flops per slot.  The first version ran one block per (batch, KV head),
// 32 blocks on 132 SMs, with scalar loads widened into f32 shared memory and
// nothing overlapped: 0.1850 ms at that shape and 0.1628 ms on hymba's ring
// (B 4, 1024 slots, 5 KV heads of 64), about 3 % of HBM bandwidth (PERF.md,
// the kernel table's earlier times).
//
// Design: split-K.
//   - decode_split_kernel runs a grid of (B*Hkv, splits) blocks; block
//     (b*Hkv + kvh, s) walks the contiguous slots [s*chunk, (s+1)*chunk) of
//     its sequence's valid range.  The host picks `splits` so that the grid
//     fills the SMs four times over with no split shorter than ~64 slots.
//   - Each K and V row is read by LPS lanes with 16-byte loads (8 bf16 or 4
//     f32 values), lane li taking chunks li, li + LPS, ... (lane_split):
//     LPS is the largest power of two that divides both rows' 16-byte chunk
//     counts, so each lane takes one chunk of a row where DK = DV is a power
//     of two, and at MLA's (96,64) in bf16 4 lanes take 3 K chunks and 2 V
//     chunks each.  Where that would leave a lane holding more than
//     kMaxHeld floats of q and acc (a row of 120: 15 bf16 chunks, a gcd of 1;
//     a group of 4 or more at 96), LPS is instead the power of two at or
//     above the longer row's chunk count, at most 32, with each lane's
//     chunks past its row's end predicated off (their q columns and acc
//     stay zero): 16 lanes of one chunk at bf16 120, 32 at f32, the registers
//     of (128,128).  Every lane keeps its columns of the g query rows of its KV head
//     in registers, in f32 and pre-scaled by scale*log2(e); dot products
//     reduce across the lanes of a row by xor shuffles.  Each group of lanes
//     keeps (m, l, acc) for its own slots in registers, and the groups, then
//     the warps, merge them at the end.
//   - Loads in flight: each lane issues the K and V loads of U slots (4, or 2
//     when g > 4; KPL + VPL chunks a slot) before it uses any of them, so a
//     block of 4 warps has 4*32*U*32 bytes in flight (more at (96,64)) and
//     a few blocks per SM reach the ~25 KB that Little's law asks at 3.35
//     TB/s and ~1 us.  Independent loads
//     were chosen over a cp.async ring: every byte is used once, by the lane
//     that loaded it, so staging through shared memory buys nothing.
//   - The block writes its partial (m, l, acc[g, DV]) in f32 to a scratch
//     tensor; a split wholly past the valid length writes m = -1e30, l = 0,
//     acc = 0, which the combine weighs at exactly 0.
//   - decode_combine_kernel, launched by the same entry point, computes for
//     each (b, query head) o = sum_s 2^(m_s-M) acc_s / max(sum_s 2^(m_s-M) l_s, 1e-30),
//     and, when asked, writes the row's (M ln 2, denominator): its logit max
//     and sum, with which outputs over disjoint slices of a cache merge.
// The arithmetic stays f32 FMAs on the CUDA cores: at g flops per byte the
// kernel is far below the tensor-core ridge.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;  // g = Hq / Hkv; the wrapper's MAX_GROUP
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kAbsent = -__builtin_huge_valf();  // a slot outside the split: exp2 gives 0

// 16-byte row chunk -> f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Merge a running (m, l, acc) with another: the result is in max(m, m_o)'s units.
template <int NV>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[NV], float m_o, float l_o,
                                      const float (&acc_o)[NV]) {
  const float mx = fmaxf(m, m_o), a = exp2f(m - mx), a_o = exp2f(m_o - mx);
  m = mx;
  l = l * a + l_o * a_o;
  #pragma unroll
  for (int e = 0; e < NV; ++e) acc[e] = acc[e] * a + acc_o[e] * a_o;
}

// The largest power of two, at most 32, that divides both a and b.
__host__ __device__ constexpr int pow2_gcd(int a, int b) {
  int p = 1;
  while (p < 32 && a % (2 * p) == 0 && b % (2 * p) == 0) p *= 2;
  return p;
}

// The smallest power of two at or above a, at most 32.
__host__ __device__ constexpr int pow2_ceil(int a) {
  int p = 1;
  while (p < 32 && p < a) p *= 2;
  return p;
}

// Floats of q and acc a lane may hold over its group's G query rows before
// the lane split widens (kernels/decode_attention.py: MAX_HELD).
constexpr int kMaxHeld = 96;

// Lanes per slot for rows of ck K and cv V 16-byte chunks of nv elements at
// group G (kernels/decode_attention.py: lane_split mirrors it).
__host__ __device__ constexpr int lanes_per_slot(int ck, int cv, int nv, int G) {
  const int p = pow2_gcd(ck, cv);
  return G * (ck + cv) / p * nv > kMaxHeld ? pow2_ceil(ck > cv ? ck : cv) : p;
}

// Cache strides in elements; the head dim is contiguous.
struct Strides {
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

// Partials: acc (B*Hq, splits, DV) and ml (B*Hq, splits, 2), f32.
template <typename T, int DK, int DV, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ lens, int len_all, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int Hq, int Hkv, int Smax, int chunk,
                    float sl2, const Strides st) {
  constexpr int NV = Vec<T>::N;        // elements per 16-byte load
  constexpr int CK = DK / NV, CV = DV / NV;            // 16-byte chunks of a K, a V row
  constexpr int LPS = lanes_per_slot(CK, CV, NV, G);   // lanes per slot
  constexpr int KPL = (CK + LPS - 1) / LPS;  // 16-byte K chunks per lane (the last may be off)
  constexpr int VPL = (CV + LPS - 1) / LPS;  // 16-byte V chunks per lane
  constexpr int SPW = 32 / LPS;        // slots per warp per step
  constexpr int U = G <= 4 ? 4 : 2;    // steps whose loads are in flight together
  constexpr int STEP = kWarps * SPW * U;
  static_assert(CK * NV == DK && CV * NV == DV, "rows of whole 16-byte chunks");
  static_assert(LPS <= 32 && 32 % LPS == 0, "a slot's lanes share one warp");
  static_assert(KPL * LPS >= CK && VPL * LPS >= CV && KPL <= 4 && VPL <= 4,
                "each lane holds at most 4 chunks of a row");

  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G], sm_acc[kWarps][G][DV];

  const int g = Hq / Hkv, splits = gridDim.y, split = blockIdx.y;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / LPS, li = lane % LPS;

  int L = min(lens != nullptr ? lens[b] : len_all, Smax);
  const bool none = L <= 0;  // no valid slot: all Smax slots count, with equal logits
  if (none) L = Smax;
  const int s0 = split * chunk, s1 = min(s0 + chunk, L);

  // This lane's chunks c*LPS + li (c < KPL) of the group's query rows:
  // columns [(c*LPS + li)*NV, (c*LPS + li)*NV + NV); a chunk past the row
  // (kon false) stays zero, so it adds nothing to a logit.
  bool kon[KPL], von[VPL];
  #pragma unroll
  for (int c = 0; c < KPL; ++c) kon[c] = KPL * LPS == CK || c * LPS + li < CK;
  #pragma unroll
  for (int c = 0; c < VPL; ++c) von[c] = VPL * LPS == CV || c * LPS + li < CV;
  float qr[G][KPL][NV];
  #pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    #pragma unroll
    for (int c = 0; c < KPL; ++c) {
      #pragma unroll
      for (int e = 0; e < NV; ++e) qr[hh][c][e] = 0.f;
      if (hh < g && kon[c]) {
        const T* qrow =
            q + (static_cast<long long>(b) * Hq + kvh * g + hh) * DK + (c * LPS + li) * NV;
        Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(qrow)), qr[hh][c]);
        #pragma unroll
        for (int e = 0; e < NV; ++e) qr[hh][c][e] *= sl2;
      }
    }
  }
  // acc[hh][c*NV + e]: column (c*LPS + li)*NV + e of query row hh.
  float m[G], l[G], acc[G][VPL * NV];
  #pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
    #pragma unroll
    for (int e = 0; e < VPL * NV; ++e) acc[hh][e] = 0.f;
  }

  const T* kb = kc + b * st.k_sb + kvh * st.k_sh + li * NV;
  const T* vb = vc + b * st.v_sb + kvh * st.v_sh + li * NV;

  for (int base = s0; base < s1; base += STEP) {
    uint4 kr[U][KPL], vr[U][VPL];
    bool in[U];
    #pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = base + (u * kWarps + warp) * SPW + sub;
      in[u] = s < s1;
      #pragma unroll
      for (int c = 0; c < KPL; ++c) kr[u][c] = make_uint4(0, 0, 0, 0);
      #pragma unroll
      for (int c = 0; c < VPL; ++c) vr[u][c] = make_uint4(0, 0, 0, 0);
      if (in[u]) {
        #pragma unroll
        for (int c = 0; c < KPL; ++c)
          if (kon[c])
            kr[u][c] = __ldg(reinterpret_cast<const uint4*>(kb + s * st.k_ss + c * LPS * NV));
        #pragma unroll
        for (int c = 0; c < VPL; ++c)
          if (von[c])
            vr[u][c] = __ldg(reinterpret_cast<const uint4*>(vb + s * st.v_ss + c * LPS * NV));
      }
    }
    float sc[U][G];
    #pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[KPL][NV];
      #pragma unroll
      for (int c = 0; c < KPL; ++c) Vec<T>::unpack(kr[u][c], kf[c]);
      #pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float dot = 0.f;
        #pragma unroll
        for (int c = 0; c < KPL; ++c)
          #pragma unroll
          for (int e = 0; e < NV; ++e) dot = fmaf(qr[hh][c][e], kf[c][e], dot);
        #pragma unroll
        for (int o = LPS / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u][hh] = !in[u] ? kAbsent : (none ? kNegInf : dot);
      }
    }
    #pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float mx = m[hh];
      #pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][hh]);
      const float alpha = exp2f(m[hh] - mx);
      m[hh] = mx;
      l[hh] *= alpha;
      #pragma unroll
      for (int e = 0; e < VPL * NV; ++e) acc[hh][e] *= alpha;
      #pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = exp2f(sc[u][hh] - mx);
        l[hh] += pu;
        #pragma unroll
        for (int c = 0; c < VPL; ++c) {
          float vf[NV];
          Vec<T>::unpack(vr[u][c], vf);
          #pragma unroll
          for (int e = 0; e < NV; ++e)
            acc[hh][c * NV + e] = fmaf(pu, vf[e], acc[hh][c * NV + e]);
        }
      }
    }
  }

  // Merge the SPW slot groups of the warp, then the warps through shared memory.
  #pragma unroll
  for (int o = LPS; o < 32; o <<= 1) {
    #pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float acc_o[VPL * NV];
      #pragma unroll
      for (int e = 0; e < VPL * NV; ++e) acc_o[e] = __shfl_xor_sync(0xffffffffu, acc[hh][e], o);
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hh], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hh], o);
      merge(m[hh], l[hh], acc[hh], m_o, l_o, acc_o);
    }
  }
  if (sub == 0) {
    #pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      if (li == 0) {
        sm_m[warp][hh] = m[hh];
        sm_l[warp][hh] = l[hh];
      }
      #pragma unroll
      for (int c = 0; c < VPL; ++c)
        if (von[c])
          #pragma unroll
          for (int e = 0; e < NV; ++e)
            sm_acc[warp][hh][(c * LPS + li) * NV + e] = acc[hh][c * NV + e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * DV; idx += kThreads) {
    const int hh = idx / DV, d = idx % DV;
    float mx = sm_m[0][hh];
    #pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][hh]);
    float lt = 0.f, at = 0.f;
    #pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(sm_m[w][hh] - mx);
      lt += sm_l[w][hh] * a;
      at += sm_acc[w][hh][d] * a;
    }
    const long long ph = (static_cast<long long>(b) * Hq + kvh * g + hh) * splits + split;
    part_acc[ph * DV + d] = at;
    if (d == 0) {
      part_ml[2 * ph] = mx;
      part_ml[2 * ph + 1] = lt;
    }
  }
}

// Max (kMax) or sum of v over the block; blockDim.x is a multiple of 32, at most 128.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, t) : v + t;
  }
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per (b, query head), its threads DV rounded up to whole warps
// (block_reduce's shuffles take full warps: 128 at DV 120): the weighted sum
// of the splits.  The threads share out the splits' (m, l) to form M, the
// weights 2^(m_s - M) and the denominator; then thread d < DV sums column d.
// A split with l = 0 saw no slot and weighs exactly 0.  ml_out, if not
// null: (B*Hq, 2) f32, M in natural units (M ln 2) and the denominator.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml, T* __restrict__ o,
                                      float* __restrict__ ml_out, int splits, int D) {
  extern __shared__ float w_s[];  // splits
  __shared__ float red[kThreads / 32];
  const long long bh = blockIdx.x;
  const int d = threadIdx.x, nt = blockDim.x;
  const float* ml = part_ml + bh * splits * 2;
  float mx = kNegInf;
  for (int s = d; s < splits; s += nt)
    if (ml[2 * s + 1] > 0.f) mx = fmaxf(mx, ml[2 * s]);
  mx = block_reduce<true>(mx, red);
  float den = 0.f;
  for (int s = d; s < splits; s += nt) {
    const float ls = ml[2 * s + 1], w = ls > 0.f ? exp2f(ml[2 * s] - mx) : 0.f;
    w_s[s] = w;
    den = fmaf(w, ls, den);
  }
  den = block_reduce<false>(den, red);  // its barriers also publish w_s
  if (ml_out != nullptr && d == 0) {
    ml_out[2 * bh] = mx * kLn2;
    ml_out[2 * bh + 1] = den;
  }
  if (d >= D) return;
  const float* acc = part_acc + bh * splits * D + d;
  float num = 0.f;
  #pragma unroll 8
  for (int s = 0; s < splits; ++s) num = fmaf(w_s[s], acc[static_cast<long long>(s) * D], num);
  o[bh * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int DK, int DV, int G>
int launch(const void* q, const void* kc, const void* vc, const int* lens, int len_all, void* o,
           float* part, float* ml_out, int B, int Hq, int Hkv, int Smax, int splits, int chunk,
           float scale, const Strides& st, cudaStream_t stream) {
  float* part_acc = part;
  float* part_ml = part + static_cast<long long>(B) * Hq * splits * DV;
  decode_split_kernel<T, DK, DV, G><<<dim3(B * Hkv, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), lens,
      len_all, part_acc, part_ml, Hq, Hkv, Smax, chunk, scale * kLog2e, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<T><<<B * Hq, (DV + 31) / 32 * 32, splits * sizeof(float), stream>>>(
      part_acc, part_ml, static_cast<T*>(o), ml_out, splits, DV);
  return static_cast<int>(cudaGetLastError());
}

// G: the group size rounded up to 1, 2, 4 (granite's 3 too), 5 (hymba's) or 8.
template <typename T, int DK, int DV>
int dispatch_g(int g, const void* q, const void* kc, const void* vc, const int* lens,
               int len_all, void* o, float* part, float* ml_out, int B, int Hq, int Hkv,
               int Smax, int splits, int chunk, float scale, const Strides& st, cudaStream_t s) {
#define DECODE_LAUNCH(G_)                                                                 \
  launch<T, DK, DV, G_>(q, kc, vc, lens, len_all, o, part, ml_out, B, Hq, Hkv, Smax, splits, \
                        chunk, scale, st, s)
  if (g <= 1) return DECODE_LAUNCH(1);
  if (g <= 2) return DECODE_LAUNCH(2);
  if (g <= 4) return DECODE_LAUNCH(4);
  if (g <= 5) return DECODE_LAUNCH(5);
  return DECODE_LAUNCH(8);
#undef DECODE_LAUNCH
}

// (DK, DV): (32,32), (64,64), (128,128), (120,120), (96,96) or MLA's (96,64),
// and in f32 only (16,16): the reduced configs' heads.
template <typename T>
int dispatch_d(int DK, int DV, int g, const void* q, const void* kc, const void* vc,
               const int* lens, int len_all, void* o, float* part, float* ml_out, int B,
               int Hq, int Hkv, int Smax, int splits, int chunk, float scale, const Strides& st,
               cudaStream_t s) {
#define DECODE_DISPATCH(DK_, DV_)                                                       \
  dispatch_g<T, DK_, DV_>(g, q, kc, vc, lens, len_all, o, part, ml_out, B, Hq, Hkv, Smax, \
                          splits, chunk, scale, st, s)
  if (DK == 32 && DV == 32) return DECODE_DISPATCH(32, 32);
  if (DK == 64 && DV == 64) return DECODE_DISPATCH(64, 64);
  if (DK == 128 && DV == 128) return DECODE_DISPATCH(128, 128);
  if (DK == 120 && DV == 120) return DECODE_DISPATCH(120, 120);
  if (DK == 96 && DV == 96) return DECODE_DISPATCH(96, 96);
  if (DK == 96 && DV == 64) return DECODE_DISPATCH(96, 64);
  if constexpr (sizeof(T) == 4) {
    if (DK == 16 && DV == 16) return DECODE_DISPATCH(16, 16);
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef DECODE_DISPATCH
}

}  // namespace

// q (B,Hq,DK) and o (B,Hq,DV) contiguous; the caches read through their
// (batch, slot, head) element strides, the head dim contiguous.  Every base
// is 16-byte aligned and every cache stride a multiple of 16 bytes.  lens:
// int32 (B,) on the device, or null, and then every sequence has len_all
// valid slots.  part: f32 scratch of B*Hq*splits*(DV+2) elements.  ml: null,
// or f32 (B, Hq, 2) that takes each row's logit max (natural units) and sum
// (the combine's M ln 2 and denominator).  Split s
// covers slots [s*chunk, (s+1)*chunk).  dtype: 0 = float32, 1 = bfloat16.
// Launches the split and combine kernels; returns a cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* lens, int len_all, void* o, void* part,
                                    void* ml, int B,
                                    int Hq, int Hkv, int Smax, int DK, int DV, int splits,
                                    int chunk, long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, float scale,
                                    int dtype, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || Smax <= 0 || splits <= 0 || splits > 8192 ||
      chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, k_cache, v_cache};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int nv = dtype == 1 ? 8 : 4;  // elements per 16 bytes
  const Strides st{k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const long long strides[6] = {k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  for (long long x : strides)
    if (x % nv != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* pt = static_cast<float*>(part);
  float* mo = static_cast<float*>(ml);
  const int g = Hq / Hkv;
  if (dtype == 0)
    return dispatch_d<float>(DK, DV, g, q, k_cache, v_cache, ln, len_all, o, pt, mo, B, Hq,
                             Hkv, Smax, splits, chunk, scale, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(DK, DV, g, q, k_cache, v_cache, ln, len_all, o, pt, mo, B,
                                     Hq, Hkv, Smax, splits, chunk, scale, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
