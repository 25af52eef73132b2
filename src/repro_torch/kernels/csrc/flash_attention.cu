// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
//   q and k (B,Sq|Skv,Hq|Hkv,DK), v (B,Skv,Hkv,DV) -> o (B,Sq,Hq,DV) in q's dtype.
//   The K head dim and the V head dim are separate template parameters:
//   (32,32), (64,64), (128,128), (120,120) (h2o-danube3) and (96,96)
//   (phi3-vision) for the GQA models, and MLA's (96,64) (minicpm3: q and k of
//   qk_nope 64 + qk_rope 32, v of 64).  Q.K^T runs over DK, P.V over DV.
//   Online softmax in f32; causal, sliding `window` and `kv_offset` masks;
//   masked logits are -1e30 (not -inf) and the denominator is clamped at 1e-30,
//   so a row with no valid key averages V exactly as the plain version does.
//   Query head h reads KV head h / g in place: the TPU kernel's per-group
//   copy of K and V (jnp.repeat) is never made.  The ragged Sq and Skv edges
//   are masked here rather than padded in device memory, and q, k and v are
//   read through their (batch, seq, head) strides, so v may be a slice of a
//   fused qkv projection.
//   With `lse` non-null, each row's log-sum-exp of its scaled, masked logits
//   is also written, f32 (B,Hq,Sq), in natural-log units: m*scale + ln(l),
//   -1e30 for a row with no valid key (the plain ref.attention_lse).  The
//   backward (flash_attention_bwd.cu) recomputes P from it.  It is stored
//   after o and touches nothing o is computed from, so o is the same to the
//   bit with and without it.
//
// Bound on the card: operations.  Causal prefill at B 4, S 1024, 16 heads of
// 128 does ~17 GFLOP on ~50 MB, well above the H100's ~295 flop/byte ridge.
// The first version did f32 FMAs on the CUDA cores (0.9458 ms at that
// shape, 16.7x SDPA); the second (PR 13) ran on Ampere's mma.sync m16n8k16
// with ldmatrix and a cp.async ring, bound by mma.sync's rate, about half
// of wgmma's (0.1154 ms, 99.23 device us, 2.1x SDPA; 298.4 ms at internlm2's
// prefill_32k, 3.35x SDPA; PERF.md's kernel table).
//
// bf16 design (Hopper's tensor cores through wgmma, tiles by TMA, warp-specialised):
//   - A block owns 128 query rows of one (batch, query head): one producer
//     warpgroup, its registers cut by setmaxnreg, beside two consumer
//     warpgroups of 64 rows each (wgmma's M), their registers raised.
//   - The producer's one thread TMA-loads Q once, then streams K and V tiles
//     of BK keys (key_tile: 128, or 64 where v takes two panels) through two
//     rings of kStages stages, one for K and one for V, K a tile ahead of V,
//     each on full (TMA's bytes landed) and empty (every consumer warp done)
//     mbarriers.  Tiles sit as TMA lays them out in the
//     128-byte swizzle, 64-column panels; head dims 120 and 96 take two
//     panels, TMA zero-filling the pad columns and the rows past Sq and Skv.
//     It loads only the key tiles the block's masks leave (tile_range).
//   - S = Q.K^T: wgmma, both operands in shared memory, K-major, N = BK,
//     over ceil(DK / 16) k-steps (6 at 96: the pad panel's zero half is
//     skipped).  A negative scale flips Q's signs in shared memory once.
//     The scale, with log2(e) folded in, is applied to S in f32 by the
//     FFMA that forms each exp2 argument, s*|scale|*log2e - m*|scale|*log2e;
//     the online softmax runs in registers, its row max and sum reduced over
//     a quad, l summed from the f32 p.  Only tiles that cross a mask edge or
//     Skv evaluate the mask per element.
//   - O += P.V: P is packed a k-step of 16 keys at a time as wgmma's register
//     A operand, a bf16 high part and the bf16 of its remainder (two
//     products, ~16 bits, as ref._split_bf16 defines them: P rounded once to
//     bf16 missed internlm2's 2e-2 gate); V is read MN-major from shared
//     memory at N = 64 x its panels, and DV columns are stored.
//   - Overlap: each tile's S and the previous tile's P.V are two commit
//     groups; wgmma_wait<1> lets this tile's softmax run while the tensor
//     cores do the previous tile's P.V (the split P's 64 packed registers
//     in flight, S and O fill the consumers' 240).  Its K stage is freed as
//     soon as S lands, its V stage once its P.V has.  The two consumers
//     take turns at issuing their products (named barriers), a tile a
//     turn, so one's softmax also runs under the other's products.
//   - Heaviest causal query tiles launch first; a consumer warpgroup whose
//     rows need fewer key tiles than the block's passes the rest on.
// The f32 instantiation keeps the first version's exact CUDA-core kernel: the f32 parity
// sweep holds at 3e-5, which TF32 or bf16 products would not.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;  // key_range, tile_range and the bf16 building blocks

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q; const void* k; const void* v; void* o;
  float* lse;  // (B,Hq,Sq) or null
  int B, Sq, Skv, Hq, Hkv;
  long long q_sb, q_ss, q_sh;  // element strides; the head dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal, window, kv_offset;  // window <= 0: none
};

__device__ __forceinline__ bool key_valid(const Params& p, int kpos, int qpos) {
  return (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// f32: the first version's exact kernel on the CUDA cores.  A block of 128 threads owns 64
// query rows; thread (ty, tx) = (tid / 8, tid % 8) owns rows 4*ty..4*ty+3,
// logit columns tx + 8*j of each 32-key tile, and output columns tx + 8*c.

namespace f32 {

constexpr int kThreads = 128;
constexpr int BQ = 64;
constexpr int BK = 32;

template <int DK, int DV>
constexpr int smem_floats() {
  return BQ * (DK + 1) + BK * (DK + 1) + BK * DV + BQ * (BK + 1);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x (DK+1), pre-scaled
  float* Ks = Qs + BQ * (DK + 1);   // BK x (DK+1)
  float* Vs = Ks + BK * (DK + 1);   // BK x DV
  float* Ps = Vs + BK * DV;         // BQ x (BK+1)

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int idx = tid; idx < BQ * DK; idx += kThreads) {
    const int r = idx / DK, c = idx % DK, i = q0 + r;
    Qs[r * (DK + 1) + c] = i < p.Sq ? q[i * p.q_ss + c] * p.scale : 0.f;
  }
  int kt_begin, kt_end;
  tile_range(p, q0, BQ, BK, &kt_begin, &kt_end);

  float m[4], l[4], acc[4][DV / 8];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < DV / 8; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    // One pass for K and V rows of one width, two where they differ.  On an
    // H100 (launch/ab_flash.py) two passes took 2-12 % longer at DK == DV,
    // and one pass over the wider row with the narrower one's columns
    // tested took 53 % longer at (96, 64).
    if constexpr (DK == DV) {
      for (int idx = tid; idx < BK * DK; idx += kThreads) {
        const int r = idx / DK, c = idx % DK, j = k0 + r;
        const bool in = j < p.Skv;
        Ks[r * (DK + 1) + c] = in ? k[j * p.k_ss + c] : 0.f;
        Vs[r * DV + c] = in ? v[j * p.v_ss + c] : 0.f;
      }
    } else {
      for (int idx = tid; idx < BK * DK; idx += kThreads) {
        const int r = idx / DK, c = idx % DK, j = k0 + r;
        Ks[r * (DK + 1) + c] = j < p.Skv ? k[j * p.k_ss + c] : 0.f;
      }
      for (int idx = tid; idx < BK * DV; idx += kThreads) {
        const int r = idx / DV, c = idx % DV, j = k0 + r;
        Vs[r * DV + c] = j < p.Skv ? v[j * p.v_ss + c] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    #pragma unroll 8
    for (int d = 0; d < DK; ++d) {
      float qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (DK + 1) + d];
      #pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 8 * j) * (DK + 1) + d];
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
        s[i][j] = kpos < p.Skv && key_valid(p, kpos, qpos) ? s[i][j] : kNegInf;
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
      for (int c = 0; c < DV / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + kk];
      #pragma unroll
      for (int c = 0; c < DV / 8; ++c) {
        const float vv = Vs[kk * DV + tx + 8 * c];
        #pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * DV;
    #pragma unroll
    for (int c = 0; c < DV / 8; ++c) orow[tx + 8 * c] = acc[i][c] / denom;
    // m is in scaled units here (Q was pre-scaled); a row with no valid key
    // has m = -1e30, which absorbs ln(l)
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] = m[i] + logf(denom);
  }
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DK, DV>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(p.B * p.Hq, (p.Sq + BQ - 1) / BQ);
  flash_fwd_f32_kernel<DK, DV><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on Hopper's tensor cores: wgmma fed by TMA, warp-specialised blocks.

namespace hop {

using namespace hopper;  // the block shape, TMA, mbarriers, descriptors, wgmma
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;                   // K tiles in their ring, V tiles in theirs
constexpr int kBlockQ = kConsumers * kRows;  // query rows a block: 64 a consumer
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kAbsent = -__builtin_huge_valf();  // a key past Skv: exp2 gives 0
// A masked logit, in unscaled units.  A power of two, so that its product with
// the scale is exact and a row whose keys are all masked gets exp2(0) = 1 for
// every key: the plain version's uniform softmax over -1e30.  With any valid
// key in the row its weight is exp2(-huge) = 0, as exp(-1e30 - m) is in f32.
constexpr float kMaskRaw = -0x1p100f;

// Keys of a streamed K or V tile, S's N.  A consumer thread holds S (BK / 2
// floats), P's two bf16 parts (BK / 2 registers) and O (32 x V's panels),
// while S and P.V are in flight: 192 of its 240 registers at BK 128 and two
// panels of V, which spilled (668 B) and ran 14-23 % slower than BK 64 on
// an H100 (PERF.md, PR 32).  kernels/flash_attention.py::key_tile mirrors it.
template <int DK, int DV> __host__ __device__ constexpr int key_tile() {
  return panels<DV>() > 1 ? 64 : 128;
}

// Shared memory, in bytes from a 1024-aligned base: Q (the block's two row
// boxes, each [panel]), kStages K tiles and kStages V tiles (each [panel],
// a panel BK rows of 128 bytes, so a panel's rows run on for N = BK), then
// the barriers (Q, K full and empty, V full and empty).  A launch asks for
// 1024 bytes more, to align the base.
template <int DK, int DV> struct Smem {
  static constexpr int NPK = panels<DK>(), NPV = panels<DV>(), BK = key_tile<DK, DV>();
  static constexpr int panel = BK * 128;
  static constexpr int q = 0, k = q + kConsumers * NPK * kBox, v = k + kStages * NPK * panel,
                       bars = v + kStages * NPV * panel, total = bars + (1 + 4 * kStages) * 8,
                       launch = total + 1024;
};

// The operands' TMA descriptors, kernel parameters (__grid_constant__).
struct Maps {
  CUtensorMap q, k, v;
};

// The ring's stage and phase parity of key tile kt (kt_begin the block's first).
struct Slot {
  int st, par;
  __device__ __forceinline__ Slot(int kt, int kt_begin)
      : st((kt - kt_begin) % kStages), par(((kt - kt_begin) / kStages) & 1) {}
};

// The consumers' turns: named barrier 3 + w is consumer w's, which its 128
// threads wait on and the other consumer's 128 arrive at (256 in all).
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - w) : "memory");
}

// This warp is done with a stage: its lane 0 arrives on the empty barrier,
// by a predicated instruction rather than a branch (ptxas serialises the
// wgmma in flight across a divergent path).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_addr(empty)), "r"(lane) : "memory");
}

// S = Q K^T for one tile, both operands K-major in shared memory; one
// commit group.
template <int BK, int KS>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], const unsigned char* sQ,
                                        const unsigned char* sK) {
  const uint64_t a = kmajor(sQ, 0), b = kmajor(sK, 0, BK * 128);
  wgmma_fence();
  #pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_ss<BK>(s, a + kmajor_step(ks), b + kmajor_step(ks, BK * 128), ks);
  wgmma_commit();
}

// The online softmax of one tile of S (keys k0 ..) over this thread's two
// rows: masks, the rows' new max m (unscaled) and sum l, S turned into P in
// f32, and each row's rescale alpha of what was summed before.  qw0 is the
// warpgroup's first row; qpos the rows' absolute positions.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Params& p, int qw0,
                                             int k0, const int (&qpos)[2], int lane,
                                             float sl2) {
  if (!whole_tile(p, qw0, kRows, k0, BK)) {  // mask only tiles that cross an edge or Skv
    #pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + (i >> 2) * 8 + ((lane & 3) << 1) + (i & 1);
      // Keys past Skv do not exist (weight 0).
      s[i] = kpos >= p.Skv ? kAbsent : (key_valid(p, kpos, qpos[(i >> 1) & 1]) ? s[i] : kMaskRaw);
    }
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) {  // over the quad's BK columns of each row
    float mx = m[r];
    #pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = fast_exp2((m[r] - mx) * sl2);
    const float mx_s = mx * sl2;
    m[r] = mx;
    float rs = 0.f;
    #pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = fast_exp2(fmaf(s[4 * j + 2 * r], sl2, -mx_s));
      const float p1 = fast_exp2(fmaf(s[4 * j + 2 * r + 1], sl2, -mx_s));
      s[4 * j + 2 * r] = p0;
      s[4 * j + 2 * r + 1] = p1;
      rs += p0 + p1;
    }
    l[r] = l[r] * alpha[r] + rs;  // this thread's partial row sum, from the f32 p
  }
}

// P as the next P.V's A operand: a bf16 high part and the bf16 of its
// remainder a k-step of 16 keys (entries 8kq .. 8kq + 7: n-tiles 2kq, 2kq + 1).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], unsigned (&ph)[BK / 16][4],
                                       unsigned (&pl)[BK / 16][4]) {
  #pragma unroll
  for (int kq = 0; kq < BK / 16; ++kq) {
    const float* x = s + 8 * kq;
    split_bf16(x[0], x[1], ph[kq][0], pl[kq][0]);
    split_bf16(x[2], x[3], ph[kq][1], pl[kq][1]);
    split_bf16(x[4], x[5], ph[kq][2], pl[kq][2]);
    split_bf16(x[6], x[7], ph[kq][3], pl[kq][3]);
  }
}

// O += P V for one tile, P from its high and low bf16 parts in registers, V
// MN-major from its stage; one commit group.
template <int NV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[NV / 2], const unsigned (&ph)[BK / 16][4],
                                         const unsigned (&pl)[BK / 16][4],
                                         const unsigned char* sV) {
  const uint64_t b = mnmajor(sV, 0, BK * 128);
  wgmma_fence();
  #pragma unroll
  for (int kq = 0; kq < BK / 16; ++kq) {
    wgmma_rs<NV>(o, ph[kq], b + mnmajor_step(kq));
    wgmma_rs<NV>(o, pl[kq], b + mnmajor_step(kq));
  }
  wgmma_commit();
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Smem<DK, DV>;
  constexpr int NPK = L::NPK, NPV = L::NPV, BK = L::BK, PANEL = L::panel;
  constexpr int KS = (DK + 15) / 16;  // Q.K^T's k-steps; past DK only zero pad
  constexpr int NV = 64 * NPV;        // P.V's N; DV columns are stored
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full_k = q_bar + 1;
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / (p.Hq / p.Hkv);
  int kt_begin, kt_end;  // the key tiles any of the block's rows visits
  tile_range(p, q0, kBlockQ, BK, &kt_begin, &kt_end);
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 4 * kConsumers);  // each consumer warp
      mbar_init(empty_v + s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, kConsumers * NPK * kBox);
      for (int r = 0; r < kConsumers; ++r)
        for (int c = 0; c < NPK; ++c)
          tma_load(sm + L::q + (r * NPK + c) * kBox, &maps.q, q_bar, 64 * c, h, q0 + kRows * r,
                   b);
      // K runs a tile ahead of V, as the consumers take them: tile kt's S
      // with tile kt - 1's P.V.
      for (int kt = kt_begin; kt <= kt_end; ++kt) {
        if (kt < kt_end) {
          const Slot sl(kt, kt_begin);
          mbar_wait(empty_k + sl.st, sl.par ^ 1);
          mbar_expect_tx(full_k + sl.st, NPK * PANEL);
          for (int c = 0; c < NPK; ++c)
            for (int r = 0; r < BK / kRows; ++r)
              tma_load(sm + L::k + (sl.st * NPK + c) * PANEL + r * kBox, &maps.k, full_k + sl.st,
                       64 * c, kvh, kt * BK + kRows * r, b);
        }
        if (kt > kt_begin) {
          const Slot sl(kt - 1, kt_begin);
          mbar_wait(empty_v + sl.st, sl.par ^ 1);
          mbar_expect_tx(full_v + sl.st, NPV * PANEL);
          for (int c = 0; c < NPV; ++c)
            for (int r = 0; r < BK / kRows; ++r)
              tma_load(sm + L::v + (sl.st * NPV + c) * PANEL + r * kBox, &maps.v, full_v + sl.st,
                       64 * c, kvh, (kt - 1) * BK + kRows * r, b);
        }
      }
    }
  } else {  // consumers: warpgroup w owns queries q0 + 64w ..
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1, w4 = (threadIdx.x >> 5) & 3;
    const int qw0 = q0 + kRows * w;
    unsigned char* sQw = sm + L::q + w * NPK * kBox;
    int tb = kt_end, te = kt_end;  // this warpgroup's own key tiles (none without a row)
    if (qw0 < p.Sq) {
      tile_range(p, qw0, kRows, BK, &tb, &te);
      tb = max(tb, kt_begin);
      te = min(te, kt_end);
    }
    // This thread's rows: r = 0 (row0) and r = 1 (+8); entry 4j + e of an
    // accumulator is row r = e >> 1, column 8j + 2 (lane & 3) + (e & 1).
    const int row0 = qw0 + w4 * 16 + (lane >> 2);
    const int qpos[2] = {row0 + p.kv_offset, row0 + 8 + p.kv_offset};
    const float sl2 = fabsf(p.scale) * kLog2e;  // exp(scale (s - m)) = exp2(sl2 s - sl2 m)
    float o[NV / 2];
    zero(o);
    float m[2] = {kMaskRaw, kMaskRaw}, l[2] = {0.f, 0.f};  // row max in unscaled units
    unsigned ph[BK / 16][4], pl[BK / 16][4];  // P's high and low bf16 parts, a k-step each

    mbar_wait(q_bar, 0);
    if (p.scale < 0.f) {  // -q.k |scale| = q.k scale: flip the signs of this warpgroup's Q
      uint32_t* qw = reinterpret_cast<uint32_t*>(sQw);
      for (int i = threadIdx.x - 128 * wg; i < NPK * kBox / 4; i += 128) qw[i] ^= 0x80008000u;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
      asm volatile("bar.sync %0, 128;\n" :: "r"(wg) : "memory");      // the warpgroup's barrier
    }

    // The two consumers take turns at issuing their products, a key tile a
    // turn, consumer 0 first: one's softmax runs while the other's products
    // do.  Each takes kt_end - kt_begin turns; consumer 0 then takes the
    // hand-on of consumer 1's last.  No branch lies between a product's
    // issue and its wait: ptxas would serialise every wgmma.
    // A tile this warpgroup's rows do not visit: wait for it (every use of
    // a stage is waited for in order), hand both stages on, take the turn.
    auto pass = [&](int kt) {
      const Slot sl(kt, kt_begin);
      mbar_wait(full_k + sl.st, sl.par);
      mbar_wait(full_v + sl.st, sl.par);
      release(empty_k + sl.st, lane);
      release(empty_v + sl.st, lane);
      turn_wait(w);
      turn_pass(w);
    };
    if (w == 1) turn_pass(w);  // consumer 0 takes the first turn

    for (int kt = kt_begin; kt < tb; ++kt) pass(kt);
    float s[BK / 2], alpha[2];
    if (tb < te) {  // the first tile: S alone
      const Slot sl(tb, kt_begin);
      mbar_wait(full_k + sl.st, sl.par);
      turn_wait(w);
      issue_s<BK, KS>(s, sQw, sm + L::k + sl.st * NPK * PANEL);
      turn_pass(w);
      wgmma_wait<0>();
      reg_fence(s);
      release(empty_k + sl.st, lane);
      softmax_tile<BK>(s, m, l, alpha, p, qw0, tb * BK, qpos, lane, sl2);
      pack_p<BK>(s, ph, pl);
    }
    for (int kt = tb + 1; kt < te; ++kt) {
      // this tile's S, then the previous tile's P.V, which runs on under
      // this tile's softmax
      const Slot sl(kt, kt_begin), prev(kt - 1, kt_begin);
      mbar_wait(full_k + sl.st, sl.par);
      mbar_wait(full_v + prev.st, prev.par);
      turn_wait(w);
      issue_s<BK, KS>(s, sQw, sm + L::k + sl.st * NPK * PANEL);
      issue_pv<NV, BK>(o, ph, pl, sm + L::v + prev.st * NPV * PANEL);
      turn_pass(w);
      wgmma_wait<1>();  // S has landed
      reg_fence(s);
      release(empty_k + sl.st, lane);
      softmax_tile<BK>(s, m, l, alpha, p, qw0, kt * BK, qpos, lane, sl2);
      wgmma_wait<0>();  // the previous tile's P.V has landed
      reg_fence(o);
      release(empty_v + prev.st, lane);
      // rescaled to this tile's max; skipped when no row max of the warp moved
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
        #pragma unroll
        for (int j = 0; j < NV / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
      pack_p<BK>(s, ph, pl);
    }
    if (tb < te) {  // the last tile's P.V
      const Slot last(te - 1, kt_begin);
      mbar_wait(full_v + last.st, last.par);
      issue_pv<NV, BK>(o, ph, pl, sm + L::v + last.st * NPV * PANEL);
      wgmma_wait<0>();
      reg_fence(o);
      release(empty_v + last.st, lane);
    }
    for (int kt = te; kt < kt_end; ++kt) pass(kt);
    if (w == 0) turn_wait(w);

    bf16* ob = static_cast<bf16*>(p.o);
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      bf16* orow =
          ob + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * DV + ((lane & 3) << 1);
      #pragma unroll
      for (int j = 0; j < NV / 8; ++j)
        if (j * 8 < DV)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      // The row max is kept unscaled: lse = (m |scale| log2e + log2 l) ln 2, in
      // the scaled logits' units.  A row with no valid key gets the plain -1e30.
      if (p.lse != nullptr && (lane & 3) == 0) {
        int lo, hi;
        key_range(p, row + p.kv_offset, &lo, &hi);
        p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] =
            hi < lo ? -1e30f : (m[r] * sl2 + log2f(fmaxf(lr, 1e-30f))) * kLn2;
      }
    }
  }
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  Maps m;
  if (!make_map(&m.q, p.q, DK, p.Hq, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb)
      || !make_map(&m.k, p.k, DK, p.Hkv, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb)
      || !make_map(&m.v, p.v, DV, p.Hkv, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Smem<DK, DV>::launch;
  static const int attr = set_smem(flash_fwd_bf16_kernel<DK, DV>, bytes);  // once a process
  if (attr) return attr;
  flash_fwd_bf16_kernel<DK, DV><<<dim3(p.B * p.Hq, (p.Sq + kBlockQ - 1) / kBlockQ), kThreads,
                                  bytes, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan of an instantiation: query rows a block, keys a tile,
// stages a ring, dynamic shared bytes.
template <int DK, int DV>
int plan(int* out) {
  out[0] = kBlockQ;
  out[1] = key_tile<DK, DV>();
  out[2] = kStages;
  out[3] = Smem<DK, DV>::launch;
  return 0;
}

}  // namespace hop


template <int DK, int DV>
int launch_d(const Params& p, int dtype, cudaStream_t s) {
  if (dtype == 0) return f32::launch<DK, DV>(p, s);
  if (dtype == 1) return hop::launch<DK, DV>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The output is contiguous (B,Sq,Hq,DV);
// `lse`, where non-null, is f32 (B,Hq,Sq) contiguous.
// (DK, DV) is one of (32,32), (64,64), (128,128), (120,120), (96,96) and (96,64),
// and in f32 (16,16).
// bf16 operands are read by TMA: their base pointers must be 16-byte
// aligned and their (b, s, h) strides multiples of 8 elements.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int Sq, int Skv, int Hq, int Hkv, int DK, int DV,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, int window, int kv_offset, int dtype, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (dtype == 1) {
    const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    for (long long st : strides)
      if (st % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
    const void* ptrs[3] = {q, k, v};
    for (const void* ptr : ptrs)
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Params p{q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, scale, causal, window, kv_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

// The bf16 kernel's launch plan for (DK, DV), into out[4]: query rows a
// block, keys a tile, stages a ring, dynamic shared bytes (the wrapper's
// flash_attention.launch_plan computes the same on the host).  Returns a
// cudaError_t.
extern "C" int flash_attention_fwd_plan(int DK, int DV, int* out) {
  if (DK == DV) {
    switch (DK) {
      case 32: return hop::plan<32, 32>(out);
      case 64: return hop::plan<64, 64>(out);
      case 128: return hop::plan<128, 128>(out);
      case 120: return hop::plan<120, 120>(out);
      case 96: return hop::plan<96, 96>(out);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (DK == 96 && DV == 64) return hop::plan<96, 64>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
