// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
//   q and k (B,Sq|Skv,Hq|Hkv,DK), v (B,Skv,Hkv,DV) -> o (B,Sq,Hq,DV) in q's dtype.
//   The K head dim and the V head dim are separate template parameters:
//   (32,32), (64,64), (128,128), (120,120) (h2o-danube3) and (96,96)
//   (phi3-vision) for the GQA models, and MLA's (96,64) (minicpm3: q and k of
//   qk_nope 64 + qk_rope 32, v of 64).  Q.K^T runs over DK, P.V over DV;
//   nothing is padded to a common width.  The bf16 kernel pads a head dim
//   that is not a multiple of 16 (120) to the next one in shared memory
//   only: the pad columns are zero-filled there, Q.K^T takes one more k-step
//   over them, P.V skips the pad's n-tile, and exactly DV columns are stored.
//   Online softmax in f32; causal, sliding `window` and `kv_offset` masks;
//   masked logits are -1e30 (not -inf) and the denominator is clamped at 1e-30,
//   so a row with no valid key averages V exactly as the plain version does.
//   Query head h reads KV head h / g in place: the TPU kernel's per-group
//   copy of K and V (jnp.repeat) is never made.  The ragged Sq and Skv edges
//   are masked here rather than padded in device memory, and q, k and v are
//   read through their (batch, seq, head) strides, so v may be a slice of a
//   fused qkv projection.
//
// Bound on the card: operations.  Causal prefill at B 4, S 1024, 16 heads of
// 128 does ~17 GFLOP on ~50 MB, well above the H100's ~295 flop/byte ridge.
// The first version did f32 FMAs on the CUDA cores (67 TFLOP/s peak), with
// scalar loads widened into f32 shared memory and nothing overlapped: 0.9458
// ms at that shape and 1.2195 ms at hymba's (B 4, S 1536, 25 heads of 64,
// window 1024), 16.7x and 4.2x SDPA (PERF.md, the kernel table's earlier times).
//
// bf16 design (FA2-shaped, on the bf16 tensor cores):
//   - A block of 4 warps owns 64 query rows of one (batch, q-head); each warp
//     owns 16 rows.  The Q fragments stay in registers for the whole key loop.
//   - S = Q.K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate), K fragments
//     from shared memory by ldmatrix.  Q is fed as loaded (exact in bf16); the
//     scale, with log2(e) folded in, is applied to S in f32 by the FFMA that
//     forms each exp2 argument, s*scale*log2e - m*scale*log2e.
//   - The online softmax runs in registers; row max and row sum reduce over
//     the four lanes of a quad.  l is summed from the f32 p.  The O rescale is
//     skipped when no row max of the warp moved.
//   - P is reused in registers as the A operand of P.V: the m16n8 accumulator
//     layout of two adjacent key tiles is m16n8k16's A layout.  It goes in as
//     a bf16 high part and the bf16 of its remainder, two products, so P keeps
//     ~16 bits: with P rounded once to bf16, internlm2's full-width logits
//     reached the 2e-2 gate against the plain path (chip_smoke.py), with the
//     split they stay near the distance the plain path itself has from f32.
//     V fragments come from shared memory by ldmatrix.trans.
//   - K and V tiles of 64 keys stay bf16 in shared memory, staged by 16-byte
//     cp.async into a ring of kStages stages: tile j+1 loads while tile j
//     computes, with one barrier per tile.  Rows are padded by 16 bytes so
//     ldmatrix's eight row addresses fall in distinct banks.  Q is staged
//     once through the last stage.
//   - Key tiles the causal or window mask empties for the whole block are
//     skipped, the heaviest causal query tiles are launched first, and only
//     tiles that cross a mask edge evaluate the mask per element.
// At 3 blocks (12 warps) per SM the kernel is bound by the tensor pipe's
// mma.sync rate, about half the wgmma rate (PERF.md, Findings): the split P
// costs ~15 %.  wgmma with TMA and warp specialisation is the next step.
// The f32 instantiation keeps the first version's exact CUDA-core kernel: the f32 parity
// sweep holds at 3e-5, which TF32 or bf16 products would not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

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

// Key tiles of width bk that the query block [q0, q0 + bq) must visit.  Valid-key
// bounds are monotone in the query position, so the block's first and last
// rows give them.  If any row has no valid key at all, every key counts (the
// plain version's uniform softmax over -1e30), so the whole range is visited.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int bq, int bk,
                                           int* begin, int* end) {
  const int last_row = min(q0 + bq, p.Sq) - 1;
  int lo0, hi0, lo1, hi1;
  key_range(p, q0 + p.kv_offset, &lo0, &hi0);
  key_range(p, last_row + p.kv_offset, &lo1, &hi1);
  *begin = 0;
  *end = (p.Skv + bk - 1) / bk;
  if (hi0 >= lo0 && hi1 >= lo1) {
    *begin = lo0 / bk;
    *end = hi1 / bk + 1;
  }
}

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
// bf16: tensor cores (mma.sync m16n8k16), cp.async ring, ldmatrix.

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;       // K/V tiles in the cp.async ring
constexpr int BQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int BK = 64;           // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kAbsent = -__builtin_huge_valf();  // a key past Skv: exp2 gives 0
// A masked logit, in unscaled units.  A power of two, so that its product with
// the scale is exact and a row whose keys are all masked gets exp2(0) = 1 for
// every key: the plain version's uniform softmax over -1e30.  With any valid
// key in the row its weight is exp2(-huge) = 0, as exp(-1e30 - m) is in f32.
constexpr float kMaskRaw = -0x1p100f;
static_assert(BQ <= BK, "Q is staged through one stage's K buffer");

// A head dim padded to the m16n8k16 k-step (and to ldmatrix.x4's pairs of
// 8-column matrices): 120 -> 128; 32, 64, 96 and 128 stay.
template <int D> __host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }
// Shared-memory row pitch in bf16 elements: the padded D plus 16 bytes, so
// the eight 16-byte rows of an ldmatrix 8x8 matrix start in distinct bank
// quads (a pitch of 128 + 8 at D 120, not 120 + 8 = 256 bytes, which would
// start every row in the same quad).  K rows take DK's pitch and V rows DV's.
template <int D> __host__ __device__ constexpr int pitch() { return padded<D>() + 8; }
template <int D> __host__ __device__ constexpr int tile_elems() { return BK * pitch<D>(); }
// One stage: a K tile, then a V tile.
template <int DK, int DV> __host__ __device__ constexpr int stage_elems() {
  return tile_elems<DK>() + tile_elems<DV>();
}
// kStages stages of a K and a V tile.
template <int DK, int DV> __host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<DK, DV>() * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (MUFU.EX2), subnormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (a, b) as a bf16 pair `hi` and the bf16 pair of what rounding left, `lo`:
// hi + lo carries a and b to ~2^-17 of their size.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

// Rows [r0, r0 + nr) of a (rows, D) bf16 operand with row stride `ss` into a
// shared tile of `nr` rows of padded<D>() columns; rows at or past `limit`,
// and the pad columns past D of every row, are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int nr, int limit, int tid) {
  constexpr int CH = D / 8, CHP = padded<D>() / 8;  // 16-byte chunks per row: real, padded
  for (int idx = tid; idx < nr * CHP; idx += kThreads) {
    const int r = idx / CHP, c = idx % CHP, row = r0 + r;
    const bool in = row < limit && c < CH;
    cp_async16(smem_addr(dst + r * pitch<D>() + c * 8),
               src + (row < limit ? row : 0) * ss + (c < CH ? c : 0) * 8, in);
  }
}

// Three blocks per SM where the padded dims pass (96,64)'s: (128,128) and
// (120,120) take 168 registers, (96,96)'s 48 output accumulators would spill
// at four blocks' 128.  Four blocks at (96,64) and below.
template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, padded<DK>() + padded<DV>() > 160 ? 3 : 4)
flash_fwd_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int PK = pitch<DK>(), PV = pitch<DV>(), TK = tile_elems<DK>(),
                STAGE = stage_elems<DK, DV>();
  constexpr int KSTEPS = padded<DK>() / 16;  // Q.K^T k-steps, the last over zero pad at 120
  constexpr int NT = DV / 8;                 // P.V n-tiles of 8 output columns (15 at 120)
  // Stage s holds K at smem + s*STAGE and V at smem + s*STAGE + TK.  Q is
  // staged through the last stage's K tile, which the key loop fills first.
  __nv_bfloat16* q_stage = smem + (kStages - 1) * STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int kt_begin, kt_end;
  tile_range(p, q0, BQ, BK, &kt_begin, &kt_end);

  // Prologue: Q, then the first kStages - 1 K/V tiles, one cp.async group each.
  load_rows<DK>(q_stage, q, p.q_ss, q0, BQ, p.Sq, tid);
  cp_async_commit();
  #pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt_begin + i < kt_end) {
      load_rows<DK>(smem + i * STAGE, k, p.k_ss, (kt_begin + i) * BK, BK, p.Skv, tid);
      load_rows<DV>(smem + i * STAGE + TK, v, p.v_ss, (kt_begin + i) * BK, BK, p.Skv, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q has landed (groups complete in order)
  __syncthreads();

  // A fragments of the warp's 16 rows: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15).
  unsigned qf[KSTEPS][4];
  {
    const int row = warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
    const int col = (lane >> 4) << 3;
    const unsigned sign = p.scale < 0.f ? 0x80008000u : 0u;  // -q.k |scale| = q.k scale
    #pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldsm_x4(qf[kk], smem_addr(q_stage + row * PK + kk * 16 + col));
      #pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][i] ^= sign;
    }
  }  // the key loop's first barrier frees Q's stage for K/V

  // This thread's accumulator rows are r = 0 (warp row lane/4) and r = 1 (+8).
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int qpos[2] = {row0 + p.kv_offset, row0 + 8 + p.kv_offset};
  const float sl2 = fabsf(p.scale) * kLog2e;  // exp(scale (s - m)) = exp2(sl2 s - sl2 m)
  float o_acc[NT][4];
  #pragma unroll
  for (int j = 0; j < NT; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m[2] = {kMaskRaw, kMaskRaw}, l[2] = {0.f, 0.f};  // row max in unscaled units

  // The block's first and last absolute query positions, for the tile mask test.
  const int qa_first = q0 + p.kv_offset, qa_last = min(q0 + BQ, p.Sq) - 1 + p.kv_offset;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin, k0 = kt * BK;
    cp_async_wait<kStages - 2>();  // tile kt has landed for this thread ...
    __syncthreads();  // ... and for all; every thread is done with tile kt - 1's stage
    if (kt + kStages - 1 < kt_end) {  // refill that stage, kStages - 1 tiles ahead
      const int st = (it + kStages - 1) % kStages, kn = k0 + (kStages - 1) * BK;
      load_rows<DK>(smem + st * STAGE, k, p.k_ss, kn, BK, p.Skv, tid);
      load_rows<DV>(smem + st * STAGE + TK, v, p.v_ss, kn, BK, p.Skv, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* sK = smem + (it % kStages) * STAGE;
    const __nv_bfloat16* sV = sK + TK;

    // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 gives b0/b1 of two.
    float s[BK / 8][4];
    #pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      const int key = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) << 3;
      #pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        #pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          unsigned kb[4];
          ldsm_x4(kb, smem_addr(sK + (np * 16 + key) * PK + kk * 16 + col));
          mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
    }

    // Mask only tiles that cross a mask edge or Skv.
    const bool full = k0 + BK <= p.Skv && (!p.causal || k0 + BK - 1 <= qa_first) &&
                      (p.window <= 0 || k0 > qa_last - p.window);
    if (!full) {
      #pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + ((lane & 3) << 1) + (e & 1);
          // Keys past Skv do not exist (weight 0).
          s[j][e] = kpos >= p.Skv ? kAbsent
                                  : (key_valid(p, kpos, qpos[e >> 1]) ? s[j][e] : kMaskRaw);
        }
      }
    }

    // Online softmax over the quad's 64 columns of each row.
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
      #pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2((m[r] - mx) * sl2), mx_s = mx * sl2;
      m[r] = mx;
      float rs = 0.f;
      #pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = fast_exp2(fmaf(s[j][2 * r], sl2, -mx_s));
        const float p1 = fast_exp2(fmaf(s[j][2 * r + 1], sl2, -mx_s));
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      l[r] = l[r] * alpha + rs;  // this thread's partial row sum, from the f32 p
      if (__any_sync(0xffffffffu, alpha != 1.f)) {  // skipped when no row max of the warp moved
        #pragma unroll
        for (int j = 0; j < NT; ++j) {
          o_acc[j][2 * r] *= alpha;
          o_acc[j][2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V: P from registers as a bf16 high part and the bf16 of its
    // remainder (two products, so P carries ~16 bits), V by ldmatrix.trans:
    // one x4 gives the b0/b1 of two n-tiles; at 120 the last x4's second
    // tile is the pad's, and its products are not issued.
    {
      const int key = (lane & 7) + (((lane >> 3) & 1) << 3), col = (lane >> 4) << 3;
      #pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        #pragma unroll
        for (int dp = 0; dp < (NT + 1) / 2; ++dp) {
          unsigned vb[4];
          ldsm_x4_trans(vb, smem_addr(sV + (kk * 16 + key) * PV + dp * 16 + col));
          mma_bf16(o_acc[2 * dp], ph, vb[0], vb[1]);
          if (2 * dp + 1 < NT) mma_bf16(o_acc[2 * dp + 1], ph, vb[2], vb[3]);
          mma_bf16(o_acc[2 * dp], pl, vb[0], vb[1]);
          if (2 * dp + 1 < NT) mma_bf16(o_acc[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o);
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * DV + ((lane & 3) << 1);
    #pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o_acc[j][2 * r] * inv, o_acc[j][2 * r + 1] * inv);
  }
}

template <int DK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DK, DV>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(p.B * p.Hq, (p.Sq + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<DK, DV><<<grid, kThreads, bytes, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16.  The output is contiguous (B,Sq,Hq,DV).
// (DK, DV) is one of (32,32), (64,64), (128,128), (120,120), (96,96) and (96,64).
// bf16 operands are read by 16-byte copies: their base pointers must be
// 16-byte aligned and their (b, s, h) strides multiples of 8 elements.
// Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
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
  Params p{q, k, v, o, B, Sq, Skv, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, scale, causal, window, kv_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
