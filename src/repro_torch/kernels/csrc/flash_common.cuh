// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): the masks' valid-key ranges, and
// the bf16 path's building blocks (16-byte cp.async staging into padded
// shared tiles, ldmatrix, mma.sync m16n8k16 with f32 accumulators).  Each
// source is still built into a library of its own; kernels/build.py hashes
// this header into both libraries' names.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// Valid keys of the query at absolute position qpos are [lo, hi] (empty if
// hi < lo).  P is a kernel's Params: window (<= 0: none), causal, Skv.
template <class P>
__device__ __forceinline__ void key_range(const P& p, int qpos, int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  *hi = p.causal ? min(qpos, p.Skv - 1) : p.Skv - 1;
}

// Key tiles of width bk that the query block [q0, q0 + bq) must visit.  Valid-key
// bounds are monotone in the query position, so the block's first and last
// rows give them.  If any row has no valid key at all, every key counts (the
// plain version's uniform softmax over -1e30), so the whole range is visited.
// Rows with no valid key form a prefix or a suffix of the queries, so the
// first and last rows also tell whether there are any.
template <class P>
__device__ __forceinline__ void tile_range(const P& p, int q0, int bq, int bk, int* begin,
                                           int* end) {
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

// A head dim padded to the m16n8k16 k-step (and to ldmatrix.x4's pairs of
// 8-column matrices): 120 -> 128; 32, 64, 96 and 128 stay.
template <int D> __host__ __device__ constexpr int padded() { return (D + 15) / 16 * 16; }
// Shared-memory row pitch in bf16 elements: the padded D plus 16 bytes, so
// the eight 16-byte rows of an ldmatrix 8x8 matrix start in distinct bank
// quads (a pitch of 128 + 8 at D 120, not 120 + 8 = 256 bytes, which would
// start every row in the same quad).
template <int D> __host__ __device__ constexpr int pitch() { return padded<D>() + 8; }

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
// shared tile of `nr` rows of padded<D>() columns, by a block of `Threads`;
// rows at or past `limit`, and the pad columns past D of every row, are
// zero-filled.
template <int D, int Threads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int r0, int nr, int limit, int tid) {
  constexpr int CH = D / 8, CHP = padded<D>() / 8;  // 16-byte chunks per row: real, padded
  for (int idx = tid; idx < nr * CHP; idx += Threads) {
    const int r = idx / CHP, c = idx % CHP, row = r0 + r;
    const bool in = row < limit && c < CH;
    cp_async16(smem_addr(dst + r * pitch<D>() + c * 8),
               src + (row < limit ? row : 0) * ss + (c < CH ? c : 0) * 8, in);
  }
}

}  // namespace flash
