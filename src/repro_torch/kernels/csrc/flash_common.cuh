// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): the masks' valid-key ranges and
// tile tests, and the bf16 path's arithmetic (exp2 by the SFU, bf16 pairs,
// a value split into a bf16 high part and the bf16 of its remainder).  The
// Hopper pieces both bf16 paths are built from (TMA, mbarriers, wgmma) are
// in hopper.cuh.  Each source is still built into a library of its own;
// kernels/build.py hashes every header into both libraries' names.
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

// Every (query, key) pair of the query block [q0, q0 + bq) and the key tile
// [k0, k0 + bk) valid: no mask, no ragged key edge.  Rows past Sq are never
// stored (the backward zero-fills them with lse +inf, so they weigh 0 either way).
template <class P>
__device__ __forceinline__ bool whole_tile(const P& p, int q0, int bq, int k0, int bk) {
  const int qa_first = q0 + p.kv_offset, qa_last = min(q0 + bq, p.Sq) - 1 + p.kv_offset;
  return k0 + bk <= p.Skv && (!p.causal || k0 + bk - 1 <= qa_first) &&
         (p.window <= 0 || k0 > qa_last - p.window);
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

}  // namespace flash
