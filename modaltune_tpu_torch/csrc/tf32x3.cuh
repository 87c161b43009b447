// Products at fp32 accuracy on Hopper's TF32 tensor cores (3xTF32), shared
// by the fp32 families of the dilated attention cores (dilated_tf32.cuh,
// D = 48) and of the key-bias flash attention's short side
// (flash_short_side_tf32.cuh, D = 16). Nothing here depends on D.
//
// * An fp32 operand x is split into hi = cvt.rna.tf32.f32(x) and
//   lo = cvt.rna.tf32.f32(x - hi), and a product is lo hi + hi lo + hi hi
//   accumulated in fp32 (the small terms first), lo lo dropped: about 2^-21
//   of each product, where one TF32 product keeps 2^-11 and misses the fp32
//   gates. A register tile (P, dS) is split the same way.
// * mma.sync m16n8k8: a thread (g = lane / 4, t = lane % 4) holds A at
//   (g, t) (g + 8, t) (g, t + 4) (g + 8, t + 4), B at (k = t, n = g) and
//   (t + 4, g), C at (g, 2t) (g, 2t + 1) (g + 8, 2t) (g + 8, 2t + 1). The C
//   fragment of a 16 x 8 tile is the A fragment of the next product's
//   8-deep step once that step's inner index is permuted: logical column t
//   is element 2t, column t + 4 element 2t + 1, and the B operand's rows
//   follow (from_scores, product).
// * The tensor cores add into their accumulator by truncation, not to
//   nearest: one accumulator over a whole stream of tiles read dq at rel-L2
//   1.104e-05 against the plain fp32 backward at (3, 10240, 16, 48), past
//   the 1e-5 gate (NVIDIA H100 80GB HBM3, 700 W). So a product over a
//   stream sums at most 32 of its inner index into a fresh fragment, which
//   fp32 adds (to nearest) add to the running sum (product).
#pragma once

#include <stdint.h>

namespace mt {
namespace tf32 {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups of copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + (what lo's rounding drops)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// An A fragment (16 x 8) in two parts.
struct Frag {
  uint32_t hi[4], lo[4];
};

// c (16 x 8) += a b for one 8-deep step, TF32 operands (a: four registers),
// fp32 sums.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at fp32 accuracy: lo hi, then hi lo, then hi hi.
__device__ __forceinline__ void mma3(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma(c, a_lo, bh[0], bh[1]);
  mma(c, a_hi, bl[0], bl[1]);
  mma(c, a_hi, bh[0], bh[1]);
}

// The A fragment of the next product's 8-deep step j from the C fragment
// of tile j of a register tile x (x[4 j + 2 rr + e]: row g + 8 rr, element
// 8 j + 2 t + e): logical column t is element 2t, column t + 4 element
// 2t + 1.
__device__ __forceinline__ Frag from_scores(const float* x, int j) {
  Frag f;
  split(x[4 * j], f.hi[0], f.lo[0]);          // (g, 2t)
  split(x[4 * j + 2], f.hi[1], f.lo[1]);      // (g + 8, 2t)
  split(x[4 * j + 1], f.hi[2], f.lo[2]);      // (g, 2t + 1)
  split(x[4 * j + 3], f.hi[3], f.lo[3]);      // (g + 8, 2t + 1)
  return f;
}

// acc (16 rows x 8 N, C fragments) += X B over J 8-deep steps (J <= 4: at
// most 32 of the inner index): X the register tile x (J tiles of 8), B's
// fragments of step j and output tile m (its rows 8 j + 2t and + 1, in
// from_scores' order, column 8 m + g) from load_b(j, m, bh, bl). The steps
// sum into a fresh fragment, which fp32 adds add to acc.
template <int N, int J, typename LoadB>
__device__ __forceinline__ void product(float* acc, const float* x, LoadB load_b) {
  static_assert(J >= 1 && J <= 4, "at most 32 of the inner index a fresh fragment");
  float t[4 * N] = {};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const Frag f = from_scores(x, j);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      uint32_t bh[2], bl[2];
      load_b(j, m, bh, bl);
      mma3(t + 4 * m, f.hi, f.lo, bh, bl);
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) acc[i] += t[i];
}

}  // namespace tf32
}  // namespace mt
