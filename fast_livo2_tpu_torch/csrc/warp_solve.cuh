// A small dense solve in one warp: Gauss-Jordan elimination with partial
// pivoting, X = A^-1 B for A (D x D) and B (D x R), D <= 32.
//
// Layout: lane r < D holds row r of A in `a` and row r of B in `b`, in
// registers (the loops are unrolled over D and R, so every index is a
// compile-time constant); lanes r >= D hold zeros and take part in the
// shuffles only. Step k picks as pivot, among the rows not yet used, the
// one of largest |a[k]|, ties to the lowest row (a NaN counts as +inf, so
// it propagates as it would through an LU factorization); rows are never
// swapped, so the tie-break is by original row index. The pivot row is
// broadcast entry by entry with shuffles; every other row r subtracts
// l_r = a_r[k] * (1 / pivot) times it (the multiplier LAPACK's sgetf2
// forms: one correctly rounded reciprocal a step, not a division an
// entry), and the pivot row is scaled by the reciprocal. Columns <= k are
// never read again and are not updated. On return the lane that pivoted
// step k holds row k of X in `b`, and the function returns that k to each
// lane (-1 for r >= D).
//
// Why Gauss-Jordan in one warp: at D = 19 the work is ~10^4 FMAs, so what
// bounds the solve is its chain of D dependent pivot steps, not bytes or
// FLOPs. A step here is one warp max-reduction (redux.sync) and one
// ballot for the pivot, one reciprocal and D - k + R - 1 independent
// shuffle + FMA pairs: no shared memory and no barrier. A symmetric
// positive definite A (the filters' information matrix) would also take
// Cholesky, but partial pivoting is what torch.linalg.inv_ex's LU runs,
// and it does not assume the symmetry that float32 sums only
// approximate. Deterministic: every operation has a fixed order and
// every lane sees the same pivot.
//
// Used by csrc/photo_tail.cu (D = 19, R = 7); the LIO filter's update
// solves a system of the same shape.

#pragma once

#include <cuda_runtime.h>

template <int D, int R>
__device__ __forceinline__ int warp_gauss_jordan(float (&a)[D], float (&b)[R],
                                                 int lane) {
  static_assert(D >= 1 && D <= 32, "one row a lane");
  constexpr unsigned kAll = 0xffffffffu;
  bool used = lane >= D;
  int pivoted = -1;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    // Key: 0 for used rows, else the bits of |a[k]| + 1 (non-negative
    // floats order as their bits; NaN as +inf's bits), so an unused row
    // always beats a used one.
    unsigned key = 0u;
    if (!used) {
      const float v = fabsf(a[k]);
      key = (v != v ? 0x7f800000u : __float_as_uint(v)) + 1u;
    }
    const unsigned best = __reduce_max_sync(kAll, key);
    const int p = __ffs(__ballot_sync(kAll, key == best)) - 1;
    const float pivot = __shfl_sync(kAll, a[k], p);
    const float rinv = 1.0f / pivot;
    const bool me = lane == p;
    if (me) {
      used = true;
      pivoted = k;
    }
    const float l = a[k] * rinv;
#pragma unroll
    for (int c = k + 1; c < D; ++c) {
      const float pc = __shfl_sync(kAll, a[c], p);
      a[c] = me ? a[c] * rinv : fmaf(-l, pc, a[c]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float pj = __shfl_sync(kAll, b[j], p);
      b[j] = me ? b[j] * rinv : fmaf(-l, pj, b[j]);
    }
  }
  return pivoted;
}
