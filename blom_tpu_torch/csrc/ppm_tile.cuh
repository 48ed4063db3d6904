// PPM reconstruction of a tile of columns held in shared memory as
// [k][column] arrays, one (k, column) point per thread, shared by the ALE
// kernels (ale_regrid.cu, ale_remap.cu).
//
// Plain version: blom_tpu_torch/ops/hor3map.py, ppm_reconstruct with its
// three limiters (edge4_weights, _edge4, _limit_mono / _limit_nosc,
// _limit_boundary, _limit_posdef, the piecewise-constant mask, the
// coefficients).  'monotonic' applies the slope clamp and the extremum
// limit at every interior cell, 'non_oscillatory' only where the
// curvature changes sign, and 'non_oscillatory_posdef' adds the
// positive-definite fix of every cell after the boundary cells.  Each
// expression below is that code's, with its operation order, split at
// the points where one cell reads what another wrote.  Where the plain
// version computes several branches and selects one with `where` (the
// three edge stencils, the limiter cases), only the selected branch is
// evaluated here; it gives the same selected value.  A division of a
// tensor by a Python constant runs on the card as a product with the
// constant's reciprocal, so the kernels write it that way (`* rcp3`).
// Minimum, maximum and clamp return a NaN operand, as PyTorch's do, so
// that columns whose reconstruction overflows give the plain version's
// values too.  Build with -fmad=false so that every operation rounds as
// the plain version's separate tensor operations do.
//
// A stage that reads a neighbour's value written by an earlier stage
// runs after a __syncthreads() that separates the two.  The order of the
// limiter's steps on one column is the plain version's:
//
//   edges -> need (non-oscillatory) -> slope clamp, boundary cells ->
//   pair sweep -> parabola limit -> posdef, piecewise-constant cells and
//   the coefficients,
//
// where the boundary cells may run beside the slope clamp because the
// interior steps (cells 1..kk-2, edges 2..kk-2) neither read nor write
// tel[0], ter[0], tel[kk-1] or ter[kk-1], and the boundary cells read
// no value the interior steps write.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace ale {

// the limiters, in the order of ale_cuda.LIMITERS
enum { LIM_MONOTONIC, LIM_NON_OSCILLATORY, LIM_POSDEF, N_LIM };

constexpr double kHeps = 1.e-11;   // hor3map.heps
constexpr double kEpsilp = 1.e-12; // constants.epsilp

template <typename T>
__device__ __forceinline__ T fab(T x) {
  return fabs(x);
}

// torch.minimum / torch.maximum (and clamp): a NaN operand is the result
template <typename T>
__device__ __forceinline__ T fmn(T a, T b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

template <typename T>
__device__ __forceinline__ T fmx(T a, T b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// neither inf nor NaN (x - x is NaN exactly then)
template <typename T>
__device__ __forceinline__ bool is_finite(T x) {
  return x - x == T(0);
}

// where(|x| < 1e-300, 1e-300, x); the constant is 0 in float, so safe
// is the identity there
template <typename T>
__device__ __forceinline__ T safe(T x) {
  return fab(x) < T(1e-300) ? T(1e-300) : x;
}

template <>
__device__ __forceinline__ float safe(float x) {
  return x;
}

__device__ __forceinline__ int clampk(int k, int kk) {
  return k < 0 ? 0 : (k > kk - 1 ? kk - 1 : k);
}

// One column of a [k][column] array of TC columns: x[k] is a[k * TC].
template <typename T, int TC>
struct Lev {
  T *a;
  __device__ __forceinline__ T &operator[](int k) const { return a[k * TC]; }
};

// The remap thickness d = max(p[k+1] - p[k], 0) of a column whose
// interfaces p are held in a [k][column] array.
template <typename T, int TC>
struct Dxr {
  const T *p;
  __device__ __forceinline__ T operator[](int k) const {
    return fmx(p[(k + 1) * TC] - p[k * TC], T(0));
  }
};

// The reconstruction thickness dx = d + heps of such a column.
template <typename T, int TC>
struct ThickP {
  const T *p;
  __device__ __forceinline__ T operator[](int k) const {
    return Dxr<T, TC>{p}[k] + T(kHeps);
  }
};

// Weights of the edge between cells q-1 and q (edge4_weights), q in
// [0, kk], reading dx through an accessor: the 4-cell estimate in the
// interior, the one-sided 3-cell estimates at q = 1 and q = kk-1 (kk-1
// first), the end cells' means at q = 0 and q = kk.
template <typename T, typename D>
__device__ __forceinline__ void edge_weights_at(const D &dx, int kk, int q,
                                                T &w1, T &w2, T &w3,
                                                T &w4) {
  if (q == 0) {
    w1 = T(0); w2 = T(0); w3 = T(1); w4 = T(0);
    return;
  }
  if (q == kk) {
    w1 = T(0); w2 = T(1); w3 = T(0); w4 = T(0);
    return;
  }
  const T x1 = dx[clampk(q - 2, kk)];
  const T x2 = dx[clampk(q - 1, kk)];
  const T x3 = dx[clampk(q, kk)];
  const T x4 = dx[clampk(q + 1, kk)];
  const T c1_2 = T(.5), c2_3 = T(2 / 3.), c3_4 = T(.75);
  const T c1_6 = T(1 / 6.), c1_12 = T(1 / 12.);

  const T a12 = -x2 - c1_2 * x1;
  const T a22 = -c1_2 * x2;
  const T a32 = c1_2 * x3;
  const T a42 = x3 + c1_2 * x4;
  const T a13 = a12 * a12 + c1_12 * x1 * x1;
  const T a23 = -c2_3 * a22 * x2;
  const T a33 = c2_3 * a32 * x3;
  const T a43 = a42 * a42 + c1_12 * x4 * x4;

  if (q == kk - 1) {
    // 1110: cells (k-2, k-1, k)
    const T d22 = a22 - a12;
    const T d32 = a32 - a12;
    const T d23 = (a23 - a13) / safe(d22);
    const T d33 = a33 - a13 - d23 * d32;
    T f2 = -a12 + T(0) * a12;
    const T f3 = (-a13 - d23 * f2) / safe(d33);
    f2 = (f2 - d32 * f3) / safe(d22);
    w1 = T(1) - f2 - f3;
    w2 = f2;
    w3 = f3;
    w4 = T(0);
    return;
  }
  if (q == 1) {
    // 0111: cells (k-1, k, k+1)
    const T c32 = a32 - a22;
    const T c42 = a42 - a22;
    const T c33 = (a33 - a23) / safe(c32);
    const T c43 = a43 - a23 - c33 * c42;
    T g3 = -a22 + T(0) * a22;
    const T g4 = (-a23 - c33 * g3) / safe(c43);
    g3 = (g3 - c42 * g4) / safe(c32);
    w1 = T(0);
    w2 = T(1) - g3 - g4;
    w3 = g3;
    w4 = g4;
    return;
  }
  // full 4-cell elimination
  const T a14 = (a13 + c1_6 * x1 * x1) * a12;
  const T a24 = -c3_4 * a23 * x2;
  const T a34 = c3_4 * a33 * x3;
  const T a44 = (a43 + c1_6 * x4 * x4) * a42;
  const T b22 = a22 - a12;
  const T b32 = a32 - a12;
  const T b42 = a42 - a12;
  const T b23 = (a23 - a13) / safe(b22);
  const T b33 = a33 - a13 - b23 * b32;
  const T b43 = a43 - a13 - b23 * b42;
  const T b24 = (a24 - a14) / safe(b22);
  T b34 = a34 - a14 - b24 * b32;
  T b44 = a44 - a14 - b24 * b42;
  b34 = b34 / safe(b33);
  b44 = b44 - b34 * b43;
  T h2 = -a12 + T(0) * a12;
  T h3 = -a13 - b23 * h2;
  const T h4 = (-a14 - b24 * h2 - b34 * h3) / safe(b44);
  h3 = (h3 - b43 * h4) / safe(b33);
  h2 = (h2 - b32 * h3 - b42 * h4) / safe(b22);
  w1 = T(1) - h2 - h3 - h4;
  w2 = h2;
  w3 = h3;
  w4 = h4;
}

// Edge q of the cell means tm (_edge4).
template <typename T, int TC>
__device__ __forceinline__ T edge_value_at(Lev<T, TC> tm, int kk, int q,
                                           T w1, T w2, T w3, T w4) {
  return w1 * tm[clampk(q - 2, kk)] + w2 * tm[clampk(q - 1, kk)] +
         w3 * tm[clampk(q, kk)] + w4 * tm[clampk(q + 1, kk)];
}

// Cell k's curvature changes sign against a neighbour (_limit_nosc's
// test), from the raw edges.
template <typename T, int TC>
__device__ __forceinline__ bool need_at(Lev<T, TC> tm, Lev<T, TC> tel,
                                        Lev<T, TC> ter, int kk, int k) {
  const int km = k > 0 ? k - 1 : 0;
  const int kp = k + 1 < kk ? k + 1 : kk - 1;
  const T d2m = tel[km] - T(2) * tm[km] + ter[km];
  const T d2 = tel[k] - T(2) * tm[k] + ter[k];
  const T d2p = tel[kp] - T(2) * tm[kp] + ter[kp];
  return d2m * d2 < T(0) || d2 * d2p < T(0);
}

// Slope clamp of interior cell k (1 <= k <= kk-2), in place.
template <typename T, int TC, typename D>
__device__ __forceinline__ void slope_clamp_at(const D &dx, Lev<T, TC> tm,
                                               Lev<T, TC> tel,
                                               Lev<T, TC> ter, int k) {
  const T tmk = tm[k], tm_m = tm[k - 1], tm_p = tm[k + 1];
  const T dxk = dx[k];
  const T hi = T(1) / dxk;
  const T sl = T(2) * (tmk - tm_m) * hi;
  const T sr = T(2) * (tm_p - tmk) * hi;
  if (!(sl * sr > T(0))) {
    tel[k] = tmk;
    ter[k] = tmk;
    return;
  }
  const T hci = T(2) / (dx[k - 1] + T(2) * dxk + dx[k + 1]);
  const T sc0 = (tm_p - tm_m) * hci;
  const T sc = copysign(fmn(fmn(fab(sl), fab(sr)), fab(sc0)), sc0);
  const T lim = T(.5) * dxk * fab(sc);
  const T l = tel[k], r = ter[k];
  if ((tm_m - l) * (tmk - l) > T(0))
    tel[k] = tmk - copysign(fmn(lim, fab(l - tmk)), sc);
  if ((tm_p - r) * (tmk - r) > T(0))
    ter[k] = tmk + copysign(fmn(lim, fab(r - tmk)), sc);
}

// Edge-pair consistency of edge k (2 <= k <= kk-2): tel[k], ter[k-1].
template <typename T, int TC>
__device__ __forceinline__ void pair_sweep_at(Lev<T, TC> tm, Lev<T, TC> tel,
                                              Lev<T, TC> ter, int k) {
  if ((tel[k] - ter[k - 1]) * (tm[k] - tm[k - 1]) < T(0)) {
    const T avg = T(.5) * (ter[k - 1] + tel[k]);
    tel[k] = avg;
    ter[k - 1] = avg;
  }
}

// Overshoot of the parabola's extremum in interior cell k.
template <typename T, int TC>
__device__ __forceinline__ void parabola_limit_at(Lev<T, TC> tm,
                                                  Lev<T, TC> tel,
                                                  Lev<T, TC> ter, int k) {
  const T rcp3 = T(1) / T(3);
  const T l = tel[k], r = ter[k], tmk = tm[k];
  const T d = r - l;
  const T q = d * (T(2) * tmk - l - r);
  const T rr = d * d * rcp3;
  if (q > rr) tel[k] = T(3) * tmk - T(2) * r;
  if (-rr > q) ter[k] = T(3) * tmk - T(2) * l;
}

// The boundary cells 0 and kk-1 of one column.
template <typename T, int TC, typename D>
__device__ __forceinline__ void boundary_cells(const D &dx, Lev<T, TC> tm,
                                               Lev<T, TC> tel,
                                               Lev<T, TC> ter, int kk,
                                               bool pc_upper) {
  const T rcp3 = T(1) / T(3);
  const T t0 = tm[0];
  const bool flat0 = (tm[1] - ter[0]) * (t0 - ter[0]) > T(0);
  const T s0 = T(2) * (tm[2] - tm[1]) / (dx[1] + dx[2]);
  const T cand0 = t0 + s0 * dx[0] * rcp3;
  T uer0 = s0 > T(0) ? fmx(t0, fmn(ter[0], cand0))
                     : fmn(t0, fmx(ter[0], cand0));
  T uel0;
  if (flat0) {
    uer0 = t0;
    uel0 = t0;
  } else {
    uel0 = T(.5) * (T(3) * t0 - uer0);
  }
  const int b = kk - 1;
  const T tb = tm[b];
  const bool flat1 = (tb - tel[b]) * (tm[b - 1] - tel[b]) > T(0);
  const T s1 = T(2) * (tm[b - 1] - tm[b - 2]) / (dx[b - 2] + dx[b - 1]);
  const T cand1 = tb - s1 * dx[b] * rcp3;
  T uel1 = s1 > T(0) ? fmn(tb, fmx(tel[b], cand1))
                     : fmx(tb, fmn(tel[b], cand1));
  T uer1;
  if (flat1) {
    uel1 = tb;
    uer1 = tb;
  } else {
    uer1 = T(.5) * (T(3) * tb - uel1);
  }
  if (pc_upper) {
    uel0 = t0;
    uer0 = t0;
  }
  tel[0] = uel0;
  ter[0] = uer0;
  tel[b] = uel1;
  ter[b] = uer1;
}

// Cell k's positive-definite fix (LIM_POSDEF), piecewise-constant mask
// and coefficients, in place: tel = c0, tm = c1, ter = c2.
template <int LIM, typename T, int TC>
__device__ __forceinline__ void fit_at(T dxk, Lev<T, TC> tm, Lev<T, TC> tel,
                                       Lev<T, TC> ter, int k,
                                       bool pc_upper) {
  const T tmk = tm[k];
  T l = tel[k], r = ter[k];
  if constexpr (LIM == LIM_POSDEF) {
    const T min_u_0 = fmn(tmk, T(0));
    l = fmx(l, min_u_0);
    r = fmx(r, min_u_0);
    const T sl = T(2) * (T(3) * tmk - T(2) * l - r);
    const T a2 = T(3) * (l - T(2) * tmk + r);
    const T sr = sl + T(2) * a2;
    if (sl < T(0) && sr > T(0)
        && (a2 * l - T(.25) * sl * sl < a2 * min_u_0)) {
      const T q = T(3) * tmk / safe(T(3) * sl * sr + T(4) * a2 * a2);
      l = sl * sl * q;
      r = sr * sr * q;
    }
  }
  if ((pc_upper && k == 0) || dxk <= T(2. * kHeps)) {
    l = tmk;
    r = tmk;
  }
  tel[k] = l;
  tm[k] = T(6) * tmk - T(4) * l - T(2) * r;
  ter[k] = T(3) * (l - T(2) * tmk + r);
}

// The machine epsilon of T.
template <typename T>
struct Eps {
  static constexpr T value = DBL_EPSILON;
};
template <>
struct Eps<float> {
  static constexpr float value = FLT_EPSILON;
};

// The deepest interface l in [0, kk-1] of a column whose interfaces
// p[0..kk-1] do not decrease that lies at least the margin
// m = 8 eps (|pq| + |p0|) + 4 heps above the pressure pq (eps the machine
// epsilon): a walk on from `from` when p[from] qualifies, else a binary
// search; 0 when none does.  The layers above it end at or above
// pq - m, so after the rounding of their thickness and of their lower
// edge p[l] + (p[l+1] - p[l]), each still ends above pq (K1: none
// contains pq) and, for the thickness d <= |pq| + |p0| + m,
// (pq - p[l]) * (1 / max(d, heps)) >= 1 after its three roundings (K2:
// each is full at pq).
template <typename T, int TC>
__device__ __forceinline__ int clear_above(Lev<T, TC> p, int kk, T pq,
                                           int from) {
  const T t = pq - (T(8) * Eps<T>::value * (fab(pq) + fab(p[0]))
                    + T(4 * kHeps));
  if (!(p[0] <= t)) return 0;
  int lo = from;
  if (!(from >= 0 && p[from] <= t)) {
    lo = 0;
    int hi = kk - 1;                  // p[lo] <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (p[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
  }
  while (lo + 1 < kk && p[lo + 1] <= t) ++lo;
  return lo;
}

}  // namespace ale
