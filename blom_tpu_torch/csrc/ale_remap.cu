// ALE remap (kernel K2): PPM reconstructions of the tracers, u and v on
// their source grids, remapped onto the new grids as layer means.
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/ale_pallas.py
// _remap_chunk / remap_call (ppm_reconstruct_multi, ppm_reconstruct and
// hor3map.remap_groups(bottom_only_empties=True) on VMEM tiles).  Plain
// version: blom_tpu_torch/dynamics/ale.py remap_plain.  One launch takes
// every tracer (the TPU kernel cut the stack into chunks of 4 to fit
// VMEM) and both velocity components: three groups, each with its own
// source grid, reconstructed and remapped with the geometry computed once
// per group.
//
// One thread per (j, i) column, neighbouring threads on neighbouring i,
// as in ale_regrid.cu; the column arrays live in local memory.  The
// tracers take the tracer limiter, u and v the velocity limiter, both
// template parameters of the kernel: nine instantiations per type, each
// with its groups inlined as the single-limiter kernel had them (a
// non-inlined group function per limiter made the main path's kernel 28 %
// slower on an H100).
//
// What bounds it on an H100: device-memory traffic in principle.  With
// ntr = 0 it reads 6 interface fields (p_src, p_dst, pu_q, pv_q, pu_new,
// pv_new; kk+1 each) and 4 layer fields (temp, saln, u, v) once and
// writes 4 layer fields: ~414 MB in f32 at 384x360x53, 0.124 ms at
// 3.35 TB/s.  The plain version's remap costs O(kk^2) per column: every
// destination edge integrates over every source layer.  Two shortcuts
// keep the kernel's result identical while making it O(kk) per field:
//
// - a term with x == 0 adds exactly zero, so for a column whose source
//   interfaces do not decrease the loop over source layers stops at the
//   first layer whose top lies at or below the destination edge;
// - a term with x == 1 is the layer's full integral
//   dx*((c0 + .5*c1) + (1/3)*c2), computed in the plain version's
//   operation order.  The layers k = 0..kf-1 that are full for an edge
//   are full for every deeper edge, and their sum, taken in the same
//   order from k = 0, is a prefix sum S[kf].  Beyond kf every layer takes
//   its own term (a layer whose x rounds to just under 1 takes the
//   explicit polynomial, as in the plain version).
//
// So each destination edge's integral is the plain version's sum over
// k = 0, 1, ..., in the same order, with its zero terms left out.  A zero
// term is exactly zero only for finite coefficients: a column whose
// interfaces or reconstruction hold inf or NaN takes every term, as the
// plain version does.

#include "ppm_column.cuh"

#define ALE_MAXNT 32

namespace {

using namespace ale;

template <typename T>
struct Args {
  const T *p_src, *pu_q, *u, *pv_q, *v, *p_dst, *pu_new, *pv_new;
  T *u_out, *v_out;
  const T *trc[ALE_MAXNT];
  T *out[ALE_MAXNT];
  int kk, ncol, nt, pc_upper_t, pc_upper_v, lim_t, lim_v;
};

// full-layer integral dx*poly(1) in the plain version's order
template <typename T>
__device__ __forceinline__ T full_term(T dxr, T c0, T c1, T c2) {
  return dxr * (c0 + T(.5) * c1 + T(1 / 3.) * c2);
}

// One group: the fields `src[f]` on interfaces `ps`, reconstructed with
// the limiter LIM and remapped onto `pd`, into `dst[f]`.
template <int LIM, typename T>
__device__ void remap_group(int kk, size_t n, int col, const T *ps,
                            const T *pd, const T *const *src,
                            T *const *dst, int nf, bool pc_upper) {
  T p[ALE_KMAX + 1], dx[ALE_KMAX], dxr[ALE_KMAX], dxi[ALE_KMAX];
  T w[4][ALE_KMAX + 1];
  T tm[ALE_KMAX], tel[ALE_KMAX], ter[ALE_KMAX], S[ALE_KMAX + 1];

  bool pfin = true;
  for (int k = 0; k <= kk; ++k) {
    p[k] = ps[k * n + col];
    pfin = pfin && is_finite(p[k]);
  }
  bool mono = true;
  int kbot = -1;
  for (int k = 0; k < kk; ++k) {
    const T d = fmx(p[k + 1] - p[k], T(0));
    dx[k] = d + T(kHeps);           // reconstruction thickness
    dxr[k] = d;                     // remap thickness
    dxi[k] = T(1) / fmx(d, T(kHeps));
    if (d > T(kHeps)) kbot = k;     // deepest wet source layer
    if (k > 0 && p[k] < p[k - 1]) mono = false;
  }
  for (int q = 0; q <= kk; ++q)
    edge_weights(dx, kk, q, w[0][q], w[1][q], w[2][q], w[3][q]);

  for (int f = 0; f < nf; ++f) {
    const T *s = src[f];
    for (int k = 0; k < kk; ++k) tm[k] = s[k * n + col];
    for (int q = 0; q <= kk; ++q) {
      const T e = edge_value(tm, kk, q, w[0][q], w[1][q], w[2][q], w[3][q]);
      if (q < kk) tel[q] = e;
      if (q > 0) ter[q - 1] = e;
    }
    limit_and_fit<LIM>(kk, dx, tm, tel, ter, pc_upper);
    // tel = c0, tm = c1, ter = c2

    bool fin = pfin;
    S[0] = T(0);
    for (int k = 0; k < kk; ++k) {
      fin = fin && is_finite(tel[k]) && is_finite(tm[k]) &&
            is_finite(ter[k]);
      S[k + 1] = S[k] + full_term(dxr[k], tel[k], tm[k], ter[k]);
    }
    const T botv = kbot >= 0 ? tel[kbot] + tm[kbot] + ter[kbot] : T(0);

    T *o = dst[f];
    int kf = 0;
    T acc_prev = T(0), pq_prev = T(0);
    for (int q = 0; q <= kk; ++q) {
      const T pq = pd[q * n + col];
      T acc;
      if (!fin || pq != pq) {
        // a non-finite coefficient or edge: every term counts, as in
        // the plain version (0 * inf is NaN)
        acc = T(0);
        for (int k = 0; k < kk; ++k) {
          const T x = fmn(fmx((pq - p[k]) * dxi[k], T(0)), T(1));
          const T x2 = x * x;
          const T poly = tel[k] * x + T(.5) * tm[k] * x2 +
                         T(1 / 3.) * ter[k] * x2 * x;
          acc = acc + dxr[k] * poly;
        }
      } else {
        if (q > 0 && !(pq >= pq_prev)) kf = 0;   // edges out of order
        while (kf < kk && (pq - p[kf]) * dxi[kf] >= T(1)) ++kf;
        acc = S[kf];
        for (int k = kf; k < kk; ++k) {
          if (mono && p[k] >= pq) break;
          const T x = (pq - p[k]) * dxi[k];
          if (x >= T(1)) {
            acc = acc + full_term(dxr[k], tel[k], tm[k], ter[k]);
          } else if (x > T(0)) {
            const T x2 = x * x;
            const T poly = tel[k] * x + T(.5) * tm[k] * x2 +
                           T(1 / 3.) * ter[k] * x2 * x;
            acc = acc + dxr[k] * poly;
          }
        }
      }
      if (q > 0) {
        const T dpd = pq - pq_prev;
        o[(q - 1) * n + col] =
            dpd > T(kHeps) ? (acc - acc_prev) * (T(1) / fmx(dpd, T(kHeps)))
                           : botv;
      }
      acc_prev = acc;
      pq_prev = pq;
    }
  }
}

template <typename T, int LT, int LV>
__global__ void __launch_bounds__(128) ale_remap_kernel(const Args<T> a) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;
  const size_t n = (size_t)a.ncol;
  remap_group<LT>(a.kk, n, col, a.p_src, a.p_dst, a.trc, a.out, a.nt,
                  a.pc_upper_t != 0);
  const T *su[1] = {a.u};
  T *du[1] = {a.u_out};
  remap_group<LV>(a.kk, n, col, a.pu_q, a.pu_new, su, du, 1,
                  a.pc_upper_v != 0);
  const T *sv[1] = {a.v};
  T *dv[1] = {a.v_out};
  remap_group<LV>(a.kk, n, col, a.pv_q, a.pv_new, sv, dv, 1,
                  a.pc_upper_v != 0);
}

template <typename T, int LT>
int launch_lt(const Args<T> &a, int blocks, int threads, cudaStream_t s) {
  switch (a.lim_v) {
    case LIM_MONOTONIC:
      ale_remap_kernel<T, LT, LIM_MONOTONIC><<<blocks, threads, 0, s>>>(a);
      break;
    case LIM_NON_OSCILLATORY:
      ale_remap_kernel<T, LT, LIM_NON_OSCILLATORY><<<blocks, threads, 0,
                                                     s>>>(a);
      break;
    default:
      ale_remap_kernel<T, LT, LIM_POSDEF><<<blocks, threads, 0, s>>>(a);
      break;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *ptrs, const int *iargs, void *stream) {
  Args<T> a;
  a.p_src = (const T *)ptrs[0];
  a.pu_q = (const T *)ptrs[1];
  a.u = (const T *)ptrs[2];
  a.pv_q = (const T *)ptrs[3];
  a.v = (const T *)ptrs[4];
  a.p_dst = (const T *)ptrs[5];
  a.pu_new = (const T *)ptrs[6];
  a.pv_new = (const T *)ptrs[7];
  a.u_out = (T *)ptrs[8];
  a.v_out = (T *)ptrs[9];
  a.kk = iargs[0];
  a.ncol = iargs[1];
  a.nt = iargs[2];
  a.pc_upper_t = iargs[3];
  a.pc_upper_v = iargs[4];
  a.lim_t = iargs[5];
  a.lim_v = iargs[6];
  if (a.kk < 3 || a.kk > ALE_KMAX || a.nt < 0 || a.nt > ALE_MAXNT
      || a.lim_t < 0 || a.lim_t >= N_LIM || a.lim_v < 0
      || a.lim_v >= N_LIM)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < ALE_MAXNT; ++t) {
    a.trc[t] = t < a.nt ? (const T *)ptrs[10 + t] : nullptr;
    a.out[t] = t < a.nt ? (T *)ptrs[10 + a.nt + t] : nullptr;
  }
  const int threads = 128;
  const int blocks = (a.ncol + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.lim_t) {
    case LIM_MONOTONIC:
      return launch_lt<T, LIM_MONOTONIC>(a, blocks, threads, s);
    case LIM_NON_OSCILLATORY:
      return launch_lt<T, LIM_NON_OSCILLATORY>(a, blocks, threads, s);
    default:
      return launch_lt<T, LIM_POSDEF>(a, blocks, threads, s);
  }
}

}  // namespace

extern "C" {

// ptrs: p_src, pu_q, u, pv_q, v, p_dst, pu_new, pv_new, u_out, v_out,
// then the nt tracer means and the nt outputs.
// iargs: kk, ncol (= J*I), nt, tracer_pc_upper, velocity_pc_upper,
// tracer limiter, velocity limiter (0 monotonic, 1 non_oscillatory,
// 2 non_oscillatory_posdef).  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for kk outside [3, ALE_KMAX], nt above ALE_MAXNT
// or an unknown limiter.
int ale_remap_f32(void *const *ptrs, const int *iargs, void *stream) {
  return launch<float>(ptrs, iargs, stream);
}

int ale_remap_f64(void *const *ptrs, const int *iargs, void *stream) {
  return launch<double>(ptrs, iargs, stream);
}

}
