// ALE regrid (kernel K1): PPM reconstruction of T and S and the nudge
// of the interface pressures toward their target densities.
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/ale_pallas.py
// regrid_call (ppm_reconstruct_multi + ale.regrid_nudge on VMEM tiles).
// Plain version: blom_tpu_torch/dynamics/ale.py regrid_plain.  The
// monotonic minimum-thickness clamp is the sequential scan, as in the
// plain version (the TPU kernel used the cummax form, ~1 ULP apart).
// The T/S reconstruction takes the tracer limiter (ale.tracer_limiting),
// a template parameter: one instantiation per limiter.
//
// One thread per (j, i) column; neighbouring threads take neighbouring
// i, so every load and store of a (k, j, i) field is coalesced.  The k
// loops run inside the thread over per-thread arrays of ALE_KMAX
// entries (interface pressures, thicknesses, T/S means, edges and
// parabola coefficients, interface densities).  They live in local
// memory, which the hardware interleaves across the threads of a warp,
// so those accesses coalesce too.
//
// What bounds it on an H100: device-memory traffic in principle.  The
// column reads p_src (kk+1), temp, saln and sigmar (kk each) once and
// writes p_dst and smooth_fac (kk+1 each): ~178 MB in f32 at
// 384x360x53, 0.053 ms at 3.35 TB/s, against ~250 operations per cell
// (0.04 ms at 67 TFLOP/s f32).  This first kernel keeps its working set
// in local memory, which goes through L1 and L2 and, past them, device
// memory, so the local traffic and the per-thread serial k loops set its
// time, not the bound.  Making it fast (shared-memory staging of the
// column arrays, fewer live arrays) is later work.
//
// Selected branches only: `kdmx` is a count, `kt` the first interface
// where the condition holds, the density at pmin a search for the first
// source layer containing it (computed only where kt's condition can
// look at it), and the isopycnal-regime nudge is evaluated only for
// interfaces in that regime and only for the case (A, B or C) that
// applies.  The plain version computes every candidate and discards the
// others with `where`; the kept values are the same.

#include "ppm_column.cuh"

namespace {

using namespace ale;

template <typename T>
struct Args {
  const T *p, *temp, *saln, *sigmar;
  T *p_dst, *sfac;
  int kk, ncol, kb, pc_upper, limiter;
  double nudge_fac, dpmin, lim;
  double ap[12];   // ap11..ap16, ap21..ap26
  double plevel[ALE_KMAX];
};

template <typename T>
struct Eos {
  T a11, a12, a13, a14, a15, a16, a21, a22, a23, a24, a25, a26;
  // 2*ap14, 2*ap15, ... as the plain version forms them in double
  T t14, t16, t24, t26;

  __device__ explicit Eos(const double *ap)
      : a11(T(ap[0])), a12(T(ap[1])), a13(T(ap[2])), a14(T(ap[3])),
        a15(T(ap[4])), a16(T(ap[5])), a21(T(ap[6])), a22(T(ap[7])),
        a23(T(ap[8])), a24(T(ap[9])), a25(T(ap[10])), a26(T(ap[11])),
        t14(T(2.0 * ap[3])), t16(T(2.0 * ap[5])), t24(T(2.0 * ap[9])),
        t26(T(2.0 * ap[11])) {}

  __device__ T num(T th, T s) const {
    return a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s;
  }
  __device__ T den(T th, T s) const {
    return a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s;
  }
  // eos.sig
  __device__ T sig(T th, T s) const { return num(th, s) / den(th, s); }
  // eos.dsigdt * dth + eos.dsigds * ds
  __device__ T dsig(T th, T s, T dth, T ds) const {
    const T r1 = num(th, s);
    const T r2i = T(1) / den(th, s);
    const T dt =
        (a12 + t14 * th + a15 * s - (a22 + t24 * th + a25 * s) * r1 * r2i) *
        r2i;
    const T dsv =
        (a13 + a15 * th + t16 * s - (a23 + a25 * th + t26 * s) * r1 * r2i) *
        r2i;
    return dt * dth + dsv * ds;
  }
};

template <typename T, int LIM>
__global__ void __launch_bounds__(128) ale_regrid_kernel(const Args<T> a) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;
  const int kk = a.kk;
  const size_t n = (size_t)a.ncol;
  const Eos<T> eos(a.ap);

  T p[ALE_KMAX + 1], dx[ALE_KMAX];
  T tmT[ALE_KMAX], telT[ALE_KMAX], terT[ALE_KMAX];
  T tmS[ALE_KMAX], telS[ALE_KMAX], terS[ALE_KMAX];
  T sig_up[ALE_KMAX], sig_lo[ALE_KMAX], sg[ALE_KMAX];

  for (int k = 0; k <= kk; ++k) p[k] = a.p[k * n + col];
  for (int k = 0; k < kk; ++k) {
    dx[k] = fmx(p[k + 1] - p[k], T(0)) + T(kHeps);
    tmT[k] = a.temp[k * n + col];
    tmS[k] = a.saln[k * n + col];
    sg[k] = a.sigmar[k * n + col];
  }

  // --- PPM reconstruction of T and S (shared edge weights)
  for (int q = 0; q <= kk; ++q) {
    T w1, w2, w3, w4;
    edge_weights(dx, kk, q, w1, w2, w3, w4);
    const T eT = edge_value(tmT, kk, q, w1, w2, w3, w4);
    const T eS = edge_value(tmS, kk, q, w1, w2, w3, w4);
    if (q < kk) {
      telT[q] = eT;
      telS[q] = eS;
    }
    if (q > 0) {
      terT[q - 1] = eT;
      terS[q - 1] = eS;
    }
  }
  limit_and_fit<LIM>(kk, dx, tmT, telT, terT, a.pc_upper != 0);
  limit_and_fit<LIM>(kk, dx, tmS, telS, terS, a.pc_upper != 0);
  // now tel = c0, tm = c1, ter = c2

  // --- regrid_nudge
  const T p_bot = p[kk];
  // the densest lower-interface density of a wet layer, 0 when there is
  // none or it is not finite (amax over where(wet, sig_lo, -inf))
  T sig_max = T(0);
  bool any_wet = false;
  for (int k = 0; k < kk; ++k) {
    sig_up[k] = eos.sig(telT[k], telS[k]);
    sig_lo[k] = eos.sig(telT[k] + tmT[k] + terT[k],
                        telS[k] + tmS[k] + terS[k]);
    if (p[k + 1] - p[k] > T(kEpsilp)) {
      sig_max = any_wet ? fmx(sig_max, sig_lo[k]) : sig_lo[k];
      any_wet = true;
    }
  }
  if (!is_finite(sig_max)) sig_max = T(0);

  int kdmx = 0;
  for (int k = 0; k < kk; ++k) kdmx += sg[k] < sig_max;
  if (kdmx < 1) kdmx = 1;

  // transition interface kt (1-based): first k > kb, k <= kdmx with
  // sigmar(k) > the density at pmin(k)
  int kt = kdmx + 1;
  for (int k = a.kb; k < kdmx; ++k) {     // 0-based k: k+1 in (kb, kdmx]
    const T pq = fmn(T(a.plevel[k]) + p[0], p_bot);
    T spm = sig_lo[kk - 1];                 // below the column
    for (int l = 0; l < kk; ++l) {
      const T dpl = p[l + 1] - p[l];
      if (pq >= p[l] && pq < p[l] + dpl) {
        const T dpi = T(1) / fmx(dpl, T(kEpsilp));
        const T w = fmn(fmx((pq - p[l]) * dpi, T(0)), T(1));
        spm = (T(1) - w) * sig_up[l] + w * sig_lo[l];
        break;
      }
    }
    if (sg[k] > spm) {
      kt = k + 1;
      break;
    }
  }

  const T nf = T(a.nudge_fac);
  const T lim = T(a.lim);
  const T rlim = T(1) / lim;
  const T dpmin = T(a.dpmin);

  // dsig_trg(k) = max(sigmar(k+1) - sigmar(k), 1e-12), the last repeated
  auto dsig_trg = [&](int k) -> T {
    const T d = k < kk - 1 ? sg[k + 1] - sg[k] : sg[kk - 1] - sg[kk - 2];
    return fmx(d, T(1e-12));
  };

  a.p_dst[col] = p[0];
  a.sfac[col] = T(1);
  T prev = p[0];
  for (int i = 0; i < kk - 1; ++i) {        // interface kif = i+2 (1-based)
    const int kif = i + 2;
    const T pmn = fmn(T(a.plevel[i + 1]) + p[0], p_bot);
    T cand, sf;
    if (kif < kt) {
      cand = p[i + 1] + nf * (pmn - p[i + 1]);
      sf = T(1);
    } else if (kif <= kdmx) {
      const T su = sig_lo[i], sl = sig_up[i + 1], st = sg[i + 1];
      const T dst_km1 = dsig_trg(i), dst_k = dsig_trg(i + 1);
      const T dp_up_raw = p[i + 1] - p[i];
      const T dp_lo_raw = p[i + 2] - p[i + 1];
      // d(sig)/dx at the lower edge of layer i and the upper of i+1
      auto dsdx_up = [&]() {
        const T tlo = telT[i] + tmT[i] + terT[i];
        const T slo = telS[i] + tmS[i] + terS[i];
        return eos.dsig(tlo, slo, tmT[i] + T(2) * terT[i],
                        tmS[i] + T(2) * terS[i]);
      };
      auto dsdx_lo = [&]() {
        return eos.dsig(telT[i + 1], telS[i + 1], tmT[i + 1], tmS[i + 1]);
      };
      auto up = [&](T dsig, T raw, T dstv, T &stab) {
        stab = raw / dstv;
        const T dsigdx = dstv * fmx(stab, lim);
        return fmx(dsig * nf / dsigdx, T(-.5)) * dp_up_raw;
      };
      auto dn = [&](T dsig, T raw, T dstv, T &stab) {
        stab = raw / dstv;
        const T dsigdx = dstv * fmx(stab, lim);
        return fmn(dsig * nf / dsigdx, T(.5)) * dp_lo_raw;
      };
      T delta, stab;
      if (st < su && st < sl) {             // case A
        delta = up(st - su, dsdx_up(), dst_km1, stab);
      } else if (st > su && st > sl) {      // case B
        delta = dn(st - sl, dsdx_lo(), dst_k, stab);
      } else {                              // case C
        const T du = dsdx_up(), dl = dsdx_lo();
        const T dp_up = fmx(dp_up_raw, T(kEpsilp));
        const T dp_lo = fmx(dp_lo_raw, T(kEpsilp));
        T si = ((sl + T(.5) * dl) * dp_up + (su - T(.5) * du) * dp_lo) /
               (dp_up + dp_lo);
        si = fmn(fmx(si, fmn(su, sl)), fmx(su, sl));
        const T dsigC = st - si;
        if (dsigC < T(0))
          delta = up(dsigC, du + T(2) * (si - su), dst_km1, stab);
        else
          delta = dn(dsigC, dl + T(2) * (sl - si), dst_k, stab);
      }
      cand = p[i + 1] + delta;
      sf = fmn(fmx((lim - stab) * rlim, T(0)), T(1));
    } else {
      cand = p_bot;
      sf = T(0);
    }
    prev = fmn(fmx(fmx(cand, pmn), prev + dpmin), p_bot);
    a.p_dst[(i + 1) * n + col] = prev;
    a.sfac[(i + 1) * n + col] = sf;
  }
  a.p_dst[kk * n + col] = p_bot;
  a.sfac[kk * n + col] = T(0);
}

template <typename T>
int launch(void *const *ptrs, const int *iargs, const double *dargs,
           void *stream) {
  Args<T> a;
  a.p = (const T *)ptrs[0];
  a.temp = (const T *)ptrs[1];
  a.saln = (const T *)ptrs[2];
  a.sigmar = (const T *)ptrs[3];
  a.p_dst = (T *)ptrs[4];
  a.sfac = (T *)ptrs[5];
  a.kk = iargs[0];
  a.ncol = iargs[1];
  a.kb = iargs[2];
  a.pc_upper = iargs[3];
  a.limiter = iargs[4];
  if (a.kk < 3 || a.kk > ALE_KMAX || a.limiter < 0 || a.limiter >= N_LIM)
    return (int)cudaErrorInvalidValue;
  a.nudge_fac = dargs[0];
  a.dpmin = dargs[1];
  a.lim = dargs[2];
  for (int i = 0; i < 12; ++i) a.ap[i] = dargs[3 + i];
  for (int k = 0; k < ALE_KMAX; ++k)
    a.plevel[k] = k < a.kk ? dargs[15 + k] : 0.;
  const int threads = 128;
  const int blocks = (a.ncol + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a.limiter) {
    case LIM_MONOTONIC:
      ale_regrid_kernel<T, LIM_MONOTONIC><<<blocks, threads, 0, s>>>(a);
      break;
    case LIM_NON_OSCILLATORY:
      ale_regrid_kernel<T, LIM_NON_OSCILLATORY><<<blocks, threads, 0, s>>>(a);
      break;
    default:
      ale_regrid_kernel<T, LIM_POSDEF><<<blocks, threads, 0, s>>>(a);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: p_src, temp, saln, sigmar, p_dst, smooth_fac.
// iargs: kk, ncol (= J*I), k_range_plevel, tracer_pc_upper, tracer
// limiter (0 monotonic, 1 non_oscillatory, 2 non_oscillatory_posdef).
// dargs: nudge_fac, dpmin_interior, stab_fac_limit, ap11..ap16,
// ap21..ap26, plevel[0..kk-1].
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for kk
// outside [3, ALE_KMAX] or an unknown limiter.
int ale_regrid_f32(void *const *ptrs, const int *iargs, const double *dargs,
                   void *stream) {
  return launch<float>(ptrs, iargs, dargs, stream);
}

int ale_regrid_f64(void *const *ptrs, const int *iargs, const double *dargs,
                   void *stream) {
  return launch<double>(ptrs, iargs, dargs, stream);
}

}
