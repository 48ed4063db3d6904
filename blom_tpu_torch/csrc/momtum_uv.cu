// Momentum-equation stencil core, in the three vorticity schemes of
// mommth: enstrophy-conserving (enscon), energy-conserving (enecon) and
// energy-conserving with upwind-selected mass fluxes (enedis).
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/momtum_pallas.py
// (momtum_uv_pallas / _make_kernel, which runs momtum._uv_body on
// VMEM-resident (k, J, I) planes).  Plain version:
// blom_tpu_torch/dynamics/momtum.py _uv_body; the arithmetic below is the
// same program, written per point.
//
// The body chains +-1 stencils in i and j through more than 60
// temporaries, and each stage reads the previous stage at its
// neighbours.  It is split into three kernels, one thread per (k, j, i)
// point each:
//   1. the total velocities utotm, vtotm, utotn, vtotn and the thickness
//      maxima dpmx (pointwise);
//   2. dl2u, dl2v, potential vorticity, defor1, defor2 and kinetic energy;
//   3. the viscosities, momentum fluxes, Coriolis, bottom stress and
//      u_new, v_new.
// The eleven staged fields (fifteen for enedis, whose minimum and
// maximum mass fluxes at u and v points stage 2 computes once, rather
// than stage 3 at four neighbours each) go to a scratch tensor that the
// wrapper allocates.  The scheme is a template parameter of stages 2 and
// 3 (MOM_ENSCON, MOM_ENECON, MOM_ENEDIS); it changes only the Coriolis
// terms and, for enedis, the staged flux bounds.  Everything else
// (side-wall weights, auxiliary velocities, viscosities, the longitudinal
// fluxes) is recomputed where it is read, by functions that return zero
// past a closed edge and wrap a periodic one, exactly as the plain
// version's shifted fields do.
//
// What bounds it on an H100: device-memory traffic.  The inputs are 17
// (k, j, i) fields, 12 (j, i) fields and 21 metric planes, the outputs 2
// (k, j, i) fields; the staging adds 11 fields written once and read back
// (from L2 for the most part, since neighbours in i and j are read by
// neighbouring threads).  Staging every field that is read at many
// neighbours keeps the recomputation to a few hundred flops per point.
//
// Build with -fmad=false so that each operation rounds as the plain
// version's separate tensor operations do.

#include <cuda_runtime.h>

namespace {

enum { K_UTOTM, K_VTOTM, K_UTOTN, K_VTOTN, K_DPMX,
       K_DL2U, K_DL2V, K_POTVOR, K_DEFOR1, K_DEFOR2, K_KE, N_SCRATCH,
       // enedis only
       K_UHMIN = N_SCRATCH, K_UHMAX, K_VHMIN, K_VHMAX, N_SCRATCH_ENEDIS };

enum { MOM_ENSCON, MOM_ENECON, MOM_ENEDIS };

enum { F_U_M, F_U_N, F_V_M, F_V_N, F_DP_M, F_DPU_M, F_DPV_M, F_P_LO, F_P_HI,
       F_PU_LO, F_PU_HI, F_PV_LO, F_PV_HI, F_STRESS_U, F_STRESS_V, F_PGF_U,
       F_PGF_V, N_F };

enum { D_UBFLXS_M, D_UBFLXS_N, D_VBFLXS_M, D_VBFLXS_N, D_PBU_M, D_PBV_M,
       D_PBU_N, D_PBV_N, D_DRAG, D_UBRHS, D_VBRHS, D_DIFWGT, N_D };

enum { G_IP, G_IU, G_IV, G_IQ, G_SCUX, G_SCUY, G_SCVX, G_SCVY, G_SCUXI,
       G_SCVYI, G_SCU2, G_SCV2, G_SCP2I, G_SCQ2I, G_SCPX, G_SCPY, G_SCQX,
       G_SCQY, G_DIFMXP, G_DIFMXQ, G_CORIOQ, N_G };

template <typename T>
struct Args {
  const T *f[N_F];
  const T *d[N_D];
  const T *g[N_G];
  T *scratch;
  T *u_new, *v_new;
  T tsfac, delt1;
  T mdv2hi, mdv2lo, mdv4hi, mdv4lo, vsc2hi, vsc2lo, vsc4hi, vsc4lo;
  int kk, J, I, periodic_i, periodic_j;
};

template <typename T>
__device__ __forceinline__ T fab(T x) {
  return x < T(0) ? -x : x;
}

template <typename T>
__device__ __forceinline__ T fmn(T a, T b) {
  return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T fmx(T a, T b) {
  return b > a ? b : a;
}

template <typename T>
__device__ __forceinline__ T clip01(T x) {
  return fmn(fmx(x, T(0)), T(1));
}

template <typename T>
__device__ __forceinline__ T hfharm(T a, T b) {
  return a * b / (a + b);
}

__device__ __forceinline__ float fsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double fsqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T sq(T x) {
  return x * x;
}

// One k-level of the body; every function of (j, i) returns the value
// the plain version's field has there after its shifts: zero past a
// closed edge, wrapped on a periodic axis.
template <typename T>
struct Body {
  const Args<T> &a;
  long k3;   // offset of the k-level
  long JI;

  __device__ Body(const Args<T> &a_, int k)
      : a(a_), k3((long)k * a_.J * a_.I), JI((long)a_.J * a_.I) {}

  static constexpr T slip = T(-1);
  static constexpr T cutoff = T(9806.);          // onem
  static constexpr T onemm = T(9.806);
  static constexpr T thkbop = T(10. * 9806.);    // thkbot * onem
  static constexpr T epsilp = T(1e-12);
  static constexpr T epsilpl = T(1e-14);

  // reads reach at most two points past an edge, so one add or
  // subtract wraps a periodic index
  __device__ __forceinline__ bool wrap(int &j, int &i) const {
    if (i < 0 || i >= a.I) {
      if (!a.periodic_i) return false;
      i += i < 0 ? a.I : -a.I;
    }
    if (j < 0 || j >= a.J) {
      if (!a.periodic_j) return false;
      j += j < 0 ? a.J : -a.J;
    }
    return true;
  }
  // raw reads at a valid point
  __device__ __forceinline__ T F(int n, int j, int i) const {
    return a.f[n][k3 + (long)j * a.I + i];
  }
  __device__ __forceinline__ T D(int n, int j, int i) const {
    return a.d[n][(long)j * a.I + i];
  }
  __device__ __forceinline__ T G(int n, int j, int i) const {
    return a.g[n][(long)j * a.I + i];
  }
  __device__ __forceinline__ T S(int n, int j, int i) const {
    return a.scratch[n * a.kk * JI + k3 + (long)j * a.I + i];
  }
  // shifted reads: zero past a closed edge
  __device__ __forceinline__ T Fo(int n, int j, int i) const {
    return wrap(j, i) ? F(n, j, i) : T(0);
  }
  __device__ __forceinline__ T Do(int n, int j, int i) const {
    return wrap(j, i) ? D(n, j, i) : T(0);
  }
  __device__ __forceinline__ T Go(int n, int j, int i) const {
    return wrap(j, i) ? G(n, j, i) : T(0);
  }
  __device__ __forceinline__ T So(int n, int j, int i) const {
    return wrap(j, i) ? S(n, j, i) : T(0);
  }

  // ---- total velocities at a valid point (mod_momtum.F90:388-432);
  // stage 1 stores them, later stages read the staged fields
  __device__ __forceinline__ T tot(int fv, int fb, int dpb, int gs, int gm,
                                   int j, int i) const {
    const T s = fmx(D(dpb, j, i) * G(gs, j, i), epsilpl);
    return (F(fv, j, i) + D(fb, j, i) * a.tsfac / s) * G(gm, j, i);
  }
  __device__ __forceinline__ T utotm(int j, int i) const {
    return So(K_UTOTM, j, i);
  }
  __device__ __forceinline__ T vtotm(int j, int i) const {
    return So(K_VTOTM, j, i);
  }
  __device__ __forceinline__ T utotn(int j, int i) const {
    return So(K_UTOTN, j, i);
  }
  __device__ __forceinline__ T vtotn(int j, int i) const {
    return So(K_VTOTN, j, i);
  }
  __device__ T uflux0(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    return S(K_UTOTM, j, i) * fmx(F(F_DPU_M, j, i), cutoff) * G(G_IU, j, i);
  }
  __device__ T vflux0(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    return S(K_VTOTM, j, i) * fmx(F(F_DPV_M, j, i), cutoff) * G(G_IV, j, i);
  }

  // ---- side-wall weights and auxiliary velocities (:434-470)
  __device__ T wgtja(int j, int i) const {
    const T hi = F(F_PU_HI, j, i);
    return clip01((hi - Do(D_PBU_M, j - 1, i))
                  / fmx(hi - F(F_PU_LO, j, i), epsilp));
  }
  __device__ T wgtjb(int j, int i) const {
    const T hi = F(F_PU_HI, j, i);
    return clip01((hi - Do(D_PBU_M, j + 1, i))
                  / fmx(hi - F(F_PU_LO, j, i), epsilp));
  }
  __device__ T wgtia(int j, int i) const {
    const T hi = F(F_PV_HI, j, i);
    return clip01((hi - Do(D_PBV_M, j, i - 1))
                  / fmx(hi - F(F_PV_LO, j, i), epsilp));
  }
  __device__ T wgtib(int j, int i) const {
    const T hi = F(F_PV_HI, j, i);
    return clip01((hi - Do(D_PBV_M, j, i + 1))
                  / fmx(hi - F(F_PV_LO, j, i), epsilp));
  }
  __device__ T uja(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T w = wgtja(j, i);
    return (T(1) - w) * utotn(j - 1, i) + w * slip * utotn(j, i);
  }
  __device__ T ujb(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T w = wgtjb(j, i);
    return (T(1) - w) * utotn(j + 1, i) + w * slip * utotn(j, i);
  }
  __device__ T via(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T w = wgtia(j, i);
    return (T(1) - w) * vtotn(j, i - 1) + w * slip * vtotn(j, i);
  }
  __device__ T vib(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T w = wgtib(j, i);
    return (T(1) - w) * vtotn(j, i + 1) + w * slip * vtotn(j, i);
  }

  // ---- neighbourhood thickness maxima at q (:355-396)
  __device__ T du_(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    return G(G_IU, j, i) * (F(F_DP_M, j, i) + Fo(F_DP_M, j, i - 1));
  }
  __device__ T dv_(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    return G(G_IV, j, i) * (F(F_DP_M, j, i) + Fo(F_DP_M, j - 1, i));
  }
  __device__ T dpmx_at(int j, int i) const {   // at a valid point
    const T m = fmx(fmx(fmx(du_(j, i), du_(j - 1, i)), dv_(j, i)),
                    dv_(j, i - 1));
    return fmx(m, T(8) * cutoff);
  }
  __device__ __forceinline__ T dpmx(int j, int i) const {
    return So(K_DPMX, j, i);
  }

  // ---- potential vorticity at q (:473-575)
  __device__ T potvor(int j, int i) const {
    const T iu = G(G_IU, j, i), iv = G(G_IV, j, i), iq = G(G_IQ, j, i);
    const T iv_w = Go(G_IV, j, i - 1), iu_s = Go(G_IU, j - 1, i);
    const T scvy = G(G_SCVY, j, i), scux = G(G_SCUX, j, i);
    const T Vv = vtotm(j, i) * scvy;
    const T Uu = utotm(j, i) * scux;
    const T Vv_w = vtotm(j, i - 1) * Go(G_SCVY, j, i - 1);
    const T Uu_s = utotm(j - 1, i) * Go(G_SCUX, j - 1, i);
    const T scq2i = G(G_SCQ2I, j, i);
    T vort;
    if (iq > T(0)) {
      vort = (Vv - Vv_w - (Uu - Uu_s)) * scq2i;
    } else {
      const T v_e = iv > T(0) ? Vv : slip * Vv_w;
      const T v_w = iv_w > T(0) ? Vv_w : slip * Vv;
      const T u_nn = iu > T(0) ? Uu : slip * Uu_s;
      const T u_ss = iu_s > T(0) ? Uu_s : slip * Uu;
      vort = (v_e - v_w - (u_nn - u_ss)) * scq2i;
    }
    const T absvor = vort + G(G_CORIOQ, j, i);

    const T dp = F(F_DP_M, j, i);
    const T dp_w = Fo(F_DP_M, j, i - 1), dp_s = Fo(F_DP_M, j - 1, i);
    const T dpmx0 = dpmx(j, i);
    T dpvor;
    if (iq > T(0)) {
      const T dp_sw = Fo(F_DP_M, j - 1, i - 1);
      dpvor = T(.125) * fmx(T(2) * (dp + dp_w + dp_s + dp_sw),
                            fmx(fmx(dpmx0, dpmx(j, i - 1)),
                                fmx(fmx(dpmx(j, i + 1), dpmx(j - 1, i)),
                                    dpmx(j + 1, i))));
    } else {
      dpvor = cutoff;
      if (iv > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp + dp_s),
                              fmx(dpmx0, dpmx(j, i + 1)));
      if (iv_w > T(0)) {
        // im1(dp_m + jm1(dp_m))
        int jj = j, ii = i - 1;
        const T x = wrap(jj, ii) ? F(F_DP_M, jj, ii)
                                       + Fo(F_DP_M, jj - 1, ii) : T(0);
        dpvor = T(.125) * fmx(T(4) * x, fmx(dpmx(j, i - 1), dpmx0));
      }
      if (iu > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp + dp_w),
                              fmx(dpmx0, dpmx(j + 1, i)));
      if (iu_s > T(0)) {
        // jm1(dp_m + im1(dp_m))
        int jj = j - 1, ii = i;
        const T x = wrap(jj, ii) ? F(F_DP_M, jj, ii)
                                       + Fo(F_DP_M, jj, ii - 1) : T(0);
        dpvor = T(.125) * fmx(T(4) * x, fmx(dpmx(j - 1, i), dpmx0));
      }
    }
    return absvor / dpvor;
  }

  // ---- defor2 at q (:537-584)
  __device__ T defor2(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T scq2i = G(G_SCQ2I, j, i);
    if (G(G_IQ, j, i) > T(0)) {
      return sq(vib(j, i - 1) * G(G_SCVY, j, i) - via(j, i) * Go(G_SCVY, j, i - 1)
                + ujb(j - 1, i) * G(G_SCUX, j, i)
                - uja(j, i) * Go(G_SCUX, j - 1, i)) * scq2i;
    }
    const T Vn = vtotn(j, i) * G(G_SCVY, j, i);
    const T Un = utotn(j, i) * G(G_SCUX, j, i);
    const T Vn_w = vtotn(j, i - 1) * Go(G_SCVY, j, i - 1);
    const T Un_s = utotn(j - 1, i) * Go(G_SCUX, j - 1, i);
    const T ve = G(G_IV, j, i) > T(0) ? Vn : slip * Vn_w;
    const T vw = Go(G_IV, j, i - 1) > T(0) ? Vn_w : slip * Vn;
    const T un = G(G_IU, j, i) > T(0) ? Un : slip * Un_s;
    const T us = Go(G_IU, j - 1, i) > T(0) ? Un_s : slip * Un;
    return sq(ve - vw + un - us) * scq2i;
  }

  // ---- deformation-dependent viscosities (:790-804): (vsc2, vsc4) at
  // u (uv = true) or v points, zero past a closed edge
  __device__ void vsc(bool uv, int j, int i, T &v2, T &v4) const {
    v2 = v4 = T(0);
    if (!wrap(j, i)) return;
    const int jo = uv ? j : j - 1, io = uv ? i - 1 : i;
    const T qw = T(.5) * (Do(D_DIFWGT, jo, io) + D(D_DIFWGT, j, i));
    const T deform = fsqrt(T(.5) * (S(K_DEFOR1, j, i) + So(K_DEFOR1, jo, io)
                                    + S(K_DEFOR2, j, i)
                                    + (uv ? So(K_DEFOR2, j + 1, i)
                                          : So(K_DEFOR2, j, i + 1))));
    v2 = fmx(qw * a.mdv2hi + (T(1) - qw) * a.mdv2lo,
             (qw * a.vsc2hi + (T(1) - qw) * a.vsc2lo) * deform);
    v4 = fmx(qw * a.mdv4hi + (T(1) - qw) * a.mdv4lo,
             (qw * a.vsc4hi + (T(1) - qw) * a.vsc4lo) * deform);
  }

  // ---- longitudinal momentum fluxes at p (:821-836)
  __device__ T uflux1(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T iu = G(G_IU, j, i), iu_e = Go(G_IU, j, i + 1);
    if (!(iu + iu_e > T(0))) return T(0);
    T v2, v4, v2e, v4e;
    vsc(true, j, i, v2, v4);
    vsc(true, j, i + 1, v2e, v4e);
    const T v2a = iu > T(0) ? v2 : v2e, v2b = iu_e > T(0) ? v2e : v2;
    const T v4a = iu > T(0) ? v4 : v4e, v4b = iu_e > T(0) ? v4e : v4;
    const T harm = hfharm(fmx(F(F_DPU_M, j, i), onemm),
                          fmx(Fo(F_DPU_M, j, i + 1), onemm));
    const T difmxp = G(G_DIFMXP, j, i), scpy = G(G_SCPY, j, i);
    return fmn(difmxp, (v2a + v2b) * scpy) * harm
               * (utotn(j, i) - utotn(j, i + 1))
           + fmn(T(.125) * difmxp, (v4a + v4b) * scpy) * harm
               * (S(K_DL2U, j, i) - So(K_DL2U, j, i + 1));
  }
  __device__ T vflux1(int j, int i) const {
    if (!wrap(j, i)) return T(0);
    const T iv = G(G_IV, j, i), iv_n = Go(G_IV, j + 1, i);
    if (!(iv + iv_n > T(0))) return T(0);
    T v2, v4, v2n, v4n;
    vsc(false, j, i, v2, v4);
    vsc(false, j + 1, i, v2n, v4n);
    const T v2a = iv > T(0) ? v2 : v2n, v2b = iv_n > T(0) ? v2n : v2;
    const T v4a = iv > T(0) ? v4 : v4n, v4b = iv_n > T(0) ? v4n : v4;
    const T harm = hfharm(fmx(F(F_DPV_M, j, i), onemm),
                          fmx(Fo(F_DPV_M, j + 1, i), onemm));
    const T difmxp = G(G_DIFMXP, j, i), scpx = G(G_SCPX, j, i);
    return fmn(difmxp, (v2a + v2b) * scpx) * harm
               * (vtotn(j, i) - vtotn(j + 1, i))
           + fmn(T(.125) * difmxp, (v4a + v4b) * scpx) * harm
               * (S(K_DL2V, j, i) - So(K_DL2V, j + 1, i));
  }
  __device__ T ke_term(int j, int i) const {   // scu2 * utotm**2
    if (!wrap(j, i)) return T(0);
    return G(G_SCU2, j, i) * sq(S(K_UTOTM, j, i));
  }
  __device__ T kv_term(int j, int i) const {   // scv2 * vtotm**2
    if (!wrap(j, i)) return T(0);
    return G(G_SCV2, j, i) * sq(S(K_VTOTM, j, i));
  }
};

// enedis: the minimum and maximum of the centred mass flux hc and the
// upstream-limited flux hm, hc first pulled toward hm (hminmax,
// mod_momtum.F90:664-712); the constants are the plain version's
// (1 - c2*3 = -.5, 1 - c3*slp = 0)
template <typename T>
__device__ __forceinline__ void hminmax(T hc, T hm, T &lo, T &hi) {
  const T hm2 = fab(hc) < T(.1) * fab(hm) ? T(10) * hc : hm;
  T hc2 = hc;
  if (fab(hc) > T(.25) * fab(hm2)) {
    if (fab(hc) < T(.5) * fab(hm2))
      hc2 = T(3) * hc + T(-.5) * hm2;
    else if (fab(hc) <= T(2) * fab(hm2))
      hc2 = hm2;
    else
      hc2 = T(.5) * hc + T(0) * hm2;
  }
  lo = fmn(hc2, hm2);
  hi = fmx(hc2, hm2);
}

// enedis: pv times the flux bound upstream of the advecting velocity
// sg, the mean of both bounds where pv*sg is zero
template <typename T>
__device__ __forceinline__ T upw(T pv, T sg, T hmx, T hmn, bool flip) {
  const T s = pv * sg;
  const T sel = s == T(0) ? T(.5) * (hmx + hmn)
                          : (((s < T(0)) != flip) ? hmx : hmn);
  return pv * sel;
}

template <typename T>
__device__ __forceinline__ bool point(const Args<T> &a, int &k, int &j,
                                      int &i) {
  i = blockIdx.x * blockDim.x + threadIdx.x;
  j = blockIdx.y;
  k = blockIdx.z;
  return i < a.I;
}

// stage 1: total velocities and dpmx
template <typename T>
__global__ void momtum_stage1(Args<T> a) {
  int k, j, i;
  if (!point(a, k, j, i)) return;
  Body<T> b(a, k);
  const long o = b.k3 + (long)j * a.I + i;
  const long NK = (long)a.kk * b.JI;
  T *S = a.scratch;
  S[K_UTOTM * NK + o] = b.tot(F_U_M, D_UBFLXS_M, D_PBU_M, G_SCUY, G_IU, j, i);
  S[K_VTOTM * NK + o] = b.tot(F_V_M, D_VBFLXS_M, D_PBV_M, G_SCVX, G_IV, j, i);
  S[K_UTOTN * NK + o] = b.tot(F_U_N, D_UBFLXS_N, D_PBU_N, G_SCUY, G_IU, j, i);
  S[K_VTOTN * NK + o] = b.tot(F_V_N, D_VBFLXS_N, D_PBV_N, G_SCVX, G_IV, j, i);
  S[K_DPMX * NK + o] = b.dpmx_at(j, i);
}

// stage 2: dl2u, dl2v, potvor, defor1, defor2, ke; for enedis the flux
// bounds
template <typename T, int MOM>
__global__ void momtum_stage2(Args<T> a) {
  int k, j, i;
  if (!point(a, k, j, i)) return;
  Body<T> b(a, k);
  const long o = b.k3 + (long)j * a.I + i;
  const long NK = (long)a.kk * b.JI;
  T *S = a.scratch;

  const T utn = b.S(K_UTOTN, j, i), vtn = b.S(K_VTOTN, j, i);
  S[K_DL2U * NK + o] = (utn - T(.25) * (b.utotn(j, i + 1) + b.utotn(j, i - 1)
                                        + b.uja(j, i) + b.ujb(j, i)))
                       * b.G(G_IU, j, i);
  S[K_DL2V * NK + o] = (vtn - T(.25) * (b.vtotn(j + 1, i) + b.vtotn(j - 1, i)
                                        + b.via(j, i) + b.vib(j, i)))
                       * b.G(G_IV, j, i);
  S[K_POTVOR * NK + o] = b.potvor(j, i);
  S[K_DEFOR1 * NK + o] =
      sq((b.utotn(j, i + 1) * b.Go(G_SCUY, j, i + 1) - utn * b.G(G_SCUY, j, i))
         - (b.vtotn(j + 1, i) * b.Go(G_SCVX, j + 1, i)
            - vtn * b.G(G_SCVX, j, i)))
      * b.G(G_SCP2I, j, i);
  S[K_DEFOR2 * NK + o] = b.defor2(j, i);
  S[K_KE * NK + o] = T(.25) * (b.ke_term(j, i) + b.ke_term(j, i + 1)
                               + b.kv_term(j, i) + b.kv_term(j + 1, i))
                     * b.G(G_SCP2I, j, i);
  if constexpr (MOM == MOM_ENEDIS) {
    const T dp = b.F(F_DP_M, j, i);
    T lo, hi;
    hminmax(T(.5) * b.S(K_UTOTM, j, i) * (dp + b.Fo(F_DP_M, j, i - 1)),
            b.uflux0(j, i), lo, hi);
    S[K_UHMIN * NK + o] = lo;
    S[K_UHMAX * NK + o] = hi;
    hminmax(T(.5) * b.S(K_VTOTM, j, i) * (dp + b.Fo(F_DP_M, j - 1, i)),
            b.vflux0(j, i), lo, hi);
    S[K_VHMIN * NK + o] = lo;
    S[K_VHMAX * NK + o] = hi;
  }
}

// stage 3: fluxes, Coriolis, bottom stress and the update (:838-1152)
template <typename T, int MOM>
__global__ void momtum_stage3(Args<T> a) {
  int k, j, i;
  if (!point(a, k, j, i)) return;
  Body<T> b(a, k);
  const long o = b.k3 + (long)j * a.I + i;
  const T slip = Body<T>::slip, onemm = Body<T>::onemm;
  const T thkbop = Body<T>::thkbop;
  const T delt1 = a.delt1;
  const T potvor = b.S(K_POTVOR, j, i);
  const T ke = b.S(K_KE, j, i);
  const T drag = b.D(D_DRAG, j, i);

  // ================= u equation =================
  {
    const T iu = b.G(G_IU, j, i);
    const T utn = b.utotn(j, i);
    const T wja = b.wgtja(j, i), wjb = b.wgtjb(j, i);
    const T uja = b.uja(j, i), ujb = b.ujb(j, i);
    const T dl2u = b.S(K_DL2U, j, i);
    const T dl2uja = (T(1) - wja) * b.So(K_DL2U, j - 1, i) + wja * slip * dl2u;
    const T dl2ujb = (T(1) - wjb) * b.So(K_DL2U, j + 1, i) + wjb * slip * dl2u;
    T v2, v4, v2s, v4s, v2n, v4n;
    b.vsc(true, j, i, v2, v4);
    b.vsc(true, j - 1, i, v2s, v4s);
    b.vsc(true, j + 1, i, v2n, v4n);
    const bool ws = b.Go(G_IU, j - 1, i) > T(0);
    const bool wn = b.Go(G_IU, j + 1, i) > T(0);
    const T v2a = ws ? v2s : v2, v4a = ws ? v4s : v4;
    const T v2b = wn ? v2n : v2, v4b = wn ? v4n : v4;
    const T dpxy = fmx(b.F(F_DPU_M, j, i), onemm);
    T dpja = fmx(b.Fo(F_DPU_M, j - 1, i), onemm);
    dpja = dpja + wja * (dpxy - dpja);
    T dpjb = fmx(b.Fo(F_DPU_M, j + 1, i), onemm);
    dpjb = dpjb + wjb * (dpxy - dpjb);
    const T difmxq = b.G(G_DIFMXQ, j, i), scqx = b.G(G_SCQX, j, i);
    const T difmxq_n = b.Go(G_DIFMXQ, j + 1, i), scqx_n = b.Go(G_SCQX, j + 1, i);
    const T uflux2 = (fmn(difmxq, (v2 + v2a) * scqx) * hfharm(dpja, dpxy)
                          * (uja - utn)
                      + fmn(T(.125) * difmxq, (v4 + v4a) * scqx)
                          * hfharm(dpja, dpxy) * (dl2uja - dl2u)) * iu;
    const T uflux3 = (fmn(difmxq_n, (v2 + v2b) * scqx_n) * hfharm(dpjb, dpxy)
                          * (utn - ujb)
                      + fmn(T(.125) * difmxq_n, (v4 + v4b) * scqx_n)
                          * hfharm(dpjb, dpxy) * (dl2u - dl2ujb)) * iu;

    const T pbu_m = b.D(D_PBU_M, j, i);
    const T ptopl = T(.5) * (fmn(pbu_m, b.F(F_P_LO, j, i))
                             + fmn(pbu_m, b.Fo(F_P_LO, j, i - 1)));
    const T pbotl = T(.5) * (fmn(pbu_m, b.F(F_P_HI, j, i))
                             + fmn(pbu_m, b.Fo(F_P_HI, j, i - 1)));
    const T qbot = T(.5) * (drag + b.Do(D_DRAG, j, i - 1))
                   * (fmx(pbu_m - thkbop, pbotl)
                      - fmx(pbu_m - thkbop, fmn(ptopl, pbotl - onemm)))
                   / fmx(b.F(F_DPU_M, j, i), onemm);
    const T botstr = -utn * qbot / (T(1) + delt1 * qbot);

    // Coriolis term (mod_momtum.F90:719-784)
    T cau;
    if constexpr (MOM == MOM_ENSCON) {
      cau = T(.125) * (b.vflux0(j, i) + b.vflux0(j + 1, i)
                       + b.vflux0(j, i - 1) + b.vflux0(j + 1, i - 1))
            * (potvor + b.So(K_POTVOR, j + 1, i)) * iu;
    } else if constexpr (MOM == MOM_ENECON) {
      cau = T(.25) * ((b.vflux0(j, i) + b.vflux0(j, i - 1)) * potvor
                      + (b.vflux0(j + 1, i) + b.vflux0(j + 1, i - 1))
                        * b.So(K_POTVOR, j + 1, i)) * iu;
    } else {
      const T utm = b.S(K_UTOTM, j, i);
      const T t1 = upw(b.So(K_POTVOR, j + 1, i), utm,
                       b.So(K_VHMAX, j + 1, i) + b.So(K_VHMAX, j + 1, i - 1),
                       b.So(K_VHMIN, j + 1, i) + b.So(K_VHMIN, j + 1, i - 1),
                       false);
      const T t2 = upw(potvor, utm,
                       b.S(K_VHMAX, j, i) + b.So(K_VHMAX, j, i - 1),
                       b.S(K_VHMIN, j, i) + b.So(K_VHMIN, j, i - 1), false);
      cau = T(.25) * (t1 + t2) * iu;
    }

    a.u_new[o] = (b.F(F_U_N, j, i) + delt1 * (
        -b.G(G_SCUXI, j, i) * (-b.F(F_PGF_U, j, i) + b.F(F_STRESS_U, j, i)
                               + (ke - b.So(K_KE, j, i - 1)))
        + cau - b.D(D_UBRHS, j, i) + botstr
        - (b.uflux1(j, i) - b.uflux1(j, i - 1) + uflux3 - uflux2)
          / (b.G(G_SCU2, j, i) * fmx(b.F(F_DPU_M, j, i), onemm)))) * iu;
  }

  // ================= v equation =================
  {
    const T iv = b.G(G_IV, j, i);
    const T vtn = b.vtotn(j, i);
    const T wia = b.wgtia(j, i), wib = b.wgtib(j, i);
    const T via = b.via(j, i), vib = b.vib(j, i);
    const T dl2v = b.S(K_DL2V, j, i);
    const T dl2via = (T(1) - wia) * b.So(K_DL2V, j, i - 1) + wia * slip * dl2v;
    const T dl2vib = (T(1) - wib) * b.So(K_DL2V, j, i + 1) + wib * slip * dl2v;
    T v2, v4, v2w, v4w, v2e, v4e;
    b.vsc(false, j, i, v2, v4);
    b.vsc(false, j, i - 1, v2w, v4w);
    b.vsc(false, j, i + 1, v2e, v4e);
    const bool ww = b.Go(G_IV, j, i - 1) > T(0);
    const bool we = b.Go(G_IV, j, i + 1) > T(0);
    const T v2a = ww ? v2w : v2, v4a = ww ? v4w : v4;
    const T v2b = we ? v2e : v2, v4b = we ? v4e : v4;
    const T dpxy = fmx(b.F(F_DPV_M, j, i), onemm);
    T dpia = fmx(b.Fo(F_DPV_M, j, i - 1), onemm);
    dpia = dpia + wia * (dpxy - dpia);
    T dpib = fmx(b.Fo(F_DPV_M, j, i + 1), onemm);
    dpib = dpib + wib * (dpxy - dpib);
    const T difmxq = b.G(G_DIFMXQ, j, i), scqy = b.G(G_SCQY, j, i);
    const T difmxq_e = b.Go(G_DIFMXQ, j, i + 1), scqy_e = b.Go(G_SCQY, j, i + 1);
    const T vflux2 = (fmn(difmxq, (v2 + v2a) * scqy) * hfharm(dpia, dpxy)
                          * (via - vtn)
                      + fmn(T(.125) * difmxq, (v4 + v4a) * scqy)
                          * hfharm(dpia, dpxy) * (dl2via - dl2v)) * iv;
    const T vflux3 = (fmn(difmxq_e, (v2 + v2b) * scqy_e) * hfharm(dpib, dpxy)
                          * (vtn - vib)
                      + fmn(T(.125) * difmxq_e, (v4 + v4b) * scqy_e)
                          * hfharm(dpib, dpxy) * (dl2v - dl2vib)) * iv;

    const T pbv_m = b.D(D_PBV_M, j, i);
    const T ptopl = T(.5) * (fmn(pbv_m, b.F(F_P_LO, j, i))
                             + fmn(pbv_m, b.Fo(F_P_LO, j - 1, i)));
    const T pbotl = T(.5) * (fmn(pbv_m, b.F(F_P_HI, j, i))
                             + fmn(pbv_m, b.Fo(F_P_HI, j - 1, i)));
    const T qbot = T(.5) * (drag + b.Do(D_DRAG, j - 1, i))
                   * (fmx(pbv_m - thkbop, pbotl)
                      - fmx(pbv_m - thkbop, fmn(ptopl, pbotl - onemm)))
                   / fmx(b.F(F_DPV_M, j, i), onemm);
    const T botstr = -vtn * qbot / (T(1) + delt1 * qbot);

    T cav;
    if constexpr (MOM == MOM_ENSCON) {
      cav = T(-.125) * (b.uflux0(j, i) + b.uflux0(j, i + 1)
                        + b.uflux0(j - 1, i) + b.uflux0(j - 1, i + 1))
            * (potvor + b.So(K_POTVOR, j, i + 1)) * iv;
    } else if constexpr (MOM == MOM_ENECON) {
      cav = T(-.25) * ((b.uflux0(j, i) + b.uflux0(j - 1, i)) * potvor
                       + (b.uflux0(j, i + 1) + b.uflux0(j - 1, i + 1))
                         * b.So(K_POTVOR, j, i + 1)) * iv;
    } else {
      const T vtm = b.S(K_VTOTM, j, i);
      const T t1 = upw(b.So(K_POTVOR, j, i + 1), vtm,
                       b.So(K_UHMAX, j, i + 1) + b.So(K_UHMAX, j - 1, i + 1),
                       b.So(K_UHMIN, j, i + 1) + b.So(K_UHMIN, j - 1, i + 1),
                       true);
      const T t2 = upw(potvor, vtm,
                       b.S(K_UHMAX, j, i) + b.So(K_UHMAX, j - 1, i),
                       b.S(K_UHMIN, j, i) + b.So(K_UHMIN, j - 1, i), true);
      cav = T(-.25) * (t1 + t2) * iv;
    }

    a.v_new[o] = (b.F(F_V_N, j, i) + delt1 * (
        -b.G(G_SCVYI, j, i) * (-b.F(F_PGF_V, j, i) + b.F(F_STRESS_V, j, i)
                               + (ke - b.So(K_KE, j - 1, i)))
        + cav - b.D(D_VBRHS, j, i) + botstr
        - (b.vflux1(j, i) - b.vflux1(j - 1, i) + vflux3 - vflux2)
          / (b.G(G_SCV2, j, i) * fmx(b.F(F_DPV_M, j, i), onemm)))) * iv;
  }
}

template <typename T, int MOM>
int launch_stage(const Args<T> &a, int stage, dim3 grid, int threads,
                 cudaStream_t s) {
  switch (stage) {
    case 1: momtum_stage1<T><<<grid, threads, 0, s>>>(a); break;
    case 2: momtum_stage2<T, MOM><<<grid, threads, 0, s>>>(a); break;
    case 3: momtum_stage3<T, MOM><<<grid, threads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void *const *ptrs, const double *dargs, const int *iargs,
           int stage, void *stream) {
  Args<T> a;
  int p = 0;
  for (int n = 0; n < N_F; ++n) a.f[n] = (const T *)ptrs[p++];
  for (int n = 0; n < N_D; ++n) a.d[n] = (const T *)ptrs[p++];
  for (int n = 0; n < N_G; ++n) a.g[n] = (const T *)ptrs[p++];
  a.scratch = (T *)ptrs[p++];
  a.u_new = (T *)ptrs[p++];
  a.v_new = (T *)ptrs[p++];
  a.tsfac = (T)dargs[0];
  a.delt1 = (T)dargs[1];
  a.mdv2hi = (T)dargs[2];
  a.mdv2lo = (T)dargs[3];
  a.mdv4hi = (T)dargs[4];
  a.mdv4lo = (T)dargs[5];
  a.vsc2hi = (T)dargs[6];
  a.vsc2lo = (T)dargs[7];
  a.vsc4hi = (T)dargs[8];
  a.vsc4lo = (T)dargs[9];
  a.kk = iargs[0];
  a.J = iargs[1];
  a.I = iargs[2];
  a.periodic_i = iargs[3];
  a.periodic_j = iargs[4];
  const int threads = iargs[5];
  const int scheme = iargs[6];
  dim3 grid((a.I + threads - 1) / threads, a.J, a.kk);
  cudaStream_t s = (cudaStream_t)stream;
  switch (scheme) {
    case MOM_ENSCON:
      return launch_stage<T, MOM_ENSCON>(a, stage, grid, threads, s);
    case MOM_ENECON:
      return launch_stage<T, MOM_ENECON>(a, stage, grid, threads, s);
    case MOM_ENEDIS:
      return launch_stage<T, MOM_ENEDIS>(a, stage, grid, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one stage (1, 2 or 3) of the core; the stages run in order on
// one stream.  ptrs: the 17 MomtumKIn fields, the 12 Momtum2DIn fields,
// the 21 grid planes (in the order of the enums above), scratch
// (momtum_scratch_fields(scheme), kk, J, I), u_new, v_new.  dargs: tsfac,
// delt1, mdv2hi, mdv2lo, mdv4hi, mdv4lo, vsc2hi, vsc2lo, vsc4hi, vsc4lo.
// iargs: kk, J, I, periodic_i, periodic_j, threads, scheme (0 enscon,
// 1 enecon, 2 enedis).  Returns the cudaError_t of the launch.
int momtum_uv_f32(void *const *ptrs, const double *dargs, const int *iargs,
                  int stage, void *stream) {
  return launch<float>(ptrs, dargs, iargs, stage, stream);
}

int momtum_uv_f64(void *const *ptrs, const double *dargs, const int *iargs,
                  int stage, void *stream) {
  return launch<double>(ptrs, dargs, iargs, stage, stream);
}

int momtum_scratch_fields(int scheme) {
  return scheme == MOM_ENEDIS ? N_SCRATCH_ENEDIS : N_SCRATCH;
}

}
