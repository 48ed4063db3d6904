// ALE regrid (kernel K1): PPM reconstruction of T and S and the nudge
// of the interface pressures toward their target densities.
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/ale_pallas.py
// regrid_call (ppm_reconstruct_multi + ale.regrid_nudge on VMEM tiles).
// Plain version: blom_tpu_torch/dynamics/ale.py regrid_plain.  The
// monotonic minimum-thickness clamp is the sequential scan, as in the
// plain version (the TPU kernel used the cummax form, ~1 ULP apart).
// The T/S reconstruction takes the tracer limiter (ale.tracer_limiting),
// a template parameter: one instantiation per limiter and type.
//
// What bounds it on an H100: device-memory traffic in principle.  A
// column reads p_src (kk+1), temp, saln and sigmar (kk each) once and
// writes p_dst and smooth_fac (kk+1 each): ~178 MB in f32 at
// 384x360x53, 0.053 ms at 3.35 TB/s, against ~250 operations per cell
// (0.04 ms at 67 TFLOP/s f32).  A column's reconstruction and nudge pass
// over its kk levels many times (weights, edges, limiter steps,
// densities, the search for the density at pmin, the clamp), so those
// passes must run on chip, and what is left is the latency of the
// dependent steps between the block's barriers.  The design, K2's
// (ale_remap.cu):
//
// - a block takes a tile of TC consecutive columns (i fastest) and holds
//   them in dynamic shared memory as [k][column] arrays: the interfaces,
//   the means and edges of T and S, the densities at the layers' upper
//   and lower edges, the target densities and the non-oscillatory tests
//   (~2.2 KB per column at kk = 53, f32, so that three blocks fit an SM).
//   Thicknesses are recomputed from the interfaces and the edge weights
//   from the thicknesses, where an edge's two values are formed.  A warp
//   reads a k-row of consecutive columns, so global loads and stores
//   coalesce.  No per-thread arrays: no stack frame, and kk is limited
//   only by the tile's size (ale_regrid_kk_max);
// - the parts that are local in k run one (k, column) point per thread
//   (ppm_tile.cuh for the reconstruction), in block-strided stages
//   separated by __syncthreads(): the edges, the limiter's steps, the
//   coefficients with both densities of the layer, the transition
//   test of each interface (each point with its own first-match search
//   for the density at pmin), the candidate of each interface and its
//   smooth_fac;
// - the per-column steps run one thread per column: the densest wet
//   density and kdmx, and the clamp scan, which writes p_dst.
//
// Selected branches only: `kdmx` is a count, `kt` the first interface
// where the condition holds (the least k whose test holds, by atomicMin),
// the density at pmin a search for the first source layer containing it
// (computed only where kt's condition can look at it; in a column whose
// interfaces are finite and do not decrease it starts from K2's binary
// search, clear_above, and stops at the first layer below pmin), and the
// isopycnal-regime nudge is evaluated only for interfaces in that regime
// and only for the case (A, B or C) that applies, its densities'
// derivatives only where the case reads them.  The plain version
// computes every candidate and discards the others with `where`; the
// kept values are the same.

#include "ppm_tile.cuh"

namespace {

using namespace ale;

// columns per tile and the blocks per SM asked of __launch_bounds__, per
// type; threads per block
constexpr int TC_F32 = 32;
constexpr int MINB_F32 = 3;
constexpr int TC_F64 = 16;
constexpr int MINB_F64 = 2;
constexpr int THREADS = 256;

template <typename T>
struct Tile {
  static constexpr int TC = TC_F64, MINB = MINB_F64;
};
template <>
struct Tile<float> {
  static constexpr int TC = TC_F32, MINB = MINB_F32;
};

template <typename T>
struct Args {
  const T *p, *temp, *saln, *sigmar;
  const double *plevel;   // device array, kk
  T *p_dst, *sfac;
  int kk, ncol, kb, pc_upper;
  double nudge_fac, dpmin, lim;
  double ap[12];   // ap11..ap16, ap21..ap26
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

// Dynamic shared memory of a tile: values of type T, ints, bytes.
template <typename T>
size_t smem_bytes(int kk) {
  constexpr size_t TC = Tile<T>::TC;
  const size_t k0 = kk, k1 = kk + 1;
  return TC * (k1 + 9 * k0) * sizeof(T) + 2 * TC * sizeof(int)
         + TC * (2 * k0 + 1);
}

// The tile's arrays, [k][column] unless noted; the per-field arrays hold
// T's, then S's.  Each address is computed where it is used, from the
// base and the sizes, so that no pointer stays in a register.
template <typename T>
struct Smem {
  static constexpr int TC = Tile<T>::TC;
  unsigned char *base;
  int k0, k1;            // kk * TC, (kk + 1) * TC

  __device__ Smem(unsigned char *b, int kk)
      : base(b), k0(kk * TC), k1((kk + 1) * TC) {}
  // source interfaces (kk+1)
  __device__ __forceinline__ T *p() const {
    return reinterpret_cast<T *>(base);
  }
  // per field (kk): means, left and right edges; then c1, c0, c2
  __device__ __forceinline__ T *tm() const { return p() + k1; }
  __device__ __forceinline__ T *tel() const { return tm() + 2 * k0; }
  __device__ __forceinline__ T *ter() const { return tm() + 4 * k0; }
  // densities at the layers' upper and lower edges (kk); the candidate
  // stage overwrites the lower ones with max(candidate, pmin)
  __device__ __forceinline__ T *sup() const { return tm() + 6 * k0; }
  __device__ __forceinline__ T *slo() const { return tm() + 7 * k0; }
  // target densities (kk)
  __device__ __forceinline__ T *sg() const { return tm() + 8 * k0; }
  // per column: kdmx, then kt (both 1-based)
  __device__ __forceinline__ int *kdmx() const {
    return reinterpret_cast<int *>(sg() + k0);
  }
  __device__ __forceinline__ int *kt() const { return kdmx() + TC; }
  // per field (kk): the non-oscillatory test
  __device__ __forceinline__ unsigned char *need() const {
    return reinterpret_cast<unsigned char *>(kt() + TC);
  }
  // per column: interfaces finite and not decreasing
  __device__ __forceinline__ unsigned char *mono() const {
    return need() + 2 * k0;
  }
};

// The tile of columns col0 .. col0+TC-1.  Every loop is block-strided,
// so any block size runs it.
template <int LIM, typename T>
__device__ __forceinline__ void regrid_tile(const Args<T> &a,
                                            const Smem<T> &s, int col0) {
  constexpr int TC = Tile<T>::TC;
  using L = Lev<T, TC>;
  const int kk = a.kk, ncol = a.ncol;
  const size_t n = (size_t)ncol;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int K0 = kk * TC, K1 = (kk + 1) * TC;
  const bool pc_upper = a.pc_upper != 0;
  // the per-column loops over m points run on the last m threads, which
  // have the fewest (k, column) points in the stages they share
  auto last = [nth](int m) { return nth > m ? nth - m : 0; };

  // interfaces, means, target densities
#pragma unroll 1
  for (int i = tid; i < K1; i += nth) {
    const int col = col0 + i % TC;
    const size_t g = (size_t)(i / TC) * n + col;
    const bool in = col < ncol;
    s.p()[i] = in ? a.p[g] : T(0);
    if (i < K0) {
      s.tm()[i] = in ? a.temp[g] : T(0);
      s.tm()[K0 + i] = in ? a.saln[g] : T(0);
      s.sg()[i] = in ? a.sigmar[g] : T(0);
    }
  }
  __syncthreads();
  // edge weights, then both fields' raw edges: edge q is tel[q], ter[q-1]
#pragma unroll 1
  for (int i = tid; i < K1; i += nth) {
    const int c = i % TC, q = i / TC;
    T w1, w2, w3, w4;
    edge_weights_at(ThickP<T, TC>{s.p() + c}, kk, q, w1, w2, w3, w4);
    for (int f = 0; f < 2; ++f) {
      const T e = edge_value_at(L{s.tm() + f * K0 + c}, kk, q, w1, w2, w3,
                                w4);
      if (q < kk) s.tel()[f * K0 + i] = e;
      if (q > 0) s.ter()[f * K0 + i - TC] = e;
    }
  }
  __syncthreads();
  if constexpr (LIM != LIM_MONOTONIC) {
    for (int f = 0; f < 2; ++f) {
#pragma unroll 1
      for (int i = tid; i < K0; i += nth) {
        const int o = f * K0 + i % TC;
        s.need()[f * K0 + i] = need_at(L{s.tm() + o}, L{s.tel() + o},
                                       L{s.ter() + o}, kk, i / TC);
      }
    }
    __syncthreads();
  }
  // slope clamp of the interior cells; the boundary cells
  for (int f = 0; f < 2; ++f) {
#pragma unroll 1
    for (int i = tid + TC; i < K0 - TC; i += nth) {
      const int c = i % TC, o = f * K0 + c;
      if (LIM == LIM_MONOTONIC || s.need()[f * K0 + i])
        slope_clamp_at(ThickP<T, TC>{s.p() + c}, L{s.tm() + o},
                       L{s.tel() + o}, L{s.ter() + o}, i / TC);
    }
  }
  if (tid >= last(2 * TC)) {
    for (int fc = tid - last(2 * TC); fc < 2 * TC; fc += nth) {
      const int c = fc % TC, o = (fc / TC) * K0 + c;
      boundary_cells(ThickP<T, TC>{s.p() + c}, L{s.tm() + o},
                     L{s.tel() + o}, L{s.ter() + o}, kk, pc_upper);
    }
  }
  __syncthreads();
  // edge-pair consistency, edges 2..kk-2
  for (int f = 0; f < 2; ++f) {
#pragma unroll 1
    for (int i = tid + 2 * TC; i < K0 - TC; i += nth) {
      const int o = f * K0 + i % TC;
      pair_sweep_at(L{s.tm() + o}, L{s.tel() + o}, L{s.ter() + o}, i / TC);
    }
  }
  __syncthreads();
  // parabola limit of the interior cells
  for (int f = 0; f < 2; ++f) {
#pragma unroll 1
    for (int i = tid + TC; i < K0 - TC; i += nth) {
      const int o = f * K0 + i % TC;
      if (LIM == LIM_MONOTONIC || s.need()[f * K0 + i])
        parabola_limit_at(L{s.tm() + o}, L{s.tel() + o}, L{s.ter() + o},
                          i / TC);
    }
  }
  __syncthreads();
  // posdef, piecewise-constant cells, coefficients of both fields; the
  // densities at the layer's upper and lower edges
  {
    const Eos<T> eos(a.ap);
#pragma unroll 1
    for (int i = tid; i < K0; i += nth) {
      const int c = i % TC, k = i / TC;
      const T dxk = ThickP<T, TC>{s.p() + c}[k];
      for (int f = 0; f < 2; ++f) {
        const int o = f * K0 + c;
        fit_at<LIM>(dxk, L{s.tm() + o}, L{s.tel() + o}, L{s.ter() + o}, k,
                    pc_upper);
      }
      const T *c0 = s.tel() + i, *c1 = s.tm() + i, *c2 = s.ter() + i;
      s.sup()[i] = eos.sig(c0[0], c0[K0]);
      s.slo()[i] = eos.sig(c0[0] + c1[0] + c2[0], c0[K0] + c1[K0] + c2[K0]);
    }
  }
  __syncthreads();
  // the densest lower-edge density of a wet layer, 0 when there is none
  // or it is not finite (amax over where(wet, sig_lo, -inf)); kdmx, the
  // count of lighter targets, at least 1; kt's default; whether the
  // interfaces are finite and do not decrease
  if (tid >= last(TC)) {
    for (int c = tid - last(TC); c < TC; c += nth) {
      const L p{s.p() + c}, slo{s.slo() + c}, sg{s.sg() + c};
      T sig_max = T(0);
      bool any_wet = false, mono = is_finite(p[kk]);
#pragma unroll 1
      for (int k = 0; k < kk; ++k) {
        mono = mono && is_finite(p[k]) && p[k + 1] >= p[k];
        if (p[k + 1] - p[k] > T(kEpsilp)) {
          sig_max = any_wet ? fmx(sig_max, slo[k]) : slo[k];
          any_wet = true;
        }
      }
      if (!is_finite(sig_max)) sig_max = T(0);
      int kdmx = 0;
#pragma unroll 1
      for (int k = 0; k < kk; ++k) kdmx += sg[k] < sig_max;
      if (kdmx < 1) kdmx = 1;
      s.kdmx()[c] = kdmx;
      s.kt()[c] = kdmx + 1;
      s.mono()[c] = mono;
    }
  }
  __syncthreads();
  // transition interface kt (1-based): the first k > kb, k <= kdmx with
  // sigmar(k) > the density at pmin(k), which lies in the first source
  // layer that contains pmin(k) (below the column: the deepest
  // lower-edge density).  Where the interfaces are finite and do not
  // decrease, no layer above clear_above's contains pmin(k) (ppm_tile.cuh)
  // and none whose top lies below pmin(k) does, so the search starts
  // there and stops at the first such layer.
  {
    const int kb = a.kb > 0 ? a.kb : 0;
#pragma unroll 1
    for (int i = tid + kb * TC; i < K0; i += nth) {
      const int c = i % TC, k = i / TC;     // 0-based k: k+1 in (kb, kdmx]
      if (k >= s.kdmx()[c]) continue;
      const L p{s.p() + c}, sup{s.sup() + c}, slo{s.slo() + c};
      const T pq = fmn(T(a.plevel[k]) + p[0], p[kk]);
      const bool mono = s.mono()[c];
      T spm = slo[kk - 1];
#pragma unroll 1
      for (int l = mono ? clear_above(p, kk, pq, -1) : 0; l < kk; ++l) {
        if (mono && p[l] > pq) break;
        const T dpl = p[l + 1] - p[l];
        if (pq >= p[l] && pq < p[l] + dpl) {
          const T dpi = T(1) / fmx(dpl, T(kEpsilp));
          const T w = fmn(fmx((pq - p[l]) * dpi, T(0)), T(1));
          spm = (T(1) - w) * sup[l] + w * slo[l];
          break;
        }
      }
      if (s.sg()[i] > spm) atomicMin(s.kt() + c, k + 1);
    }
  }
  __syncthreads();
  // the candidate of each interior interface kif = k+2 (1-based) and its
  // smooth_fac: the pressure regime above kt, the isopycnal nudge from kt
  // to kdmx, the bottom below; max(candidate, pmin) over slo[k], the one
  // density this point reads of layer k
  {
    const Eos<T> eos(a.ap);
    const T nf = T(a.nudge_fac);
    const T lim = T(a.lim);
    const T rlim = T(1) / lim;
#pragma unroll 1
    for (int j = tid; j < K0 - TC; j += nth) {
      const int c = j % TC, i = j / TC, col = col0 + c;
      const int kif = i + 2;
      const int kt = s.kt()[c], kdmx = s.kdmx()[c];
      const L p{s.p() + c}, sg{s.sg() + c};
      const T p_bot = p[kk];
      const T pmn = fmn(T(a.plevel[i + 1]) + p[0], p_bot);
      T cand, sf;
      if (kif < kt) {
        cand = p[i + 1] + nf * (pmn - p[i + 1]);
        sf = T(1);
      } else if (kif <= kdmx) {
        const L tmT{s.tm() + c}, telT{s.tel() + c}, terT{s.ter() + c};
        const L tmS{s.tm() + K0 + c}, telS{s.tel() + K0 + c},
            terS{s.ter() + K0 + c};
        // dsig_trg(k) = max(sigmar(k+1) - sigmar(k), 1e-12), the last
        // repeated
        auto dsig_trg = [&](int k) -> T {
          const T d = k < kk - 1 ? sg[k + 1] - sg[k]
                                 : sg[kk - 1] - sg[kk - 2];
          return fmx(d, T(1e-12));
        };
        const T su = s.slo()[j], sl = s.sup()[j + TC], st = sg[i + 1];
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
        // case A: target lighter than both neighbours, move up; case B:
        // denser than both, move down; case C: in between, the density
        // interpolated across the interface decides.  Each lane forms
        // only what its case reads, and all share the nudge itself.
        const bool A = st < su && st < sl, B = st > su && st > sl;
        T du = T(0), dl = T(0);
        if (!B) du = dsdx_up();
        if (!A) dl = dsdx_lo();
        bool upward;
        T dsig, raw;
        if (A) {
          upward = true;
          dsig = st - su;
          raw = du;
        } else if (B) {
          upward = false;
          dsig = st - sl;
          raw = dl;
        } else {
          const T dp_up = fmx(dp_up_raw, T(kEpsilp));
          const T dp_lo = fmx(dp_lo_raw, T(kEpsilp));
          T si = ((sl + T(.5) * dl) * dp_up + (su - T(.5) * du) * dp_lo) /
                 (dp_up + dp_lo);
          si = fmn(fmx(si, fmn(su, sl)), fmx(su, sl));
          dsig = st - si;
          upward = dsig < T(0);
          raw = upward ? du + T(2) * (si - su) : dl + T(2) * (sl - si);
        }
        const T dstv = upward ? dst_km1 : dst_k;
        const T stab = raw / dstv;
        const T q = dsig * nf / (dstv * fmx(stab, lim));
        const T delta = upward ? fmx(q, T(-.5)) * dp_up_raw
                               : fmn(q, T(.5)) * dp_lo_raw;
        cand = p[i + 1] + delta;
        sf = fmn(fmx((lim - stab) * rlim, T(0)), T(1));
      } else {
        cand = p_bot;
        sf = T(0);
      }
      s.slo()[j] = fmx(cand, pmn);
      if (col < ncol) a.sfac[(size_t)(i + 1) * n + col] = sf;
    }
  }
  __syncthreads();
  // the monotonic clamp with the minimum interior thickness, in order
  if (tid >= last(TC)) {
    const T dpmin = T(a.dpmin);
    for (int c = tid - last(TC); c < TC; c += nth) {
      const int col = col0 + c;
      if (col >= ncol) continue;
      const L p{s.p() + c}, cand{s.slo() + c};
      const T p_bot = p[kk];
      T prev = p[0];
      a.p_dst[col] = prev;
      a.sfac[col] = T(1);
#pragma unroll 1
      for (int i = 0; i < kk - 1; ++i) {
        prev = fmn(fmx(cand[i], prev + dpmin), p_bot);
        a.p_dst[(size_t)(i + 1) * n + col] = prev;
      }
      a.p_dst[(size_t)kk * n + col] = p_bot;
      a.sfac[(size_t)kk * n + col] = T(0);
    }
  }
}

template <typename T, int LIM>
__global__ void __launch_bounds__(THREADS, Tile<T>::MINB)
    ale_regrid_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  regrid_tile<LIM>(a, Smem<T>(smem, a.kk), blockIdx.x * Tile<T>::TC);
}

template <typename T, int LIM>
int launch1(const Args<T> &a, size_t smem, cudaStream_t s) {
  auto kern = ale_regrid_kernel<T, LIM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.ncol + Tile<T>::TC - 1) / Tile<T>::TC;
  kern<<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The largest kk whose tile fits `limit` bytes of shared memory.
template <typename T>
int kk_max(size_t limit) {
  int kk = 3;
  while (smem_bytes<T>(kk + 1) <= limit) ++kk;
  return kk;
}

template <typename T>
int launch(void *const *ptrs, const int *iargs, const double *dargs,
           void *stream) {
  Args<T> a;
  a.p = (const T *)ptrs[0];
  a.temp = (const T *)ptrs[1];
  a.saln = (const T *)ptrs[2];
  a.sigmar = (const T *)ptrs[3];
  a.plevel = (const double *)ptrs[4];
  a.p_dst = (T *)ptrs[5];
  a.sfac = (T *)ptrs[6];
  a.kk = iargs[0];
  a.ncol = iargs[1];
  a.kb = iargs[2];
  a.pc_upper = iargs[3];
  const int limiter = iargs[4];
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (a.kk < 3 || a.kk > kk_max<T>((size_t)limit) || a.ncol < 1
      || limiter < 0 || limiter >= N_LIM)
    return (int)cudaErrorInvalidValue;
  a.nudge_fac = dargs[0];
  a.dpmin = dargs[1];
  a.lim = dargs[2];
  for (int i = 0; i < 12; ++i) a.ap[i] = dargs[3 + i];
  const size_t smem = smem_bytes<T>(a.kk);
  cudaStream_t s = (cudaStream_t)stream;
  switch (limiter) {
    case LIM_MONOTONIC:
      return launch1<T, LIM_MONOTONIC>(a, smem, s);
    case LIM_NON_OSCILLATORY:
      return launch1<T, LIM_NON_OSCILLATORY>(a, smem, s);
    default:
      return launch1<T, LIM_POSDEF>(a, smem, s);
  }
}

}  // namespace

extern "C" {

// ptrs: p_src, temp, saln, sigmar, plevel (kk doubles on the device),
// p_dst, smooth_fac.
// iargs: kk, ncol (= J*I), k_range_plevel, tracer_pc_upper, tracer
// limiter (0 monotonic, 1 non_oscillatory, 2 non_oscillatory_posdef).
// dargs: nudge_fac, dpmin_interior, stab_fac_limit, ap11..ap16,
// ap21..ap26.
// Returns the cudaError_t of the launch; cudaErrorInvalidValue for kk
// outside [3, ale_regrid_kk_max] or an unknown limiter.
int ale_regrid_f32(void *const *ptrs, const int *iargs, const double *dargs,
                   void *stream) {
  return launch<float>(ptrs, iargs, dargs, stream);
}

int ale_regrid_f64(void *const *ptrs, const int *iargs, const double *dargs,
                   void *stream) {
  return launch<double>(ptrs, iargs, dargs, stream);
}

// Dynamic shared memory of one block at kk levels (f64 != 0: double).
long long ale_regrid_shared_bytes(int kk, int f64) {
  return (long long)(f64 ? smem_bytes<double>(kk) : smem_bytes<float>(kk));
}

// The largest kk the kernel takes with `limit` bytes of shared memory
// per block.
int ale_regrid_kk_max(int f64, long long limit) {
  return f64 ? kk_max<double>((size_t)limit) : kk_max<float>((size_t)limit);
}

}
