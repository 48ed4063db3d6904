// ALE remap (kernel K2): PPM reconstructions of the tracers, u and v on
// their source grids, remapped onto the new grids as layer means.
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/ale_pallas.py
// _remap_chunk / remap_call (ppm_reconstruct_multi, ppm_reconstruct and
// hor3map.remap_groups(bottom_only_empties=True) on VMEM tiles).  Plain
// version: blom_tpu_torch/dynamics/ale.py remap_plain.  One launch takes
// every tracer, in chunks of NF fields with no upper limit on their
// number, and both velocity components: three groups, each with its own
// source grid, whose geometry and edge weights are computed once per
// group and kept for all its chunks.
//
// What bounds it on an H100: device-memory traffic in principle.  With
// ntr = 0 it reads 6 interface fields (p_src, p_dst, pu_q, pv_q, pu_new,
// pv_new; kk+1 each) and 4 layer fields (temp, saln, u, v) once and
// writes 4 layer fields: ~414 MB in f32 at 384x360x53, 0.124 ms at
// 3.35 TB/s.  A column's reconstruction and remap pass over its kk
// levels many times (weights, edges, limiter steps, prefix sums,
// destination edges), so those passes must run on chip, and what is left
// is the latency of the dependent steps between the block's barriers.
// The design:
//
// - a block takes a tile of TC consecutive columns (i fastest) and holds
//   them in dynamic shared memory as [k][column] arrays: the source and
//   destination interfaces, the inverse thicknesses, three of the four
//   edge weights, and per field of a chunk the means, edges and prefix
//   sums (~2.2 KB per column at kk = 53, f32, NF = 1, so that three
//   blocks fit an SM).  Thicknesses are recomputed from the interfaces,
//   and the first weight from the other three as edge_weights computes
//   it, (1 - w2 - w3) - w4 (0 at edge 1), both bit for bit.  A warp reads
//   a k-row of consecutive columns, so global loads and stores coalesce
//   and shared reads are free of bank conflicts.  No per-thread arrays:
//   no stack frame;
// - the parts that are local in k run one (k, column) point per thread
//   (ppm_tile.cuh), in block-strided stages separated by __syncthreads(),
//   each loop kept rolled (unrolled, they need more registers than three
//   blocks per SM leave, and spill, for no gain);
//   the per-column facts (interfaces finite, not decreasing, deepest wet
//   layer) are gathered in the same pass;
// - the boundary cells and the prefix sums run one thread per column;
// - the destination edges run one thread per column and block of
//   consecutive edges, each edge on its own, and the thread writes the
//   layer means between its edges.
//
// The plain version's remap costs O(kk^2) per column: every destination
// edge integrates over every source layer.  Two shortcuts keep the
// result identical while making it O(kk) per field:
//
// - a term with x == 0 adds exactly zero, so for a column whose source
//   interfaces do not decrease the loop over source layers stops at the
//   first layer whose top lies at or below the destination edge;
// - a term with x == 1 is the layer's full integral
//   dx*((c0 + .5*c1) + (1/3)*c2), computed in the plain version's
//   operation order, and the layers k = 0..kf-1 that are full for an edge
//   (kf the first that is not) have the prefix sum S[kf], taken in the
//   same order from k = 0.  Any start kf' <= kf gives the same sum:
//   S[kf] is S[kf'] followed by the full terms of layers kf'..kf-1 in the
//   same order, which is what the loop from kf' adds.  So each edge takes
//   for kf' the deepest source interface (a binary search over the
//   column's non-decreasing interfaces, or a walk on from the previous
//   edge's when that still qualifies) that lies at least
//   m = 8 eps (|pq| + |p0|) + 4 heps above it, eps the machine epsilon:
//   every layer above kf' then has pq - p[k] >= d + m (less the rounding
//   of pq - m), with d <= |pq| + |p0| the layer's thickness, which makes
//   (pq - p[k]) * (1 / max(d, heps)) >= 1 after its three roundings.  A
//   column whose interfaces decrease starts from 0.
//
// So each destination edge's integral is the plain version's sum over
// k = 0, 1, ..., in the same order, with its zero terms left out.  A zero
// term is exactly zero only for finite coefficients: a column whose
// interfaces or reconstruction hold inf or NaN takes every term, as the
// plain version does.
//
// The tracers take the tracer limiter, u and v the velocity limiter,
// both template parameters of the kernel: nine instantiations per type.

#include "ppm_tile.cuh"

namespace {

using namespace ale;

// columns per tile, fields per chunk and the blocks per SM asked of
// __launch_bounds__, per type; threads per block
constexpr int TC_F32 = 32;
constexpr int NF_F32 = 1;
constexpr int MINB_F32 = 3;
constexpr int TC_F64 = 16;
constexpr int NF_F64 = 1;
constexpr int MINB_F64 = 2;
constexpr int THREADS = 256;

template <typename T>
struct Tile {
  static constexpr int TC = TC_F64, NF = NF_F64, MINB = MINB_F64;
};
template <>
struct Tile<float> {
  static constexpr int TC = TC_F32, NF = NF_F32, MINB = MINB_F32;
};

template <typename T>
struct Args {
  const T *p_src, *pu_q, *pv_q, *p_dst, *pu_new, *pv_new;
  // device array: the nt + 2 input fields (tracers, u, v), then their
  // outputs in the same order
  const uint64_t *fields;
  int kk, ncol, nt, pc_upper_t, pc_upper_v;
};

// Dynamic shared memory of a tile: values of type T, ints, bytes.
template <typename T>
size_t smem_bytes(int kk) {
  constexpr size_t TC = Tile<T>::TC, NF = Tile<T>::NF;
  const size_t k0 = kk, k1 = kk + 1;
  return TC * (5 * k1 + k0 + NF * (3 * k0 + k1 + 1)) * sizeof(T)
         + TC * sizeof(int) + TC * (2 + NF * (k0 + 1));
}

// The tile's arrays, [k][column] unless noted; per-field arrays hold the
// chunk's fields one after another.  Each address is computed where it
// is used, from the base and the sizes, so that no pointer stays in a
// register.
template <typename T>
struct Smem {
  static constexpr int TC = Tile<T>::TC, NF = Tile<T>::NF;
  unsigned char *base;
  int k0, k1;            // kk * TC, (kk + 1) * TC

  __device__ Smem(unsigned char *b, int kk)
      : base(b), k0(kk * TC), k1((kk + 1) * TC) {}
  // source and destination interfaces (kk+1)
  __device__ __forceinline__ T *p() const {
    return reinterpret_cast<T *>(base);
  }
  __device__ __forceinline__ T *pd() const { return p() + k1; }
  // edge weights 2..4, each (kk+1)
  __device__ __forceinline__ T *w() const { return p() + 2 * k1; }
  // 1 / max(thickness, heps) (kk)
  __device__ __forceinline__ T *dxi() const { return p() + 5 * k1; }
  // per field (kk): means, left and right edges
  __device__ __forceinline__ T *tm() const { return dxi() + k0; }
  __device__ __forceinline__ T *tel() const { return tm() + NF * k0; }
  __device__ __forceinline__ T *ter() const { return tm() + 2 * NF * k0; }
  // per field (kk+1): prefix sums
  __device__ __forceinline__ T *S() const { return tm() + 3 * NF * k0; }
  // per field, per column: the bottom value
  __device__ __forceinline__ T *botv() const { return S() + NF * k1; }
  // per column: deepest wet source layer
  __device__ __forceinline__ int *kbot() const {
    return reinterpret_cast<int *>(botv() + NF * TC);
  }
  // per column: interfaces finite, not decreasing
  __device__ __forceinline__ unsigned char *pfin() const {
    return reinterpret_cast<unsigned char *>(kbot() + TC);
  }
  __device__ __forceinline__ unsigned char *mono() const {
    return pfin() + TC;
  }
  // per field, per column: a coefficient not finite
  __device__ __forceinline__ unsigned char *bad() const {
    return pfin() + 2 * TC;
  }
  // per field (kk): the non-oscillatory test
  __device__ __forceinline__ unsigned char *need() const {
    return pfin() + (2 + NF) * TC;
  }
};

// full-layer integral dx*poly(1) in the plain version's order
template <typename T>
__device__ __forceinline__ T full_term(T dxr, T c0, T c1, T c2) {
  return dxr * (c0 + T(.5) * c1 + T(1 / 3.) * c2);
}

// integral over the fraction x of a layer, dx*poly(x)
template <typename T>
__device__ __forceinline__ T part_term(T dxr, T x, T c0, T c1, T c2) {
  const T x2 = x * x;
  const T poly = c0 * x + T(.5) * c1 * x2 + T(1 / 3.) * c2 * x2 * x;
  return dxr * poly;
}

// The integral of field (c0, c1, c2) from the column top to pq, as the
// plain version sums it.  kf: on entry the previous edge's start (-1 for
// none), on exit this edge's.
template <typename T, int TC>
__device__ __forceinline__ T edge_integral(Lev<T, TC> p, Lev<T, TC> dxi,
                                           Lev<T, TC> c0, Lev<T, TC> c1,
                                           Lev<T, TC> c2, Lev<T, TC> S,
                                           int kk, T pq, bool fin,
                                           bool mono, int &kf) {
  const Dxr<T, TC> dxr{&p[0]};
  T acc;
  if (!fin || pq != pq) {
    // a non-finite coefficient or edge: every term counts, as in the
    // plain version (0 * inf is NaN)
    acc = T(0);
#pragma unroll 1
    for (int k = 0; k < kk; ++k) {
      const T x = fmn(fmx((pq - p[k]) * dxi[k], T(0)), T(1));
      acc = acc + part_term(dxr[k], x, c0[k], c1[k], c2[k]);
    }
    kf = -1;
    return acc;
  }
  kf = mono ? clear_above(p, kk, pq, kf) : 0;
  acc = S[kf];
#pragma unroll 1
  for (int k = kf; k < kk; ++k) {
    if (mono && p[k] >= pq) break;
    const T x = (pq - p[k]) * dxi[k];
    if (x >= T(1)) {
      acc = acc + full_term(dxr[k], c0[k], c1[k], c2[k]);
    } else if (x > T(0)) {
      acc = acc + part_term(dxr[k], x, c0[k], c1[k], c2[k]);
    }
  }
  return acc;
}

// One group: the fields src[0..nf) on the source interfaces ps,
// reconstructed with the limiter LIM and remapped onto pd, into
// dst[0..nf).  Every loop is block-strided, so any block size runs it.
template <int LIM, typename T>
__device__ __forceinline__ void remap_group(const Smem<T> &s, int kk,
                                            int ncol, int col0,
                                            const T *ps, const T *pd,
                                            const uint64_t *src,
                                            const uint64_t *dst, int nf,
                                            bool pc_upper) {
  constexpr int TC = Tile<T>::TC, NF = Tile<T>::NF;
  using L = Lev<T, TC>;
  const size_t n = (size_t)ncol;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int K0 = kk * TC, K1 = (kk + 1) * TC;
  // the per-column loops over n points run on the last n threads, which
  // have the fewest (k, column) points in the stages they share
  auto last = [nth](int n) { return nth > n ? nth - n : 0; };

  __syncthreads();   // the previous group has read every array
#pragma unroll 1
  for (int i = tid; i < K1; i += nth) {
    const int col = col0 + i % TC;
    const size_t g = (size_t)(i / TC) * n + col;
    s.p()[i] = col < ncol ? ps[g] : T(0);
    s.pd()[i] = col < ncol ? pd[g] : T(0);
    if (i < TC) {
      s.pfin()[i] = 1;
      s.mono()[i] = 1;
      s.kbot()[i] = -1;
    }
  }
  __syncthreads();
  // the column's facts, inverse thicknesses, edge weights
#pragma unroll 1
  for (int i = tid; i < K1; i += nth) {
    const int c = i % TC, q = i / TC;
    const L p{s.p() + c};
    if (q < kk) {
      const T d = Dxr<T, TC>{s.p() + c}[q];
      s.dxi()[i] = T(1) / fmx(d, T(kHeps));
      if (d > T(kHeps)) atomicMax(s.kbot() + c, q);   // deepest wet layer
      if (q > 0 && p[q] < p[q - 1]) s.mono()[c] = 0;
    }
    if (!is_finite(p[q])) s.pfin()[c] = 0;
    T w1;
    edge_weights_at(ThickP<T, TC>{s.p() + c}, kk, q, w1, s.w()[i],
                    s.w()[K1 + i], s.w()[2 * K1 + i]);
  }

  for (int f0 = 0; f0 < nf; f0 += NF) {
    const int m = nf - f0 < NF ? nf - f0 : NF;
    __syncthreads();   // the geometry, or the previous chunk's remap
    // cell means
    for (int f = 0; f < m; ++f) {
      const T *sp = reinterpret_cast<const T *>(src[f0 + f]);
#pragma unroll 1
      for (int i = tid; i < K0; i += nth) {
        const int c = i % TC, col = col0 + c;
        s.tm()[f * K0 + i] = col < ncol ? sp[(size_t)(i / TC) * n + col]
                                      : T(0);
        if (i < TC) s.bad()[f * TC + c] = 0;
      }
    }
    __syncthreads();
    // raw edge values: edge q is tel[q] and ter[q-1]
    for (int f = 0; f < m; ++f) {
#pragma unroll 1
      for (int i = tid; i < K1; i += nth) {
        const int c = i % TC, q = i / TC;
        const T w2 = s.w()[i], w3 = s.w()[K1 + i], w4 = s.w()[2 * K1 + i];
        const T w1 = q == 1 ? T(0) : T(1) - w2 - w3 - w4;
        const T e = edge_value_at(L{s.tm() + f * K0 + c}, kk, q, w1, w2, w3,
                                  w4);
        if (q < kk) s.tel()[f * K0 + i] = e;
        if (q > 0) s.ter()[f * K0 + i - TC] = e;
      }
    }
    __syncthreads();
    if constexpr (LIM != LIM_MONOTONIC) {
      for (int f = 0; f < m; ++f) {
#pragma unroll 1
        for (int i = tid; i < K0; i += nth) {
          const int c = i % TC, o = f * K0 + c;
          s.need()[f * K0 + i] = need_at(L{s.tm() + o}, L{s.tel() + o},
                                       L{s.ter() + o}, kk, i / TC);
        }
      }
      __syncthreads();
    }
    // slope clamp of the interior cells; the boundary cells
    for (int f = 0; f < m; ++f) {
#pragma unroll 1
      for (int i = tid + TC; i < K0 - TC; i += nth) {
        const int c = i % TC, o = f * K0 + c;
        if (LIM == LIM_MONOTONIC || s.need()[f * K0 + i])
          slope_clamp_at(ThickP<T, TC>{s.p() + c}, L{s.tm() + o},
                         L{s.tel() + o}, L{s.ter() + o}, i / TC);
      }
    }
    if (tid >= last(m * TC)) {
      for (int fc = tid - last(m * TC); fc < m * TC; fc += nth) {
        const int c = fc % TC, o = (fc / TC) * K0 + c;
        boundary_cells(ThickP<T, TC>{s.p() + c}, L{s.tm() + o},
                       L{s.tel() + o}, L{s.ter() + o}, kk, pc_upper);
      }
    }
    __syncthreads();
    // edge-pair consistency, edges 2..kk-2
    for (int f = 0; f < m; ++f) {
#pragma unroll 1
      for (int i = tid + 2 * TC; i < K0 - TC; i += nth) {
        const int o = f * K0 + i % TC;
        pair_sweep_at(L{s.tm() + o}, L{s.tel() + o}, L{s.ter() + o}, i / TC);
      }
    }
    __syncthreads();
    // parabola limit of the interior cells
    for (int f = 0; f < m; ++f) {
#pragma unroll 1
      for (int i = tid + TC; i < K0 - TC; i += nth) {
        const int o = f * K0 + i % TC;
        if (LIM == LIM_MONOTONIC || s.need()[f * K0 + i])
          parabola_limit_at(L{s.tm() + o}, L{s.tel() + o}, L{s.ter() + o},
                            i / TC);
      }
    }
    __syncthreads();
    // posdef, piecewise-constant cells, coefficients; each layer's full
    // integral into S[k+1]
    for (int f = 0; f < m; ++f) {
#pragma unroll 1
      for (int i = tid; i < K0; i += nth) {
        const int c = i % TC, k = i / TC, o = f * K0 + c;
        const L tm{s.tm() + o}, tel{s.tel() + o}, ter{s.ter() + o};
        const T d = Dxr<T, TC>{s.p() + c}[k];
        fit_at<LIM>(d + T(kHeps), tm, tel, ter, k, pc_upper);
        const T c0 = tel[k], c1 = tm[k], c2 = ter[k];
        if (!(is_finite(c0) && is_finite(c1) && is_finite(c2)))
          s.bad()[f * TC + c] = 1;
        s.S()[f * K1 + i + TC] = full_term(d, c0, c1, c2);
      }
    }
    __syncthreads();
    // prefix sums in the plain order; the bottom value
    if (tid >= last(m * TC)) {
      for (int fc = tid - last(m * TC); fc < m * TC; fc += nth) {
        const int c = fc % TC, f = fc / TC, o = f * K0 + c;
        const L S{s.S() + f * K1 + c};
        T sum = T(0);
        S[0] = sum;
#pragma unroll 8
        for (int k = 0; k < kk; ++k) {
          sum = sum + S[k + 1];
          S[k + 1] = sum;
        }
        const int kb = s.kbot()[c];
        s.botv()[fc] = kb >= 0 ? s.tel()[o + kb * TC] + s.tm()[o + kb * TC] +
                                   s.ter()[o + kb * TC]
                             : T(0);
      }
    }
    __syncthreads();
    // the integrals to the destination edges and the layer means between
    // them: each thread a column and a block of R consecutive layers
    const int per_col = nth / (m * TC) > 0 ? nth / (m * TC) : 1;
    const int R = (kk + per_col - 1) / per_col;
    const int nb = (kk + R - 1) / R;
    for (int i = tid; i < m * nb * TC; i += nth) {
      const int c = i % TC, col = col0 + c;
      const int f = i / TC / nb, k0 = i / TC % nb * R;
      const int k1 = k0 + R < kk ? k0 + R : kk;
      if (col >= ncol) continue;
      const int o = f * K0 + c;
      const L p{s.p() + c}, pdl{s.pd() + c}, dxi{s.dxi() + c};
      const L S{s.S() + f * K1 + c};
      const L c0{s.tel() + o}, c1{s.tm() + o}, c2{s.ter() + o};
      const bool fin = s.pfin()[c] && !s.bad()[f * TC + c];
      const bool mono = s.mono()[c];
      const T botv = s.botv()[f * TC + c];
      T *out = reinterpret_cast<T *>(dst[f0 + f]);
      T acc_prev = T(0), pq_prev = T(0);
      int kf = -1;
#pragma unroll 1
      for (int q = k0; q <= k1; ++q) {
        const T pq = pdl[q];
        const T acc = edge_integral(p, dxi, c0, c1, c2, S, kk, pq, fin,
                                    mono, kf);
        if (q > k0) {
          const T dpd = pq - pq_prev;
          out[(size_t)(q - 1) * n + col] =
              dpd > T(kHeps)
                  ? (acc - acc_prev) * (T(1) / fmx(dpd, T(kHeps)))
                  : botv;
        }
        acc_prev = acc;
        pq_prev = pq;
      }
    }
  }
}

template <typename T, int LT, int LV>
__global__ void __launch_bounds__(THREADS, Tile<T>::MINB)
    ale_remap_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> s(smem, a.kk);
  const int col0 = blockIdx.x * Tile<T>::TC;
  const int nt = a.nt;
  const uint64_t *in = a.fields, *out = a.fields + nt + 2;
  remap_group<LT>(s, a.kk, a.ncol, col0, a.p_src, a.p_dst, in, out, nt,
                  a.pc_upper_t != 0);
  remap_group<LV>(s, a.kk, a.ncol, col0, a.pu_q, a.pu_new, in + nt,
                  out + nt, 1, a.pc_upper_v != 0);
  remap_group<LV>(s, a.kk, a.ncol, col0, a.pv_q, a.pv_new, in + nt + 1,
                  out + nt + 1, 1, a.pc_upper_v != 0);
}

template <typename T, int LT, int LV>
int launch3(const Args<T> &a, size_t smem, cudaStream_t s) {
  auto kern = ale_remap_kernel<T, LT, LV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.ncol + Tile<T>::TC - 1) / Tile<T>::TC;
  kern<<<blocks, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int LT>
int launch_lt(const Args<T> &a, int lim_v, size_t smem, cudaStream_t s) {
  switch (lim_v) {
    case LIM_MONOTONIC:
      return launch3<T, LT, LIM_MONOTONIC>(a, smem, s);
    case LIM_NON_OSCILLATORY:
      return launch3<T, LT, LIM_NON_OSCILLATORY>(a, smem, s);
    default:
      return launch3<T, LT, LIM_POSDEF>(a, smem, s);
  }
}

// The largest kk whose tile fits `limit` bytes of shared memory.
template <typename T>
int kk_max(size_t limit) {
  int kk = 3;
  while (smem_bytes<T>(kk + 1) <= limit) ++kk;
  return kk;
}

template <typename T>
int launch(void *const *ptrs, const int *iargs, void *stream) {
  Args<T> a;
  a.p_src = (const T *)ptrs[0];
  a.pu_q = (const T *)ptrs[1];
  a.pv_q = (const T *)ptrs[2];
  a.p_dst = (const T *)ptrs[3];
  a.pu_new = (const T *)ptrs[4];
  a.pv_new = (const T *)ptrs[5];
  a.fields = (const uint64_t *)ptrs[6];
  a.kk = iargs[0];
  a.ncol = iargs[1];
  a.nt = iargs[2];
  a.pc_upper_t = iargs[3];
  a.pc_upper_v = iargs[4];
  const int lim_t = iargs[5], lim_v = iargs[6];
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (a.kk < 3 || a.kk > kk_max<T>((size_t)limit) || a.nt < 0
      || a.ncol < 1 || lim_t < 0 || lim_t >= N_LIM || lim_v < 0
      || lim_v >= N_LIM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(a.kk);
  cudaStream_t s = (cudaStream_t)stream;
  switch (lim_t) {
    case LIM_MONOTONIC:
      return launch_lt<T, LIM_MONOTONIC>(a, lim_v, smem, s);
    case LIM_NON_OSCILLATORY:
      return launch_lt<T, LIM_NON_OSCILLATORY>(a, lim_v, smem, s);
    default:
      return launch_lt<T, LIM_POSDEF>(a, lim_v, smem, s);
  }
}

}  // namespace

extern "C" {

// ptrs: p_src, pu_q, pv_q, p_dst, pu_new, pv_new, then a device array of
// 2 * (nt + 2) pointers: the nt tracer means, u, v, then their outputs.
// iargs: kk, ncol (= J*I), nt, tracer_pc_upper, velocity_pc_upper,
// tracer limiter, velocity limiter (0 monotonic, 1 non_oscillatory,
// 2 non_oscillatory_posdef).  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for kk outside [3, ale_remap_kk_max], a negative
// nt or an unknown limiter.
int ale_remap_f32(void *const *ptrs, const int *iargs, void *stream) {
  return launch<float>(ptrs, iargs, stream);
}

int ale_remap_f64(void *const *ptrs, const int *iargs, void *stream) {
  return launch<double>(ptrs, iargs, stream);
}

// Dynamic shared memory of one block at kk levels (f64 != 0: double).
long long ale_remap_shared_bytes(int kk, int f64) {
  return (long long)(f64 ? smem_bytes<double>(kk) : smem_bytes<float>(kk));
}

// The largest kk the kernel takes with `limit` bytes of shared memory
// per block.
int ale_remap_kk_max(int f64, long long limit) {
  return f64 ? kk_max<double>((size_t)limit) : kk_max<float>((size_t)limit);
}

}
