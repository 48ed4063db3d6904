// CPPM transport sweep, in its four variants: full or partial
// compatibility of the tracer edges with the thickness parabola,
// non-oscillatory or monotonic limiting.
//
// Replaces the Pallas TPU kernel blom_tpu/dynamics/cppm_pallas.py
// (_sweep_chunk / _make_kernel, which runs cppm._cppm_sweep_body on VMEM
// tiles).  Plain version: blom_tpu_torch/dynamics/cppm.py
// _cppm_sweep_body; the arithmetic below is the same program, written
// per cell.
//
// One launch sweeps every line of one axis: the i-sweep (ax=-1) walks
// rows (k, j) with stride 1, the j-sweep (ax=-2) walks columns (k, i)
// with stride I.  A block owns `nw` adjacent lines of one k-level (nw=1
// for the i-sweep; in the j-sweep nw = 8 neighbouring i columns in f32,
// so that each warp-wide access covers whole 32-byte sectors) and loops
// over every tracer; the k-level is the grid's fastest index.
//
// What bounds it on an H100: the bytes are ~13 (k, j, i) fields at nt=2
// (0.11 ms at 384x360x53 f32), but its time is the latency of its
// dependent stages, each a loop over the block's cells between two
// barriers.  So the design keeps every intermediate of the stencil chain
// in shared memory, one array of line length each, reads each input from
// device memory once (the thickness stages leave each cell's flux
// weights, tracer-edge coefficients, 1 / hn and the divisor of its
// thickness-parabola factors for the tracer loop), and lets the cell
// that owns an edge's upstream parabola write that edge's flux, so a
// tracer takes 4 barriers (3 monotonic).  The +-2 reach of the stencils
// needs no halo because a block holds the whole line.  19 arrays of a
// 360-cell line of 8 columns take 219 KB in f32: one block of 1024
// threads per SM, at most 64 registers each, which the full variants
// meet without spills.
//
// The tracer-matrix coefficients tmc0/tmcl/tmcr are read as the
// precomputed (12, J, I) slabs of init_cppm_coeffs rather than rebuilt
// from dx as the TPU kernel did, since a rebuild would not round as the
// plain version's f64 set-up does.  All 36 of a cell are loaded as one
// batch ahead of the LU arithmetic; the blocks of one line at all
// k-levels run together, so the planes (20 MB in f32 at 384x360) come
// from L2.  The stencil class is a switch, so the LU solve of that class
// alone runs (the plain version evaluates all classes and selects one).
//
// The variant is a template parameter (FULL: compatible tracer edges
// from the per-cell LU solves, else edges from the thickness
// coefficients; MONO: monotonic limiting everywhere, else
// non-oscillatory limiting where the curvature changes sign, with the
// positivity fixes), so each instantiation carries only its own stages:
// the monotonic ones skip both extrema detectors and the positivity
// fixes, the partial ones the LU solves.  Every stencil reaches at most
// two cells along the line, in all four variants, and a block holds the
// whole line, so no variant needs a halo.
//
// Shifts zero-fill at a closed end and wrap on a periodic axis, exactly
// as the plain version's _sh.  Build with -fmad=false so that each
// operation rounds as the plain version's separate tensor operations do;
// a division by a constant is a product with its reciprocal, as PyTorch
// computes `x / 3.` on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block shape, per dtype.  The i-sweep block takes one row with
// THREADS_I threads (two cells each at I = 384); the j-sweep block takes
// NW_F32 (NW_F64) neighbouring i columns with THREADS_J_F32 (_F64)
// threads, so that a warp's loads cover whole 32-byte sectors in i, and
// fewer columns where their line arrays do not fit in the shared memory.
// MINB is the blocks per SM of the larger of the two thread counts that
// __launch_bounds__ asks for: it sets the registers a thread may take,
// 65536 / (MINB * threads), 64 in f32.
constexpr int THREADS_I = 192;
constexpr int THREADS_J_F32 = 1024;
constexpr int THREADS_J_F64 = 256;
constexpr int NW_F32 = 8;
constexpr int NW_F64 = 4;
constexpr int MINB = 1;

template <typename T>
struct Shape {
  static constexpr bool f32 = sizeof(T) == 4;
  static constexpr int threads_j = f32 ? THREADS_J_F32 : THREADS_J_F64;
  static constexpr int threads_max =
      THREADS_I > threads_j ? THREADS_I : threads_j;
  static constexpr int nw = f32 ? NW_F32 : NW_F64;
};

enum { S0000, S1111, S1110, S0111, S1100, S0110, S0011, S0100, S0010 };

// shared-memory arrays, each of nw * N values.  The thickness stages
// use HM, TE (the raw edges), TD2 (the second derivatives), HEL and HER;
// stage 5 leaves each cell's quantities that the tracer loop reads: the
// tracer-edge coefficients TEV0..3, the flux weights P0..2 and the flux
// area CA of the cell's left edge, HO, AI and HNI (1 / hn) for the
// update, and in FULL the thickness parabola as HM, HEL, HER with QH =
// 1 / (12 hm - hel - her).  HF, the thickness flux, shares TD2's array:
// its last read comes before the tracer loop's first write of TD2.
enum {
  A_HM, A_HEL, A_HER, A_TE, A_TD2, A_TM, A_HTF, A_TEV0, A_TEV1, A_TEV2,
  A_TEV3, A_P0, A_P1, A_P2, A_CA, A_HO, A_AI, A_HNI, A_QH, N_ARR
};
constexpr int A_HF = A_TD2;
// 1 / hm of each cell for the LU solves, in HTF's array, which the
// tracer loop first writes after them
constexpr int A_HMI = A_HTF;

template <typename T>
struct Args {
  const T *hm, *tm, *ca, *db, *du, *dl, *ai, *div;
  const int32_t *stencil;
  const T *hevc, *ssc, *scc, *d2m, *tmc0, *tmcl, *tmcr;
  T *hn, *tmn, *hf, *htf;
  int kk, J, I, nt, ax, periodic, nw, db3, ai3;
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
__device__ __forceinline__ T sgn(T x) {
  return (T)((x > T(0)) - (x < T(0)));
}

template <typename T>
__device__ __forceinline__ T safe(T x) {
  return x == T(0) ? T(1) : x;
}

template <typename T>
struct Line {
  int N, nw, w, periodic;
  long base2;     // 2-D offset of the line's first cell
  long stride;    // 2-D offset between neighbouring cells of the line
  T *sh;          // shared arrays

  // neighbour position; false where a closed end is crossed.  A
  // periodic line wraps by the remainder, as torch.roll does: an offset
  // of +-2 passes more than one period on a line of length 1.
  __device__ __forceinline__ bool nb(int p, int off, int &q) const {
    q = p + off;
    if (q < 0 || q >= N) {
      if (!periodic) return false;
      q %= N;
      if (q < 0) q += N;
    }
    return true;
  }
  __device__ __forceinline__ T &s(int arr, int p) const {
    return sh[(long)arr * N * nw + (long)p * nw + w];
  }
  // shared array `arr` at p+off, zero past a closed end
  __device__ __forceinline__ T so(int arr, int p, int off) const {
    int q;
    return nb(p, off, q) ? s(arr, q) : T(0);
  }
  __device__ __forceinline__ long i2(int p) const {
    return base2 + (long)p * stride;
  }
  // device field f (plane offset koff) at p+off, zero past a closed end
  __device__ __forceinline__ T go(const T *f, long koff, int p,
                                  int off) const {
    int q;
    return nb(p, off, q) ? f[koff + i2(q)] : T(0);
  }
};

// Flux-integration weights of the upstream parabola
// (flux_integration, mod_cppm.F90:1373-1468): p0, p1, p2 such that the
// flux at the left edge of cell p of a field with parabola coefficients
// (c0, c1, c2) of the upstream cell is (p0*c0 + p1*c1 + p2*c2) * ca;
// upstream is cell p for ca < 0 and cell p-1 otherwise.
template <typename T>
__device__ __forceinline__ void flux_weights(const Args<T> &a,
                                             const Line<T> &L, long k3,
                                             int p, T ca, T &p0, T &p1,
                                             T &p2) {
  const T c1_2 = T(.5), c1_3 = T(1. / 3.), c1_4 = T(.25), c1_5 = T(1. / 5.);
  const long ix = L.i2(p);
  const T db = a.db[(a.db3 ? k3 : 0) + ix];
  if (ca < T(0)) {
    const T hpc0 = L.s(A_HEL, p);
    const T hm = L.s(A_HM, p), her = L.s(A_HER, p);
    const T hpc1 = T(6) * hm - T(4) * hpc0 - T(2) * her;
    const T hpc2 = T(3) * (hpc0 - T(2) * hm + her);
    const T c = ca * L.s(A_AI, p);
    const T hb = fmx(db - a.du[k3 + ix], T(0));
    const bool deep = a.dl[k3 + ix] > db;
    const T hf_par = hpc0 - (c1_2 * hpc1 - c1_3 * hpc2 * c) * c;
    p0 = deep ? hb : hf_par;
    p1 = deep ? T(-.5) * hb * c
              : -(c1_2 * hpc0 - (c1_3 * hpc1 - c1_4 * hpc2 * c) * c) * c;
    p2 = deep ? c1_3 * hb * c * c
              : (c1_3 * hpc0 - (c1_4 * hpc1 - c1_5 * hpc2 * c) * c) * c * c;
  } else {
    const T h0w = L.so(A_HEL, p, -1);
    const T hmw = L.so(A_HM, p, -1), herw = L.so(A_HER, p, -1);
    int q;
    const bool ok = L.nb(p, -1, q);
    const T h1w = ok ? T(6) * hmw - T(4) * h0w - T(2) * herw : T(0);
    const T h2w = ok ? T(3) * (h0w - T(2) * hmw + herw) : T(0);
    const T duw = L.go(a.du, k3, p, -1);
    const T dlw = L.go(a.dl, k3, p, -1);
    const T cw = ca * L.so(A_AI, p, -1);
    const T q1 = T(1) - c1_2 * cw;
    const T q2 = T(1) - (T(1) - c1_3 * cw) * cw;
    const T hb = fmx(db - duw, T(0));
    const bool deep = dlw > db;
    const T hf_par = h0w + q1 * h1w + q2 * h2w;
    const T q3 = c1_4 * (T(1) + T(3) * (T(1) - cw) * q2);
    const T q4 = c1_5 * (T(1) + T(4) * (T(1) - cw) * q3);
    p0 = deep ? hb : hf_par;
    p1 = deep ? q1 * hb : q1 * h0w + q2 * h1w + q3 * h2w;
    p2 = deep ? q2 * hb : q2 * h0w + q3 * h1w + q4 * h2w;
  }
}

// the thickness-parabola factors of a FULL cell (mod_cppm.F90:731-1371):
// with them the tracer parabola's slope is hf1m tm + hf1l tel + hf1r ter
// and its curvature hf2m tm + hf2l tel + hf2r ter, hf2m = -hf1m
template <typename T>
struct HFac {
  T f1m, f1l, f1r, f2m, f2l, f2r;
  __device__ __forceinline__ void load(const Line<T> &L, int p) {
    const T hm = L.s(A_HM, p), hel = L.s(A_HEL, p), her = L.s(A_HER, p);
    const T qh = L.s(A_QH, p);
    f1m = T(60) * hm * qh;
    f1l = -(T(42) * hm + T(4) * hel - T(6) * her) * qh;
    f1r = -(T(18) * hm - T(4) * hel + T(6) * her) * qh;
    f2m = -f1m;
    f2l = T(5) * (T(6) * hm + hel - her) * qh;
    f2r = T(5) * (T(6) * hm - hel + her) * qh;
  }
};

// The compatible tracer-edge coefficients of cell p in stencil class st
// (mod_cppm.F90:505-560): the LU solve of the class's rows of the
// compatible-edge matrix.  Row 3 o + m (m = 0, 1, 2) is built from the
// coefficient rows 3 o + m of cell p and the thickness of the cell at
// p + o - 2 (its edges and 1 / hm; past a closed end 0, where no class
// reads the row).  All 36 coefficients are loaded first, as one batch that
// depends on nothing but the cell (the unused rows of a class cost no
// more sectors, since the warp's other cells read them), and the rows of
// all four offsets are formed from them; the class then selects its LU
// solve, as the plain version selects among all classes.
template <typename T>
__device__ __forceinline__ void tracer_edge_coeffs(const Args<T> &a,
                                                   const Line<T> &L, int p,
                                                   int st, T tev[4]) {
  const long JI = (long)a.J * a.I;
  const long ix = L.i2(p);
  T c0[12], cl[12], cr[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    c0[j] = a.tmc0[j * JI + ix];
    cl[j] = a.tmcl[j * JI + ix];
    cr[j] = a.tmcr[j * JI + ix];
  }
  T r[12];
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const T hl = L.so(A_HEL, p, o - 2);
    const T hr = L.so(A_HER, p, o - 2);
    const T hi = L.so(A_HMI, p, o - 2);
#pragma unroll
    for (int m = 3 * o; m < 3 * o + 3; ++m)
      r[m] = c0[m] + (cl[m] * hl + cr[m] * hr) * hi;
  }
  const T a12 = r[0], a13 = r[1], a14 = r[2];
  const T b22 = r[3], b23 = r[4], b24 = r[5];
  const T b32 = r[6], b33 = r[7], b34 = r[8];
  const T b42 = r[9], b43 = r[10], b44 = r[11];
  tev[0] = tev[1] = tev[2] = tev[3] = T(0);
  switch (st) {
    case S1111: {
      const T a22 = b22 - a12, a23 = b23 - a13, a24 = b24 - a14;
      const T a32 = b32 - a12, a33 = b33 - a13, a34 = b34 - a14;
      const T a42 = b42 - a12, a43 = b43 - a13, a44 = b44 - a14;
      const T q = T(1) / safe(a22);
      const T a23q = a23 * q;
      const T c33 = a33 - a23q * a32;
      const T c43 = a43 - a23q * a42;
      const T a24q = a24 * q;
      T c34 = a34 - a24q * a32;
      T c44 = a44 - a24q * a42;
      c34 = c34 / safe(c33);
      c44 = c44 - c34 * c43;
      T t2 = -a12;
      T t3 = -a13 - a23q * t2;
      T t4 = -a14 - a24q * t2 - c34 * t3;
      t4 = t4 / safe(c44);
      t3 = (t3 - c43 * t4) / safe(c33);
      t2 = (t2 - a32 * t3 - a42 * t4) / safe(a22);
      tev[0] = T(1) - t2 - t3 - t4;
      tev[1] = t2;
      tev[2] = t3;
      tev[3] = t4;
      break;
    }
    case S1110: {
      const T d23 = (b23 - a13) / safe(b22 - a12);
      const T d33 = (b33 - a13) - d23 * (b32 - a12);
      T t2 = -a12;
      const T t3 = (-a13 - d23 * t2) / safe(d33);
      t2 = (t2 - (b32 - a12) * t3) / safe(b22 - a12);
      tev[0] = T(1) - t2 - t3;
      tev[1] = t2;
      tev[2] = t3;
      break;
    }
    case S0111: {
      const T e32 = b32 - b22, e42 = b42 - b22;
      const T e33 = (b33 - b23) / safe(e32);
      const T e43 = (b43 - b23) - e33 * e42;
      T t3 = -b22;
      const T t4 = (-b23 - e33 * t3) / safe(e43);
      t3 = (t3 - e42 * t4) / safe(e32);
      tev[1] = T(1) - t3 - t4;
      tev[2] = t3;
      tev[3] = t4;
      break;
    }
    case S1100: {
      const T t2 = -a12 / safe(b22 - a12);
      tev[0] = T(1) - t2;
      tev[1] = t2;
      break;
    }
    case S0110: {
      const T t3 = -b22 / safe(b32 - b22);
      tev[1] = T(1) - t3;
      tev[2] = t3;
      break;
    }
    case S0011: {
      const T t4 = -b32 / safe(b42 - b32);
      tev[2] = T(1) - t4;
      tev[3] = t4;
      break;
    }
    case S0100:
      tev[1] = T(1);
      break;
    case S0010:
      tev[2] = T(1);
      break;
    default:
      break;
  }
}

template <typename T>
__device__ __forceinline__ T minmod3(T sl, T sr, T sc) {
  return sgn(sc) * fmn(fmn(fab(sl), fab(sr)), fab(sc));
}

// Minmod-clamped edge values el2, er2 of a cell with mean m, neighbour
// means m_m, m_p and raw edges el, er (the slope clamp every limiter
// starts from); false where the cell has no monotone slope, and then the
// limiters take m at both edges
template <typename T>
__device__ __forceinline__ bool edge_clamp(T m, T m_m, T m_p, T ssc, T scc,
                                           T el, T er, T &el2, T &er2) {
  const T sl = ssc * (m - m_m), sr = ssc * (m_p - m);
  if (!(sl * sr > T(0))) return false;
  const T sc = minmod3(sl, sr, scc * (m_p - m_m));
  el2 = ((m_m - el) * (m - el) > T(0))
      ? m - sgn(sc) * fmn(T(.5) * fab(sc), fab(el - m)) : el;
  er2 = ((m_p - er) * (m - er) > T(0))
      ? m + sgn(sc) * fmn(T(.5) * fab(sc), fab(er - m)) : er;
  return true;
}

// the overshoot limit of a parabola's interior extremum (PPM form)
template <typename T>
__device__ __forceinline__ void extremum_limit(T m, T el2, T er2, T &el,
                                               T &er) {
  const T d = er2 - el2;
  const T q = d * (T(2) * m - el2 - er2);
  const T r = d * d * (T(1) / T(3));
  el = q > r ? T(3) * m - T(2) * er2 : el2;
  er = -r > q ? T(3) * m - T(2) * el2 : er2;
}

// the parabola of a tracer (mean tm, limited edges tel, ter) as the
// coefficients (c0, c1, c2) of the flux integration
template <typename T, bool FULL>
__device__ __forceinline__ void tracer_parabola(const HFac<T> &f, T tm,
                                                T tel, T ter, T &c0, T &c1,
                                                T &c2) {
  c0 = tel;
  if constexpr (FULL) {
    c1 = f.f1m * tm + f.f1l * tel + f.f1r * ter;
    c2 = f.f2m * tm + f.f2l * tel + f.f2r * ter;
  } else {
    c1 = T(6) * tm - T(4) * tel - T(2) * ter;
    c2 = T(3) * (tel - T(2) * tm + ter);
  }
}

template <typename T, bool FULL, bool MONO>
__global__ void __launch_bounds__(Shape<T>::threads_max, MINB)
    cppm_sweep_kernel(Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  const bool isweep = a.ax == -1;
  const int k = blockIdx.x;
  const int lb = blockIdx.y;   // block of lines
  const long JI = (long)a.J * a.I;
  const long k3 = (long)k * JI;
  const long NK = (long)a.kk * JI;
  const int N = isweep ? a.I : a.J;
  const int nlines = isweep ? a.J : a.I;
  const int ncell = N * a.nw;
  const T dpeps = T(1e-12);

  Line<T> L;
  L.N = N;
  L.nw = a.nw;
  L.periodic = a.periodic;
  L.sh = reinterpret_cast<T *>(smem_raw);
  L.stride = isweep ? 1 : a.I;

#define FOR_CELLS                                                   \
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {           \
    const int p = c / a.nw;                                         \
    L.w = c - p * a.nw;                                             \
    const int line = lb * a.nw + L.w;                               \
    if (line >= nlines) continue;                                   \
    L.base2 = isweep ? (long)line * a.I : (long)line;               \
    const long ix = L.i2(p);                                        \
    (void)ix;

#define END_CELLS }

  // ---- 1: thickness, with the transverse divergence correction; the
  // first tracer
  FOR_CELLS
    const T ho = fmx(a.hm[k3 + ix], T(0)) + dpeps;
    const T ai = a.ai[(a.ai3 ? k3 : 0) + ix];
    L.s(A_HO, p) = ho;
    L.s(A_AI, p) = ai;
    const T hm = a.div ? ho / (T(1) - a.div[k3 + ix] * ai) : ho;
    L.s(A_HM, p) = hm;
    if constexpr (FULL) L.s(A_HMI, p) = T(1) / hm;
    if (a.nt > 0) L.s(A_TM, p) = a.tm[k3 + ix];
  END_CELLS
  __syncthreads();

  // ---- 2: 4th-order edge estimate (h_edges_*, mod_cppm.F90:361-380);
  // in PARTIAL its coefficients are the tracers' too
  FOR_CELLS
    const T *hv = a.hevc + ix;
    const T v0 = hv[0], v1 = hv[JI], v2 = hv[2 * JI];
    const T v3 = hv[3 * JI];
    L.s(A_TE, p) = v0 * L.so(A_HM, p, -2) + v1 * L.so(A_HM, p, -1)
                   + v2 * L.s(A_HM, p) + v3 * L.so(A_HM, p, 1);
    if constexpr (!FULL) {
      L.s(A_TEV0, p) = v0;
      L.s(A_TEV1, p) = v1;
      L.s(A_TEV2, p) = v2;
      L.s(A_TEV3, p) = v3;
    }
  END_CELLS
  __syncthreads();

  // ---- 3: second-derivative extrema detector (non-oscillatory only)
  if constexpr (!MONO) {
    FOR_CELLS
      const T hm = L.s(A_HM, p);
      const T hel = L.s(A_TE, p), her = L.so(A_TE, p, 1);
      L.s(A_TD2, p) = a.d2m[ix] * (hel - T(2) * hm + her);
    END_CELLS
    __syncthreads();
  }

  // ---- 4: limiting, and for non-oscillatory limiting the positivity of
  // the thickness parabola (h_edges_nosc, mod_cppm.F90:381-430;
  // h_edges_mono, :436-488)
  FOR_CELLS
    const T hm = L.s(A_HM, p);
    T hel = L.s(A_TE, p), her = L.so(A_TE, p, 1);
    bool need = true;
    if constexpr (!MONO) {
      const T d2h = L.s(A_TD2, p);
      need = (L.so(A_TD2, p, -1) * d2h <= T(0))
             || (d2h * L.so(A_TD2, p, 1) <= T(0));
    }
    if (need) {
      T hel2, her2;
      if (edge_clamp(hm, L.so(A_HM, p, -1), L.so(A_HM, p, 1),
                     a.ssc[ix], a.scc[ix], hel, her, hel2,
                     her2)) {
        extremum_limit(hm, hel2, her2, hel, her);
      } else {
        hel = hm;
        her = hm;
      }
    }
    if constexpr (!MONO) {
      hel = fmx(hel, dpeps);
      her = fmx(her, dpeps);
      const T sl = T(2) * (T(3) * hm - T(2) * hel - her);
      const T a2 = T(3) * (hel - T(2) * hm + her);
      const T sr = sl + T(2) * a2;
      if (sl < T(0) && sr > T(0)
          && (a2 * hel - T(.25) * sl * sl < a2 * dpeps)) {
        const T qq = T(3) * hm / (T(3) * sl * sr + T(4) * a2 * a2);
        hel = sl * sl * qq;
        her = sr * sr * qq;
      }
    }
    L.s(A_HEL, p) = hel;
    L.s(A_HER, p) = her;
  END_CELLS
  __syncthreads();

  // ---- 5: compatible tracer-edge coefficients (per-cell LU solve of the
  // cell's stencil class; full compatibility only), the flux weights of
  // the cell's left edge and the thickness flux there
  FOR_CELLS
    if constexpr (FULL) {
      T tev[4];
      tracer_edge_coeffs(a, L, p, a.stencil[ix], tev);
      L.s(A_TEV0, p) = tev[0];
      L.s(A_TEV1, p) = tev[1];
      L.s(A_TEV2, p) = tev[2];
      L.s(A_TEV3, p) = tev[3];
    }
    const T ca = a.ca[k3 + ix];
    T p0, p1, p2;
    flux_weights(a, L, k3, p, ca, p0, p1, p2);
    L.s(A_P0, p) = p0;
    L.s(A_P1, p) = p1;
    L.s(A_P2, p) = p2;
    L.s(A_CA, p) = ca;
    L.s(A_HF, p) = p0 * ca;
  END_CELLS
  __syncthreads();

  // ---- 5b: hn and hf (written once), 1 / hn, and in FULL the divisor of
  // the thickness-parabola factors; each cell's own values, read by the
  // same thread in the tracer loop, so no barrier follows
  FOR_CELLS
    const T ho = L.s(A_HO, p), ai = L.s(A_AI, p), hf = L.s(A_HF, p);
    const T hn = ho - (L.so(A_HF, p, 1) - hf) * ai;
    a.hn[k3 + ix] = hn;
    a.hf[k3 + ix] = hf;
    L.s(A_HNI, p) = T(1) / hn;
    if constexpr (FULL)
      L.s(A_QH, p) = T(1) / (T(12) * L.s(A_HM, p) - L.s(A_HEL, p)
                             - L.s(A_HER, p));
  END_CELLS

  for (int t = 0; t < a.nt; ++t) {
    const long t3 = t * NK + k3;
    // ---- 6b: tracer edge values: compatible (the cell's LU
    // coefficients) or from the thickness coefficients (mod_cppm.F90:
    // 1143-1155)
    FOR_CELLS
      L.s(A_TE, p) = L.s(A_TEV0, p) * L.so(A_TM, p, -2)
                     + L.s(A_TEV1, p) * L.so(A_TM, p, -1)
                     + L.s(A_TEV2, p) * L.s(A_TM, p)
                     + L.s(A_TEV3, p) * L.so(A_TM, p, 1);
    END_CELLS
    __syncthreads();

    // ---- 6c: extrema detector of the tracer parabola (non-oscillatory
    // only)
    if constexpr (!MONO) {
      FOR_CELLS
        const T tm = L.s(A_TM, p);
        const T tel = L.s(A_TE, p), ter = L.so(A_TE, p, 1);
        if constexpr (FULL) {
          HFac<T> f;
          f.load(L, p);
          L.s(A_TD2, p) = a.d2m[ix] * (f.f2m * tm + f.f2l * tel
                                       + f.f2r * ter);
        } else {
          L.s(A_TD2, p) = a.d2m[ix] * (tel - T(2) * tm + ter);
        }
      END_CELLS
      __syncthreads();
    }

    // ---- 6d: limiting, positivity and parabola coefficients
    // (parabola_coeffs_{fc,pc}_{nosc,mono}, mod_cppm.F90:731-1371); the
    // cell then writes the flux of each edge whose upstream cell it is:
    // its left edge where ca < 0, its right edge where ca >= 0 there
    FOR_CELLS
      const T tm = L.s(A_TM, p);
      T tel = L.s(A_TE, p), ter = L.so(A_TE, p, 1);
      bool need = true;
      if constexpr (!MONO) {
        const T d2t = L.s(A_TD2, p);
        need = (L.so(A_TD2, p, -1) * d2t <= T(0))
               || (d2t * L.so(A_TD2, p, 1) <= T(0));
      }
      HFac<T> f;
      if constexpr (FULL) {
        f.load(L, p);
        if (need) {
          T tel2, ter2;
          if (edge_clamp(tm, L.so(A_TM, p, -1), L.so(A_TM, p, 1),
                         a.ssc[ix], a.scc[ix], tel, ter, tel2,
                         ter2)) {
            const T sl2 = f.f1m * tm + f.f1l * tel2 + f.f1r * ter2;
            const T a2 = f.f2m * tm + f.f2l * tel2 + f.f2r * ter2;
            const T sr2 = sl2 + T(2) * a2;
            const bool fix = sl2 * sr2 < T(0);
            const bool left_fix = (ter2 - tel2) * a2 < T(0);
            const T tel3 = (fix && left_fix)
                ? -((f.f1m + T(2) * f.f2m) * tm
                    + (f.f1r + T(2) * f.f2r) * ter2)
                      / (f.f1l + T(2) * f.f2l)
                : tel2;
            const T ter3 = (fix && !left_fix)
                ? -(f.f1m * tm + f.f1l * tel3) / f.f1r : ter2;
            tel = tel3;
            ter = ter3;
          } else {
            tel = tm;
            ter = tm;
          }
        }
        if (!MONO && t >= 1) {
          // positivity for salinity and passive tracers
          T tel_p = fmx(tel, T(0)), ter_p = fmx(ter, T(0));
          const T sl3 = f.f1m * tm + f.f1l * tel_p + f.f1r * ter_p;
          const T a23 = f.f2m * tm + f.f2l * tel_p + f.f2r * ter_p;
          const T sr3 = sl3 + T(2) * a23;
          if (sl3 < T(0) && sr3 > T(0)
              && (a23 * tel_p - T(.25) * sl3 * sl3 < T(0))) {
            const T qq = T(3) * tm / (T(3) * sl3 * sr3 + T(4) * a23 * a23);
            tel_p = sl3 * sl3 * qq;
            ter_p = sr3 * sr3 * qq;
          }
          tel = tel_p;
          ter = ter_p;
        }
      } else {
        if (need) {
          T tel2, ter2;
          if (edge_clamp(tm, L.so(A_TM, p, -1), L.so(A_TM, p, 1),
                         a.ssc[ix], a.scc[ix], tel, ter, tel2,
                         ter2)) {
            extremum_limit(tm, tel2, ter2, tel, ter);
          } else {
            tel = tm;
            ter = tm;
          }
        }
        if (!MONO && t >= 1) {
          // positivity for salinity and passive tracers, PPM form
          T tel_p = fmx(tel, T(0)), ter_p = fmx(ter, T(0));
          const T sl3 = T(2) * (T(3) * tm - T(2) * tel_p - ter_p);
          const T a23 = T(3) * (tel_p - T(2) * tm + ter_p);
          const T sr3 = sl3 + T(2) * a23;
          if (sl3 < T(0) && sr3 > T(0)
              && (a23 * tel_p - T(.25) * sl3 * sl3 < T(0))) {
            const T qq = T(3) * tm / (T(3) * sl3 * sr3 + T(4) * a23 * a23);
            tel_p = sl3 * sl3 * qq;
            ter_p = sr3 * sr3 * qq;
          }
          tel = tel_p;
          ter = ter_p;
        }
      }
      T c0, c1, c2;
      tracer_parabola<T, FULL>(f, tm, tel, ter, c0, c1, c2);
      const T ca = L.s(A_CA, p);
      if (ca < T(0))
        L.s(A_HTF, p) = (L.s(A_P0, p) * c0 + L.s(A_P1, p) * c1
                         + L.s(A_P2, p) * c2) * ca;
      int q;
      if (L.nb(p, 1, q)) {
        const T car = L.s(A_CA, q);
        if (!(car < T(0)))
          L.s(A_HTF, q) = (L.s(A_P0, q) * c0 + L.s(A_P1, q) * c1
                           + L.s(A_P2, q) * c2) * car;
      }
      if (!L.nb(p, -1, q) && !(ca < T(0))) {
        // the left edge of a closed line: its upstream cell lies beyond
        // the end, whose parabola is zero
        L.s(A_HTF, p) = (L.s(A_P0, p) * T(0) + L.s(A_P1, p) * T(0)
                         + L.s(A_P2, p) * T(0)) * ca;
      }
    END_CELLS
    __syncthreads();

    // ---- 6f: cell update, and the next tracer
    FOR_CELLS
      const T htf = L.s(A_HTF, p);
      a.tmn[t3 + ix] = (L.s(A_HO, p) * L.s(A_TM, p)
                        - (L.so(A_HTF, p, 1) - htf) * L.s(A_AI, p))
                       * L.s(A_HNI, p);
      a.htf[t3 + ix] = htf;
      if (t + 1 < a.nt) L.s(A_TM, p) = a.tm[t3 + NK + ix];
    END_CELLS
    if (t + 1 < a.nt) __syncthreads();
  }
#undef FOR_CELLS
#undef END_CELLS
}

template <typename T, bool FULL, bool MONO>
int launch_variant(const Args<T> &a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cppm_sweep_kernel<T, FULL, MONO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nlines = a.ax == -1 ? a.J : a.I;
  // the k-level is the grid's fastest index: the blocks of one line at
  // every level run close together and share its coefficient planes in L2
  const dim3 grid(a.kk, (nlines + a.nw - 1) / a.nw);
  cppm_sweep_kernel<T, FULL, MONO><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Lines per block (nw) and shared bytes per block of a sweep with lines
// of N cells on axis ax: fewer lines than NW_F32 (NW_F64) where they do
// not fit in the device's shared memory (the j-sweep at large J, in f64
// first); cudaErrorInvalidValue where one line does not fit.
template <typename T>
int block_lines(int N, int ax, int &nw, size_t &smem) {
  nw = ax == -1 ? 1 : Shape<T>::nw;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t line_bytes = (size_t)N_ARR * N * sizeof(T);
  while (nw > 1 && line_bytes * nw > (size_t)smem_max) nw /= 2;
  if (line_bytes > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  smem = line_bytes * nw;
  return cudaSuccess;
}

template <typename T>
int launch(void *const *ptrs, const int *iargs, void *stream) {
  Args<T> a;
  a.hm = (const T *)ptrs[0];
  a.tm = (const T *)ptrs[1];
  a.ca = (const T *)ptrs[2];
  a.db = (const T *)ptrs[3];
  a.du = (const T *)ptrs[4];
  a.dl = (const T *)ptrs[5];
  a.ai = (const T *)ptrs[6];
  a.div = (const T *)ptrs[7];
  a.stencil = (const int32_t *)ptrs[8];
  a.hevc = (const T *)ptrs[9];
  a.ssc = (const T *)ptrs[10];
  a.scc = (const T *)ptrs[11];
  a.d2m = (const T *)ptrs[12];
  a.tmc0 = (const T *)ptrs[13];
  a.tmcl = (const T *)ptrs[14];
  a.tmcr = (const T *)ptrs[15];
  a.hn = (T *)ptrs[16];
  a.tmn = (T *)ptrs[17];
  a.hf = (T *)ptrs[18];
  a.htf = (T *)ptrs[19];
  a.kk = iargs[0];
  a.J = iargs[1];
  a.I = iargs[2];
  a.nt = iargs[3];
  a.ax = iargs[4];
  a.periodic = iargs[5];
  a.db3 = iargs[6];
  a.ai3 = iargs[7];
  const int full = iargs[8], mono = iargs[9];
  const int threads = a.ax == -1 ? THREADS_I : Shape<T>::threads_j;
  const int N = a.ax == -1 ? a.I : a.J;
  size_t smem;
  const int err = block_lines<T>(N, a.ax, a.nw, smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (full)
    return mono ? launch_variant<T, true, true>(a, threads, smem, s)
                : launch_variant<T, true, false>(a, threads, smem, s);
  return mono ? launch_variant<T, false, true>(a, threads, smem, s)
              : launch_variant<T, false, false>(a, threads, smem, s);
}

}  // namespace

extern "C" {

// ptrs: hm, tm, ca, db, du, dl, ai, div (or null), stencil, hevc, ssc,
// scc, d2m, tmc0, tmcl, tmcr, hn, tmn, hf, htf.
// iargs: kk, J, I, nt, ax, periodic, db3, ai3, full (compatibility
// 'full', else 'partial'), mono (limiting 'monotonic', else
// 'non_oscillatory').  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue when one line does not fit in shared memory (N
// above 3874 in f32, 1937 in f64, at the H100's 227 KB per block).
int cppm_sweep_f32(void *const *ptrs, const int *iargs, void *stream) {
  return launch<float>(ptrs, iargs, stream);
}

int cppm_sweep_f64(void *const *ptrs, const int *iargs, void *stream) {
  return launch<double>(ptrs, iargs, stream);
}

// dynamic shared memory of a block sweeping lines of n cells on axis ax
// (-1: i, -2: j), in f64 or f32; -1 where one line does not fit
long long cppm_sweep_shared_bytes(int n, int ax, int f64) {
  int nw;
  size_t smem;
  const int err = f64 ? block_lines<double>(n, ax, nw, smem)
                      : block_lines<float>(n, ax, nw, smem);
  return err == cudaSuccess ? (long long)smem : -1;
}

}
