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
// temporaries and has no coupling in k.  One launch computes it: one
// block per tile of TJ x TI points and KB k-levels, grid (ceil(I/TI),
// ceil(J/TJ), ceil(kk/KB)).  Every intermediate that the body reads at a
// neighbour is computed once per point of the tile and of the ring
// around it that the later stages read, into shared memory, by
// block-strided loops separated by __syncthreads().  Regions are given
// as the offsets of their first and last rows and columns from the
// tile's, j then i:
//   0. once for the block's levels, j, i [-2, +2]: the barotropic part
//      of the four total velocities, (j, i) fields;
//   1. per level, utotn, vtotn on j, i [-2, +2]; utotm, vtotm, uflux0,
//      vflux0 on [-1, +1]; dpmx, wgtja, wgtia on [-1, +2]; wgtjb on
//      j [-2, +1] x i [-1, +2]; wgtib on j [-1, +2] x i [-2, +1];
//   2. dl2u, dl2v on [-1, +1]; defor1 on [-2, +1]; defor2 on [-1, +2];
//      potvor on [0, +1]; ke on [-1, 0]; for enedis the mass-flux bounds,
//      uh on j [-1, 0] x i [0, +1], vh on j [0, +1] x i [-1, 0];
//   3. [-1, +1]: the viscosity pairs (vsc2, vsc4) at u and at v points;
//   4. uflux1 on j [0, 0] x i [-1, 0], vflux1 on j [-1, 0] x i [0, 0];
//   5. the tile: the remaining fluxes, Coriolis, bottom stress and u_new,
//      v_new.
// So the outputs of a tile read its inputs 2 points past it
// (momtum_cuda.HALO, to which tests/test_torch_momtum.py holds the plain
// body); stage 1 reads one point more for dpmx and the weights.  A
// stage's fields run one region after another in one loop, so no thread
// idles until its last pass and each field's reads are straight-line
// code that issues them together.
//
// Edges: the plain version's shifted fields are zero past a closed edge
// and wrapped on a periodic one, computed fields as well as inputs.  A
// stage stores 0 at a point past a closed edge; at a point past a
// periodic edge it computes from the wrapped inputs, which gives the
// wrapped value.  The later stages read the shared arrays at their
// neighbours with no test, except defor2, which reads ujb and vib (not
// staged) at one neighbour each.  Input reads wrap their index and
// select 0 past a closed edge; a tile whose reads all lie inside the
// grid (the interior, ~76 % of the tiles at 384 x 360) runs an
// instantiation with neither.
//
// What bounds it on an H100: the bytes, 17 (k, j, i) input fields, 12
// (j, i) fields and 21 metric planes read and 2 fields written, set the
// least time; nothing else goes to device memory.  What holds it above
// that is the latency of its ~250 shared-memory and cached reads per
// point, which only more warps hide: in f32 two blocks of 512 threads fit
// an SM when a thread takes at most 64 registers (MIN_BLOCKS; with 80,
// one block fits and the kernel runs 1.5x slower), and staging the
// (k, j, i) inputs in shared memory with cp.async ran slower, not
// faster.  The shared arrays (24 of SJ x SI, 28 for enedis; three hold a
// later stage's field once their own last reader has run) take 69 KB a
// block in f32 (81 KB enedis) and 138 KB in f64 (161 KB), dynamic shared
// memory.
//
// The tripolar fold (Grid.arctic): a j+1 read at the top row J-1 that
// blom_tpu tags with a point class and vector-ness reads the fold's ghost,
// the i-mirrored (sign-flipped for a vector) value at row J-3 (p and u
// points) or J-2 (q and v points), parallel/arctic.py fold_row; an
// untagged read there reads 0, as past a closed edge.  The body reads
// across the fold derived fields as well as inputs, and a derived
// field's mirror lies in another tile.  So a second kernel runs first,
// the fold pre-pass: one row of blocks, each a tile of the two rows J-3
// and J-2, runs stages 0 to 3 there (none of whose values on those rows
// reads the ghost row, which the tests check) and writes each derived
// field that a tagged read takes across the fold, mirrored and signed,
// into a ghost buffer of (kk, N_GH, I).  The main kernel's FOLD
// instantiation then stores, at each shared point of row J, the
// buffer's ghost for those fields (0 past a closed i edge) and 0 for the
// rest, and reads the inputs that tagged reads take at row J at their
// mirrored points.  Rows below J and a grid without the fold run as
// before, and the non-arctic instantiation is the same code as without
// the fold.
//
// Build with -fmad=false so that each operation rounds as the plain
// version's separate tensor operations do.

#include <cuda_runtime.h>

// the shared arrays, as T (8-byte aligned)
extern __shared__ double momtum_smem[];

namespace {

enum { MOM_ENSCON, MOM_ENECON, MOM_ENEDIS };

enum { F_U_M, F_U_N, F_V_M, F_V_N, F_DP_M, F_DPU_M, F_DPV_M, F_P_LO, F_P_HI,
       F_PU_LO, F_PU_HI, F_PV_LO, F_PV_HI, F_STRESS_U, F_STRESS_V, F_PGF_U,
       F_PGF_V, N_F };

enum { D_UBFLXS_M, D_UBFLXS_N, D_VBFLXS_M, D_VBFLXS_N, D_PBU_M, D_PBV_M,
       D_PBU_N, D_PBV_N, D_DRAG, D_UBRHS, D_VBRHS, D_DIFWGT, N_D };

enum { G_IP, G_IU, G_IV, G_IQ, G_SCUX, G_SCUY, G_SCVX, G_SCVY, G_SCUXI,
       G_SCVYI, G_SCU2, G_SCV2, G_SCP2I, G_SCQ2I, G_SCPX, G_SCPY, G_SCQX,
       G_SCQY, G_DIFMXP, G_DIFMXQ, G_CORIOQ, N_G };

constexpr int TI = 32, TJ = 16;    // the tile: one warp along i per row
constexpr int H = 2;               // the ring of stage 1
constexpr int SI = TI + 2 * H, SJ = TJ + 2 * H;
constexpr int NTHREADS = TI * TJ;
constexpr int KB = 4;              // k-levels of a block
// blocks an SM must hold by registers: two in f32 (at most 64 registers
// a thread), where two blocks' shared arrays fit an SM; one in f64, where
// they do not
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;

// shared arrays; a field whose last reader is an earlier stage's makes
// room for a later one
enum { S_BUM, S_BVM, S_BUN, S_BVN, S_UTOTM, S_VTOTM, S_UTOTN, S_VTOTN,
       S_UFLUX0, S_VFLUX0, S_WGTJA, S_WGTJB, S_WGTIA, S_WGTIB, S_DPMX,
       S_DL2U, S_DL2V, S_POTVOR, S_DEFOR1, S_DEFOR2, S_KE, S_VSC4U, S_VSC2V,
       S_VSC4V, N_S,
       // enedis only
       S_UHMIN = N_S, S_UHMAX, S_VHMIN, S_VHMAX, N_S_ENEDIS,
       S_VSC2U = S_DPMX,       // dpmx is last read in stage 2
       S_UFLUX1 = S_DEFOR1,    // defor1, defor2 in stage 3
       S_VFLUX1 = S_DEFOR2 };

// point classes of the fold's mirror (parallel/arctic.py fold_row)
enum { K_P, K_U, K_Q, K_V };

// the derived fields a tagged j+1 read takes across the fold, in the
// order of the ghost buffer; the first GH_PASS0 (GH_PASS0_ENEDIS with
// the flux bounds) are written after stage 2, the rest after stage 3
enum { GH_UTOTN, GH_VTOTN, GH_VTOTM, GH_VFLUX0, GH_DPMX, GH_DL2U, GH_DL2V,
       GH_DEFOR2, GH_POTVOR, GH_PASS0, GH_VHMIN = GH_PASS0, GH_VHMAX,
       GH_PASS0_ENEDIS, GH_VSC2U = GH_PASS0_ENEDIS, GH_VSC4U, GH_VSC2V,
       GH_VSC4V, N_GH };

template <typename T>
struct Args {
  const T *f[N_F];
  const T *d[N_D];
  const T *g[N_G];
  T *u_new, *v_new;
  T *ghost;      // (kk, N_GH, I) fold ghosts; null without the fold
  T tsfac, delt1;
  T mdv2hi, mdv2lo, mdv4hi, mdv4lo, vsc2hi, vsc2lo, vsc4hi, vsc4lo;
  int kk, J, I, periodic_i, periodic_j, arctic;
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

// A rectangle of local points: rows [r0, r0 + n / w), columns [c0, c0 + w).
struct Region {
  int r0, c0, w, n;
};

// Calls fn(g, lj, li) for every point (lj, li) of each region rg[g], the
// regions one after another, block-strided over the threads: a stage's
// fields each on their own region, with no thread idle until the last
// pass, and each field's loads in straight-line code.
template <int N, typename Fn>
__device__ __forceinline__ void for_regions(const Region (&rg)[N], Fn fn) {
  int total = 0;
#pragma unroll
  for (int g = 0; g < N; ++g) total += rg[g].n;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int g = 0, q = idx, r0 = rg[0].r0, c0 = rg[0].c0, w = rg[0].w;
#pragma unroll
    for (int h = 1; h < N; ++h) {
      if (g == h - 1 && q >= rg[h - 1].n) {
        q -= rg[h - 1].n;
        g = h;
        r0 = rg[h].r0;
        c0 = rg[h].c0;
        w = rg[h].w;
      }
    }
    const int r = q / w;
    fn(g, r0 + r, c0 + q - r * w);
  }
}

// The shared array of each ghost field, its point class and whether
// it is a vector component (blom_tpu's tags at its reads across the
// fold: jp1uv(utotn), jp1vv(vtotn), jp1v(scv2 * vtotm**2),
// jp1vv(vflux0), jp1p(dpmx), jp1uv(dl2u), jp1vv(dl2v), jp1q(defor2),
// jp1q(potvor), jp1vv(vh_min), jp1vv(vh_max), jp1u(vsc2u), jp1u(vsc4u),
// jp1v(vsc2v), jp1v(vsc4v))
__device__ __forceinline__ void ghost_field(int g, int &slot, int &kind,
                                            bool &vec) {
  switch (g) {
    case GH_UTOTN: slot = S_UTOTN; kind = K_U; vec = true; break;
    case GH_VTOTN: slot = S_VTOTN; kind = K_V; vec = true; break;
    case GH_VTOTM: slot = S_VTOTM; kind = K_V; vec = false; break;
    case GH_VFLUX0: slot = S_VFLUX0; kind = K_V; vec = true; break;
    case GH_DPMX: slot = S_DPMX; kind = K_P; vec = false; break;
    case GH_DL2U: slot = S_DL2U; kind = K_U; vec = true; break;
    case GH_DL2V: slot = S_DL2V; kind = K_V; vec = true; break;
    case GH_DEFOR2: slot = S_DEFOR2; kind = K_Q; vec = false; break;
    case GH_POTVOR: slot = S_POTVOR; kind = K_Q; vec = false; break;
    case GH_VHMIN: slot = S_VHMIN; kind = K_V; vec = true; break;
    case GH_VHMAX: slot = S_VHMAX; kind = K_V; vec = true; break;
    case GH_VSC2U: slot = S_VSC2U; kind = K_U; vec = false; break;
    case GH_VSC4U: slot = S_VSC4U; kind = K_U; vec = false; break;
    case GH_VSC2V: slot = S_VSC2V; kind = K_V; vec = false; break;
    default: slot = S_VSC4V; kind = K_V; vec = false;
  }
}

// Index i wrapped into [0, n) by the remainder, as torch.roll wraps: a
// read up to three points past an edge passes more than one period where
// n < 3.
__device__ __forceinline__ int wrap_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The row a ghost of point class `kind` mirrors and the mirrored column
// of column i (in [0, I)): p, u from row J-3; q, v from J-2; p, v
// reversed, u, q reversed and rolled by one
__device__ __forceinline__ int fold_src_row(int kind, int J) {
  return J - (kind == K_P || kind == K_U ? 3 : 2);
}
__device__ __forceinline__ int fold_col(int kind, int i, int I) {
  return kind == K_P || kind == K_V ? I - 1 - i : (i == 0 ? 0 : I - i);
}

// One tile, at the k-level whose offset is k3.  Local indices (lj, li)
// run over the shared arrays, the tile's first point at (H, H); (j, i)
// are the global indices of the same point, wrapped where the axis is
// periodic.  EDGE is false for a whole tile whose reads all lie inside
// the grid: its index arithmetic has no tests and its regions are
// constants.  FOLD (with EDGE) is the tripolar grid's: row J holds the
// fold's ghosts.
template <typename T, bool EDGE, bool FOLD = false>
struct Tile {
  const Args<T> &a;
  T *s;
  long k3;       // offset of the k-level
  int jt, it;    // global indices of local (0, 0)
  int nj_, ni_;  // points of the tile inside the grid

  static constexpr T slip = T(-1);
  static constexpr T cutoff = T(9806.);          // onem
  static constexpr T onemm = T(9.806);
  static constexpr T thkbop = T(10. * 9806.);    // thkbot * onem
  static constexpr T epsilp = T(1e-12);
  static constexpr T epsilpl = T(1e-14);

  // the main kernel's tile of the block
  __device__ Tile(const Args<T> &a_, T *s_)
      : a(a_), s(s_), k3(0),
        jt((int)blockIdx.y * TJ - H), it((int)blockIdx.x * TI - H) {
    nj_ = min(TJ, a.J - jt - H);
    ni_ = min(TI, a.I - it - H);
  }
  // the fold pre-pass's: nj rows from row j0
  __device__ Tile(const Args<T> &a_, T *s_, int j0, int nj)
      : a(a_), s(s_), k3(0), jt(j0 - H), it((int)blockIdx.x * TI - H) {
    nj_ = nj;
    ni_ = min(TI, a.I - it - H);
  }
  // the k-level and the offset of field g of the ghost buffer's level
  __device__ __forceinline__ int level() const {
    return (int)(k3 / ((long)a.J * a.I));
  }
  __device__ __forceinline__ long ghost_row(int g) const {
    return ((long)level() * N_GH + g) * a.I;
  }
  __device__ __forceinline__ int nj() const {
    if constexpr (EDGE) return nj_; else return TJ;
  }
  __device__ __forceinline__ int ni() const {
    if constexpr (EDGE) return ni_; else return TI;
  }
  // rows jlo..jhi and columns ilo..ihi, counted from the tile's first
  // and last
  __device__ __forceinline__ Region region(int jlo, int jhi, int ilo,
                                           int ihi) const {
    const int w = ni() + ihi - ilo;
    return {H + jlo, H + ilo, w, (nj() + jhi - jlo) * w};
  }

  // Wraps (j, i) into the grid on both axes and returns false past a
  // closed edge.  Indices reach at most three points past an edge, more
  // than one period of an axis shorter than three, so they wrap by the
  // remainder; a read at the wrapped index is then in bounds either way,
  // and the shifted reads below load unconditionally and select, with no
  // branch.
  __device__ __forceinline__ bool wrap(int &j, int &i) const {
    if constexpr (!EDGE) {
      return true;
    } else {
      const bool in_i = i >= 0 && i < a.I, in_j = j >= 0 && j < a.J;
      i = wrap_index(i, a.I);
      j = wrap_index(j, a.J);
      return (in_i || a.periodic_i) && (in_j || a.periodic_j);
    }
  }
  __device__ __forceinline__ bool inside(int j, int i) const {
    return wrap(j, i);
  }
  // wrap for a j+1 read tagged with point class KIND: at row J of a
  // tripolar grid, the mirrored point below the fold (false past a
  // closed i edge)
  template <int KIND>
  __device__ __forceinline__ bool wrap_fold(int &j, int &i) const {
    if constexpr (FOLD) {
      if (j == a.J) {
        const bool in_i = i >= 0 && i < a.I;
        i = wrap_index(i, a.I);
        j = fold_src_row(KIND, a.J);
        i = fold_col(KIND, i, a.I);
        return in_i || a.periodic_i;
      }
    }
    return wrap(j, i);
  }
  // input reads at a point inside the grid
  __device__ __forceinline__ T F(int n, int j, int i) const {
    return __ldg(a.f[n] + k3 + j * a.I + i);
  }
  __device__ __forceinline__ T D(int n, int j, int i) const {
    return __ldg(a.d[n] + j * a.I + i);
  }
  __device__ __forceinline__ T G(int n, int j, int i) const {
    return __ldg(a.g[n] + j * a.I + i);
  }
  // shifted input reads: zero past a closed edge
  __device__ __forceinline__ T Fo(int n, int j, int i) const {
    const bool ok = wrap(j, i);
    const T v = F(n, j, i);
    return ok ? v : T(0);
  }
  __device__ __forceinline__ T Do(int n, int j, int i) const {
    const bool ok = wrap(j, i);
    const T v = D(n, j, i);
    return ok ? v : T(0);
  }
  __device__ __forceinline__ T Go(int n, int j, int i) const {
    const bool ok = wrap(j, i);
    const T v = G(n, j, i);
    return ok ? v : T(0);
  }
  // tagged j+1 input reads: the fold's ghost at row J of a tripolar grid
  template <int KIND>
  __device__ __forceinline__ T Ft(int n, int j, int i) const {
    const bool ok = wrap_fold<KIND>(j, i);
    const T v = F(n, j, i);
    return ok ? v : T(0);
  }
  template <int KIND>
  __device__ __forceinline__ T Dt(int n, int j, int i) const {
    const bool ok = wrap_fold<KIND>(j, i);
    const T v = D(n, j, i);
    return ok ? v : T(0);
  }
  template <int KIND>
  __device__ __forceinline__ T Gt(int n, int j, int i) const {
    const bool ok = wrap_fold<KIND>(j, i);
    const T v = G(n, j, i);
    return ok ? v : T(0);
  }
  // whether local row lj is row J of a tripolar grid, where the ghost
  // fields hold the fold's ghosts
  __device__ __forceinline__ bool fold_row(int lj) const {
    if constexpr (FOLD) return jt + lj == a.J; else return false;
  }
  // the ghost of field g at local column li of row J (0 past a closed i
  // edge), from the pre-pass's buffer
  __device__ __forceinline__ T ghost(int g, int li) const {
    int i = it + li;
    const bool in_i = i >= 0 && i < a.I;
    i = wrap_index(i, a.I);
    const T v = a.ghost[ghost_row(g) + i];
    return in_i || a.periodic_i ? v : T(0);
  }
  // a shared array at a local point
  __device__ __forceinline__ T &sh(int n, int lj, int li) const {
    return s[(n * SJ + lj) * SI + li];
  }

  // ---- stage 0, once for all levels of the block: the barotropic part
  // of each total velocity (mod_momtum.F90:388-432)
  __device__ __forceinline__ T btr(int fb, int dpb, int gs, int j,
                                   int i) const {
    const T sc = fmx(D(dpb, j, i) * G(gs, j, i), epsilpl);
    return D(fb, j, i) * a.tsfac / sc;
  }
  __device__ __forceinline__ void stage0(int lj, int li) const {
    int j = jt + lj, i = it + li;
    wrap(j, i);     // past a closed edge stage 1 stores 0 in any case
    sh(S_BUM, lj, li) = btr(D_UBFLXS_M, D_PBU_M, G_SCUY, j, i);
    sh(S_BVM, lj, li) = btr(D_VBFLXS_M, D_PBV_M, G_SCVX, j, i);
    sh(S_BUN, lj, li) = btr(D_UBFLXS_N, D_PBU_N, G_SCUY, j, i);
    sh(S_BVN, lj, li) = btr(D_VBFLXS_N, D_PBV_N, G_SCVX, j, i);
  }

  // ---- stage 1 (mod_momtum.F90:355-470), each field group on the
  // region its readers need; the reads of a point past a closed edge stay
  // in bounds (wrap) and the point stores 0
  __device__ __forceinline__ T tot(int fv, int b, int gm, int lj, int li,
                                   int j, int i) const {
    return (F(fv, j, i) + sh(b, lj, li)) * G(gm, j, i);
  }
  __device__ __forceinline__ T wgt(int fhi, int flo, int dpb, int jo, int io,
                                   int j, int i) const {
    const T hi = F(fhi, j, i);
    return clip01((hi - Do(dpb, j + jo, i + io))
                  / fmx(hi - F(flo, j, i), epsilp));
  }
  // wgtjb's, whose j+1 read of pbu_m is tagged 'u'
  __device__ __forceinline__ T wgt_n(int j, int i) const {
    const T hi = F(F_PU_HI, j, i);
    return clip01((hi - Dt<K_U>(D_PBU_M, j + 1, i))
                  / fmx(hi - F(F_PU_LO, j, i), epsilp));
  }
  __device__ __forceinline__ T du_(int j, int i) const {
    const bool ok = wrap(j, i);
    const T v = G(G_IU, j, i) * (F(F_DP_M, j, i) + Fo(F_DP_M, j, i - 1));
    return ok ? v : T(0);
  }
  __device__ __forceinline__ T dv_(int j, int i) const {
    const bool ok = wrap(j, i);
    const T v = G(G_IV, j, i) * (F(F_DP_M, j, i) + Fo(F_DP_M, j - 1, i));
    return ok ? v : T(0);
  }
  enum { S1_TOTN, S1_TOTM, S1_DPMX, S1_WGTJB, S1_WGTIB };
  __device__ __forceinline__ void stage1(int g, int lj, int li) const {
    int j = jt + lj, i = it + li;
    const bool ok = wrap(j, i);
    const bool fr = fold_row(lj);
    const auto put = [&](int n, T v) { sh(n, lj, li) = ok ? v : T(0); };
    const auto putg = [&](int n, int gh, T v) {
      sh(n, lj, li) = fr ? ghost(gh, li) : (ok ? v : T(0));
    };
    switch (g) {
      case S1_TOTN:
        putg(S_UTOTN, GH_UTOTN, tot(F_U_N, S_BUN, G_IU, lj, li, j, i));
        putg(S_VTOTN, GH_VTOTN, tot(F_V_N, S_BVN, G_IV, lj, li, j, i));
        break;
      case S1_TOTM: {
        const T utm = tot(F_U_M, S_BUM, G_IU, lj, li, j, i);
        const T vtm = tot(F_V_M, S_BVM, G_IV, lj, li, j, i);
        put(S_UTOTM, utm);
        putg(S_VTOTM, GH_VTOTM, vtm);
        put(S_UFLUX0, utm * fmx(F(F_DPU_M, j, i), cutoff) * G(G_IU, j, i));
        putg(S_VFLUX0, GH_VFLUX0,
             vtm * fmx(F(F_DPV_M, j, i), cutoff) * G(G_IV, j, i));
        break;
      }
      case S1_DPMX: {
        put(S_WGTJA, wgt(F_PU_HI, F_PU_LO, D_PBU_M, -1, 0, j, i));
        put(S_WGTIA, wgt(F_PV_HI, F_PV_LO, D_PBV_M, 0, -1, j, i));
        // neighbourhood thickness maxima at q (:355-396)
        const T m = fmx(fmx(fmx(du_(j, i), du_(j - 1, i)), dv_(j, i)),
                        dv_(j, i - 1));
        putg(S_DPMX, GH_DPMX, fmx(m, T(8) * cutoff));
        break;
      }
      case S1_WGTJB:
        put(S_WGTJB, wgt_n(j, i));
        break;
      default:
        put(S_WGTIB, wgt(F_PV_HI, F_PV_LO, D_PBV_M, 0, 1, j, i));
    }
  }
  __device__ __forceinline__ void run_stage1() const {
    const Region rg[] = {region(-2, 2, -2, 2), region(-1, 1, -1, 1),
                         region(-1, 2, -1, 2), region(-2, 1, -1, 2),
                         region(-1, 2, -2, 1)};
    for_regions(rg, [&](int g, int lj, int li) { stage1(g, lj, li); });
  }

  // ---- auxiliary velocities at a point inside the grid (:434-470)
  __device__ __forceinline__ T uja(int lj, int li) const {
    const T w = sh(S_WGTJA, lj, li);
    return (T(1) - w) * sh(S_UTOTN, lj - 1, li)
           + w * slip * sh(S_UTOTN, lj, li);
  }
  __device__ __forceinline__ T ujb(int lj, int li) const {
    const T w = sh(S_WGTJB, lj, li);
    return (T(1) - w) * sh(S_UTOTN, lj + 1, li)
           + w * slip * sh(S_UTOTN, lj, li);
  }
  __device__ __forceinline__ T via(int lj, int li) const {
    const T w = sh(S_WGTIA, lj, li);
    return (T(1) - w) * sh(S_VTOTN, lj, li - 1)
           + w * slip * sh(S_VTOTN, lj, li);
  }
  __device__ __forceinline__ T vib(int lj, int li) const {
    const T w = sh(S_WGTIB, lj, li);
    return (T(1) - w) * sh(S_VTOTN, lj, li + 1)
           + w * slip * sh(S_VTOTN, lj, li);
  }

  // ---- stage 2; every input is read before the branches
  // potential vorticity at q (:473-575)
  __device__ __forceinline__ T potvor(int lj, int li, int j, int i) const {
    const T iu = G(G_IU, j, i), iv = G(G_IV, j, i), iq = G(G_IQ, j, i);
    const T iv_w = Go(G_IV, j, i - 1), iu_s = Go(G_IU, j - 1, i);
    const T Vv = sh(S_VTOTM, lj, li) * G(G_SCVY, j, i);
    const T Uu = sh(S_UTOTM, lj, li) * G(G_SCUX, j, i);
    const T Vv_w = sh(S_VTOTM, lj, li - 1) * Go(G_SCVY, j, i - 1);
    const T Uu_s = sh(S_UTOTM, lj - 1, li) * Go(G_SCUX, j - 1, i);
    const T scq2i = G(G_SCQ2I, j, i), corioq = G(G_CORIOQ, j, i);
    const T dp = F(F_DP_M, j, i);
    const T dp_w = Fo(F_DP_M, j, i - 1), dp_s = Fo(F_DP_M, j - 1, i);
    const T dp_sw = Fo(F_DP_M, j - 1, i - 1);
    const T dpmx0 = sh(S_DPMX, lj, li);
    const T dpmx_w = sh(S_DPMX, lj, li - 1), dpmx_e = sh(S_DPMX, lj, li + 1);
    const T dpmx_s = sh(S_DPMX, lj - 1, li), dpmx_n = sh(S_DPMX, lj + 1, li);
    T vort, dpvor;
    if (iq > T(0)) {
      vort = (Vv - Vv_w - (Uu - Uu_s)) * scq2i;
      dpvor = T(.125) * fmx(T(2) * (dp + dp_w + dp_s + dp_sw),
                            fmx(fmx(dpmx0, dpmx_w),
                                fmx(fmx(dpmx_e, dpmx_s), dpmx_n)));
    } else {
      const T v_e = iv > T(0) ? Vv : slip * Vv_w;
      const T v_w = iv_w > T(0) ? Vv_w : slip * Vv;
      const T u_nn = iu > T(0) ? Uu : slip * Uu_s;
      const T u_ss = iu_s > T(0) ? Uu_s : slip * Uu;
      vort = (v_e - v_w - (u_nn - u_ss)) * scq2i;
      dpvor = cutoff;
      if (iv > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp + dp_s), fmx(dpmx0, dpmx_e));
      // im1(dp_m + jm1(dp_m)): where (j, i - 1) lies past a closed edge,
      // so does (j - 1, i - 1), and the sum is 0
      if (iv_w > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp_w + dp_sw), fmx(dpmx_w, dpmx0));
      if (iu > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp + dp_w), fmx(dpmx0, dpmx_n));
      // jm1(dp_m + im1(dp_m)), likewise
      if (iu_s > T(0))
        dpvor = T(.125) * fmx(T(4) * (dp_s + dp_sw), fmx(dpmx_s, dpmx0));
    }
    return (vort + corioq) / dpvor;
  }

  // defor2 at q (:537-584); defor2 reads ujb and vib, which are not
  // staged, at one neighbour each
  __device__ __forceinline__ T defor2(int lj, int li, int j, int i) const {
    const T scq2i = G(G_SCQ2I, j, i);
    const T scvy = G(G_SCVY, j, i), scvy_w = Go(G_SCVY, j, i - 1);
    const T scux = G(G_SCUX, j, i), scux_s = Go(G_SCUX, j - 1, i);
    const T iq = G(G_IQ, j, i), iv = G(G_IV, j, i), iu = G(G_IU, j, i);
    const T iv_w = Go(G_IV, j, i - 1), iu_s = Go(G_IU, j - 1, i);
    if (iq > T(0)) {
      const T vib_w = inside(j, i - 1) ? vib(lj, li - 1) : T(0);
      const T ujb_s = inside(j - 1, i) ? ujb(lj - 1, li) : T(0);
      return sq(vib_w * scvy - via(lj, li) * scvy_w + ujb_s * scux
                - uja(lj, li) * scux_s) * scq2i;
    }
    const T Vn = sh(S_VTOTN, lj, li) * scvy;
    const T Un = sh(S_UTOTN, lj, li) * scux;
    const T Vn_w = sh(S_VTOTN, lj, li - 1) * scvy_w;
    const T Un_s = sh(S_UTOTN, lj - 1, li) * scux_s;
    const T ve = iv > T(0) ? Vn : slip * Vn_w;
    const T vw = iv_w > T(0) ? Vn_w : slip * Vn;
    const T un = iu > T(0) ? Un : slip * Un_s;
    const T us = iu_s > T(0) ? Un_s : slip * Un;
    return sq(ve - vw + un - us) * scq2i;
  }

  enum { S2_DL2, S2_DEFOR1, S2_DEFOR2, S2_POTVOR, S2_KE, S2_UH, S2_VH };
  template <int MOM>
  __device__ __forceinline__ void stage2(int g, int lj, int li) const {
    int j = jt + lj, i = it + li;
    const bool ok = wrap(j, i);
    const bool fr = fold_row(lj);
    const auto put = [&](int n, T v) { sh(n, lj, li) = ok ? v : T(0); };
    const auto putg = [&](int n, int gh, T v) {
      sh(n, lj, li) = fr ? ghost(gh, li) : (ok ? v : T(0));
    };
    switch (g) {
      case S2_DL2: {
        const T utn = sh(S_UTOTN, lj, li), vtn = sh(S_VTOTN, lj, li);
        putg(S_DL2U, GH_DL2U, (utn - T(.25) * (sh(S_UTOTN, lj, li + 1)
                                               + sh(S_UTOTN, lj, li - 1)
                                               + uja(lj, li) + ujb(lj, li)))
                                  * G(G_IU, j, i));
        putg(S_DL2V, GH_DL2V, (vtn - T(.25) * (sh(S_VTOTN, lj + 1, li)
                                               + sh(S_VTOTN, lj - 1, li)
                                               + via(lj, li) + vib(lj, li)))
                                  * G(G_IV, j, i));
        break;
      }
      case S2_DEFOR1:
        put(S_DEFOR1,
            sq((sh(S_UTOTN, lj, li + 1) * Go(G_SCUY, j, i + 1)
                - sh(S_UTOTN, lj, li) * G(G_SCUY, j, i))
               - (sh(S_VTOTN, lj + 1, li) * Gt<K_V>(G_SCVX, j + 1, i)
                  - sh(S_VTOTN, lj, li) * G(G_SCVX, j, i)))
            * G(G_SCP2I, j, i));
        break;
      case S2_DEFOR2:
        putg(S_DEFOR2, GH_DEFOR2, defor2(lj, li, j, i));
        break;
      case S2_POTVOR:
        putg(S_POTVOR, GH_POTVOR, potvor(lj, li, j, i));
        break;
      case S2_KE:     // Arakawa kinetic energy (:609-663)
        put(S_KE, T(.25) * (G(G_SCU2, j, i) * sq(sh(S_UTOTM, lj, li))
                            + Go(G_SCU2, j, i + 1)
                                * sq(sh(S_UTOTM, lj, li + 1))
                            + G(G_SCV2, j, i) * sq(sh(S_VTOTM, lj, li))
                            + Gt<K_V>(G_SCV2, j + 1, i)
                                * sq(sh(S_VTOTM, lj + 1, li)))
                  * G(G_SCP2I, j, i));
        break;
      case S2_UH: {
        T lo, hi;
        hminmax(T(.5) * sh(S_UTOTM, lj, li)
                    * (F(F_DP_M, j, i) + Fo(F_DP_M, j, i - 1)),
                sh(S_UFLUX0, lj, li), lo, hi);
        put(S_UHMIN, lo);
        put(S_UHMAX, hi);
        break;
      }
      default: {
        T lo, hi;
        hminmax(T(.5) * sh(S_VTOTM, lj, li)
                    * (F(F_DP_M, j, i) + Fo(F_DP_M, j - 1, i)),
                sh(S_VFLUX0, lj, li), lo, hi);
        putg(S_VHMIN, GH_VHMIN, lo);
        putg(S_VHMAX, GH_VHMAX, hi);
      }
    }
  }
  template <int MOM>
  __device__ __forceinline__ void run_stage2() const {
    const auto fn = [&](int g, int lj, int li) {
      stage2<MOM>(g, lj, li);
    };
    if constexpr (MOM == MOM_ENEDIS) {
      const Region rg[] = {region(-1, 1, -1, 1), region(-2, 1, -2, 1),
                           region(-1, 2, -1, 2), region(0, 1, 0, 1),
                           region(-1, 0, -1, 0), region(-1, 0, 0, 1),
                           region(0, 1, -1, 0)};
      for_regions(rg, fn);
    } else {
      const Region rg[] = {region(-1, 1, -1, 1), region(-2, 1, -2, 1),
                           region(-1, 2, -1, 2), region(0, 1, 0, 1),
                           region(-1, 0, -1, 0)};
      for_regions(rg, fn);
    }
  }

  // ---- stage 3: deformation-dependent viscosities (:790-804)
  __device__ __forceinline__ void stage3(int lj, int li) const {
    int j = jt + lj, i = it + li;
    const bool ok = wrap(j, i);
    const bool fr = fold_row(lj);
    const auto put = [&](int n, int gh, T v) {
      sh(n, lj, li) = fr ? ghost(gh, li) : (ok ? v : T(0));
    };
    const T dw = D(D_DIFWGT, j, i);
    const T du = fsqrt(T(.5) * (sh(S_DEFOR1, lj, li)
                                + sh(S_DEFOR1, lj, li - 1)
                                + sh(S_DEFOR2, lj, li)
                                + sh(S_DEFOR2, lj + 1, li)));
    T qw = T(.5) * (Do(D_DIFWGT, j, i - 1) + dw);
    put(S_VSC2U, GH_VSC2U,
        fmx(qw * a.mdv2hi + (T(1) - qw) * a.mdv2lo,
            (qw * a.vsc2hi + (T(1) - qw) * a.vsc2lo) * du));
    put(S_VSC4U, GH_VSC4U,
        fmx(qw * a.mdv4hi + (T(1) - qw) * a.mdv4lo,
            (qw * a.vsc4hi + (T(1) - qw) * a.vsc4lo) * du));
    const T dv = fsqrt(T(.5) * (sh(S_DEFOR1, lj, li)
                                + sh(S_DEFOR1, lj - 1, li)
                                + sh(S_DEFOR2, lj, li)
                                + sh(S_DEFOR2, lj, li + 1)));
    qw = T(.5) * (Do(D_DIFWGT, j - 1, i) + dw);
    put(S_VSC2V, GH_VSC2V,
        fmx(qw * a.mdv2hi + (T(1) - qw) * a.mdv2lo,
            (qw * a.vsc2hi + (T(1) - qw) * a.vsc2lo) * dv));
    put(S_VSC4V, GH_VSC4V,
        fmx(qw * a.mdv4hi + (T(1) - qw) * a.mdv4lo,
            (qw * a.vsc4hi + (T(1) - qw) * a.vsc4lo) * dv));
  }

  // ---- stage 4: longitudinal momentum fluxes at p (:821-836), 0 where
  // neither neighbouring u (v) point is wet
  __device__ __forceinline__ T uflux1(int lj, int li, int j, int i) const {
    const T iu = G(G_IU, j, i), iu_e = Go(G_IU, j, i + 1);
    const T v2 = sh(S_VSC2U, lj, li), v2e = sh(S_VSC2U, lj, li + 1);
    const T v4 = sh(S_VSC4U, lj, li), v4e = sh(S_VSC4U, lj, li + 1);
    const T v2a = iu > T(0) ? v2 : v2e, v2b = iu_e > T(0) ? v2e : v2;
    const T v4a = iu > T(0) ? v4 : v4e, v4b = iu_e > T(0) ? v4e : v4;
    const T harm = hfharm(fmx(F(F_DPU_M, j, i), onemm),
                          fmx(Fo(F_DPU_M, j, i + 1), onemm));
    const T difmxp = G(G_DIFMXP, j, i), scpy = G(G_SCPY, j, i);
    const T fl = fmn(difmxp, (v2a + v2b) * scpy) * harm
                     * (sh(S_UTOTN, lj, li) - sh(S_UTOTN, lj, li + 1))
                 + fmn(T(.125) * difmxp, (v4a + v4b) * scpy) * harm
                     * (sh(S_DL2U, lj, li) - sh(S_DL2U, lj, li + 1));
    return iu + iu_e > T(0) ? fl : T(0);
  }
  __device__ __forceinline__ T vflux1(int lj, int li, int j, int i) const {
    const T iv = G(G_IV, j, i), iv_n = Gt<K_V>(G_IV, j + 1, i);
    const T v2 = sh(S_VSC2V, lj, li), v2n = sh(S_VSC2V, lj + 1, li);
    const T v4 = sh(S_VSC4V, lj, li), v4n = sh(S_VSC4V, lj + 1, li);
    const T v2a = iv > T(0) ? v2 : v2n, v2b = iv_n > T(0) ? v2n : v2;
    const T v4a = iv > T(0) ? v4 : v4n, v4b = iv_n > T(0) ? v4n : v4;
    const T harm = hfharm(fmx(F(F_DPV_M, j, i), onemm),
                          fmx(Ft<K_V>(F_DPV_M, j + 1, i), onemm));
    const T difmxp = G(G_DIFMXP, j, i), scpx = G(G_SCPX, j, i);
    const T fl = fmn(difmxp, (v2a + v2b) * scpx) * harm
                     * (sh(S_VTOTN, lj, li) - sh(S_VTOTN, lj + 1, li))
                 + fmn(T(.125) * difmxp, (v4a + v4b) * scpx) * harm
                     * (sh(S_DL2V, lj, li) - sh(S_DL2V, lj + 1, li));
    return iv + iv_n > T(0) ? fl : T(0);
  }
  __device__ __forceinline__ void stage4(int g, int lj, int li) const {
    int j = jt + lj, i = it + li;
    const bool ok = wrap(j, i);
    if (g == 0)
      sh(S_UFLUX1, lj, li) = ok ? uflux1(lj, li, j, i) : T(0);
    else
      sh(S_VFLUX1, lj, li) = ok ? vflux1(lj, li, j, i) : T(0);
  }

  // ---- stage 5: the remaining fluxes, Coriolis, bottom stress and the
  // update at a point of the tile (:838-1152)
  template <int MOM>
  __device__ __forceinline__ void stage5(int lj, int li) const {
    const int j = jt + lj, i = it + li;
    const long o = k3 + j * a.I + i;
    const T delt1 = a.delt1;
    const T potvor = sh(S_POTVOR, lj, li);
    const T ke = sh(S_KE, lj, li);
    const T drag = D(D_DRAG, j, i);

    // ================= u equation =================
    {
      const T iu = G(G_IU, j, i);
      const T utn = sh(S_UTOTN, lj, li);
      const T wja = sh(S_WGTJA, lj, li), wjb = sh(S_WGTJB, lj, li);
      const T uja_ = uja(lj, li), ujb_ = ujb(lj, li);
      const T dl2u = sh(S_DL2U, lj, li);
      const T dl2uja = (T(1) - wja) * sh(S_DL2U, lj - 1, li)
                       + wja * slip * dl2u;
      const T dl2ujb = (T(1) - wjb) * sh(S_DL2U, lj + 1, li)
                       + wjb * slip * dl2u;
      const T v2 = sh(S_VSC2U, lj, li), v4 = sh(S_VSC4U, lj, li);
      const bool ws = Go(G_IU, j - 1, i) > T(0);
      const bool wn = Gt<K_U>(G_IU, j + 1, i) > T(0);
      const T v2a = ws ? sh(S_VSC2U, lj - 1, li) : v2;
      const T v4a = ws ? sh(S_VSC4U, lj - 1, li) : v4;
      const T v2b = wn ? sh(S_VSC2U, lj + 1, li) : v2;
      const T v4b = wn ? sh(S_VSC4U, lj + 1, li) : v4;
      const T dpu = F(F_DPU_M, j, i);
      const T dpxy = fmx(dpu, onemm);
      T dpja = fmx(Fo(F_DPU_M, j - 1, i), onemm);
      dpja = dpja + wja * (dpxy - dpja);
      T dpjb = fmx(Ft<K_U>(F_DPU_M, j + 1, i), onemm);
      dpjb = dpjb + wjb * (dpxy - dpjb);
      const T hja = hfharm(dpja, dpxy), hjb = hfharm(dpjb, dpxy);
      const T difmxq = G(G_DIFMXQ, j, i), scqx = G(G_SCQX, j, i);
      const T difmxq_n = Gt<K_Q>(G_DIFMXQ, j + 1, i);
      // jp1q(scqx) in the Laplacian term, an untagged jp1(scqx) in the
      // biharmonic one, as in blom_tpu (0 across the fold)
      const T scqx_n = Gt<K_Q>(G_SCQX, j + 1, i);
      T scqx_n0 = scqx_n;
      if constexpr (FOLD) scqx_n0 = Go(G_SCQX, j + 1, i);
      const T uflux2 = (fmn(difmxq, (v2 + v2a) * scqx) * hja * (uja_ - utn)
                        + fmn(T(.125) * difmxq, (v4 + v4a) * scqx) * hja
                            * (dl2uja - dl2u)) * iu;
      const T uflux3 = (fmn(difmxq_n, (v2 + v2b) * scqx_n) * hjb
                            * (utn - ujb_)
                        + fmn(T(.125) * difmxq_n, (v4 + v4b) * scqx_n0) * hjb
                            * (dl2u - dl2ujb)) * iu;

      const T pbu_m = D(D_PBU_M, j, i);
      const T ptopl = T(.5) * (fmn(pbu_m, F(F_P_LO, j, i))
                               + fmn(pbu_m, Fo(F_P_LO, j, i - 1)));
      const T pbotl = T(.5) * (fmn(pbu_m, F(F_P_HI, j, i))
                               + fmn(pbu_m, Fo(F_P_HI, j, i - 1)));
      const T qbot = T(.5) * (drag + Do(D_DRAG, j, i - 1))
                     * (fmx(pbu_m - thkbop, pbotl)
                        - fmx(pbu_m - thkbop, fmn(ptopl, pbotl - onemm)))
                     / dpxy;
      const T botstr = -utn * qbot / (T(1) + delt1 * qbot);

      // Coriolis term (mod_momtum.F90:719-784)
      T cau;
      if constexpr (MOM == MOM_ENSCON) {
        cau = T(.125) * (sh(S_VFLUX0, lj, li) + sh(S_VFLUX0, lj + 1, li)
                         + sh(S_VFLUX0, lj, li - 1)
                         + sh(S_VFLUX0, lj + 1, li - 1))
              * (potvor + sh(S_POTVOR, lj + 1, li)) * iu;
      } else if constexpr (MOM == MOM_ENECON) {
        cau = T(.25) * ((sh(S_VFLUX0, lj, li) + sh(S_VFLUX0, lj, li - 1))
                            * potvor
                        + (sh(S_VFLUX0, lj + 1, li)
                           + sh(S_VFLUX0, lj + 1, li - 1))
                            * sh(S_POTVOR, lj + 1, li)) * iu;
      } else {
        const T utm = sh(S_UTOTM, lj, li);
        const T t1 = upw(sh(S_POTVOR, lj + 1, li), utm,
                         sh(S_VHMAX, lj + 1, li) + sh(S_VHMAX, lj + 1, li - 1),
                         sh(S_VHMIN, lj + 1, li) + sh(S_VHMIN, lj + 1, li - 1),
                         false);
        const T t2 = upw(potvor, utm,
                         sh(S_VHMAX, lj, li) + sh(S_VHMAX, lj, li - 1),
                         sh(S_VHMIN, lj, li) + sh(S_VHMIN, lj, li - 1),
                         false);
        cau = T(.25) * (t1 + t2) * iu;
      }

      a.u_new[o] = (F(F_U_N, j, i) + delt1 * (
          -G(G_SCUXI, j, i) * (-F(F_PGF_U, j, i) + F(F_STRESS_U, j, i)
                               + (ke - sh(S_KE, lj, li - 1)))
          + cau - D(D_UBRHS, j, i) + botstr
          - (sh(S_UFLUX1, lj, li) - sh(S_UFLUX1, lj, li - 1) + uflux3
             - uflux2)
            / (G(G_SCU2, j, i) * dpxy))) * iu;
    }

    // ================= v equation =================
    {
      const T iv = G(G_IV, j, i);
      const T vtn = sh(S_VTOTN, lj, li);
      const T wia = sh(S_WGTIA, lj, li), wib = sh(S_WGTIB, lj, li);
      const T via_ = via(lj, li), vib_ = vib(lj, li);
      const T dl2v = sh(S_DL2V, lj, li);
      const T dl2via = (T(1) - wia) * sh(S_DL2V, lj, li - 1)
                       + wia * slip * dl2v;
      const T dl2vib = (T(1) - wib) * sh(S_DL2V, lj, li + 1)
                       + wib * slip * dl2v;
      const T v2 = sh(S_VSC2V, lj, li), v4 = sh(S_VSC4V, lj, li);
      const bool ww = Go(G_IV, j, i - 1) > T(0);
      const bool we = Go(G_IV, j, i + 1) > T(0);
      const T v2a = ww ? sh(S_VSC2V, lj, li - 1) : v2;
      const T v4a = ww ? sh(S_VSC4V, lj, li - 1) : v4;
      const T v2b = we ? sh(S_VSC2V, lj, li + 1) : v2;
      const T v4b = we ? sh(S_VSC4V, lj, li + 1) : v4;
      const T dpv = F(F_DPV_M, j, i);
      const T dpxy = fmx(dpv, onemm);
      T dpia = fmx(Fo(F_DPV_M, j, i - 1), onemm);
      dpia = dpia + wia * (dpxy - dpia);
      T dpib = fmx(Fo(F_DPV_M, j, i + 1), onemm);
      dpib = dpib + wib * (dpxy - dpib);
      const T hia = hfharm(dpia, dpxy), hib = hfharm(dpib, dpxy);
      const T difmxq = G(G_DIFMXQ, j, i), scqy = G(G_SCQY, j, i);
      const T difmxq_e = Go(G_DIFMXQ, j, i + 1);
      const T scqy_e = Go(G_SCQY, j, i + 1);
      const T vflux2 = (fmn(difmxq, (v2 + v2a) * scqy) * hia * (via_ - vtn)
                        + fmn(T(.125) * difmxq, (v4 + v4a) * scqy) * hia
                            * (dl2via - dl2v)) * iv;
      const T vflux3 = (fmn(difmxq_e, (v2 + v2b) * scqy_e) * hib
                            * (vtn - vib_)
                        + fmn(T(.125) * difmxq_e, (v4 + v4b) * scqy_e) * hib
                            * (dl2v - dl2vib)) * iv;

      const T pbv_m = D(D_PBV_M, j, i);
      const T ptopl = T(.5) * (fmn(pbv_m, F(F_P_LO, j, i))
                               + fmn(pbv_m, Fo(F_P_LO, j - 1, i)));
      const T pbotl = T(.5) * (fmn(pbv_m, F(F_P_HI, j, i))
                               + fmn(pbv_m, Fo(F_P_HI, j - 1, i)));
      const T qbot = T(.5) * (drag + Do(D_DRAG, j - 1, i))
                     * (fmx(pbv_m - thkbop, pbotl)
                        - fmx(pbv_m - thkbop, fmn(ptopl, pbotl - onemm)))
                     / dpxy;
      const T botstr = -vtn * qbot / (T(1) + delt1 * qbot);

      T cav;
      if constexpr (MOM == MOM_ENSCON) {
        cav = T(-.125) * (sh(S_UFLUX0, lj, li) + sh(S_UFLUX0, lj, li + 1)
                          + sh(S_UFLUX0, lj - 1, li)
                          + sh(S_UFLUX0, lj - 1, li + 1))
              * (potvor + sh(S_POTVOR, lj, li + 1)) * iv;
      } else if constexpr (MOM == MOM_ENECON) {
        cav = T(-.25) * ((sh(S_UFLUX0, lj, li) + sh(S_UFLUX0, lj - 1, li))
                             * potvor
                         + (sh(S_UFLUX0, lj, li + 1)
                            + sh(S_UFLUX0, lj - 1, li + 1))
                             * sh(S_POTVOR, lj, li + 1)) * iv;
      } else {
        const T vtm = sh(S_VTOTM, lj, li);
        const T t1 = upw(sh(S_POTVOR, lj, li + 1), vtm,
                         sh(S_UHMAX, lj, li + 1) + sh(S_UHMAX, lj - 1, li + 1),
                         sh(S_UHMIN, lj, li + 1) + sh(S_UHMIN, lj - 1, li + 1),
                         true);
        const T t2 = upw(potvor, vtm,
                         sh(S_UHMAX, lj, li) + sh(S_UHMAX, lj - 1, li),
                         sh(S_UHMIN, lj, li) + sh(S_UHMIN, lj - 1, li), true);
        cav = T(-.25) * (t1 + t2) * iv;
      }

      a.v_new[o] = (F(F_V_N, j, i) + delt1 * (
          -G(G_SCVYI, j, i) * (-F(F_PGF_V, j, i) + F(F_STRESS_V, j, i)
                               + (ke - sh(S_KE, lj - 1, li)))
          + cav - D(D_VBRHS, j, i) + botstr
          - (sh(S_VFLUX1, lj, li) - sh(S_VFLUX1, lj - 1, li) + vflux3
             - vflux2)
            / (G(G_SCV2, j, i) * dpxy))) * iv;
    }
  }
};

template <typename T, int MOM, bool EDGE, bool FOLD>
__device__ __forceinline__ void run_tile(const Args<T> &a) {
  Tile<T, EDGE, FOLD> t(a, reinterpret_cast<T *>(momtum_smem));
  const Region r0[] = {t.region(-2, 2, -2, 2)};
  for_regions(r0, [&](int, int lj, int li) { t.stage0(lj, li); });
  const Region r3[] = {t.region(-1, 1, -1, 1)};
  const Region r4[] = {t.region(0, 0, -1, 0), t.region(-1, 0, 0, 0)};
  const Region r5[] = {t.region(0, 0, 0, 0)};
  const int k1 = min(a.kk, ((int)blockIdx.z + 1) * KB);
  for (int k = blockIdx.z * KB; k < k1; ++k) {
    t.k3 = (long)k * a.J * a.I;
    __syncthreads();
    t.run_stage1();
    __syncthreads();
    t.template run_stage2<MOM>();
    __syncthreads();
    for_regions(r3, [&](int, int lj, int li) { t.stage3(lj, li); });
    __syncthreads();
    for_regions(r4, [&](int g, int lj, int li) { t.stage4(g, lj, li); });
    __syncthreads();
    for_regions(r5, [&](int, int lj, int li) {
      t.template stage5<MOM>(lj, li);
    });
  }
}

// FOLD: the tripolar grid's instantiation, which reads the pre-pass's
// ghost buffer (a tile whose ring reaches row J is an edge tile)
template <typename T, int MOM, bool FOLD>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<T>)
    momtum_uv_kernel(Args<T> a) {
  // the reads of a tile reach H + 1 points past it
  const int j0 = blockIdx.y * TJ, i0 = blockIdx.x * TI;
  if (j0 < H + 1 || j0 + TJ + H + 1 > a.J || i0 < H + 1
      || i0 + TI + H + 1 > a.I)
    run_tile<T, MOM, true, FOLD>(a);
  else
    run_tile<T, MOM, false, false>(a);
}

// The fold pre-pass: per block a tile of rows J-3 and J-2 and TI columns,
// KB levels; stages 0 to 3 as the main kernel's (closed in j: no value
// on those rows reads row J), then each ghost field written to the
// buffer at its mirrored column, sign-flipped for a vector: the fields of
// stages 1 and 2 before stage 3 overwrites dpmx's array, the viscosities
// after it.
template <typename T, int MOM>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<T>)
    momtum_fold_kernel(Args<T> a) {
  Tile<T, true> t(a, reinterpret_cast<T *>(momtum_smem), a.J - 3, 2);
  const Region r0[] = {t.region(-2, 2, -2, 2)};
  for_regions(r0, [&](int, int lj, int li) { t.stage0(lj, li); });
  const Region r3[] = {t.region(-1, 1, -1, 1)};
  const int ni = t.ni();
  const auto out = [&](int g0, int g1) {
    for (int idx = threadIdx.x; idx < (g1 - g0) * ni; idx += blockDim.x) {
      const int g = g0 + idx / ni, li = H + idx % ni;
      int slot, kind;
      bool vec;
      ghost_field(g, slot, kind, vec);
      const int lj = H + fold_src_row(kind, a.J) - (a.J - 3);
      const T v = t.sh(slot, lj, li);
      a.ghost[t.ghost_row(g) + fold_col(kind, t.it + li, a.I)] =
          vec ? -v : v;
    }
  };
  const int k1 = min(a.kk, ((int)blockIdx.z + 1) * KB);
  for (int k = blockIdx.z * KB; k < k1; ++k) {
    t.k3 = (long)k * a.J * a.I;
    __syncthreads();
    t.run_stage1();
    __syncthreads();
    t.template run_stage2<MOM>();
    __syncthreads();
    out(0, MOM == MOM_ENEDIS ? GH_PASS0_ENEDIS : GH_PASS0);
    __syncthreads();
    for_regions(r3, [&](int, int lj, int li) { t.stage3(lj, li); });
    __syncthreads();
    out(GH_PASS0_ENEDIS, N_GH);
  }
}

// dynamic shared memory of a block
int shared_bytes(int elem_size, int scheme) {
  return (scheme == MOM_ENEDIS ? N_S_ENEDIS : N_S) * SJ * SI * elem_size;
}

template <typename K, typename T>
int launch_kernel(K kern, const Args<T> &a, int scheme, int rows,
                  cudaStream_t s) {
  const int bytes = shared_bytes((int)sizeof(T), scheme);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.I + TI - 1) / TI, rows, (a.kk + KB - 1) / KB);
  kern<<<grid, NTHREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MOM>
int launch_scheme(const Args<T> &a, bool fold_pass, cudaStream_t s) {
  if (fold_pass)
    return launch_kernel(momtum_fold_kernel<T, MOM>, a, MOM, 1, s);
  const int rows = (a.J + TJ - 1) / TJ;
  if (a.arctic)
    return launch_kernel(momtum_uv_kernel<T, MOM, true>, a, MOM, rows, s);
  return launch_kernel(momtum_uv_kernel<T, MOM, false>, a, MOM, rows, s);
}

template <typename T>
int launch(void *const *ptrs, const double *dargs, const int *iargs,
           void *stream, bool fold_pass) {
  Args<T> a;
  int p = 0;
  for (int n = 0; n < N_F; ++n) a.f[n] = (const T *)ptrs[p++];
  for (int n = 0; n < N_D; ++n) a.d[n] = (const T *)ptrs[p++];
  for (int n = 0; n < N_G; ++n) a.g[n] = (const T *)ptrs[p++];
  a.u_new = (T *)ptrs[p++];
  a.v_new = (T *)ptrs[p++];
  a.ghost = (T *)ptrs[p++];
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
  a.arctic = iargs[6];
  // the fold needs its ghost buffer, a grid closed in j and the three
  // rows below the top row that it mirrors
  if ((a.arctic || fold_pass)
      && (a.ghost == nullptr || a.periodic_j || a.J < 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (iargs[5]) {
    case MOM_ENSCON: return launch_scheme<T, MOM_ENSCON>(a, fold_pass, s);
    case MOM_ENECON: return launch_scheme<T, MOM_ENECON>(a, fold_pass, s);
    case MOM_ENEDIS: return launch_scheme<T, MOM_ENEDIS>(a, fold_pass, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the core once on `stream`.  ptrs: the 17 MomtumKIn fields, the
// 12 Momtum2DIn fields, the 21 grid planes (in the order of the enums
// above), u_new, v_new, and the (kk, N_GH, I) fold ghost buffer (null
// without the fold).  dargs: tsfac, delt1, mdv2hi, mdv2lo, mdv4hi,
// mdv4lo, vsc2hi, vsc2lo, vsc4hi, vsc4lo.  iargs: kk, J, I, periodic_i,
// periodic_j, scheme (0 enscon, 1 enecon, 2 enedis), arctic.  With
// arctic, the fold pre-pass (momtum_fold_*) must have filled the ghost
// buffer on the same stream.  Returns the cudaError_t of the launch.
int momtum_uv_f32(void *const *ptrs, const double *dargs, const int *iargs,
                  void *stream) {
  return launch<float>(ptrs, dargs, iargs, stream, false);
}

int momtum_uv_f64(void *const *ptrs, const double *dargs, const int *iargs,
                  void *stream) {
  return launch<double>(ptrs, dargs, iargs, stream, false);
}

// Launches the fold pre-pass once on `stream`: the same arguments as
// momtum_uv_*, with arctic set; fills the ghost buffer (u_new and v_new
// are not written).
int momtum_fold_f32(void *const *ptrs, const double *dargs, const int *iargs,
                    void *stream) {
  return launch<float>(ptrs, dargs, iargs, stream, true);
}

int momtum_fold_f64(void *const *ptrs, const double *dargs, const int *iargs,
                    void *stream) {
  return launch<double>(ptrs, dargs, iargs, stream, true);
}

// Bytes of dynamic shared memory a block of the kernel (and of the fold
// pre-pass) takes, for elements of elem_size bytes and the scheme
// numbered as in iargs.
int momtum_uv_shared_bytes(int elem_size, int scheme) {
  return shared_bytes(elem_size, scheme);
}

// Fields of the fold ghost buffer per level: its shape is (kk, this, I).
int momtum_uv_ghost_fields() { return N_GH; }

}
