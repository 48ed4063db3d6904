"""The CUDA momentum kernel (blom_tpu_torch/csrc/momtum_uv.cu) on the CPU.

g++ compiles the kernel against the host shim blom_tpu_torch/csrc/
host_shim.h, as tests/test_torch_ale_host.py does for the ALE kernels,
and the library is called with ctypes on CPU tensors as the wrapper
dynamics/momtum_cuda.py calls it: on a tripolar grid the fold pre-pass
first, then the main kernel.  Its u_new and v_new are held against the
plain version momtum._uv_body in f64 at |err| <= 1e-12 (1 + |ref|), in
the three schemes, closed and periodic in i, on grids without the fold
(periodic in j) and on tripolar grids (closed in j, the top row on the
fold).  The grid's 17 rows end inside the second row of tiles with one
row, so the tiles of the first row hold the rows the fold mirrors and
their ring reaches the ghost row; its 40 columns end inside the second
column of tiles, and 5 levels inside the second block of levels.  One
f32 case runs within 1e-4 of max |ref|, chip_smoke's f32 tolerance, and
one tripolar case of each scheme runs each block as the launch's
threads, host threads meeting at a real barrier.  Grids periodic in
both axes with a period of 1, 2 or 3 on either axis (the single column is
1 x 1) read up to three points past an edge, more than one period.
Skips when g++ is absent."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from blom_tpu_torch.core.grid import finish_grid
from blom_tpu_torch.dynamics import momtum, momtum_cuda

from test_torch_ale_host import _host_build

KK, J, I = 5, 17, 40
SCHEMES = momtum.MOMMTHS
PARAMS = dict(mdv2hi=2., mdv2lo=1., vsc4hi=.1, vsc4lo=.05)
TSFAC, DELT1 = .75, 3600.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """momtum_uv.cu built by g++ against the host shim, with its fold
    pre-pass's entry points."""
    out = _host_build(tmp_path_factory, 'momtum_uv', 4)
    for t in ('f32', 'f64'):
        getattr(out, f'momtum_fold_{t}').argtypes = [ctypes.c_void_p] * 4
        getattr(out, f'momtum_fold_{t}').restype = ctypes.c_int
    return out


def inputs(periodic_i, arctic, dtype=torch.float64, seed=0, shape=(KK, J, I),
           land=True):
    """tests/test_torch_momtum.py's fixture as the port's tensors: random
    land (a quarter of the cells, none without `land`), walls at the ends
    of a closed i axis,
    random velocities, thicknesses and fluxes; a tripolar grid is closed
    in j with the fold on its top row, the others periodic in j."""
    kk, jj, ii = shape
    rng = np.random.default_rng(seed)
    depths = np.where(rng.uniform(size=(jj, ii)) < (.75 if land else 2.),
                      200., 0.)
    if not periodic_i:
        depths[:, 0] = depths[:, -1] = 0.
    if arctic:
        depths[0] = 0.
    ones = np.ones((jj, ii))
    gs = 10e3
    grid = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=depths,
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=periodic_i, periodic_j=not arctic, kk=kk, baclin=1800.,
        arctic=arctic, dtype=dtype)
    ip, iu, iv = (g.double().numpy() for g in (grid.ip, grid.iu, grid.iv))
    H3, H2 = (kk, jj, ii), (jj, ii)
    dp = rng.uniform(1e4, 3e5, H3) * ip
    dpu = rng.uniform(1e4, 3e5, H3) * iu
    dpv = rng.uniform(1e4, 3e5, H3) * iv
    z = np.zeros((1, jj, ii))
    p = np.concatenate([z, np.cumsum(dp, 0)])
    pu = np.concatenate([z, np.cumsum(dpu, 0)])
    pv = np.concatenate([z, np.cumsum(dpv, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype)
    f = momtum.MomtumKIn(
        u_m=t(rng.normal(0., .3, H3) * iu), u_n=t(rng.normal(0., .3, H3) * iu),
        v_m=t(rng.normal(0., .3, H3) * iv), v_n=t(rng.normal(0., .3, H3) * iv),
        dp_m=t(dp), dpu_m=t(dpu), dpv_m=t(dpv),
        p_lo=t(p[:-1]), p_hi=t(p[1:]), pu_lo=t(pu[:-1]), pu_hi=t(pu[1:]),
        pv_lo=t(pv[:-1]), pv_hi=t(pv[1:]),
        stress_u=t(rng.normal(0., 1e-6, H3) * iu),
        stress_v=t(rng.normal(0., 1e-6, H3) * iv),
        pgf_u=t(rng.normal(0., 1e-3, H3) * iu),
        pgf_v=t(rng.normal(0., 1e-3, H3) * iv))
    d2 = momtum.Momtum2DIn(
        ubflxs_m=t(rng.normal(0., 1e7, H2) * iu),
        ubflxs_n=t(rng.normal(0., 1e7, H2) * iu),
        vbflxs_m=t(rng.normal(0., 1e7, H2) * iv),
        vbflxs_n=t(rng.normal(0., 1e7, H2) * iv),
        pbu_m=t(pu[-1]), pbv_m=t(pv[-1]),
        pbu_n=t(pu[-1] * 1.01), pbv_n=t(pv[-1] * 1.01),
        drag=t(rng.uniform(0., 1e-7, H2) * ip),
        ubrhs=t(rng.normal(0., 1e-5, H2) * iu),
        vbrhs=t(rng.normal(0., 1e-5, H2) * iv),
        difwgt=t(rng.uniform(0., 1., H2) * ip))
    return grid, f, d2


def run_kernel(lib, grid, par, f, d2, tsfac=TSFAC, delt1=DELT1):
    """(u_new, v_new) of the kernel for CPU tensors, called as
    momtum_cuda.momtum_uv_cuda calls it (outputs and ghost buffer filled
    with NaN first, so that a point no launch wrote shows)."""
    kk, jj, ii = f.u_m.shape
    u_new = torch.full_like(f.u_m, torch.nan)
    v_new = torch.full_like(f.v_m, torch.nan)
    ghost = torch.full((kk, lib.momtum_uv_ghost_fields(), ii), torch.nan,
                       dtype=f.u_m.dtype)
    planes = [getattr(grid, n) for n in momtum_cuda.METRICS]
    ptrs = [*f, *d2, *planes, u_new, v_new]
    ptr_arr = (ctypes.c_void_p * (len(ptrs) + 1))(
        *[x.data_ptr() for x in ptrs],
        ghost.data_ptr() if grid.arctic else None)
    dargs = (ctypes.c_double * 10)(
        tsfac, delt1, par.mdv2hi, par.mdv2lo, par.mdv4hi, par.mdv4lo,
        par.vsc2hi, par.vsc2lo, par.vsc4hi, par.vsc4lo)
    iargs = (ctypes.c_int * 7)(kk, jj, ii, int(grid.periodic_i),
                               int(grid.periodic_j),
                               momtum.MOMMTHS.index(par.mommth),
                               int(grid.arctic))
    t = 'f64' if f.u_m.dtype == torch.float64 else 'f32'
    if grid.arctic:
        assert getattr(lib, f'momtum_fold_{t}')(ptr_arr, dargs, iargs,
                                                None) == 0
    assert getattr(lib, f'momtum_uv_{t}')(ptr_arr, dargs, iargs, None) == 0
    return u_new, v_new


def _check(lib, periodic_i, arctic, mommth, dtype=torch.float64,
           threads=1, shape=(KK, J, I), land=True):
    grid, f, d2 = inputs(periodic_i, arctic, dtype, shape=shape, land=land)
    par = momtum.MomtumParams(mommth=mommth, **PARAMS)
    lib.shim_set_block_threads(threads)
    try:
        out = run_kernel(lib, grid, par, f, d2)
    finally:
        lib.shim_set_block_threads(1)
    ref = momtum._uv_body(grid, par, f, d2, TSFAC, DELT1)
    for o, r, name in zip(out, ref, ('u_new', 'v_new')):
        o, r = o.double().numpy(), r.double().numpy()
        assert np.isfinite(r).all() and np.abs(r).max() > 0., name
        err = np.abs(o - r)
        if dtype == torch.float64:
            assert (err <= 1e-12 * (1. + np.abs(r))).all(), \
                (name, err.max(), np.argwhere(err > 1e-12 * (1. + np.abs(r)))[:5])
        else:
            assert err.max() <= 1e-4 * np.abs(r).max(), (name, err.max())
    return out, ref


@pytest.mark.parametrize('mommth', SCHEMES)
@pytest.mark.parametrize('arctic', [False, True])
@pytest.mark.parametrize('periodic_i', [False, True])
def test_host_momtum_matches_plain(lib, periodic_i, arctic, mommth):
    """Every scheme, both periodicities in i, without and with the fold,
    in f64.  On the tripolar grid the plain version's outputs of the top
    row differ from those of the same inputs on the grid without the
    fold, and those more than HALO rows below it do not."""
    _, ref = _check(lib, periodic_i, arctic, mommth)
    if arctic:
        grid, f, d2 = inputs(periodic_i, True)
        closed = momtum._uv_body(
            dataclasses.replace(grid, arctic=False),
            momtum.MomtumParams(mommth=mommth, **PARAMS), f, d2, TSFAC,
            DELT1)
        for o, c in zip(ref, closed):
            assert not torch.equal(o[:, -1], c[:, -1])
            assert torch.equal(o[:, :-momtum_cuda.HALO],
                               c[:, :-momtum_cuda.HALO])


def test_host_momtum_f32(lib):
    """The f32 instantiation of the tripolar path's scheme and grid."""
    _check(lib, True, True, 'enscon', dtype=torch.float32)


@pytest.mark.parametrize('mommth', SCHEMES)
def test_host_momtum_block_threads(lib, mommth):
    """The launch's own threads per block, meeting at real barriers, on
    the tripolar grid: every point of every stage covered by some thread,
    and every stage's reads of its neighbours behind a barrier."""
    _check(lib, True, True, mommth, threads=-1)


@pytest.mark.parametrize('mommth', SCHEMES)
@pytest.mark.parametrize('jj,ii', [(1, 1), (2, 2), (3, 3), (J, 1), (J, 2),
                                   (J, 3), (1, I), (2, I), (3, I)])
def test_host_momtum_short_periods(lib, jj, ii, mommth):
    """Periodic in both axes with a period of 1, 2 or 3 on either: reads
    up to three points past an edge wrap by the remainder, as torch.roll
    does.  All water, so that a 1 x 1 grid has a velocity point."""
    _check(lib, True, False, mommth, shape=(KK, jj, ii), land=False)
