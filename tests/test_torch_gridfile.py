"""The grid-file and single-column configurations of the port against
blom_tpu's, on the CPU in f64.

- `geoenv_file` reads a grid file written by gridfiles.write_grid_file
  (the geometry of the port's fuk95 at 16x8x6) from .npz and from NetCDF,
  with and without CWMOD channel-width changes: the Grid equals
  blom_tpu's field for field, exactly;
- `inicon_woa` on random T/S (made from a seed with numpy) with missing
  points and levels below a varying sea floor: within 1e-12;
- `build_gridfile` on that fuk95 file (arctic False, 200 m deep, with a
  WOA-shaped climatology) and on gridfiles.coupled_files' tripolar grid and
  WOA-shaped initial conditions (arctic True): grid, CPPM coefficients
  and parameters equal, the state within 1e-12, then 4 steps of both
  drivers under a zonal wind stress within test_torch_slice.py's
  FULL_TOL; `build_single_column` the same;
- a day of the port's single column with tests/test_configs.py's checks;
- `getpl` bit for bit blom_tpu's compiled one on seeded columns;
- a sea floor from 100 to 5500 m under a WOA-shaped climatology leaves
  massless bottom layers in the shallow columns: the port's initial
  pressures equal blom_tpu's bit for bit, and the first ALE step of both
  is finite and agrees within FULL_TOL.

blom_tpu's 4-step runs compile its step (~30 s each) and are built once
per test run (tests/torch_shared.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blom_tpu.core import geoenv as jgeo
from blom_tpu.core import init as jinit
from blom_tpu.core import inicon as jini
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import ale as jal
from blom_tpu_torch import convert
from blom_tpu_torch.core import geoenv as tgeo
from blom_tpu_torch.core import init as tinit
from blom_tpu_torch.core import inicon as tini
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.dynamics import ale as tal
from blom_tpu_torch.drivers import standalone as tst

from blom_tpu_torch.tools import gridfiles
from tests.test_torch_slice import FULL_TOL
from torch_shared import shared

FUK95 = dict(itdm=16, jtdm=8, kdm=6)
TRIPOLAR = dict(itdm=16, jtdm=12, kdm=6)
CWMOD = (('gib', 'u', 3, 4, 1234.), ('bos', 'v', 5, 2, 800.))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


def _rel_errors(ref_state, state):
    out = {}
    for name, a in _np_fields(ref_state).items():
        if a.size:
            b = getattr(state, name).numpy()
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


def _grid_equal(jg, tg):
    assert (jg.periodic_i, jg.periodic_j, jg.arctic, jg.kk) \
        == (tg.periodic_i, tg.periodic_j, tg.arctic, tg.kk)
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)


def _fuk95_file(directory, suffix='.nc', depth=None):
    """The fuk95 geometry's grid file, its water 200 m deep, or `depth`.
    A build from it without an icfile reads build_gridfile's fallback
    profile, whose levels reach 4000 m: give such a build a floor below
    them (4500 m), so that inicon_woa's fill_global has no level without
    data to sweep 1000 times; that floor breaks the barotropic step's CFL
    limit at fuk95's 650 m spacing, so step only the 200 m build, from
    _ic_file's climatology."""
    geom = tst.build_fuk95(**FUK95, device='cpu').grid
    path = str(directory / f'grid{suffix}')
    gridfiles.write_grid_file(path, geom, None if depth is None else
                               np.where(geom.depths.numpy() > 0., depth, 0.))
    return path


def _ic_file(directory, shape, floor, warm=0.):
    """gridfiles' WOA-shaped climatology on its levels above `floor`,
    warmer by `warm` (K, a scalar or a (J, I) field) at every level."""
    lev = np.asarray(gridfiles.WOA_LEVELS)
    bnds = gridfiles.woa_bounds()
    keep = bnds[:, 0] < floor
    _, _, t, s = tst.fallback_profile(lev[keep])
    full = (int(keep.sum()),) + tuple(shape)
    path = str(directory / 'woa.nc')
    gridfiles.write_ic_file(path, np.broadcast_to(
                                t[:, None, None] + np.asarray(warm), full),
                             np.broadcast_to(s[:, None, None], full),
                             bnds[keep])
    return path


@pytest.mark.parametrize('cwmod', [(), CWMOD], ids=['plain', 'cwmod'])
@pytest.mark.parametrize('suffix', ['.npz', '.nc'])
def test_geoenv_file_matches_blom_tpu(tmp_path, suffix, cwmod):
    path = _fuk95_file(tmp_path, suffix)
    jg = jgeo.geoenv_file(path, kk=6, baclin=180., cwmod=cwmod)
    tg = tgeo.geoenv_file(path, kk=6, baclin=180., cwmod=cwmod)
    _grid_equal(jg, tg)
    if cwmod:
        plain = tgeo.geoenv_file(path, kk=6, baclin=180.)
        assert not torch.equal(plain.scuy, tg.scuy)
        assert float(tg.scuy[3, 2]) == 1234. and float(tg.scvx[1, 4]) == 800.


@pytest.mark.parametrize('bad', [('x', 'w', 1, 1, 1.), ('x', 'u', 99, 1, 1.)])
def test_apply_cwmod_refuses_as_blom_tpu(bad):
    v = {'pdx': np.ones((4, 5)), 'udy': np.ones((4, 5)),
         'vdx': np.ones((4, 5))}
    with pytest.raises(ValueError) as jerr:
        jgeo.apply_cwmod(dict(v), [bad])
    with pytest.raises(ValueError) as terr:
        tgeo.apply_cwmod(dict(v), [bad])
    assert str(terr.value) == str(jerr.value)


def test_inicon_woa_matches_blom_tpu(tmp_path):
    geom = tst.build_tripolar(**TRIPOLAR, device='cpu').grid
    rng = np.random.default_rng(11)
    depths = np.where(geom.depths.numpy() > 0.,
                      rng.uniform(50., 900., geom.shape), 0.)
    path = str(tmp_path / 'grid.nc')
    gridfiles.write_grid_file(path, geom, depths)
    kw = dict(kk=TRIPOLAR['kdm'], baclin=180., arctic=True)
    jg, tg = jgeo.geoenv_file(path, **kw), tgeo.geoenv_file(path, **kw)
    bnds = gridfiles.woa_bounds()[:14]          # 0 .. 1050 m
    shape = (len(bnds),) + geom.shape
    t = rng.uniform(2., 20., shape)
    s = rng.uniform(33., 36., shape)
    t[rng.uniform(size=shape) < .15] = np.nan    # missing points
    s[rng.uniform(size=shape) < .15] = np.nan
    from blom_tpu.core import eos as jeos
    from blom_tpu_torch.core import eos as teos
    je = jeos.init_eos(pref=2000.e4, expcnf='cesm')
    te = teos.init_eos(pref=2000.e4, expcnf='cesm')
    ref = jini.inicon_woa(jg, je, t, s, bnds)
    out = tini.inicon_woa(tg, te, t, s, bnds)
    for name, a, b in zip(('temp', 'saln', 'sigmar', 'phi'), ref, out):
        a = np.asarray(a)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(tini.dst_interfaces(bnds, 9),
                                  jini.dst_interfaces(bnds, 9))


def _gridfile_args(directory, arctic):
    """(grfile, keyword arguments of build_gridfile) of a case."""
    if arctic:
        grfile, icfile = gridfiles.coupled_files(directory, **TRIPOLAR)
        return grfile, dict(kdm=TRIPOLAR['kdm'], baclin=180., batrop=6.,
                            expcnf='cesm', icfile=icfile, arctic=True)
    return _fuk95_file(directory), dict(
        kdm=FUK95['kdm'], baclin=180., batrop=6., expcnf='ben02clim',
        icfile=_ic_file(directory, (FUK95['jtdm'], FUK95['itdm']), 200.))


def _check_build(jm, tm):
    _grid_equal(jm.grid, tm.grid)
    for name in ('coeffs_i', 'coeffs_j'):
        for f in getattr(tm, name)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(tm, name), f).numpy(),
                np.asarray(getattr(getattr(jm, name), f)), err_msg=f)
    assert dataclasses.asdict(tm.clock) == dataclasses.asdict(jm.clock)
    assert dataclasses.asdict(tm.e) == dataclasses.asdict(jm.e)
    for f in ('baclin', 'lstep', 'dlt', 'pgfmth', 'vcoord_isopyc', 'ale',
              'itriag', 'momtum', 'barotp'):
        a, b = getattr(jm.par, f), getattr(tm.par, f)
        assert (a._asdict() if hasattr(a, '_asdict') else a) \
            == (b._asdict() if hasattr(b, '_asdict') else b), f
    _state_close(jm.state, tm.state)


def _state_close(ref, state):
    """Every field within 1e-12 of max(max |ref|, 1), the sea level of
    the water column's depth (max pb / onem): at rest it is a difference
    of bottom pressures, rounding alone."""
    depth = float(np.asarray(ref.pb).max()) / 9806.
    bad = {}
    for name, a in _np_fields(ref).items():
        if a.size:
            err = float(np.abs(a - getattr(state, name).numpy()).max())
            scale = depth if name == 'sealv' else max(np.abs(a).max(), 1.)
            if err > 1e-12 * scale:
                bad[name] = err
    assert not bad, bad


TAU = (.1, .05)     # N m-2 at u and v points: the 4 steps move water


def _wind(jm, tm):
    """Both models under a wind stress of TAU."""
    for m in (jm, tm):
        m.forcing = dataclasses.replace(m.forcing, taux=TAU[0] * m.grid.iu,
                                        tauy=TAU[1] * m.grid.iv)


def _check_run(ref, jm, tm):
    """4 steps of the port's driver from blom_tpu's initial state against
    blom_tpu's 4 steps `ref`, the prognostic fields within FULL_TOL (the
    others, pressure gradients among them, are rounding alone in a
    horizontally uniform ocean); the port finite and the water moving."""
    model = dataclasses.replace(
        tm, state=convert.state_from_numpy(_np_fields(jm.state)))
    ts, clock = tst.run(model, 4)
    assert clock.nstep == 4
    for name in ('dp', 'temp', 'saln', 'u', 'v', 'pb'):
        assert torch.isfinite(getattr(ts, name)).all(), name
    assert float(ts.u.abs().max()) > 1e-5 and float(ts.v.abs().max()) > 1e-5
    errs = _rel_errors(ref, ts)
    bad = {k: errs[k] for k in FULL_TOL if errs[k] > FULL_TOL[k]}
    assert not bad, bad


@pytest.mark.parametrize('arctic', [False, True])
def test_build_gridfile_matches_blom_tpu(tmp_path, tmp_path_factory, arctic):
    grfile, kw = _gridfile_args(tmp_path, arctic)
    jm = jst.build_gridfile(grfile, **kw)
    tm = tst.build_gridfile(grfile, **kw, device='cpu')
    _check_build(jm, tm)
    _wind(jm, tm)
    ref = shared(tmp_path_factory, f'gridfile_run_{arctic}',
                 lambda: jst.run(jm, 4)[0])
    _check_run(ref, jm, tm)


def test_build_single_column_matches_blom_tpu(tmp_path_factory):
    jm = jst.build_single_column()
    tm = tst.build_single_column(device='cpu')
    _check_build(jm, tm)
    _wind(jm, tm)
    ref = shared(tmp_path_factory, 'single_column_run',
                 lambda: jst.run(jm, 4)[0])
    _check_run(ref, jm, tm)


def test_single_column_day():
    """tests/test_configs.py::test_single_column_day on the port."""
    model = tst.build_single_column(device='cpu')
    s0 = model.state
    assert float(s0.pb[0][0, 0]) > 0.
    s, clock = tst.run(model, 48)   # 1 model day at baclin=1800
    for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'):
        assert torch.isfinite(getattr(s, f)).all(), f
    t = s.temp[1][:, 0, 0].numpy()
    dp = s.dp[1][:, 0, 0].numpy()
    wet = dp > 1.
    assert t[wet][0] > t[wet][-1] + 5.  # thermocline survives the day
    assert float(s.u.abs().max()) < 1e-6
    h0 = float((s0.temp[1] * s0.dp[1]).sum())
    h1 = float((s.temp[1] * s.dp[1]).sum())
    assert abs(h1 - h0) / abs(h0) < 1e-6


def test_entry_points_need_cuda_or_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tst.build_single_column()
    with pytest.raises(RuntimeError, match='CUDA'):
        tst.build_gridfile(_fuk95_file(tmp_path, depth=4500.), kdm=6,
                           baclin=180., batrop=6.)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_getpl_rounds_as_blom_tpu_compiled(dtype):
    """core/init.py getpl equals blom_tpu's jitted getpl bit for bit on
    20,000 seeded (T, S, phi, p) columns: XLA contracts its products into
    fused multiply-adds, which the port rounds exactly once."""
    rng = np.random.default_rng(21)
    n = 20000
    phiu = -rng.uniform(0., 4e4, n)
    cols = [a.astype(dtype) for a in (
        rng.uniform(-2., 30., n), rng.uniform(30., 38., n), phiu,
        phiu - rng.uniform(1., 5e3, n), -1.025 * phiu)]
    ref = np.asarray(jax.jit(jinit.getpl)(*cols))
    got = tinit.getpl(*map(torch.from_numpy, cols)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_varying_floor_init_and_ale_match_blom_tpu(tmp_path):
    """A floor from 100 to 5500 m under gridfiles' WOA-shaped
    climatology at 32x24x53, f64, leaves massless bottom layers in the
    shallow columns.  The port's initial state equals blom_tpu's bit for
    bit in p, dp and pb (its getpl rounds as blom_tpu's compiled one:
    with an ulp apart there, the first ALE step of either package was
    NaN in four 105 m columns); the port's first ALE regrid/remap is
    then finite where blom_tpu's is and agrees with it within FULL_TOL."""
    itdm, jtdm, kdm = 32, 24, 53
    geom = tst.build_tripolar(itdm=itdm, jtdm=jtdm, kdm=6, device='cpu').grid
    y = np.arange(jtdm)[:, None] / (jtdm - 1)
    x = 2. * np.pi * (np.arange(itdm)[None, :] + .5) / itdm
    depths = 100. + 5400. * (.5 - .5 * np.cos(x)) * np.sin(np.pi * y)
    depths = np.where(geom.depths.numpy() > 0., depths, 0.)
    depths[-1] = depths[-2][::-1]
    grfile = str(tmp_path / 'grid.nc')
    gridfiles.write_grid_file(grfile, geom, depths)
    icfile = str(tmp_path / 'woa.nc')
    lev = np.asarray(gridfiles.WOA_LEVELS)
    _, _, t, s = tst.fallback_profile(lev)
    shape = (len(lev), jtdm, itdm)
    gridfiles.write_ic_file(
        icfile, np.broadcast_to(t[:, None, None], shape),
        np.broadcast_to(s[:, None, None], shape), gridfiles.woa_bounds())
    kw = dict(kdm=kdm, baclin=180., batrop=6., expcnf='cesm', icfile=icfile,
              arctic=True)
    jm = jst.build_gridfile(grfile, **kw)
    tm = tst.build_gridfile(grfile, **kw, device='cpu')
    _state_close(jm.state, tm.state)
    for name in ('p', 'dp', 'pb'):
        np.testing.assert_array_equal(getattr(tm.state, name).numpy(),
                                      np.asarray(getattr(jm.state, name)),
                                      err_msg=name)
    ref = jal.ale_regrid_remap(jm.grid, jm.e, jm.par.ale, jm.state, 0, 1,
                               180.)
    out = tal.ale_regrid_remap(tm.grid, tm.e, tm.par.ale, tm.state.clone(),
                               0, 1, 180.)
    for name in ('dp', 'temp', 'saln', 'u', 'v'):
        fin = np.isfinite(np.asarray(getattr(ref, name)))
        assert fin.all(), name
        np.testing.assert_array_equal(
            np.isfinite(getattr(out, name).numpy()), fin, err_msg=name)
    errs = _rel_errors(ref, out)
    bad = {k: errs[k] for k in FULL_TOL if errs[k] > FULL_TOL[k]}
    assert not bad, bad
