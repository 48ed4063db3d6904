"""The port's coupled cap and forcing streams against blom_tpu's, on the
CPU in f64.

Every function of drivers/coupled.py and drivers/streams.py from the
same inputs (made from a seed with numpy; a fuk95 state at 16x8x6 with
random velocities, sea level and a top layer partly below freezing)
within 1e-12 of max |ref|: zero_imports, init_cesm_forcing,
import_forcing, getfrc_cesm over a coupling interval with and without
smoothing, thermf_cesm, sfcstr_cesm, ocn_export with and without BGC
fluxes (the 30-level profiles 1e30 below the sea floor), monthly_stream
with and without a fill mask, Stream.interp over a year and its data-year
alignment, stream_from_netcdf with a scale factor, and swtfrz in each
option.  Then one OcnCap interval of 2 steps on a grid-file cesm build
at 16x8x6 from a climatology warmer by CAP_DT across the channel,
data_initialize's and advance's exports and the state within
test_torch_slice.py's FULL_TOL, the barotropic velocities at u's and v's
(blom_tpu's interval, its step run eagerly as its cap runs it, is built
once per test run)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core import eos as jeos
from blom_tpu.drivers import coupled as jcp
from blom_tpu.drivers import standalone as jst
from blom_tpu.drivers import streams as jss
from blom_tpu_torch import convert
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.drivers import coupled as tcp
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.drivers import streams as tss

from tests.test_torch_slice import FULL_TOL
from torch_shared import shared, shared_build

SIZE = dict(itdm=16, jtdm=8, kdm=6)
# K of warming across the cap's channel, from its west to its east wall:
# a horizontally uniform ocean's layer velocities are rounding alone
CAP_DT = 2.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(a, b, name=''):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, name
    np.testing.assert_allclose(b, a, rtol=0,
                               atol=1e-12 * max(np.abs(a).max(initial=0.),
                                                1e-300), err_msg=name)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """blom_tpu's and the port's fuk95 at SIZE with one state: random
    velocities, barotropic velocities and sea level, and the top layer's
    temperature partly below freezing."""
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **SIZE)
    tm = tst.build_fuk95(**SIZE, device='cpu')
    rng = np.random.default_rng(31)
    d = _np_fields(jm.state)
    d['u'] = rng.normal(0., .2, d['u'].shape) * np.asarray(jm.grid.iu)
    d['v'] = rng.normal(0., .2, d['v'].shape) * np.asarray(jm.grid.iv)
    d['ub'] = rng.normal(0., .05, d['ub'].shape)
    d['vb'] = rng.normal(0., .05, d['vb'].shape)
    d['sealv'] = rng.normal(0., .3, d['sealv'].shape)
    d['temp'] = d['temp'].copy()
    d['temp'][:, 0] = rng.uniform(-3., 20., d['temp'][:, 0].shape)
    jm = dataclasses.replace(jm, state=dataclasses.replace(
        jm.state, **{k: jnp.asarray(v) for k, v in d.items()}))
    tm = dataclasses.replace(tm, state=convert.state_from_numpy(d))
    je = jeos.init_eos(pref=0., expcnf='cesm')
    te = teos.init_eos(pref=0., expcnf='cesm')
    return jm, tm, je, te


def _import_values(shape, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name in jcp.ImportFields._fields:
        if name in ('hmat', 'hmoa', 'hlat'):
            continue
        out[name] = rng.uniform(-1., 1., shape)
    out['duu10n'] = rng.uniform(-5., 60., shape)     # clamped below 0
    out['lamult'] = rng.uniform(1., 2., shape)
    out['swnet'] = rng.uniform(0., 300., shape)
    for k in ('rain', 'snow', 'evap', 'rofl', 'rofi', 'meltw', 'salt',
              'rofl_glc', 'rofi_glc'):
        out[k] = out[k] * 1e-4
    return out


def _imports(shape, seed):
    v = _import_values(shape, seed)
    return (jcp.ImportFields(**{k: jnp.asarray(a) for k, a in v.items()}),
            convert.imports_from_numpy(v))


def test_zero_imports_and_forcing_match_blom_tpu():
    shape = (5, 7)
    for a, b in zip(jcp.zero_imports(shape), tcp.zero_imports(shape)):
        _close(a, b)
    ja, ta = jcp.init_cesm_forcing(shape), tcp.init_cesm_forcing(shape)
    for f in dataclasses.fields(ja):
        _close(getattr(ja, f.name), getattr(ta, f.name), f.name)
    assert tcp.N_IMPORTS == jcp.N_IMPORTS
    assert tcp.EXPORT_LEVEL_BNDS == jcp.EXPORT_LEVEL_BNDS
    assert tcp.EXPORT_LEVELS == jcp.EXPORT_LEVELS
    assert tcp.ImportFields._fields == jcp.ImportFields._fields
    assert tcp.ExportFields._fields == jcp.ExportFields._fields
    assert [f.name for f in dataclasses.fields(tcp.CesmForcing)] \
        == [f.name for f in dataclasses.fields(jcp.CesmForcing)]


def _forcings(shape):
    """Both packages' CesmForcing after two intervals of random imports."""
    jcf, tcf = jcp.init_cesm_forcing(shape), tcp.init_cesm_forcing(shape)
    for seed in (1, 2):
        ji, ti = _imports(shape, seed)
        jcf, tcf = jcp.import_forcing(jcf, ji), tcp.import_forcing(tcf, ti)
    return jcf, tcf


def test_import_forcing_matches_blom_tpu():
    jcf, tcf = _forcings((8, 16))
    for f in dataclasses.fields(jcf):
        _close(getattr(jcf, f.name), getattr(tcf, f.name), f.name)
    d = {f.name: np.asarray(getattr(jcf, f.name))
         for f in dataclasses.fields(jcf)}
    back = convert.cesm_forcing_from_numpy(d)
    assert torch.equal(back.swa, tcf.swa)


@pytest.mark.parametrize('smtfrc', [True, False])
def test_getfrc_cesm_matches_blom_tpu(smtfrc):
    jcf, tcf = _forcings((8, 16))
    for istep in range(11):
        ja = jcp.getfrc_cesm(jcf, 4, istep, smtfrc)
        ta = tcp.getfrc_cesm(tcf, 4, istep, smtfrc)
        assert sorted(ja) == sorted(ta)
        for k in ja:
            _close(ja[k], ta[k], k)


def test_thermf_and_sfcstr_cesm_match_blom_tpu(models):
    jm, tm, je, te = models
    jcf, tcf = _forcings(jm.grid.shape)
    jf = jcp.getfrc_cesm(jcf, 4, 1)
    tf = tcp.getfrc_cesm(tcf, 4, 1)
    for m, n in ((0, 1), (1, 0)):
        ja = jcp.thermf_cesm(jm.grid, je, jm.state, jf, m, n, 180.)
        ta = tcp.thermf_cesm(tm.grid, te, tm.state, tf, m, n, 180.)
        assert sorted(ja) == sorted(ta)
        for k in ja:
            _close(ja[k], ta[k], k)
        assert float(ta['frzpot'].max()) > 0.
    for a, b in zip(jcp.sfcstr_cesm(jm.grid, jf), tcp.sfcstr_cesm(tm.grid,
                                                                  tf)):
        _close(a, b)


@pytest.mark.parametrize('bgc', [False, True])
def test_ocn_export_matches_blom_tpu(models, bgc):
    jm, tm, je, te = models
    rng = np.random.default_rng(5)
    shape = jm.grid.shape
    frzpot = rng.uniform(0., 1e4, shape)
    fl = ({k: rng.normal(0., 1e-8, shape) for k in
           ('co2flux', 'dmsflux', 'brfflux', 'n2oflux', 'nh3flux')}
          if bgc else None)
    for n in (0, 1):
        ja = jcp.ocn_export(jm.grid, je, jm.state, n, jnp.asarray(frzpot),
                            180., fl and {k: jnp.asarray(v)
                                          for k, v in fl.items()})
        ta = tcp.ocn_export(tm.grid, te, tm.state, n,
                            torch.from_numpy(frzpot), 180.,
                            fl and {k: torch.from_numpy(v)
                                    for k, v in fl.items()})
        for k in jcp.ExportFields._fields:
            _close(getattr(ja, k), getattr(ta, k), k)
        # fuk95's sea floor lies above the deepest export level
        assert (ta.So_t_depth == 1e30).any()
        back = convert.exports_from_numpy(
            {k: np.asarray(getattr(ja, k)) for k in ja._fields})
        assert torch.equal(back.So_s, ta.So_s)


@pytest.mark.parametrize('fill', [False, True])
def test_monthly_stream_matches_blom_tpu(fill):
    rng = np.random.default_rng(7)
    fields = rng.uniform(-2., 30., (2, 12, 5, 6))
    mask = (rng.uniform(size=(5, 6)) < .8).astype(float) if fill else None
    js_ = jss.monthly_stream(fields, 1990, 1991, 2000, fill_mask=mask)
    ts_ = tss.monthly_stream(fields, 1990, 1991, 2000, fill_mask=mask)
    for f in ('data', 'day_of_year', 'year'):
        np.testing.assert_array_equal(getattr(ts_, f), getattr(js_, f))
    for f in ('year_first', 'year_last', 'year_align', 'nday_in_year'):
        assert getattr(ts_, f) == getattr(js_, f)
    for year in (1999, 2000, 2001, 2002):
        for day in np.linspace(0., 365., 29):
            _close(js_.interp(year, day), ts_.interp(year, day), day)
    out = ts_.interp(2000, 100.5, dtype=torch.float32)
    assert out.dtype == torch.float32 and out.device.type == 'cpu'
    with pytest.raises(ValueError):
        dataclasses.replace(ts_, year=ts_.year + 100).interp(2000, 1.)


def test_stream_from_netcdf_matches_blom_tpu(tmp_path):
    from scipy.io import netcdf_file
    rng = np.random.default_rng(9)
    data = rng.integers(-300, 3000, (12, 4, 5)).astype(np.int16)
    path = str(tmp_path / 'sst.nc')
    with netcdf_file(path, 'w') as nc:
        nc.createDimension('time', 12)
        nc.createDimension('lat', 4)
        nc.createDimension('lon', 5)
        var = nc.createVariable('sst', 'h', ('time', 'lat', 'lon'))
        var[:] = data
        var.scale_factor = .01
    mask = np.ones((4, 5))
    mask[0, 0] = 0.
    js_ = jss.stream_from_netcdf(path, 'sst', 1850, 1850, 1, fill_mask=mask)
    ts_ = tss.stream_from_netcdf(path, 'sst', 1850, 1850, 1, fill_mask=mask)
    np.testing.assert_array_equal(ts_.data, js_.data)
    for day in (0., 15.2, 200., 364.9):
        _close(js_.interp(7, day), ts_.interp(7, day))


def test_swtfrz_matches_blom_tpu():
    s = np.random.default_rng(3).uniform(0., 40., (6, 7))
    assert tss.TFREEZE_OPTIONS == jss.TFREEZE_OPTIONS
    for option in tss.TFREEZE_OPTIONS:
        _close(jss.swtfrz(jnp.asarray(s), option),
               tss.swtfrz(torch.from_numpy(s), option), option)
    for mod, x in ((jss, jnp.asarray(s)), (tss, torch.from_numpy(s))):
        with pytest.raises(ValueError):
            mod.swtfrz(x, 'ice')


def _cap_file(directory):
    """The fuk95 geometry's grid file and build_gridfile's arguments: a
    climatology warmer by CAP_DT from the west wall to the east one, so
    that the layers carry pressure gradients and flow."""
    from test_torch_gridfile import _fuk95_file, _ic_file
    shape = (SIZE['jtdm'], SIZE['itdm'])
    warm = CAP_DT * np.broadcast_to(np.linspace(0., 1., shape[1]), shape)
    return _fuk95_file(directory), dict(
        kdm=SIZE['kdm'], baclin=180., batrop=6., expcnf='cesm',
        icfile=_ic_file(directory, shape, 200., warm))


def test_cap_interval_matches_blom_tpu(tmp_path, tmp_path_factory):
    grfile, kw = _cap_file(tmp_path)
    jm = jst.build_gridfile(grfile, **kw)
    tm = tst.build_gridfile(grfile, **kw, device='cpu')
    tm.state = convert.state_from_numpy(_np_fields(jm.state))
    shape = jm.grid.shape
    vals = _import_values(shape, 4)
    vals['swnet'] = 150. * np.maximum(np.cos(np.radians(
        np.asarray(jm.grid.plat))), 0.)

    def reference():
        cap = jcp.OcnCap(jm, 2)
        ex0 = cap.data_initialize()
        ex = cap.advance(jcp.ImportFields(**{k: jnp.asarray(a)
                                             for k, a in vals.items()}))
        return ex0, ex, jm.state, cap.frzpot

    jex0, jex, jstate, jfrz = shared(tmp_path_factory, 'cap_interval',
                                     reference)
    cap = tcp.OcnCap(tm, 2)
    tex0 = cap.data_initialize()
    for k in jcp.ExportFields._fields:
        _close(getattr(jex0, k), getattr(tex0, k), k)
    tex = cap.advance(convert.imports_from_numpy(vals))
    assert cap.nstep == 2 and tm.state is not None
    ts = tm.state
    for name in ('dp', 'temp', 'saln', 'u', 'v', 'pb'):
        assert torch.isfinite(getattr(ts, name)).all(), name
    # the zonal temperature gradient drives the layers, the stress the
    # barotropic mode
    assert float(ts.u.abs().max()) > 1e-3 and float(ts.v.abs().max()) > 1e-3
    assert float(ts.ub.abs().max()) > 1e-4
    tols = dict(FULL_TOL, ub=FULL_TOL['u'], vb=FULL_TOL['v'])
    bad = {}
    for k in tols:
        a = np.asarray(getattr(jstate, k))
        err = float(np.abs(a - getattr(ts, k).numpy()).max()
                    / np.abs(a).max())
        if err > tols[k]:
            bad[k] = err
    assert not bad, bad
    for k in jcp.ExportFields._fields:
        a, b = np.asarray(getattr(jex, k)), getattr(tex, k).numpy()
        tol = FULL_TOL['u'] if k in ('So_u', 'So_v', 'So_dhdx',
                                     'So_dhdy') else FULL_TOL['temp']
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=tol * max(np.abs(a).max(), 1e-300),
                                   err_msg=k)
    _close(jfrz, cap.frzpot, 'frzpot')
