"""The port's auxiliary surface physics against blom_tpu's, on CPU in
f64, from the same inputs made from a seed with numpy:

- `phys/temmin.py` settemmin on both vertical coordinates, exactly;
  diapfl's massless fill with a settemmin field, a number and None on
  columns without interior layers whose layer 2 is colder than some
  layers' floors, within 1e-12 (measured: bit for bit), None bit for bit
  the port's -3 C floor;
- `phys/niw.py` niw_ke_tendency over two calls, within 1e-12; mxlayr
  with a seeded idkedt and niwgf > 0 within test_torch_isopyc.py's
  MXLAYR_TOL (the near-inertial energy makes it entrain);
- `phys/intp1d.py` intp1d and clim_indices (the wrap), the clock's
  month_interp, ymd_tod and day of the year over a 360-day year,
  exactly;
- `phys/idarlx.py` (a round trip through tmp_path; diagnose_flux leaves
  the caller's accumulator as it was) and `phys/rdcsss.py` from .npz and
  from classic NetCDF written with scipy, with missing values, exactly;
- `phys/forcing.py` fwbbal_accumulate and fwbbal_update within 1e-12;
- `phys/swabs.py` swabs_from_chl, updswa and init_swabs for every method
  and blom_tpu's error messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core import geoenv as jgeo
from blom_tpu.core import modeltime as jmt
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import diapfl as jdp
from blom_tpu.dynamics import mxlayr as jmx
from blom_tpu.phys import forcing as jfo
from blom_tpu.phys import idarlx as jid
from blom_tpu.phys import intp1d as jip
from blom_tpu.phys import niw as jniw
from blom_tpu.phys import rdcsss as jrd
from blom_tpu.phys import swabs as jsw
from blom_tpu.phys import temmin as jtm
from blom_tpu_torch import convert
from blom_tpu_torch.core import geoenv as tgeo
from blom_tpu_torch.core import modeltime as tmt
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import diapfl as tdp
from blom_tpu_torch.dynamics import mxlayr as tmx
from blom_tpu_torch.phys import forcing as tfo
from blom_tpu_torch.phys import idarlx as tid
from blom_tpu_torch.phys import intp1d as tip
from blom_tpu_torch.phys import niw as tniw
from blom_tpu_torch.phys import rdcsss as trd
from blom_tpu_torch.phys import swabs as tsw
from blom_tpu_torch.phys import temmin as ttm
from tests.test_diapfl_oracle import _random_columns as diapfl_columns
from tests.test_torch_isopyc import MXLAYR_TOL
from tests.test_torch_tracers import _np_fields, _port_state, _rel_errors
from tests.torch_shared import shared_build

TOL = 1e-12
ISOPYC = dict(vcoord='isopyc_bulkml', itdm=24, jtdm=8, kdm=10)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _assert_close(ref, port, tol=TOL):
    if isinstance(port, torch.Tensor):
        ref = np.asarray(ref)
        err = np.abs(ref - port.numpy()).max() / max(np.abs(ref).max(),
                                                    1e-300)
        assert err <= tol, err
        return
    bad = {k: v for k, v in _rel_errors(ref, port).items() if v > tol}
    assert not bad, bad


@pytest.fixture(scope='module')
def isopyc(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_fuk95, **ISOPYC),
            tst.build_fuk95(device='cpu', **ISOPYC))


# ---------------------------------------------------------------- temmin

def test_settemmin_matches_blom_tpu(isopyc):
    jm, tm = isopyc
    for isopyc_, expcnf in ((True, 'fuk95'), (False, 'fuk95'),
                            (True, 'single_column')):
        ref = jtm.settemmin(jm.e, jm.state.sigmar, isopyc_, expcnf)
        out = ttm.settemmin(tm.e, tm.state.sigmar, isopyc_, expcnf)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    out = ttm.settemmin(tm.e, tm.state.sigmar, True)
    assert bool((out[0] == -3.).all()) and bool((out[1:] > -2.5).all())
    assert bool((out[1:] < 0.).all())


def _unfilled_columns(jm, seed=23):
    """test_diapfl_oracle.py's columns, a third of them without interior
    layers (mass in the mixed layer alone) and their layer 2 at -2.6 to
    -1 C, below some layers' freezing floors and above -3 C."""
    s, nu, n = diapfl_columns(jm)
    rng = np.random.default_rng(seed)
    H = jm.grid.shape
    bare = rng.uniform(size=H) < 1. / 3.
    dp = np.asarray(s.dp[n]).copy()
    dp[2:, bare] = 0.
    temp = np.asarray(s.temp[n]).copy()
    temp[1, bare] = rng.uniform(-2.6, -1., H)[bare]
    s = dataclasses.replace(s, dp=s.dp.at[n].set(jnp.asarray(dp)),
                            temp=s.temp.at[n].set(jnp.asarray(temp)))
    return s, nu, n


def test_diapfl_temmin_matches_blom_tpu(tmp_path_factory):
    jm = shared_build(tmp_path_factory, jst.build_fuk95, itdm=18, jtdm=8,
                      kdm=12)
    tm = tst.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, nu, n = _unfilled_columns(jm)
    g = jm.grid
    d1 = 2. * jm.par.baclin
    jtmn = jtm.settemmin(jm.e, jm.state.sigmar, True)
    ttmn = ttm.settemmin(tm.e, tm.state.sigmar, True)
    outs = {}
    for name, jt_, tt_ in (('none', None, None), ('field', jtmn, ttmn)):
        ref = jax.jit(lambda s, nu: jdp.diapfl(g, jm.e, s, nu, 0, n, d1,
                                               temmin=jt_))(s, nu)
        outs[name] = tdp.diapfl(tm.grid, tm.e, _port_state(s), _t(nu), 0,
                                n, d1, temmin=tt_)
        _assert_close(ref, outs[name])

    def port(tmn):
        return tdp.diapfl(tm.grid, tm.e, _port_state(s), _t(nu), 0, n, d1,
                          temmin=tmn)
    # None is the -3 C floor, and a number the field of that number, bit
    # for bit
    for a, b in ((outs['none'], port(tdp.TMIN)),
                 (outs['none'], port(torch.full_like(ttmn, tdp.TMIN))),
                 (port(-2.), port(torch.full_like(ttmn, -2.)))):
        for f in ('temp', 'saln', 'sigma', 'dp'):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    # the per-layer floor bites where the -3 C one does not
    lifted = outs['field'].temp[n] - outs['none'].temp[n]
    assert float(lifted.min()) >= 0. and float(lifted.max()) > .1


# ------------------------------------------------------------------- niw

def _niw_state(jm, seed=24):
    """The isopycnic initial state with seeded mixed-layer velocities,
    thicknesses and barotropic fluxes, and nonzero pbu/pbv."""
    rng = np.random.default_rng(seed)
    s = jm.state
    g = jm.grid
    iu, iv = np.asarray(g.iu), np.asarray(g.iv)
    shape = np.asarray(s.u).shape
    return dataclasses.replace(
        s, u=jnp.asarray(rng.normal(0., .2, shape) * iu),
        v=jnp.asarray(rng.normal(0., .2, shape) * iv),
        dpu=jnp.asarray(rng.uniform(5., 20., shape) * 9806. * iu),
        dpv=jnp.asarray(rng.uniform(5., 20., shape) * 9806. * iv),
        pbu=jnp.full_like(s.pbu, 100. * 9806.),
        pbv=jnp.full_like(s.pbv, 100. * 9806.),
        ubflxs_p=jnp.asarray(rng.normal(0., 1e6, np.shape(s.ubflxs_p))),
        vbflxs_p=jnp.asarray(rng.normal(0., 1e6, np.shape(s.vbflxs_p))))


def test_niw_ke_tendency_matches_blom_tpu(isopyc):
    """Two calls, the second after a velocity jump in the mixed layer, as
    tests/test_aux_modules.py drives it; the second call's idkedt is
    positive over water."""
    jm, tm = isopyc
    s = _niw_state(jm)
    H = jm.grid.shape
    jn = jniw.init_niw(H)
    tn = tniw.init_niw(H, device='cpu')
    _assert_close(jn, tn, 0.)
    dlt = jm.par.dlt
    for step in range(2):
        if step:
            s = dataclasses.replace(s, u=s.u.at[0, :2].add(.1))
        jn = jniw.niw_ke_tendency(jm.grid, s, jn, 0, 360., dlt)
        tn = tniw.niw_ke_tendency(tm.grid, _port_state(s), tn, 0, 360., dlt)
        _assert_close(jn, tn)
        tn = convert.niw_from_numpy(_np_fields(jn))
    wet = tm.grid.ip > 0
    assert float(tn.idkedt[wet].max()) > 0.


def test_mxlayr_idkedt_matches_blom_tpu(isopyc):
    """mxlayr with niwgf 1 and a seeded idkedt (the near-inertial energy
    source, mod_mxlayr.F90:204-205) within MXLAYR_TOL, and the source
    moves the mixed layer."""
    jm, tm = isopyc
    rng = np.random.default_rng(25)
    idkedt = rng.uniform(0., 1., jm.grid.shape) * np.asarray(jm.grid.ip)
    jpar = jm.par.mxlayr._replace(niwgf=1.)
    tpar = tm.par.mxlayr._replace(niwgf=1.)
    d1 = jm.clock.delt1
    ref = jmx.mxlayr(jm.grid, jm.e, jm.state, jm.forcing, jpar, 0, 1, d1,
                     swabs=jm.swabs, idkedt=jnp.asarray(idkedt), dfl=jm.dfl)

    def port(**kw):
        return tmx.mxlayr(
            tm.grid, tm.e, _port_state(jm.state), tm.forcing, tpar, 0, 1, d1,
            swabs=tm.swabs,
            dfl=convert.diffusion_fields_from_numpy(_np_fields(jm.dfl)), **kw)
    out = port(idkedt=_t(idkedt))
    for r, o in zip(ref, out):
        _assert_close(r, o, MXLAYR_TOL['wind'])
    plain, _ = port()
    assert float((out[0].dp[1][0] - plain.dp[1][0]).abs().max()) > 0.


# ---------------------------------------------------- time interpolation

def test_intp1d_and_clim_indices_match_blom_tpu():
    rng = np.random.default_rng(26)
    d = rng.normal(0., 1., (5, 4, 3))
    for x in (0., .25, .5, .999):
        ref = jip.intp1d(*(jnp.asarray(a) for a in d), x)
        out = tip.intp1d(*(_t(a) for a in d), x)
        _assert_close(ref, out)
    assert tip.intp1d(-2., -1., 0., 1., 2., .25) == pytest.approx(-.25)
    for day in range(1, 366):
        for frac in (0., .5, .99):
            for nday in (360., 365.):
                assert (tip.clim_indices(day, frac, 48, nday)
                        == jip.clim_indices(day, frac, 48, nday))
    i1, i2, i3, i4, i5, _ = tip.clim_indices(1, 0.)
    assert (i1, i2, i3, i4, i5) == (46, 47, 0, 1, 2)


def test_month_interp_over_a_year():
    """The port's clock against blom_tpu's, every 1000th step of a
    360-day year at 180 s steps (the fuk95 clock)."""
    args = ('fuk95', 180., 6., 10101, 10101)
    jc, tc = jmt.init_timevars(*args), tmt.init_timevars(*args)
    months = set()
    for step in range(360 * 480 + 1):
        if step % 1000 == 0 or step == 360 * 480:
            assert tc.month_interp() == jc.month_interp(), step
            assert tc.ymd_tod() == jc.ymd_tod(), step
            assert ((tc.nday_of_year, tc.nday_in_year)
                    == (jc.nday_of_year, jc.nday_in_year)), step
            months.add(tc.month_interp()[3])
        jc, tc = jc.step(), tc.step()
    assert months == set(range(1, 13))
    assert tc.date.to_ymd() == 20101 and tc.nday_of_year == 1


# --------------------------------------------- flux climatologies and SSS

def test_idarlx_round_trip(tmp_path):
    arr = np.random.default_rng(27).normal(0., 10., (48, 4, 5))
    np.savez(tmp_path / 'tflxdi.npz', tflxap=arr)
    np.save(tmp_path / 'sflxdi.npy', arr[::-1])
    for name, var in (('tflxdi.npz', 'tflxap'), ('sflxdi.npy', None)):
        path = str(tmp_path / name)
        jc = jid.load_flux_clim(path, var)
        tc = tid.load_flux_clim(path, var, device='cpu')
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for day, frac in ((1, 0.), (10, .5), (365, .99)):
            _assert_close(jid.apply_flux_clim(jc, day, frac),
                          tid.apply_flux_clim(tc, day, frac))
    acc = torch.zeros(48, 4, 5, dtype=torch.float64)
    count = torch.zeros(48, dtype=torch.int32)
    flx = _t(arr[0])
    acc2, count2 = tid.diagnose_flux(acc, count, flx, 7)
    jacc, jcount = jid.diagnose_flux(jnp.zeros((48, 4, 5)),
                                     jnp.zeros(48, jnp.int32),
                                     jnp.asarray(arr[0]), 7)
    np.testing.assert_array_equal(acc2.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(count2.numpy(), np.asarray(jcount))
    assert not acc.any() and not count.any()
    np.save(tmp_path / 'short.npy', arr[:12])
    with pytest.raises(ValueError, match='48 slices'):
        tid.load_flux_clim(str(tmp_path / 'short.npy'), None, device='cpu')


def _sss(seed=28):
    """12 months of SSS at 6x8 with blocks of missing values."""
    rng = np.random.default_rng(seed)
    sss = 35. + rng.normal(0., .5, (12, 6, 8))
    sss[:, 1:4, 2:5] = -9.99e33
    sss[3, :, 0] = -9.99e33
    return sss


def test_rdcsss_matches_blom_tpu(tmp_path):
    from scipy.io import netcdf_file
    sss = _sss()
    np.savez(tmp_path / 'sss.npz', sss=sss)
    with netcdf_file(tmp_path / 'sss.nc', 'w') as f:
        f.createDimension('month', 12)
        f.createDimension('y', 6)
        f.createDimension('x', 8)
        v = f.createVariable('sss', 'f8', ('month', 'y', 'x'))
        v[:] = sss
    mask = np.ones((6, 8))
    mask[0] = 0.
    for name in ('sss.npz', 'sss.nc'):
        for m in (None, mask):
            path = str(tmp_path / name)
            ref = np.asarray(jrd.rdcsss(path, mask=m))
            out = trd.rdcsss(path, mask=None if m is None else _t(m),
                             device='cpu')
            np.testing.assert_array_equal(out.numpy(), ref)
            assert (np.abs(out.numpy() - 35.) < 5.)[:, 1:].all()
    for a, miss in ((sss[0], -9.99e33), (np.where(sss[3] < 0., np.nan,
                                                  sss[3]), np.nan)):
        for cyclic in (True, False):
            np.testing.assert_array_equal(
                tgeo.fill_global(a, miss, cyclic_i=cyclic),
                jgeo.fill_global(a, miss, cyclic_i=cyclic))
    np.savez(tmp_path / 'bad.npz', sss=sss[:6])
    with pytest.raises(ValueError, match='12 months'):
        trd.rdcsss(str(tmp_path / 'bad.npz'), device='cpu')


def test_fwbbal_matches_blom_tpu(isopyc):
    jm, tm = isopyc
    rng = np.random.default_rng(29)
    H = jm.grid.shape
    f = [rng.normal(0., 1e-5, H) for _ in range(8)]
    ref = jfo.fwbbal_accumulate(*(jnp.asarray(a) for a in f), 1800.)
    out = tfo.fwbbal_accumulate(*(_t(a) for a in f), 1800.)
    for r, o in zip(ref, out):
        _assert_close(r, o)
    ref = jfo.fwbbal_update(1.2, *ref, jm.grid.scp2, jm.grid.ip)
    out = tfo.fwbbal_update(1.2, *out, tm.grid.scp2, tm.grid.ip)
    _assert_close(ref[0], out[0])
    assert not out[1].any() and not out[2].any()
    zero = torch.zeros(H, dtype=torch.float64)
    assert float(tfo.fwbbal_update(1.2, zero + 1., zero, tm.grid.scp2,
                                   tm.grid.ip)[0]) < 0.


# ------------------------------------------------------------- shortwave

@pytest.mark.parametrize('swamth', ['chlorophyll_ma94', 'chlorophyll_ohl03'])
def test_swabs_chlorophyll_matches_blom_tpu(swamth):
    """swabs_from_chl over log10 chl beyond the clamp on both sides, the
    LUT's nodes and half-way points (ohl03: the same table entry, bit for
    bit), then updswa of a 12-month climatology at the clock's weights
    and init_swabs' first month."""
    rng = np.random.default_rng(30)
    nodes = tsw._LOG10CHL_MIN + tsw._DLOG10CHL * np.arange(0., 401., .5)
    chl10 = np.concatenate([[-3., -2., 1., 2.], nodes,
                            rng.uniform(-2.5, 1.5, 300)])
    ref = jsw.swabs_from_chl(jnp.asarray(chl10), swamth)
    out = tsw.swabs_from_chl(_t(chl10), swamth)
    _assert_close(ref, out, 0. if swamth == 'chlorophyll_ohl03' else TOL)
    chl10c = rng.uniform(-2., 1., (12, 4, 5))
    clock = tmt.init_timevars('fuk95', 180., 6., 10316, 10101)
    mi = clock.month_interp()
    _assert_close(jsw.updswa(swamth, jnp.asarray(chl10c), mi),
                  tsw.updswa(swamth, _t(chl10c), mi))
    _assert_close(jsw.init_swabs((4, 5), swamth, chl10c=chl10c),
                  tsw.init_swabs((4, 5), swamth, chl10c=chl10c))


def test_init_swabs_methods_match_blom_tpu():
    for swamth in ('jerlov', 'top-layer'):
        for jwtype in range(1, 6):
            _assert_close(jsw.init_swabs((3, 4), swamth, jwtype),
                          tsw.init_swabs((3, 4), swamth, jwtype), 0.)
    fields = tsw.SwabsFields(*(torch.full((3, 4), v, dtype=torch.float64)
                               for v in (.3, .4, 1., 20.)))
    assert tsw.init_swabs((3, 4), 'spatial_frac_attlen',
                          fields=fields) is fields
    for swamth, kw in (('chlorophyll_ohl03', {}),
                       ('spatial_frac_attlen', {}), ('nonsense', {})):
        with pytest.raises(ValueError) as ref:
            jsw.init_swabs((3, 4), swamth, **kw)
        with pytest.raises(ValueError) as out:
            tsw.init_swabs((3, 4), swamth, **kw)
        assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError, match='not chlorophyll-based'):
        tsw.swabs_from_chl(torch.zeros(2, dtype=torch.float64), 'jerlov')
