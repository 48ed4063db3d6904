"""The port's KPP boundary layer and tidal-dissipation mixing against
blom_tpu's, on CPU in f64.

Every function from the same inputs, made from a seed with numpy, within
1e-12 relative to the largest value of each output (as
tests/test_torch_slice.py measures):

- the KPP constants, by name;
- `turb_velocity_scales` in each regime: stable (zeta >= 0), unstable
  above ZETA_M, between ZETA_S and ZETA_M, and below ZETA_S;
- `bulk_richardson_obl`, `kpp_boundary_layer` and `difest_vertical_kpp`
  at 24x12x10 under a weak wind, a strong wind, cooling and heating
  (tests/test_kpp.py's forcings), the Langmuir factor given as an
  argument and through the forcing, on a state with random velocities,
  thicknesses and temperatures;
- `tidal_diffusivity` with and without the latitude dependence;
  `difest_vertical` with `twedon` as a float and as a field (the tidal
  increment non-negative and bottom-intensified,
  tests/test_kpp.py:135-171); `read_tidaldissip` from .npz, .npy and
  classic NetCDF written to tmp_path;
- the step with KPP and the tidal field, phase by phase over both
  parities, each phase from blom_tpu's state before it (barotp within
  1e-8, test_torch_slice.py's tolerance): on the ALE path at 24x8x8 with
  bench.py's physics and the geopotential PGF, on the isopycnic path at
  24x8x10 (mxlayr, which entrains under this forcing, within
  test_torch_isopyc.py's MXLAYR_TOL); the forcing a wind stress, a
  cooling (the nonlocal term active) and a seeded Langmuir factor;
- on the tripolar grid at 16x12x6, from a state four steps in (the fold
  rows carry flow): `difest_vertical_kpp` within 1e-12 and one step of
  each parity within test_torch_tripolar.py's whole-step tolerances.

blom_tpu's phases run eagerly, as test_torch_tracers.py runs them
(`_Ref`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import pgforc as jg
from blom_tpu.dynamics import step as jstep
from blom_tpu.phys import tidaldissip as jtd
from blom_tpu.phys import vmix as jvm
from blom_tpu_torch import convert
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import pgforc as tg
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.phys import tidaldissip as ttd
from blom_tpu_torch.phys import vmix as tvm
from tests.test_torch_isopyc import MXLAYR_TOL
from tests.test_torch_slice import FULL_PHASES
from tests.test_torch_tracers import (EXTRA, _np_fields, _port,
                                      _port_state, _Ref, _rel_errors)
from tests.torch_shared import shared_build

TOL = 1e-12
SIZE = dict(itdm=24, jtdm=12, kdm=10)
KPP_CONSTANTS = ('KAPPA', 'ZETA_M', 'A_M', 'C_M', 'ZETA_S', 'A_S', 'C_S',
                 'RIC', 'CV_T2', 'EPS_SL', 'BETA_T', 'CS_NONLOC')
# tests/test_kpp.py's forcings: wind stress at u (and v) points [N m-2],
# surflx > 0 cools the ocean (a destabilizing buoyancy loss)
FORCINGS = {'weak_wind': dict(taux=.01),
            'strong_wind': dict(taux=.5, tauy=.2),
            'cooling': dict(taux=.1, surflx=500.),
            'heating': dict(taux=.1, surflx=-500.)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _close(port, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _assert_rel(ref, port, tol=TOL):
    bad = {k: v for k, v in _rel_errors(ref, port).items() if v > tol}
    assert not bad, bad


def test_kpp_constants_match_blom_tpu():
    for name in KPP_CONSTANTS:
        assert getattr(tvm, name) == getattr(jvm, name), name
    assert tvm.VmixParams()._asdict() == jvm.VmixParams()._asdict()


# ------------------------------------------------------ velocity scales

# target zeta (stability parameter) of each regime
REGIMES = {'stable': (0., 3.), 'unstable_m': (-.19, -.01),
           'between': (-.95, -.25), 'convective': (-8., -1.05)}


@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_turb_velocity_scales_match_blom_tpu(regime):
    rng = np.random.default_rng(11)
    shape = (6, 5, 7)
    sigma = rng.uniform(.01, 1., shape)
    hbl = rng.uniform(1., 200., shape)
    ustar = rng.uniform(1e-4, .03, shape)
    ustar.flat[::17] = 0.          # the 1e-8 floor
    zeta = rng.uniform(*REGIMES[regime], shape)
    um = np.maximum(ustar, 1e-8)
    # bfsfc < 0 uses min(sigma, EPS_SL)
    sig_eff = np.where(zeta < 0., np.minimum(sigma, tvm.EPS_SL), sigma)
    bfsfc = zeta * um ** 3 / (sig_eff * hbl * tvm.KAPPA)
    ref = jvm.turb_velocity_scales(*map(jnp.asarray,
                                        (sigma, hbl, ustar, bfsfc)))
    out = tvm.turb_velocity_scales(*map(_t, (sigma, hbl, ustar, bfsfc)))
    for o, r in zip(out, ref):
        _close(o, r)
    wm, ws = (np.asarray(r) for r in ref)
    ku = tvm.KAPPA * um
    if regime == 'stable':
        assert (wm <= ku * (1 + 1e-12)).all() and (wm == ws).all()
    else:
        assert (ws > ku).all()


# ------------------------------------------------------------------ KPP

@pytest.fixture(scope='module')
def kpp_models(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_fuk95, **SIZE),
            tst.build_fuk95(device='cpu', **SIZE))


def _kpp_state(jm, seed=3):
    """blom_tpu's initial state with thicknesses, velocities (baroclinic
    and barotropic), temperatures and densities perturbed at random."""
    rng = np.random.default_rng(seed)
    s, g = jm.state, jm.grid
    ip, iu, iv = (np.asarray(a) for a in (g.ip, g.iu, g.iv))
    dp = np.asarray(s.dp) * (1. + .3 * rng.random(np.asarray(s.dp).shape))
    shape = np.asarray(s.u).shape
    bshape = np.asarray(s.ub).shape
    return dataclasses.replace(
        s, dp=jnp.asarray(dp * ip),
        u=jnp.asarray(rng.normal(0., .2, shape) * iu),
        v=jnp.asarray(rng.normal(0., .2, shape) * iv),
        ub=jnp.asarray(rng.normal(0., .1, bshape) * iu),
        vb=jnp.asarray(rng.normal(0., .1, bshape) * iv),
        temp=s.temp + jnp.asarray(rng.normal(0., .3, shape)),
        sigma=s.sigma + jnp.asarray(rng.normal(0., .02, shape)))


def _forcing(jm, case, seed=4):
    """blom_tpu's forcing of `case` with a seeded Langmuir factor in
    [1, 2]."""
    g = jm.grid
    H = g.shape
    rng = np.random.default_rng(seed)
    f = FORCINGS[case]
    return dataclasses.replace(
        jm.forcing,
        taux=jnp.full(H, f.get('taux', 0.)) * g.iu,
        tauy=jnp.full(H, f.get('tauy', 0.)) * g.iv,
        surflx=jnp.full(H, f.get('surflx', 0.)) * g.ip,
        lamult=jnp.asarray(rng.uniform(1., 2., H)))


def _ustar_bfsfc(jm, s, f, n=0):
    """The surface friction velocity and buoyancy flux
    difest_vertical_kpp derives from the forcing."""
    g = jm.grid
    base = jvm.difest_vertical(g, jm.e, s, f, jm.swabs, jvm.VmixParams(), n)
    taux_p = .5 * (f.taux + g.ip1(f.taux))
    tauy_p = .5 * (f.tauy + g.jp1(f.tauy, 'v', True))
    ustar = jnp.sqrt(jnp.sqrt(taux_p ** 2 + tauy_p ** 2) / 1000.)
    return ustar, base.buoyfl[0]


@pytest.mark.parametrize('case', sorted(FORCINGS))
def test_bulk_richardson_obl_matches_blom_tpu(kpp_models, case):
    jm, tm = kpp_models
    s = _kpp_state(jm)
    ustar, bfsfc0 = _ustar_bfsfc(jm, s, _forcing(jm, case))
    ref = jvm.bulk_richardson_obl(jm.grid, jm.e, s, 0, ustar, bfsfc0)
    out = tvm.bulk_richardson_obl(tm.grid, tm.e, _port_state(s), 0,
                                  _t(ustar), _t(bfsfc0))
    for o, r in zip(out, ref):
        _close(o, r)
    hbl = np.asarray(ref[0])[np.asarray(jm.grid.ip) > 0]
    # some columns find a supercritical layer, the depth varies
    assert hbl.min() >= 1. and hbl.max() > hbl.min()


@pytest.mark.parametrize('case', sorted(FORCINGS))
def test_kpp_boundary_layer_matches_blom_tpu(kpp_models, case):
    jm, tm = kpp_models
    s = _kpp_state(jm)
    ustar, bfsfc0 = _ustar_bfsfc(jm, s, _forcing(jm, case))
    hbl, _ = jvm.bulk_richardson_obl(jm.grid, jm.e, s, 0, ustar, bfsfc0)
    p_i = jnp.concatenate([jnp.zeros_like(s.dp[0][:1]),
                           jnp.cumsum(s.dp[0], 0)], 0) * jm.grid.ip
    ref = jvm.kpp_boundary_layer(jm.grid, hbl, ustar, bfsfc0, p_i)
    out = tvm.kpp_boundary_layer(tm.grid, _t(hbl), _t(ustar), _t(bfsfc0),
                                 _t(p_i))
    for o, r in zip(out, ref):
        _close(o, r)
    nl = np.asarray(ref[2])[1:]
    if case == 'heating':
        assert nl.max() == 0.
    elif case == 'cooling':
        assert nl.max() > 0.


@pytest.mark.parametrize('lamult', ['argument', 'forcing'])
@pytest.mark.parametrize('case', sorted(FORCINGS))
def test_difest_vertical_kpp_matches_blom_tpu(kpp_models, case, lamult):
    jm, tm = kpp_models
    s = _kpp_state(jm)
    f = _forcing(jm, case)
    par = jvm.VmixParams(use_kpp=True)
    if lamult == 'argument':
        lam = np.random.default_rng(5).uniform(1., 3., jm.grid.shape)
        ref = jvm.difest_vertical_kpp(jm.grid, jm.e, s, f, jm.swabs, par,
                                      1, lamult=jnp.asarray(lam))
        out = tvm.difest_vertical_kpp(
            tm.grid, tm.e, _port_state(s),
            convert.forcing_from_numpy(_np_fields(f)), tm.swabs,
            tvm.VmixParams(use_kpp=True), 1, lamult=_t(lam))
    else:
        ref = jvm.difest_vertical_kpp(jm.grid, jm.e, s, f, jm.swabs, par, 1)
        out = tvm.difest_vertical_kpp(
            tm.grid, tm.e, _port_state(s),
            convert.forcing_from_numpy(_np_fields(f)), tm.swabs,
            tvm.VmixParams(use_kpp=True), 1)
    _assert_rel(ref, out)
    # the boundary layer raises the interior coefficients somewhere
    base = jvm.difest_vertical(jm.grid, jm.e, s, f, jm.swabs, par, 1)
    assert (np.asarray(ref.Kdiff_t) > np.asarray(base.Kdiff_t)).any()


# ---------------------------------------------------------------- tidal

@pytest.mark.parametrize('with_plat', [False, True])
def test_tidal_diffusivity_matches_blom_tpu(with_plat):
    rng = np.random.default_rng(12)
    kk, H = 7, (5, 6)
    dp = rng.uniform(0., 3e6, (kk,) + H)
    dp[2, 1] = 0.
    p_i = np.concatenate([np.zeros((1,) + H), np.cumsum(dp, 0)])
    twedon = rng.uniform(.01, .05, H)
    bvfbot = rng.uniform(1e-4, 3e-3, H)
    bvfsq = rng.uniform(-1e-6, 1e-5, (kk,) + H)
    plat = rng.uniform(-89., 89., H) if with_plat else None
    kw = dict(tdclat=30., tddlat=10., tdmls1=200. * 9806.)
    ref = jtd.tidal_diffusivity(
        *map(jnp.asarray, (twedon, bvfbot, bvfsq, p_i, dp)), 9.806,
        plat=None if plat is None else jnp.asarray(plat), **kw)
    out = ttd.tidal_diffusivity(
        *map(_t, (twedon, bvfbot, bvfsq, p_i, dp)), 9.806,
        plat=None if plat is None else _t(plat), **kw)
    _close(out, ref)


@pytest.mark.parametrize('kind', ['float', 'field'])
def test_difest_vertical_tidal_matches_blom_tpu(tmp_path_factory, kind):
    """tests/test_kpp.py:135-171's configuration (fuk95 24x8x10, n 1):
    the tidal increment of the tracer diffusivity is non-negative and
    larger at the deepest interior interface than at the shallowest, on
    the mean over water."""
    jm = shared_build(tmp_path_factory, jst.build_fuk95, itdm=24, jtdm=8,
                      kdm=10)
    tm = tst.build_fuk95(itdm=24, jtdm=8, kdm=10, device='cpu')
    if kind == 'float':
        jtw, ttw = 5e-2, 5e-2
    else:
        tw = np.random.default_rng(13).uniform(.01, .05, jm.grid.shape)
        jtw, ttw = jnp.asarray(tw), _t(tw)
    ref = jvm.difest_vertical(jm.grid, jm.e, jm.state, jm.forcing,
                              jm.swabs, jvm.VmixParams(twedon=jtw), 1)
    out = tvm.difest_vertical(tm.grid, tm.e, tm.state, tm.forcing,
                              tm.swabs, tvm.VmixParams(twedon=ttw), 1)
    _assert_rel(ref, out)
    base = tvm.difest_vertical(tm.grid, tm.e, tm.state, tm.forcing,
                               tm.swabs, tvm.VmixParams(), 1)
    wet = tm.grid.ip > 0
    dk = (out.Kdiff_t - base.Kdiff_t)[:, wet]
    assert float(dk.min()) >= 0. and float(dk.max()) > 0.
    assert float(dk[-1].mean()) > float(dk[1].mean())
    assert torch.equal(out.Kvisc_m, base.Kvisc_m)


@pytest.mark.parametrize('fmt', ['npz', 'npy', 'nc'])
def test_read_tidaldissip_matches_blom_tpu(tmp_path, fmt):
    field = np.random.default_rng(14).uniform(.01, .05, (6, 9))
    path = str(tmp_path / f'tidal.{fmt}')
    if fmt == 'npz':
        np.savez(path, twedon=field)
    elif fmt == 'npy':
        np.save(path, field)
    else:
        from scipy.io import netcdf_file
        with netcdf_file(path, 'w') as f:
            f.createDimension('y', field.shape[0])
            f.createDimension('x', field.shape[1])
            v = f.createVariable('twedon', 'f8', ('y', 'x'))
            v[:] = field
    ref = np.asarray(jtd.read_tidaldissip(path))
    out = ttd.read_tidaldissip(path, device='cpu')
    assert out.dtype == torch.float64 and out.device.type == 'cpu'
    np.testing.assert_array_equal(out.numpy(), ref)
    f32 = ttd.read_tidaldissip(path, dtype=torch.float32, device='cpu')
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), field.astype(np.float32))


def test_tidaldissip_needs_cuda_or_device(tmp_path, monkeypatch):
    np.save(tmp_path / 't.npy', np.ones((2, 3)))
    np.testing.assert_array_equal(
        ttd.inivar_tidaldissip((2, 3), device='cpu').numpy(),
        np.asarray(jtd.inivar_tidaldissip((2, 3))))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for call in (lambda: ttd.read_tidaldissip(str(tmp_path / 't.npy')),
                 lambda: ttd.inivar_tidaldissip((2, 3))):
        with pytest.raises(RuntimeError, match='CUDA'):
            call()


# ------------------------------------------------------------- the step

ALE_SIZE = dict(itdm=24, jtdm=8, kdm=8)
ISOPYC_SIZE = dict(itdm=24, jtdm=8, kdm=10)
TAIL = ('barotp', 'pbcor2', 'tmsmt2')
ISOPYC_PHASES = ('tmsmt1', 'advect', 'pbcor1', 'pgforc', 'momtum', 'convec',
                 'difest_vertical', 'tke', 'diapfl', 'mxlayr') + TAIL
STEP_EXTRA = dict(EXTRA, tke='kdiff')


class VRef(_Ref):
    """test_torch_tracers.py's `_Ref` with this slice's phases: pgforc by
    par.pgfmth, the estimator that blom_tpu's step picks (`_difest_v`),
    and on the isopycnic path the TKE/GLS closure ('tke', skipped
    without par.itrtke)."""

    def fn(self, name, m, n):
        jm = self.jm
        g, e, par = jm.grid, jm.e, jm.par
        if name == 'pgforc':
            return lambda s, dfl, x, d1: jg.pgforc(g, e, s, m, n, par.pgfmth)
        if name == 'difest_vertical':
            return lambda s, dfl, x, d1: jstep._difest_v(par)(
                g, e, s, jm.forcing, jm.swabs, par.vmix, n)
        if name == 'tke':
            return lambda s, dfl, kdiff, d1: jstep._tke_closure(
                g, s, jm.forcing, kdiff, par, n, d1)
        return super().fn(name, m, n)

    def run(self, nsteps, phases):
        jm = self.jm
        s, dfl, clock = jm.state, jm.dfl, jm.clock
        rec = []
        for step in range(nsteps):
            m, n = (0, 1) if step % 2 == 0 else (1, 0)
            d1 = clock.delt1
            clock = clock.step()
            s = jstep.init_fluxes(s, m)
            ctx = {}
            for name in phases:
                if name == 'tke' and jm.par.itrtke < 0:
                    continue
                extra = ctx.get(STEP_EXTRA.get(name))
                out = self.fn(name, m, n)(s, dfl, extra, d1)
                rec.append((step, name, m, n, d1, (s, dfl, extra), out))
                if name == 'cmnfld':
                    ctx['cf'] = out
                elif name == 'difest_vertical':
                    ctx['kdiff'], ctx['vf'] = out.Kdiff_t, out
                    dfl = dataclasses.replace(
                        dfl, difvho=out.Kdiff_t, difvso=out.Kdiff_s,
                        difvmo=out.Kvisc_m, bld=out.mld * jm.grid.ip)
                elif name == 'tke':
                    s, ctx['kdiff'] = out
                elif name in ('difest_lateral', 'eddtra'):
                    dfl = out
                elif name in ('diffus', 'mxlayr'):
                    s, dfl = out
                elif name == 'momtum':
                    s = out[0]
                    ctx['uv'] = tuple(np.asarray(x) for x in out[1:])
                else:
                    s = out
        return rec, s


def port_phase(tm, coord, name, m, n, d1, s, dfl, extra):
    """The port's phase `name`, as VRef runs blom_tpu's."""
    g, e, par = tm.grid, tm.e, tm.par
    if name == 'pgforc':
        return tg.pgforc(g, e, s, m, n, par.pgfmth)
    if name == 'difest_vertical':
        return tstep._difest_v(par)(g, e, s, tm.forcing, tm.swabs,
                                    par.vmix, n)
    if name == 'tke':
        return tstep._tke_closure(g, s, tm.forcing, _t(extra), par, n, d1)
    return _port(tm, coord, name, m, n, d1, s, dfl, extra)


def phase_errors(rec, tm, coord, nsteps=2, forced=True):
    """{(step, phase): {field: error over TOL}} of the port's phases on
    VRef's recorded inputs: barotp within 1e-8 (test_torch_slice.py) and,
    when the mixed layer is `forced` (it entrains), mxlayr within
    test_torch_isopyc.py's MXLAYR_TOL."""
    bad = {}
    for step, name, m, n, d1, (s, dfl, extra), ref in rec:
        if step >= nsteps:
            continue
        out = port_phase(tm, coord, name, m, n, d1, _port_state(s),
                         convert.diffusion_fields_from_numpy(
                             _np_fields(dfl)), extra)
        if name == 'tke':
            errs = _rel_errors(ref[0], out[0])
            r, o = np.asarray(ref[1]), out[1].numpy()
            errs['kdiff'] = float(np.abs(r - o).max() / np.abs(r).max())
        else:
            pairs = (list(zip(ref, out)) if name in ('diffus', 'mxlayr')
                     else [(ref[0] if name == 'momtum' else ref, out)])
            errs = {}
            for r, o in pairs:
                errs.update(_rel_errors(r, o))
        tol = (1e-8 if name == 'barotp'
               else MXLAYR_TOL['cooling'] if name == 'mxlayr' and forced
               else TOL)
        errs = {k: v for k, v in errs.items() if v > tol}
        if errs:
            bad[(step, name)] = errs
    return bad


def kpp_forcing(model, seed=6):
    """A wind stress, a cooling and a seeded Langmuir factor in [1, 2],
    as numpy arrays."""
    g = model.grid
    H = tuple(g.shape)
    rng = np.random.default_rng(seed)
    mask = {k: np.asarray(getattr(g, k)) for k in ('ip', 'iu', 'iv')}
    return dict(taux=.1 * mask['iu'],
                tauy=rng.normal(0., .05, H) * mask['iv'],
                surflx=200. * mask['ip'],
                lamult=rng.uniform(1., 2., H))


def twedon_field(shape, seed=7):
    return np.random.default_rng(seed).uniform(.01, .05, tuple(shape))


def with_vertical_physics(jm, tm, vmix, forcing, **par):
    """Both models with `vmix` (numpy twedon) and `par` in their step
    parameters and `forcing` (numpy) in their forcing."""
    jtw = ttw = vmix.get('twedon')
    if isinstance(jtw, np.ndarray):
        jtw, ttw = jnp.asarray(jtw), _t(jtw)
    jv = dict(vmix, twedon=jtw)
    tv = dict(vmix, twedon=ttw)
    jm = dataclasses.replace(
        jm, par=jm.par._replace(vmix=jvm.VmixParams(**jv), **par),
        forcing=dataclasses.replace(
            jm.forcing, **{k: jnp.asarray(v) for k, v in forcing.items()}))
    tm = dataclasses.replace(
        tm, par=tm.par._replace(vmix=tvm.VmixParams(**tv), **par),
        forcing=dataclasses.replace(
            tm.forcing, **{k: _t(v) for k, v in forcing.items()}))
    return jm, tm


def _step_models(coord, tmp_path_factory):
    if coord == 'isopyc':
        size = dict(vcoord='isopyc_bulkml', **ISOPYC_SIZE)
    else:
        size = ALE_SIZE
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **size)
    tm = tst.build_fuk95(device='cpu', **size)
    par = {}
    if coord == 'ale':
        # bench.py's physics and the geopotential PGF
        jm.par = jm.par._replace(difest=jdf.DifestParams(egc=.85,
                                                         egmndf=100.))
        tm.par = tm.par._replace(difest=tdf.DifestParams(egc=.85,
                                                         egmndf=100.))
        par['pgfmth'] = 'geopotential'
    vmix = dict(use_kpp=True, twedon=twedon_field(jm.grid.shape))
    return with_vertical_physics(jm, tm, vmix, kpp_forcing(jm), **par)


@pytest.mark.parametrize('coord', ['ale', 'isopyc'])
def test_kpp_tidal_step_matches_blom_tpu(tmp_path_factory, coord):
    """Every phase of two steps (both parities) with KPP, the tidal field
    and (ALE) the geopotential PGF, from blom_tpu's state before it."""
    jm, tm = _step_models(coord, tmp_path_factory)
    tstep.check_supported(tm.grid, tm.par)
    phases = (FULL_PHASES if coord == 'ale' else ISOPYC_PHASES)
    rec, _ = VRef(jm, coord).run(2, phases)
    assert not phase_errors(rec, tm, coord)
    # the KPP boundary layer and the nonlocal term were active
    vf = next(r[-1] for r in rec if r[1] == 'difest_vertical')
    assert float(np.asarray(vf.t_ns_nonloc)[1:].max()) > 0.


# ------------------------------------------------------------- tripolar

TRIPOLAR_SIZE = dict(itdm=16, jtdm=12, kdm=6)
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')


@pytest.fixture(scope='module')
def tripolar_advanced(tmp_path_factory):
    """Both tripolar models with KPP, the tidal field and the forcing of
    kpp_forcing, from the state and diffusion fields the port reaches in
    four steps (the fold rows carry flow)."""
    jm = shared_build(tmp_path_factory, jst.build_tripolar, **TRIPOLAR_SIZE)
    tm = tst.build_tripolar(device='cpu', **TRIPOLAR_SIZE)
    jm, tm = with_vertical_physics(
        jm, tm, dict(use_kpp=True, twedon=twedon_field(jm.grid.shape)),
        kpp_forcing(jm))
    s, clock = tst.run(tm, 4)
    tm = dataclasses.replace(tm, state=s)
    jm = dataclasses.replace(
        jm, state=dataclasses.replace(
            jm.state, **{k: jnp.asarray(v)
                         for k, v in _np_fields(s).items()}),
        dfl=dataclasses.replace(
            jm.dfl, **{k: jnp.asarray(v)
                       for k, v in _np_fields(tm.dfl).items()}))
    assert float(s.v[0][:, -1].abs().max()) > 0.
    return jm, tm, clock.delt1


@pytest.mark.parametrize('n', [0, 1])
def test_tripolar_kpp_matches_blom_tpu(tripolar_advanced, n):
    """difest_vertical_kpp on the advanced tripolar state: the fold-tagged
    j+1 reads of v and tauy."""
    jm, tm, _ = tripolar_advanced
    ref = jvm.difest_vertical_kpp(jm.grid, jm.e, jm.state, jm.forcing,
                                  jm.swabs, jm.par.vmix, n)
    out = tvm.difest_vertical_kpp(tm.grid, tm.e, tm.state, tm.forcing,
                                  tm.swabs, tm.par.vmix, n)
    _assert_rel(ref, out)


@pytest.mark.parametrize('case', ['strong_wind', 'cooling'])
def test_tripolar_obl_matches_blom_tpu(tripolar_advanced, case):
    """bulk_richardson_obl and difest_vertical_kpp on a random tripolar
    state (_kpp_state): velocities large enough at the fold that the OBL
    depth of its top row depends on the tagged j+1 read of v."""
    jm, tm, _ = tripolar_advanced
    s = _kpp_state(jm, seed=8)
    f = _forcing(jm, case)
    ustar, bfsfc0 = _ustar_bfsfc(jm, s, f, n=1)
    ref = jvm.bulk_richardson_obl(jm.grid, jm.e, s, 1, ustar, bfsfc0)
    out = tvm.bulk_richardson_obl(tm.grid, tm.e, _port_state(s), 1,
                                  _t(ustar), _t(bfsfc0))
    for o, r in zip(out, ref):
        _close(o, r)
    ref = jvm.difest_vertical_kpp(jm.grid, jm.e, s, f, jm.swabs,
                                  jm.par.vmix, 1)
    out = tvm.difest_vertical_kpp(
        tm.grid, tm.e, _port_state(s),
        convert.forcing_from_numpy(_np_fields(f)), tm.swabs, tm.par.vmix, 1)
    _assert_rel(ref, out)


@pytest.mark.parametrize('parity', [(0, 1), (1, 0)])
def test_tripolar_kpp_step_matches_blom_tpu(tripolar_advanced, parity):
    """One step of each parity: blom_tpu's blom_step compiled, the port's;
    every field within test_torch_tripolar.py's whole-step tolerances."""
    jm, tm, d1 = tripolar_advanced
    m, n = parity
    step = jax.jit(lambda s, dfl, d1: jstep.blom_step(
        jm.grid, jm.e, jm.par, jm.coeffs_i, jm.coeffs_j, s, jm.forcing,
        dfl, m, n, d1, jm.swabs))
    js, _ = step(jm.state, jm.dfl, d1)
    ts, _ = tstep.blom_step(tm.grid, tm.e, tm.par, tm.coeffs_i,
                            tm.coeffs_j, tm.state.clone(), tm.forcing,
                            dataclasses.replace(tm.dfl), m, n, d1,
                            tm.swabs)
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items()
           if v > (1e-6 if k in PROGNOSTIC else 1e-5)}
    assert not bad, bad
