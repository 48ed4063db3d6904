"""The port's isopycnic coordinate (fuk95 with isopyc_bulkml) against
blom_tpu's, on CPU in f64.

Each module of the slice, from the same inputs made from a seed with
numpy, within rtol = atol = 1e-12 (relative to the largest value of
each output field, as tests/test_torch_slice.py measures) unless stated:

- `ops.reduce.ksum` exactly; `eos.sofsig`, `eos.p_p_alpha` and
  `hor3map.remap_means`, the last on columns with empty source and
  destination layers;
- `configs.fuk95.initial_profiles_isopyc` exactly, and the built model:
  grid and CPPM coefficients exactly, the initial state within
  test_torch_slice.py's build tolerance, the same parameters;
- `tmsmt1`/`tmsmt2` with `vcoord_isopyc`; momtum's mixed-layer wind
  stress under a random wind (its depth-mean tendency within
  test_torch_slice.py's 1e-9); `eddtra_isopyc` with weak and strong
  diffusivities, the depletion limiter firing;
- `convec` on test_convec_oracle.py's random unstable state, `diapfl` on
  test_diapfl_oracle.py's random columns, each also with two tracers;
- `mxlayr` unforced and under wind, cooling, warming and shortwave, as
  tests/test_mxlayr.py forces it, with a tracer and the mtke budget
  (within 1e-9 where it entrains: see MXLAYR_TOL);
- the whole step phase by phase for three steps (both parities), with
  egc 0 and with bench.py's egc .85, each phase from blom_tpu's state
  before it (barotp within 1e-8, test_torch_slice.py's tolerance); and
  `standalone.run` for the three steps (the odd tail included) against
  blom_tpu's phases chained: the prognostic fields within 1e-6 and every
  field within 1e-4 (measured: 4e-7 for v, 4e-6 for uflx, the
  barotropic solve's 1e-8 grown over three steps), with the port's own
  invariants.

blom_tpu runs eagerly, as test_torch_slice.py runs it, except convec op
by op and diapfl compiled (see `_RefPhases`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.configs import fuk95 as jcfg
from blom_tpu.core import eos as jeos
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import advect as ja
from blom_tpu.dynamics import barotp as jb
from blom_tpu.dynamics import cmnfld as jcf
from blom_tpu.dynamics import convec as jcv
from blom_tpu.dynamics import diapfl as jdp
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import diffus as jdi
from blom_tpu.dynamics import eddtra as jed
from blom_tpu.dynamics import momtum as jmo
from blom_tpu.dynamics import mxlayr as jmx
from blom_tpu.dynamics import pbcor as jp
from blom_tpu.dynamics import pgforc as jg
from blom_tpu.dynamics import step as jstep
from blom_tpu.dynamics import tmsmt as jt
from blom_tpu.ops import hor3map as jh3
from blom_tpu.ops import reduce as jre
from blom_tpu.phys import vmix as jvm
from blom_tpu_torch import convert
from blom_tpu_torch.configs import fuk95 as tcfg
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import advect as ta
from blom_tpu_torch.dynamics import barotp as tb
from blom_tpu_torch.dynamics import cmnfld as tcf
from blom_tpu_torch.dynamics import convec as tcv
from blom_tpu_torch.dynamics import diapfl as tdp
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import diffus as tdi
from blom_tpu_torch.dynamics import eddtra as ted
from blom_tpu_torch.dynamics import momtum as tmo
from blom_tpu_torch.dynamics import mxlayr as tmx
from blom_tpu_torch.dynamics import pbcor as tp
from blom_tpu_torch.dynamics import pgforc as tg
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.dynamics import tmsmt as tt
from blom_tpu_torch.ops import hor3map as th3
from blom_tpu_torch.ops import reduce as tre
from blom_tpu_torch.phys import vmix as tvm
from tests.test_convec_oracle import _random_state as convec_state
from tests.test_diapfl_oracle import _random_columns as diapfl_columns
from tests.torch_shared import shared_build

SIZE = dict(itdm=24, jtdm=8, kdm=10)
TOL = 1e-12
ISOPYC = 'isopyc_bulkml'


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _rel_errors(ref, port):
    """{field: max|ref - port| / max|ref|} of a dataclass or NamedTuple,
    over the non-empty fields."""
    fields = (ref._asdict() if hasattr(ref, '_asdict')
              else _np_fields(ref))
    out = {}
    for name, a in fields.items():
        a = np.asarray(a)
        if a.size:
            b = getattr(port, name).numpy()
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


def _assert_close(ref, port, tol=TOL):
    bad = {k: v for k, v in _rel_errors(ref, port).items() if v > tol}
    assert not bad, bad


def _port_state(s):
    return convert.state_from_numpy(_np_fields(s))


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """Both packages' isopycnic build_fuk95."""
    return (shared_build(tmp_path_factory, jst.build_fuk95, vcoord=ISOPYC,
                         **SIZE),
            tst.build_fuk95(vcoord=ISOPYC, device='cpu', **SIZE))


# ------------------------------------------------------------ the helpers

@pytest.mark.parametrize('axis', [0, 1, -1])
def test_ksum_matches_blom_tpu(axis):
    """Exact: both add the slices in ascending index order."""
    a = np.random.default_rng(0).normal(0., 1e3, (7, 5, 6))
    np.testing.assert_array_equal(tre.ksum(_t(a), axis).numpy(),
                                  np.asarray(jre.ksum(jnp.asarray(a), axis)))


def test_eos_sofsig_p_p_alpha_match_blom_tpu():
    rng = np.random.default_rng(1)
    e_j = jeos.init_eos(pref=0., expcnf='fuk95')
    e_t = teos.init_eos(pref=0., expcnf='fuk95')
    th = rng.uniform(-1., 25., 500)
    sg = rng.uniform(22., 28., 500)
    s = rng.uniform(30., 37., 500)
    p1 = rng.uniform(0., 2e6, 500)
    p2 = p1 + rng.uniform(0., 5e5, 500)
    pairs = [(teos.sofsig(e_t, _t(sg), _t(th)),
              jeos.sofsig(e_j, jnp.asarray(sg), jnp.asarray(th)))]
    for a, b in ((p1, p2), (p2, p1)):
        pairs.append((teos.p_p_alpha(_t(a), _t(b), _t(th), _t(s)),
                      jeos.p_p_alpha(*map(jnp.asarray, (a, b, th, s)))))
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=TOL, atol=TOL)


def test_remap_means_matches_blom_tpu():
    """A parabola per source layer, empty source layers inside and at the
    bottom, destination grids with empty layers and edges beyond the
    source column."""
    rng = np.random.default_rng(2)
    kk, H = 9, (4, 6)
    dx = rng.uniform(1e3, 5e4, (kk,) + H)
    dx[rng.uniform(size=dx.shape) < .25] = 0.
    dx[-2:, 0] = 0.
    p = np.concatenate([np.zeros((1,) + H), np.cumsum(dx, 0)])
    c0, c1, c2 = (rng.normal(0., 1., (kk,) + H) for _ in range(3))
    dd = rng.uniform(1e3, 6e4, (kk,) + H)
    dd[rng.uniform(size=dd.shape) < .3] = 0.
    p_dst = np.concatenate([np.zeros((1,) + H), np.cumsum(dd, 0)])
    ref = jh3.remap_means(jh3.Recon(p=jnp.asarray(p), c0=jnp.asarray(c0),
                                    c1=jnp.asarray(c1), c2=jnp.asarray(c2)),
                          jnp.asarray(p_dst))
    out = th3.remap_means(th3.Recon(p=_t(p), c0=_t(c0), c1=_t(c1),
                                    c2=_t(c2)), _t(p_dst))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(ref)).max())


# ---------------------------------------------------- config and the build

@pytest.mark.parametrize('size', [(24, 8, 10), (156, 32, 12)])
def test_initial_profiles_isopyc_match_blom_tpu(size):
    """Exact: the same numpy expressions."""
    assert tcfg.mltmin == jcfg.mltmin
    for a, b in zip(tcfg.initial_profiles_isopyc(*size),
                    jcfg.initial_profiles_isopyc(*size)):
        np.testing.assert_array_equal(a, b)


def test_build_isopyc_matches_blom_tpu(models):
    """The same grid, coefficients, parameters and (to rounding) initial
    state, in which many interior layers are massless."""
    jm, tm = models
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm.grid, name).numpy(),
                                      np.asarray(getattr(jm.grid, name)),
                                      err_msg=name)
    for co_j, co_t in ((jm.coeffs_i, tm.coeffs_i),
                       (jm.coeffs_j, tm.coeffs_j)):
        for name in co_t._fields:
            np.testing.assert_array_equal(getattr(co_t, name).numpy(),
                                          np.asarray(getattr(co_j, name)),
                                          err_msg=name)
    for name, a in _np_fields(jm.state).items():
        b = getattr(tm.state, name).numpy()
        assert b.shape == a.shape, name
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-10 * np.abs(a).max(initial=0.) + 1e-11,
            err_msg=name)
    assert tm.par.vcoord_isopyc is jm.par.vcoord_isopyc is True
    assert tm.par.ale is jm.par.ale is None
    for name in ('momtum', 'barotp', 'vmix', 'difest', 'mxlayr'):
        assert getattr(tm.par, name)._asdict() == \
            getattr(jm.par, name)._asdict(), name
    tstep.check_supported(tm.grid, tm.par)
    wet = tm.grid.ip > 0
    assert int((tm.state.dp[1][2:] == 0.)[:, wet].sum()) > 0


# --------------------------------------------------------------- modules

def _perturbed(jm, seed=3):
    """blom_tpu's isopycnic initial state with random velocities and
    both time levels' interior layers thickened at random (the mixed
    layer and massless layers kept)."""
    rng = np.random.default_rng(seed)
    s = jm.state
    g = jm.grid
    ip, iu, iv = (np.asarray(a) for a in (g.ip, g.iu, g.iv))
    dp = np.asarray(s.dp)
    dp = dp * (1. + .2 * rng.random(dp.shape))
    p = np.concatenate([np.zeros((2, 1) + dp.shape[2:]),
                        np.cumsum(dp, 1)], 1)
    shape = np.asarray(s.u).shape
    return dataclasses.replace(
        s, dp=jnp.asarray(dp * ip),
        pb=jnp.asarray(p[:, -1] * ip),
        u=jnp.asarray(rng.normal(0., .2, shape) * iu),
        v=jnp.asarray(rng.normal(0., .2, shape) * iv))


@pytest.mark.parametrize('m,n', [(0, 1), (1, 0)])
def test_tmsmt_isopyc_matches_blom_tpu(models, m, n):
    """tmsmt1 also saves dpu/dpv; tmsmt2 re-derives the mid level's
    dpu/dpv from the blended interfaces."""
    jm, tm = models
    s = _perturbed(jm)
    j1 = jt.tmsmt1(jm.grid, s, n, True)
    _assert_close(j1, tt.tmsmt1(tm.grid, _port_state(s), n, True))
    j2 = jt.tmsmt2(jm.grid, j1, m, n, True)
    _assert_close(j2, tt.tmsmt2(tm.grid, _port_state(j1), m, n, True))
    assert not np.array_equal(np.asarray(j2.dpu[m]), np.asarray(s.dpu[m]))


def test_momtum_isopyc_stress_matches_blom_tpu(models):
    """A random wind on the isopycnic state: the stress acts on the top
    layer over the mixed layer's upper part, not through mu_nonloc."""
    jm, tm = models
    rng = np.random.default_rng(5)
    g = jm.grid
    H = g.shape
    s = _perturbed(jm)
    forcing = dataclasses.replace(
        jm.forcing, taux=jnp.asarray(rng.normal(0., .2, H)) * g.iu,
        tauy=jnp.asarray(rng.normal(0., .2, H)) * g.iv)
    tforcing = convert.forcing_from_numpy(_np_fields(forcing))
    d1, par = 360., jm.par
    outs = {}
    for isopyc in (True, False):
        js, ju, jv = jmo.momtum(g, s, forcing, par.momtum, jm.dfl.difwgt, 0,
                                1, d1, par.dlt, isopyc)
        ts, tu, tv = tmo.momtum(tm.grid, _port_state(s), tforcing,
                                tm.par.momtum, tm.dfl.difwgt, 0, 1, d1,
                                tm.par.dlt, isopyc)
        _assert_close(js, ts)
        for port, ref in ((tu, ju), (tv, jv)):
            ref = np.asarray(ref)
            assert (np.abs(port.numpy() - ref).max()
                    <= 1e-9 * np.abs(ref).max() + 1e-16 / d1)
        outs[isopyc] = np.asarray(js.u)
    assert not np.array_equal(outs[True], outs[False])


@pytest.mark.parametrize('kappa_scale', [1e3, 5e6])
def test_eddtra_isopyc_matches_blom_tpu(models, kappa_scale):
    """Weak and strong diffusivities; the depletion limiter fires in
    both, at least at the massless layers."""
    jm, tm = models
    g = jm.grid
    rng = np.random.default_rng(6)
    s = _perturbed(jm)
    difint = rng.uniform(.2, 1., (g.kk,) + g.shape) * kappa_scale \
        * np.asarray(g.ip)
    jdfl = dataclasses.replace(jm.dfl, difint=jnp.asarray(difint))
    ref = jed.eddtra_isopyc(g, s, jdfl, 0, 1, 360.)
    ted.host_syncs = 0
    out = ted.eddtra_isopyc(tm.grid, _port_state(s),
                            convert.diffusion_fields_from_numpy(
                                _np_fields(jdfl)), 0, 1, 360.)
    _assert_close(ref, out)
    assert np.abs(np.asarray(ref.umfltd[0])).max() > 0.
    assert ted.host_syncs > 1


def _with_tracers(s, ntr, seed=7):
    if not ntr:
        return s
    rng = np.random.default_rng(seed)
    shape = (2, ntr) + np.asarray(s.dp).shape[1:]
    return dataclasses.replace(
        s, trc=jnp.asarray(rng.uniform(0., 2., shape)),
        trcold=jnp.asarray(rng.uniform(0., 2., shape[1:])))


@pytest.mark.parametrize('ntr', [0, 2])
def test_convec_matches_blom_tpu(tmp_path_factory, ntr):
    """test_convec_oracle.py's random state: unstable columns, kfplo
    above and below the collapsed kfpl, random velocities."""
    jm = shared_build(tmp_path_factory, jst.build_fuk95, itdm=18, jtdm=8,
                      kdm=12)
    tm = tst.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, n = convec_state(jm)
    rng = np.random.default_rng(8)
    u = rng.normal(0., .2, np.asarray(s.u).shape) * np.asarray(jm.grid.iu)
    s = _with_tracers(dataclasses.replace(s, u=jnp.asarray(u)), ntr)
    ref = _ref_convec(jm.grid, jm.e, s, 0, n)
    out = tcv.convec(tm.grid, tm.e, _port_state(s), 0, n)
    _assert_close(ref, out)
    assert not np.array_equal(np.asarray(ref.kfpla), np.asarray(s.kfpla))


@pytest.mark.parametrize('ntr', [0, 2])
def test_diapfl_matches_blom_tpu(tmp_path_factory, ntr):
    """test_diapfl_oracle.py's random columns with random velocities."""
    jm = shared_build(tmp_path_factory, jst.build_fuk95, itdm=18, jtdm=8,
                      kdm=12)
    tm = tst.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, nu, n = diapfl_columns(jm)
    g = jm.grid
    rng = np.random.default_rng(9)
    shape = np.asarray(s.u).shape
    s = _with_tracers(dataclasses.replace(
        s, u=jnp.asarray(rng.normal(0., .2, shape) * np.asarray(g.iu)),
        v=jnp.asarray(rng.normal(0., .2, shape) * np.asarray(g.iv))), ntr)
    d1 = 2. * jm.par.baclin
    ref = jax.jit(lambda s, nu: jdp.diapfl(g, jm.e, s, nu, 0, n, d1))(s, nu)
    out = tdp.diapfl(tm.grid, tm.e, _port_state(s), _t(nu), 0, n, d1)
    _assert_close(ref, out)
    assert not np.array_equal(np.asarray(ref.u), np.asarray(s.u))


# tests/test_mxlayr.py's forcings: taux [N m-2], surflx and sswflx [W m-2]
# (surflx > 0 cools the ocean)
MXLAYR_FORCINGS = {'none': {}, 'wind': dict(taux=1.),
                   'cooling': dict(surflx=400.),
                   'warming': dict(surflx=-400.),
                   'shortwave': dict(sswflx=200.)}
# Where the mixed layer entrains (wind, cooling), the Newton solve for
# its base amplifies rounding: blom_tpu against itself, run op by op and
# run with its scans compiled, differs by 1e-10 relative in dp there
# (measured), and the port by 5e-11.
MXLAYR_TOL = dict(wind=1e-9, cooling=1e-9)


@pytest.mark.parametrize('case', sorted(MXLAYR_FORCINGS))
def test_mxlayr_matches_blom_tpu(models, case):
    """Two applications at n = 1 with delt1 = 2 baclin, as
    tests/test_mxlayr.py runs it, on the isopycnic state with random
    velocities and a tracer; the mtke budget too."""
    jm, tm = models
    g = jm.grid
    H = g.shape
    fields = dict(taux=0., surflx=0., sswflx=0.)
    fields.update(MXLAYR_FORCINGS[case])
    masks = dict(taux=g.iu, surflx=g.ip, sswflx=g.ip)
    forcing = dataclasses.replace(jm.forcing, **{
        k: jnp.full(H, v) * masks[k] for k, v in fields.items()})
    tforcing = convert.forcing_from_numpy(_np_fields(forcing))
    d1 = 2. * jm.par.baclin

    js = _with_tracers(_perturbed(jm), 1)
    ts = _port_state(js)
    jdfl, tdfl = jm.dfl, tm.dfl
    for _ in range(2):
        js, jdfl = jmx.mxlayr(g, jm.e, js, forcing, jm.par.mxlayr, 0, 1, d1,
                              swabs=jm.swabs, dfl=jdfl)
        ts, tdfl = tmx.mxlayr(tm.grid, tm.e, ts, tforcing, tm.par.mxlayr, 0,
                              1, d1, swabs=tm.swabs, dfl=tdfl)
        tol = MXLAYR_TOL.get(case, TOL)
        _assert_close(js, ts, tol)
        np.testing.assert_allclose(
            tdfl.mtke.numpy(), np.asarray(jdfl.mtke), rtol=0,
            atol=tol * np.abs(np.asarray(jdfl.mtke)).max())


# --------------------------------------------------------------- the step

PHASES = ('tmsmt1', 'cmnfld', 'difest_lateral', 'eddtra', 'advect',
          'pbcor1', 'diffus', 'pgforc', 'momtum', 'convec',
          'difest_vertical', 'diapfl', 'mxlayr', 'barotp', 'pbcor2',
          'tmsmt2')
LATERAL = ('cmnfld', 'difest_lateral', 'eddtra', 'diffus')
EXTRA = {'difest_lateral': 'cf', 'diapfl': 'kdiff', 'barotp': 'uv'}


def _with_egc(models, egc):
    out = []
    for mo, dparams in zip(models, (jdf.DifestParams, tdf.DifestParams)):
        mo = dataclasses.replace(mo)
        if egc:
            mo.par = mo.par._replace(difest=dparams(egc=egc, egmndf=100.))
        out.append(mo)
    return out


def _ref_convec(g, e, s, m, n):
    """blom_tpu's convec op by op: run eagerly, its velocity remap's
    scan body compiles, and XLA's rounding there, divided by thin
    destination layers, moves u and v by ~1e-9 relative (measured);
    op by op it agrees with the port to rounding."""
    with jax.disable_jit():
        return jcv.convec(g, e, s, m, n)


class _RefPhases:
    """blom_tpu's isopycnic phases, run eagerly as test_torch_slice.py
    runs them, convec op by op (`_ref_convec`) and diapfl compiled once
    per time-level parity (run eagerly, its ~60 k-scans compile one by
    one); `run` chains them as blom_tpu's blom_step does and records
    each phase's inputs and output."""

    def __init__(self, jm):
        self.jm = jm
        self.fns = {}

    def fn(self, name, m, n):
        key = (name, m, n)
        if key not in self.fns:
            fn = self._phase(name, m, n)
            self.fns[key] = jax.jit(fn) if name == 'diapfl' else fn
        return self.fns[key]

    def _phase(self, name, m, n):
        jm = self.jm
        g, e, par, f = jm.grid, jm.e, jm.par, jm.forcing
        return {
            'tmsmt1': lambda s, dfl, x, d1: jt.tmsmt1(g, s, n, True),
            'cmnfld': lambda s, dfl, x, d1: jcf.cmnfld(g, e, s, n),
            'difest_lateral': lambda s, dfl, cf, d1: jdf.difest_lateral(
                g, s, cf, par.difest, dfl, m, n),
            'eddtra': lambda s, dfl, x, d1: jed.eddtra_isopyc(
                g, s, dfl, m, n, d1),
            'advect': lambda s, dfl, x, d1: ja.advect(
                g, s, dfl, jm.coeffs_i, jm.coeffs_j, m, n, d1, par.dlt),
            'pbcor1': lambda s, dfl, x, d1: jp.pbcor1(g, s, m, n, par.dlt),
            'diffus': lambda s, dfl, x, d1: jdi.diffus(g, e, s, dfl, m, n,
                                                       d1),
            'pgforc': lambda s, dfl, x, d1: jg.pgforc(g, e, s, m, n),
            'momtum': lambda s, dfl, x, d1: jmo.momtum(
                g, s, f, par.momtum, dfl.difwgt, m, n, d1, par.dlt, True),
            'convec': lambda s, dfl, x, d1: _ref_convec(g, e, s, m, n),
            'difest_vertical': lambda s, dfl, x, d1: jvm.difest_vertical(
                g, e, s, f, jm.swabs, par.vmix, n),
            'diapfl': lambda s, dfl, kdiff, d1: jdp.diapfl(
                g, e, s, kdiff, m, n, d1),
            'mxlayr': lambda s, dfl, x, d1: jmx.mxlayr(
                g, e, s, f, par.mxlayr, m, n, d1, swabs=jm.swabs, dfl=dfl),
            'barotp': lambda s, dfl, uv, d1: jb.barotp(
                g, s, uv[0], uv[1], m, n, par.lstep, par.dlt, par.barotp),
            'pbcor2': lambda s, dfl, x, d1: jp.pbcor2(g, e, s, m, n,
                                                      par.dlt),
            'tmsmt2': lambda s, dfl, x, d1: jt.tmsmt2(g, s, m, n, True),
        }[name]

    def run(self, nsteps):
        """[(step, phase, m, n, delt1, (state, dfl, extra) before,
        output)] of `nsteps` steps, and the final state."""
        jm = self.jm
        lateral = jm.par.difest.egc > 0.
        s, dfl, clock = jm.state, jm.dfl, jm.clock
        rec = []
        for step in range(nsteps):
            m, n = (0, 1) if step % 2 == 0 else (1, 0)
            d1 = clock.delt1
            clock = clock.step()
            s = jstep.init_fluxes(s, m)
            # cmnfld's fields, the vertical diffusivity, momtum's
            # depth-mean tendencies: the extra input of a later phase
            ctx = {}
            for name in PHASES:
                if name in LATERAL and not lateral:
                    continue
                extra = ctx.get(EXTRA.get(name))
                out = self.fn(name, m, n)(s, dfl, extra, d1)
                rec.append((step, name, m, n, d1, (s, dfl, extra), out))
                if name == 'cmnfld':
                    ctx['cf'] = out
                elif name == 'difest_vertical':
                    ctx['kdiff'] = out.Kdiff_t
                    dfl = dataclasses.replace(
                        dfl, difvho=out.Kdiff_t, difvso=out.Kdiff_s,
                        difvmo=out.Kvisc_m, bld=out.mld * jm.grid.ip)
                elif name in ('difest_lateral', 'eddtra'):
                    dfl = out
                elif name in ('diffus', 'mxlayr'):
                    s, dfl = out
                elif name == 'momtum':
                    s, ctx['uv'] = out[0], out[1:]
                else:
                    s = out
        return rec, s


def _port_phase(tm, name, m, n, d1, s, dfl, extra):
    g, e, par = tm.grid, tm.e, tm.par
    if name == 'tmsmt1':
        return tt.tmsmt1(g, s, n, True)
    if name == 'cmnfld':
        return tcf.cmnfld(g, e, s, n)
    if name == 'difest_lateral':
        cf = convert.cmn_fields_from_numpy(
            {k: np.asarray(v) for k, v in extra._asdict().items()})
        return tdf.difest_lateral(g, s, cf, par.difest, dfl, m, n)
    if name == 'eddtra':
        return ted.eddtra_isopyc(g, s, dfl, m, n, d1)
    if name == 'advect':
        return ta.advect(g, s, dfl, tm.coeffs_i, tm.coeffs_j, m, n, d1,
                         par.dlt)
    if name == 'pbcor1':
        return tp.pbcor1(g, s, m, n, par.dlt)
    if name == 'diffus':
        return tdi.diffus(g, e, s, dfl, m, n, d1)
    if name == 'pgforc':
        return tg.pgforc(g, e, s, m, n)
    if name == 'momtum':
        return tmo.momtum(g, s, tm.forcing, par.momtum, dfl.difwgt, m, n,
                          d1, par.dlt, True)[0]
    if name == 'convec':
        return tcv.convec(g, e, s, m, n)
    if name == 'difest_vertical':
        return tvm.difest_vertical(g, e, s, tm.forcing, tm.swabs, par.vmix,
                                   n)
    if name == 'diapfl':
        return tdp.diapfl(g, e, s, _t(extra), m, n, d1)
    if name == 'mxlayr':
        return tmx.mxlayr(g, e, s, tm.forcing, par.mxlayr, m, n, d1,
                          swabs=tm.swabs, dfl=dfl)
    if name == 'barotp':
        return tb.barotp(g, s, _t(extra[0]), _t(extra[1]), m, n, par.lstep,
                         par.dlt, par.barotp)
    if name == 'pbcor2':
        return tp.pbcor2(g, e, s, m, n, par.dlt)
    return tt.tmsmt2(g, s, m, n, True)


RUN_TOL = 1e-4
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')


@pytest.mark.parametrize('egc', [0., .85])
def test_step_matches_blom_tpu(models, egc):
    """Every phase of the first three steps (both parities) from
    blom_tpu's state before it; egc .85 adds cmnfld, the lateral
    diffusivities, eddtra_isopyc and diffus.  Then standalone.run for the
    three steps (a pair and the odd tail) against blom_tpu's phases
    chained, and the port's invariants: finite fields, mass to rounding,
    the mixed layer near its 5 m minimum (no forcing), kfpla in
    [2, kk]."""
    jm, tm = _with_egc(models, egc)
    rec, js = _RefPhases(jm).run(3)
    assert len({r[1] for r in rec}) == (16 if egc else 12)
    bad = {}
    for step, name, m, n, d1, (s, dfl, extra), ref in rec:
        out = _port_phase(tm, name, m, n, d1, _port_state(s),
                          convert.diffusion_fields_from_numpy(
                              _np_fields(dfl)), extra)
        pairs = (list(zip(ref, out)) if name in ('diffus', 'mxlayr')
                 else [(ref[0] if name == 'momtum' else ref, out)])
        tol = 1e-8 if name == 'barotp' else TOL
        for r, o in pairs:
            errs = {k: v for k, v in _rel_errors(r, o).items() if v > tol}
            if errs:
                bad[(step, name)] = errs
    assert not bad, bad

    model = dataclasses.replace(tm, state=_port_state(jm.state))
    ts, clock = tst.run(model, 3)
    assert clock.nstep == 3
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items()
           if v > (1e-6 if k in PROGNOSTIC else RUN_TOL)}
    assert not bad, bad

    g = tm.grid
    wet = g.ip > 0
    for name in PROGNOSTIC:
        assert torch.isfinite(getattr(ts, name)).all(), name
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[0].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
    ml = ((ts.dp[0][0] + ts.dp[0][1]) / tmx.onem)[wet]
    assert 2. < float(ml.min()) and float(ml.max()) < 12.
    assert int(ts.kfpla[0][wet].min()) >= 2
    assert int(ts.kfpla[0][wet].max()) <= g.kk


@pytest.mark.parametrize('change', [dict(srxday=30.)])
def test_isopyc_refusals_name_the_path(models, change):
    """Surface restoring, which the isopycnic path once refused: on the
    isopycnic initial state, the salt restoring flux of thermf_relax
    towards a seeded climatology (test_torch_thermf.py's, the srxlim
    clamp biting) within TOL of blom_tpu's, then mxlayr reading it
    within MXLAYR_TOL; check_supported takes the option."""
    from blom_tpu.phys import thermf as jthermf
    from blom_tpu_torch.phys import thermf as tthermf
    from tests.test_torch_thermf import with_restoring
    jm, tm = with_restoring(*models, **change)
    tstep.check_supported(tm.grid, tm.par)
    m, n, d1 = 0, 1, jm.clock.delt1
    jf = jthermf.thermf_relax(jm.grid, jm.state, jm.forcing, jm.par.thermf,
                              n, jm.forcing.sstclm, jm.forcing.sssclm)
    ref = jmx.mxlayr(jm.grid, jm.e, jm.state, jf, jm.par.mxlayr, m, n, d1,
                     swabs=jm.swabs, dfl=jm.dfl)
    ts = _port_state(jm.state)
    tf = tthermf.thermf_relax(tm.grid, ts, tm.forcing, tm.par.thermf, n,
                              tm.forcing.sstclm, tm.forcing.sssclm)
    out = tmx.mxlayr(tm.grid, tm.e, ts, tf, tm.par.mxlayr, m, n, d1,
                     swabs=tm.swabs, dfl=tm.dfl)
    assert float(tf.salrlx.abs().max()) > 0. and not tf.surrlx.any()
    _assert_close(jf, tf)
    for r, o in zip(ref, out):
        _assert_close(r, o, MXLAYR_TOL['cooling'])


def test_isopyc_remap_matches_blom_tpu(models):
    """advmth='remap', which the isopycnic path once refused: advect on
    the isopycnic initial state (many massless layers) with seeded
    velocities up to 0.5 m/s, both parities, within TOL of blom_tpu's
    (run eagerly, as the step's phases are here).  30 % of the layer
    cells are massless; blom_tpu gives no NaN on them (the remap carries
    every layer with DPEPS added, so its update never divides by zero),
    and neither does the port."""
    jm, tm = models
    tstep.check_supported(tm.grid, tm.par._replace(advmth='remap'))
    rng = np.random.default_rng(17)
    s = jm.state
    s = dataclasses.replace(
        s, u=jnp.asarray(rng.uniform(-.5, .5, s.u.shape)) * jm.grid.iu,
        v=jnp.asarray(rng.uniform(-.5, .5, s.v.shape)) * jm.grid.iv)
    massless = np.asarray(s.dp) < 1e-3 * tmx.onem
    assert .2 < massless.mean() < .8
    for m, n in ((0, 1), (1, 0)):
        ref = ja.advect(jm.grid, s, jm.dfl, jm.coeffs_i, jm.coeffs_j, m, n,
                        jm.clock.delt1, jm.par.dlt, 'remap')
        out = ta.advect(tm.grid, _port_state(s), tm.dfl, tm.coeffs_i,
                        tm.coeffs_j, m, n, tm.clock.delt1, tm.par.dlt,
                        'remap')
        for name, a in _np_fields(ref).items():
            b = getattr(out, name).numpy()
            np.testing.assert_allclose(
                b, a, rtol=0, atol=TOL * np.abs(a).max(initial=0.),
                err_msg=f'{name} (m={m})')
        assert np.abs(np.asarray(ref.uflx[m])).max() > 0.


@pytest.mark.parametrize('option', ['itrtke', 'itrgls', 'kpp', 'tidal'])
def test_isopyc_vertical_physics_options_match_blom_tpu(models, option):
    """The options the isopycnic path once refused: the TKE closure
    (itrtke 0, psi diagnostic from the last slot), a GLS slot alone
    (itrgls 0 without itrtke: no closure in either package), KPP and the
    tidal term (a float twedon).  One step of each, phase by phase from
    blom_tpu's state before each phase (test_torch_kpp.py's VRef), within
    TOL (barotp 1e-8)."""
    from tests.test_torch_kpp import (ISOPYC_PHASES, VRef, phase_errors,
                                      with_vertical_physics)
    from tests.test_torch_tke import with_tke_slots
    jm, tm = models
    if option in ('itrtke', 'itrgls'):
        jm, tm = with_tke_slots(jm, tm, *((0, -1) if option == 'itrtke'
                                          else (-1, 0)))
    else:
        vmix = dict(twedon=1.) if option == 'tidal' else dict(use_kpp=True)
        jm, tm = with_vertical_physics(jm, tm, vmix, {})
    tstep.check_supported(tm.grid, tm.par)
    rec, _ = VRef(jm, 'isopyc').run(1, ISOPYC_PHASES)
    assert any(r[1] == 'tke' for r in rec) == (option == 'itrtke')
    assert not phase_errors(rec, tm, 'isopyc', nsteps=1, forced=False)
