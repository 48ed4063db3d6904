"""The port's tracer step (ideal age and the BGC base chain) against
blom_tpu's, on CPU in f64.

- `idlage_init` and `idlage_step` exactly;
- fuk95 with `use_idlage=True, use_bgc=True` (20 tracers: the age, then
  the 19 BGC tracers), phase by phase from blom_tpu's state before each
  phase, with `idlage` and `hamocc` after the vertical physics: on the
  ALE path at 24x8x8 (the phases of test_torch_slice.py's FULL_PHASES,
  bench.py's physics, two steps: both parities; ale_vdifft compiled, see
  `_Ref`) and on the isopycnic path at 24x8x10 (the phases of
  test_torch_isopyc.py, egc 0, three steps).  Each output within 1e-12
  relative (barotp 1e-8, as test_torch_slice.py says why), every tracer
  measured on its own (max |port - ref| / max |ref| of trc[:, i]);
  blom_tpu's BGC runs op by op (`jax.disable_jit()`).  Then
  `standalone.run` for three steps against blom_tpu's phases chained,
  every field within the tolerance each of those files uses for it and
  the tracers within the one it uses for temperature (1e-5 on the ALE
  path, 1e-6 on the isopycnic path);
- the channel with `build_channel(use_idlage=True)` at 8x16x6, one step
  against blom_tpu's channel with an age slot, run op by op as
  test_torch_case.py runs it (1e-10; measured equal);
- the port's own properties: total phosphorus through six steps of
  `run` within 5e-7 (tests/test_bgc.py:262), and the ideal age's bounds
  of tests/test_tracers.py:14-27."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blom_tpu.bgc import step as jbstep
from blom_tpu.configs import channel as jch
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import ale as jal
from blom_tpu.dynamics import ale_vdiff as jvd
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import eddtra as jed
from blom_tpu.dynamics import momtum as jmo
from blom_tpu.dynamics import step as jstep
from blom_tpu.dynamics import tmsmt as jt
from blom_tpu.tracers import idlage as jidl
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import step as tbstep
from blom_tpu_torch.bgc.params import BgcTracers as T
from blom_tpu_torch.configs import channel as tch
from blom_tpu_torch.core.constants import onem
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.tracers import idlage as tidl
from tests.test_torch_isopyc import _RefPhases
from tests.test_torch_isopyc import _port_phase as isopyc_port_phase
from tests.test_torch_slice import FULL_PHASES, FULL_TOL, _full_port_phase
from tests.torch_shared import shared_build

ALE_SIZE = dict(itdm=24, jtdm=8, kdm=8)
ISOPYC_SIZE = dict(itdm=24, jtdm=8, kdm=10)
TRACERS = dict(use_idlage=True, use_bgc=True)
TOL = 1e-12
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')


def _run_tol(coord, field):
    """The tolerance of `field` after three steps of standalone.run:
    test_torch_slice.py's FULL_TOL on the ALE path, test_torch_isopyc.py's
    1e-6 for the prognostic fields and 1e-4 for the rest on the isopycnic
    path; the tracers at the temperature's."""
    if field.startswith('trc'):
        field = 'temp'
    if coord == 'ale':
        return FULL_TOL.get(field, 1.)
    return 1e-6 if field in PROGNOSTIC else 1e-4
ISOPYC_PHASES = ('tmsmt1', 'advect', 'pbcor1', 'pgforc', 'momtum',
                 'convec', 'difest_vertical', 'diapfl', 'mxlayr')
TAIL = ('barotp', 'pbcor2', 'tmsmt2')
PHASES = {
    'ale': FULL_PHASES[:FULL_PHASES.index('barotp')]
    + ('idlage', 'hamocc') + TAIL,
    'isopyc': ISOPYC_PHASES + ('idlage', 'hamocc') + TAIL}
EXTRA = {'difest_lateral': 'cf', 'eddtra': 'cf', 'diapfl': 'kdiff',
         'ale_vdifft': 'vf', 'ale_vdiffm': 'vf', 'barotp': 'uv'}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


def _port_state(s):
    return convert.state_from_numpy(_np_fields(s))


def _rel_errors(ref, port):
    """{field: max |ref - port| / max |ref|} of a dataclass or NamedTuple;
    the tracer fields tracer by tracer."""
    fields = (ref._asdict() if hasattr(ref, '_asdict')
              else _np_fields(ref))
    out = {}
    for name, a in fields.items():
        a = np.asarray(a)
        if not a.size:
            continue
        b = getattr(port, name).numpy()
        if name in ('trc', 'trcold'):
            ax = 1 if name == 'trc' else 0
            for i in range(a.shape[ax]):
                ai, bi = np.take(a, i, ax), np.take(b, i, ax)
                out[f'{name}[{i}]'] = float(
                    np.abs(ai - bi).max() / max(np.abs(ai).max(), 1e-300))
        else:
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


# ------------------------------------------------------------ ideal age

def test_idlage_matches_blom_tpu(tmp_path_factory):
    m = tst.build_fuk95(use_idlage=True, device='cpu', **ALE_SIZE)
    rng = np.random.default_rng(2)
    d = _np_fields(m.state)
    d['trc'] = rng.uniform(0., 1e-4, d['trc'].shape)
    js = shared_build(tmp_path_factory, jst.build_fuk95, use_idlage=True,
                      **ALE_SIZE).state
    js = dataclasses.replace(js, trc=jax.numpy.asarray(d['trc']))
    for n, d1 in ((0, 180.), (1, 360.)):
        ref = jidl.idlage_step(js, 0, n, d1)
        port = tidl.idlage_step(convert.state_from_numpy(d), 0, n, d1)
        np.testing.assert_array_equal(port.trc.numpy(), np.asarray(ref.trc))
    np.testing.assert_array_equal(
        tidl.idlage_init(convert.state_from_numpy(d), 0).trc.numpy(),
        np.asarray(jidl.idlage_init(js, 0).trc))


# ------------------------------------------------------------- the step

class _Ref:
    """blom_tpu's phases of the tracer step on either coordinate, run as
    test_torch_slice.py (ALE) and test_torch_isopyc.py (isopycnic) run
    them, with idlage and hamocc (op by op); `run` chains them as
    blom_tpu's blom_step does and records each phase's inputs and
    output."""

    def __init__(self, jm, coord):
        self.jm, self.coord = jm, coord
        self.isopyc = _RefPhases(jm)
        self.jit = {}

    def fn(self, name, m, n):
        jm = self.jm
        g, e, par = jm.grid, jm.e, jm.par
        if name == 'idlage':
            return lambda s, dfl, x, d1: jidl.idlage_step(
                s, par.itriag, n, d1, par.nday_in_year)
        if name == 'hamocc':
            def hamocc(s, dfl, x, d1):
                with jax.disable_jit():
                    return jbstep.hamocc_step(g, e, par.bgc, s,
                                              jm.bgc_forcing, par.itrbgc,
                                              n, m, d1)[0]
            return hamocc
        if self.coord == 'isopyc':
            return self.isopyc.fn(name, m, n)
        if name == 'ale':
            return lambda s, dfl, x, d1: jal.ale_regrid_remap(
                g, e, par.ale, s, m, n, d1)
        if name == 'eddtra':
            return lambda s, dfl, cf, d1: jed.eddtra(g, s, cf, dfl, m, n,
                                                     d1)
        if name in ('ale_vdifft', 'ale_vdiffm'):
            if name == 'ale_vdifft':
                # compiled once per parity: run eagerly, its Thomas scan
                # compiles once per tracer and call (measured equal to
                # the eager run within 6e-16)
                key = (name, m, n)
                if key not in self.jit:
                    self.jit[key] = jax.jit(
                        lambda s, vf, d1: jvd.ale_vdifft(
                            g, e, s, jm.forcing, vf, m, n, d1))
                return lambda s, dfl, vf, d1: self.jit[key](s, vf, d1)
            return lambda s, dfl, vf, d1: jvd.ale_vdiffm(g, s, vf, m, n,
                                                         d1)
        # the ALE path's tmsmt without the isopycnic flag; the rest as
        # the isopycnic path runs them
        if name in ('tmsmt1', 'tmsmt2'):
            if name == 'tmsmt1':
                return lambda s, dfl, x, d1: jt.tmsmt1(g, s, n)
            return lambda s, dfl, x, d1: jt.tmsmt2(g, s, m, n)
        if name == 'momtum':
            return lambda s, dfl, x, d1: jmo.momtum(
                g, s, jm.forcing, par.momtum, dfl.difwgt, m, n, d1,
                par.dlt)
        return self.isopyc.fn(name, m, n)

    def run(self, nsteps):
        jm = self.jm
        s, dfl, clock = jm.state, jm.dfl, jm.clock
        rec = []
        for step in range(nsteps):
            m, n = (0, 1) if step % 2 == 0 else (1, 0)
            d1 = clock.delt1
            clock = clock.step()
            s = jstep.init_fluxes(s, m)
            ctx = {}
            for name in PHASES[self.coord]:
                extra = ctx.get(EXTRA.get(name))
                out = self.fn(name, m, n)(s, dfl, extra, d1)
                rec.append((step, name, m, n, d1, (s, dfl, extra), out))
                if name == 'cmnfld':
                    ctx['cf'] = out
                elif name == 'difest_vertical':
                    ctx['kdiff'], ctx['vf'] = out.Kdiff_t, out
                    dfl = dataclasses.replace(
                        dfl, difvho=out.Kdiff_t, difvso=out.Kdiff_s,
                        difvmo=out.Kvisc_m, bld=out.mld * jm.grid.ip)
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


def _port(tm, coord, name, m, n, d1, s, dfl, extra):
    g, e, par = tm.grid, tm.e, tm.par
    if name == 'idlage':
        return tidl.idlage_step(s, par.itriag, n, d1, par.nday_in_year)
    if name == 'hamocc':
        return tbstep.hamocc_step(g, e, par.bgc, s, tm.bgc_forcing,
                                  par.itrbgc, n, m, d1)[0]
    if coord == 'isopyc':
        return isopyc_port_phase(tm, name, m, n, d1, s, dfl, extra)
    return _full_port_phase(tm, name, m, n, d1, s, dfl, extra)


def _models(coord, tmp_path_factory):
    if coord == 'isopyc':
        size = dict(vcoord='isopyc_bulkml', **ISOPYC_SIZE)
    else:
        size = ALE_SIZE
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **TRACERS, **size)
    tm = tst.build_fuk95(device='cpu', **TRACERS, **size)
    if coord == 'ale':
        # bench.py's physics
        jm.par = jm.par._replace(difest=jdf.DifestParams(egc=.85,
                                                         egmndf=100.))
        tm.par = tm.par._replace(difest=tdf.DifestParams(egc=.85,
                                                         egmndf=100.))
    return jm, tm


STEPS = {'ale': 2, 'isopyc': 3}


@pytest.mark.parametrize('coord', ['ale', 'isopyc'])
def test_tracer_step_matches_blom_tpu(tmp_path_factory, coord):
    """Every phase of the first steps from blom_tpu's state before it,
    then three steps of standalone.run against blom_tpu's phases
    chained, then the port's invariants."""
    jm, tm = _models(coord, tmp_path_factory)
    assert tm.state.trc.shape[1] == 20
    np.testing.assert_array_equal(tm.state.trc.numpy(),
                                  np.asarray(jm.state.trc))
    rec, js = _Ref(jm, coord).run(3)
    bad = {}
    for step, name, m, n, d1, (s, dfl, extra), ref in rec:
        if step >= STEPS[coord]:
            continue
        out = _port(tm, coord, name, m, n, d1, _port_state(s),
                    convert.diffusion_fields_from_numpy(_np_fields(dfl)),
                    extra)
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
    bad = {k: v for k, v in errs.items() if v > _run_tol(coord, k)}
    assert not bad, bad
    g = tm.grid
    assert torch.isfinite(ts.trc).all()
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[0].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13


# ----------------------------------------------------------- the channel

CHANNEL_SIZE = dict(ITDM=8, JTDM=16, KDM=6)


def test_channel_with_age_matches_blom_tpu(monkeypatch):
    """build_channel(use_idlage=True), one step against blom_tpu's
    channel given an age slot (its build_channel has no such option;
    build_gridfile's, which the port's follows, adds slot 0)."""
    for mod in (jch, tch):
        for name, v in CHANNEL_SIZE.items():
            monkeypatch.setattr(mod, name, v)
    tm = tst.build_channel(device='cpu', use_idlage=True)
    jm = jst.build_channel()
    z = jax.numpy.zeros((2, 1) + jm.state.dp.shape[1:])
    js0 = dataclasses.replace(jm.state, trc=z, trcold=z[0])
    assert tm.par.itriag == 0
    assert tm.state.trc.shape == js0.trc.shape
    d1 = jm.clock.delt1
    with jax.disable_jit():
        js, _ = jstep.blom_step(jm.grid, jm.e, jm.par._replace(itriag=0),
                                jm.coeffs_i, jm.coeffs_j, js0, jm.forcing,
                                jm.dfl, 0, 1, d1, jm.swabs)
    ts, _ = tstep.blom_step(tm.grid, tm.e, tm.par, tm.coeffs_i,
                            tm.coeffs_j, _port_state(js0), tm.forcing,
                            tm.dfl, 0, 1, d1, tm.swabs)
    errs = {k: v for k, v in _rel_errors(js, ts).items() if v > 1e-10}
    assert not errs, errs
    assert float(ts.trc[1, 0, 1:].min()) > 0.


# ------------------------------------------------- the port's invariants

def _p_inventory(s, lev, itrbgc):
    t = s.trc[lev, itrbgc:].double()
    tot = t[T.phosph] + t[T.phy] + t[T.zoo] + t[T.doc] + t[T.det]
    return float((tot * s.dp[lev].double() / onem).sum())


def test_phosphorus_inventory_and_age_bounds():
    """tests/test_bgc.py:243-265 and tests/test_tracers.py:14-27 on the
    port: total phosphorus within 5e-7 through six steps (no P source);
    the age zero at the surface, no older than the steps allow, positive
    at depth and not negative."""
    m = tst.build_fuk95(device='cpu', itdm=32, jtdm=16, kdm=12, **TRACERS)
    p0 = _p_inventory(m.state, 0, m.par.itrbgc)
    s, _ = tst.run(m, 6)
    assert torch.isfinite(s.trc).all()
    assert abs(_p_inventory(s, 0, m.par.itrbgc) / p0 - 1.) <= 5e-7
    ip = m.grid.ip > 0
    age = s.trc[1, 0]
    expected = 6 * 2 * 180. / (86400. * 360.)
    assert float(age[0][ip].max()) < 1e-4
    assert float(age[3][ip].max()) <= expected * 1.05
    assert float(age[-1][ip].mean()) > 0.2 * expected
    assert float(age.min()) >= -1e-14
