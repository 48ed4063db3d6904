"""The port's fuk95 step against blom_tpu's, on CPU, at 24x8x8 in f64.

The adiabatic dynamical core (both models with ``par._replace(ale=None,
vmix=None, difest=None)``):

- The port's build_fuk95 gives the same grid, CPPM coefficients and
  initial state.
- Phase by phase, from the same input state, the port reproduces each
  phase of blom_tpu's step to rounding (both parities).  blom_tpu runs
  the barotropic substeps as a compiled lax.scan in which XLA contracts
  multiply-adds, and the barotropic pressure-gradient terms cancel by
  about six orders of magnitude, so barotp alone agrees to ~1e-9
  relative rather than to the last bit.
- Over 4 steps of the jitted blom_tpu driver those roundoff differences
  grow through the CPPM limiters and the barotropic solve: the
  prognostic fields agree to 1e-6 relative (measured 3e-7 for v), every
  State field to 1e-5 (measured 3e-6 for the pressure-gradient fields,
  which are differences of a ~2e3 m2 s-2 potential).
- The port's own physical invariants: finite fields, mass conserved to
  roundoff, uniform salinity kept.

The full default step (ALE regrid/remap, cmnfld, difest_lateral,
eddtra, diffus, CVMix-lite vertical mixing, ale_vdifft/ale_vdiffm) with
bench.py's ``DifestParams(egc=.85, egmndf=100.)``:

- Both build_fuk95 give the same parameters and shortwave fields.
- Phase by phase for both parities, from blom_tpu's state before each
  phase, every output agrees to 1e-12 relative (barotp to 1e-8, as
  above).
- Over 4 steps of the jitted blom_tpu driver the differences grow much
  faster than in the adiabatic core, through the discrete choices of
  the nudge regrid (the regime and case of each interface) and of the
  eddy-transport limiter.  Measured: the first step leaves ~1e-7 (v,
  vflx, from barotp); at step 4 an interface flips its choice and the
  worst fields are pgfy 0.24, v 2.6e-2, usflx 1.9e-2, dp 1.0e-3, temp
  3.7e-7, pb 5.4e-8 (max |port - ref| / max |ref|).  blom_tpu run
  eagerly, phase by phase, differs from its own jitted driver by the same
  amounts (pgfy 0.24, v 2.6e-2, dp 1.0e-3), so these tolerances measure
  the model's sensitivity to rounding, not a fault of the port: pb, temp
  and saln within 1e-5, dp and u within 3e-2, v within 0.2, every State
  field within 1.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blom_tpu.core.constants import onem
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import advect as ja
from blom_tpu.dynamics import ale as jal
from blom_tpu.dynamics import ale_vdiff as jvd
from blom_tpu.dynamics import barotp as jb
from blom_tpu.dynamics import cmnfld as jcf
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import diffus as jdi
from blom_tpu.dynamics import eddtra as jed
from blom_tpu.dynamics import momtum as jmo
from blom_tpu.dynamics import ndiff as jnd
from blom_tpu.dynamics import pbcor as jp
from blom_tpu.dynamics import pgforc as jg
from blom_tpu.dynamics import step as jstep
from blom_tpu.dynamics import tmsmt as jt
from blom_tpu.phys import vmix as jvm
from blom_tpu_torch import convert
from blom_tpu_torch.core import constants as tcst
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import advect as ta
from blom_tpu_torch.dynamics import ale as tal
from blom_tpu_torch.dynamics import ale_vdiff as tvd
from blom_tpu_torch.dynamics import barotp as tb
from blom_tpu_torch.dynamics import cmnfld as tcf
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import diffus as tdi
from blom_tpu_torch.dynamics import eddtra as ted
from blom_tpu_torch.dynamics import momtum as tmo
from blom_tpu_torch.dynamics import ndiff as tnd
from blom_tpu_torch.dynamics import pbcor as tp
from blom_tpu_torch.dynamics import pgforc as tg
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.dynamics import tmsmt as tt
from blom_tpu_torch.phys import vmix as tvm
from tests.torch_shared import shared_build, shared_items

SIZE = dict(itdm=24, jtdm=8, kdm=8)
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')
PHASES = ('tmsmt1', 'advect', 'pbcor1', 'pgforc', 'momtum', 'barotp',
          'pbcor2', 'tmsmt2')


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


def _rel_errors(ref_state, state):
    """{field: max|ref - port| / max|ref|} over the non-empty fields."""
    out = {}
    for name, a in _np_fields(ref_state).items():
        if a.size:
            b = getattr(state, name).numpy()
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


@pytest.fixture(scope='module')
def default_models(tmp_path_factory):
    """Both packages' build_fuk95 with their defaults."""
    torch.set_num_threads(1)
    return (shared_build(tmp_path_factory, jst.build_fuk95, **SIZE),
            tst.build_fuk95(device='cpu', **SIZE))


@pytest.fixture(scope='module')
def models(default_models):
    """The adiabatic dynamical core of both."""
    core = dict(ale=None, vmix=None, difest=None)
    return tuple(dataclasses.replace(mo, par=mo.par._replace(**core))
                 for mo in default_models)


@pytest.fixture(scope='module')
def full_models(default_models):
    """The full default step with bench.py's lateral diffusivities."""
    jm, tm = (dataclasses.replace(mo) for mo in default_models)
    jm.par = jm.par._replace(difest=jdf.DifestParams(egc=.85, egmndf=100.))
    tm.par = tm.par._replace(difest=tdf.DifestParams(egc=.85, egmndf=100.))
    return jm, tm


@pytest.fixture(scope='module')
def phase_snapshots(models, tmp_path_factory):
    """blom_tpu's state before and after each phase of the first two
    steps, run eagerly phase by phase, once per run."""
    return shared_items(tmp_path_factory, 'slice_phase_snapshots',
                        lambda: _phase_items(models[0]))


def _phase_items(jm):
    """Yields ((step, phase), (m, n, delt1, state before, state after,
    momtum's depth-mean tendencies or None)) as each phase is run."""
    g, e, par = jm.grid, jm.e, jm.par
    s = jm.state
    for step, (m, n) in enumerate(((0, 1), (1, 0))):
        d1 = jm.clock.delt1
        s = jstep.init_fluxes(s, m)
        for name, fn in (
                ('tmsmt1', lambda s: jt.tmsmt1(g, s, n)),
                ('advect', lambda s: ja.advect(g, s, jm.dfl, jm.coeffs_i,
                                               jm.coeffs_j, m, n, d1,
                                               par.dlt)),
                ('pbcor1', lambda s: jp.pbcor1(g, s, m, n, par.dlt)),
                ('pgforc', lambda s: jg.pgforc(g, e, s, m, n))):
            before, s = s, fn(s)
            yield (step, name), (m, n, d1, before, s, None)
        before = s
        s, ju, jv = jmo.momtum(g, s, jm.forcing, par.momtum,
                               jm.dfl.difwgt, m, n, d1, par.dlt)
        uv = (np.asarray(ju), np.asarray(jv))
        yield (step, 'momtum'), (m, n, d1, before, s, uv)
        for name, fn in (
                ('barotp', lambda s: jb.barotp(g, s, ju, jv, m, n,
                                               par.lstep, par.dlt,
                                               par.barotp)),
                ('pbcor2', lambda s: jp.pbcor2(g, e, s, m, n, par.dlt)),
                ('tmsmt2', lambda s: jt.tmsmt2(g, s, m, n))):
            before, s = s, fn(s)
            yield (step, name), (m, n, d1, before, s,
                                 uv if name == 'barotp' else None)


def _port_phase(tm, name, m, n, d1, s, uv):
    g, e, par = tm.grid, tm.e, tm.par
    if name == 'tmsmt1':
        return tt.tmsmt1(g, s, n)
    if name == 'advect':
        return ta.advect(g, s, tm.dfl, tm.coeffs_i, tm.coeffs_j, m, n, d1,
                         par.dlt)
    if name == 'pbcor1':
        return tp.pbcor1(g, s, m, n, par.dlt)
    if name == 'pgforc':
        return tg.pgforc(g, e, s, m, n)
    if name == 'momtum':
        s, u, v = tmo.momtum(g, s, tm.forcing, par.momtum, tm.dfl.difwgt,
                             m, n, d1, par.dlt)
        # the depth-mean tendency is a column sum of terms that cancel by
        # ~1e6, taken in another order than jnp.sum; from rest it is
        # pure rounding, so the floor is 1e-16 m s-1 per step
        for port, ref in ((u, uv[0]), (v, uv[1])):
            assert (np.abs(port.numpy() - ref).max()
                    <= 1e-9 * np.abs(ref).max() + 1e-16 / d1)
        return s
    if name == 'barotp':
        return tb.barotp(g, s, torch.tensor(uv[0]), torch.tensor(uv[1]),
                         m, n, par.lstep, par.dlt, par.barotp)
    if name == 'pbcor2':
        return tp.pbcor2(g, e, s, m, n, par.dlt)
    return tt.tmsmt2(g, s, m, n)


def test_build_matches_blom_tpu(models):
    """Same grid and CPPM coefficients; the same initial state to
    rounding (getpl's Newton loop and the column scans run compiled in
    blom_tpu; PGF fields are differences of a ~2e3 m2 s-2 potential, so
    their absolute error sits near 1e-12)."""
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
    assert tm.par.lstep == jm.par.lstep and tm.par.dlt == jm.par.dlt
    assert tm.par.momtum._asdict() == jm.par.momtum._asdict()
    assert tm.par.barotp._asdict() == jm.par.barotp._asdict()
    assert (tm.par.ale, tm.par.vmix, tm.par.difest) == (None, None, None)


def test_full_build_matches_blom_tpu(default_models):
    """The default build turns on ALE, vertical mixing and the lateral
    diffusivity estimate as blom_tpu's does, and check_supported takes
    them, and bench.py's physics."""
    jm, tm = default_models
    for name in ('ale', 'vmix', 'difest'):
        assert getattr(tm.par, name)._asdict() == \
            getattr(jm.par, name)._asdict(), name
    assert tm.par.ltedtp == jm.par.ltedtp
    for name in ('swfc1', 'swfc2', 'swal1', 'swal2'):
        np.testing.assert_array_equal(getattr(tm.swabs, name).numpy(),
                                      np.asarray(getattr(jm.swabs, name)))
    tstep.check_supported(tm.grid, tm.par)
    tstep.check_supported(tm.grid, tm.par._replace(
        difest=tdf.DifestParams(egc=.85, egmndf=100.)))


@pytest.mark.parametrize('phase', PHASES)
@pytest.mark.parametrize('step', [0, 1])
def test_phase_matches_blom_tpu(models, phase_snapshots, step, phase):
    _, tm = models
    m, n, d1, before, after, uv = phase_snapshots[(step, phase)]
    s = convert.state_from_numpy(_np_fields(before))
    s = _port_phase(tm, phase, m, n, d1, s, uv)
    tol = 1e-8 if phase == 'barotp' else 1e-12
    errs = _rel_errors(after, s)
    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, bad


def test_four_steps_match_blom_tpu(models):
    """The forward first step and both parities, through both drivers."""
    jm, tm = models
    js, jclock = jst.run(jm, 4)
    model = dataclasses.replace(
        tm, state=convert.state_from_numpy(_np_fields(jm.state)))
    ts, tclock = tst.run(model, 4)
    assert tclock.nstep == jclock.nstep == 4
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items()
           if v > (1e-6 if k in PROGNOSTIC else 1e-5)}
    assert not bad, bad


def test_invariants_odd_steps(models):
    """5 steps (the odd tail included): finite fields, mass conserved to
    roundoff, uniform salinity kept (compatible advection)."""
    _, tm = models
    s0 = tm.state.dp.clone()
    s, clock = tst.run(tm, 5)
    assert torch.equal(tm.state.dp, s0)      # run leaves the model's state
    assert clock.nstep == 5
    g = tm.grid
    for name in ('dp', 'temp', 'saln', 'u', 'v', 'pb'):
        assert torch.isfinite(getattr(s, name)).all(), name
    mass0 = float((s0[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((s.dp[0].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
    assert float(((s.saln[0] - 35.) * g.ip).abs().max()) < 1e-12
    assert float(s.v.abs().max()) > 0.


def test_entry_point_needs_cuda_or_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tst.build_fuk95(**SIZE)


@pytest.mark.parametrize('change', [dict(trxday=30.)], ids=['change2'])
def test_unported_phases_raise(full_models, full_snapshots, change):
    """Surface restoring, which the port once refused here: for both
    parities, on blom_tpu's inputs of the full step's vertical physics,
    the restoring fluxes of thermf_relax towards seeded climatologies
    (test_torch_thermf.py's, the trxlim clamp biting), then
    difest_vertical and ale_vdifft reading them, each within 1e-12 of
    blom_tpu's; check_supported takes the option."""
    from blom_tpu.phys import thermf as jthermf
    from blom_tpu_torch.phys import thermf as tthermf
    from tests.test_torch_thermf import with_restoring
    jm, tm = with_restoring(*full_models, **change)
    tstep.check_supported(tm.grid, tm.par)
    for step in (0, 1):
        m, n, d1, (before, dfl, _), _ = full_snapshots[
            (step, 'difest_vertical')]
        jf = jthermf.thermf_relax(jm.grid, before, jm.forcing, jm.par.thermf,
                                  n, jm.forcing.sstclm, jm.forcing.sssclm)
        vf = jvm.difest_vertical(jm.grid, jm.e, before, jf, jm.swabs,
                                 jm.par.vmix, n)
        after = jvd.ale_vdifft(jm.grid, jm.e, before, jf, vf, m, n, d1)
        s = convert.state_from_numpy(_np_fields(before))
        tf = tthermf.thermf_relax(tm.grid, s, tm.forcing, tm.par.thermf, n,
                                  tm.forcing.sstclm, tm.forcing.sssclm)
        tvf = tvm.difest_vertical(tm.grid, tm.e, s, tf, tm.swabs,
                                  tm.par.vmix, n)
        out = tvd.ale_vdifft(tm.grid, tm.e, s, tf, tvf, m, n, d1)
        assert float(tf.surrlx.abs().max()) > 0.
        for ref, port in ((jf, tf), (vf, tvf), (after, out)):
            errs = _rel_errors_any(ref, port)
            bad = {k: v for k, v in errs.items() if v > 1e-12}
            assert not bad, (step, bad)


@pytest.mark.parametrize('option', ['remap', 'neutral'])
def test_transport_options_match_blom_tpu(full_models, full_snapshots,
                                          option):
    """The lateral transport options the port once refused here:
    incremental-remapping advection (advmth='remap') and neutral
    diffusion (ltedtp='neutral').  For both parities, the port's advect
    or ndiff on blom_tpu's inputs of that phase in the full step (the
    phases before it are the main path's) against blom_tpu's own, within
    1e-12 (measured: bit for bit); check_supported takes them."""
    change = (dict(advmth='remap') if option == 'remap'
              else dict(ltedtp='neutral'))
    jm, tm = (dataclasses.replace(mo, par=mo.par._replace(**change))
              for mo in full_models)
    tstep.check_supported(tm.grid, tm.par)
    phase = 'advect' if option == 'remap' else 'diffus'
    for step in (0, 1):
        m, n, d1, (before, dfl, cf), _ = full_snapshots[(step, phase)]
        ref = ref_transport(jm, phase, m, n, d1, before, dfl, cf)
        s = convert.state_from_numpy(_np_fields(before))
        tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
        out = _full_port_phase(tm, phase, m, n, d1, s, tdfl, cf)
        pairs = (list(zip(ref, out)) if phase == 'diffus'
                 else [(ref, out)])
        for r, o in pairs:
            errs = _rel_errors_any(r, o)
            bad = {k: v for k, v in errs.items() if v > 1e-12}
            assert not bad, (step, bad)


@pytest.mark.parametrize('change', [dict(regrid_method='direct'),
                                    dict(reconstruction_method='pqm')])
def test_ale_methods_match_blom_tpu(full_models, change):
    """The ALE methods the port once refused here: one full step of
    each, phase by phase from blom_tpu's state before each phase, within
    1e-12 (barotp 1e-8); check_supported takes them.  blom_tpu runs op by
    op (jax.disable_jit): the direct regrid leaves layers ~60 Pa thin,
    and across them ale_vdifft's tridiagonal solve turns the multiply-adds
    that XLA contracts in blom_tpu's compiled scan into 1.7e-10 of T and
    S."""
    jm, tm = (dataclasses.replace(mo, par=mo.par._replace(
        ale=mo.par.ale._replace(**change))) for mo in full_models)
    tstep.check_supported(tm.grid, tm.par)
    with jax.disable_jit():
        snaps = dict(full_step_items(jm, jm.state, jm.dfl, jm.clock.delt1,
                                     parities=((0, 1),)))
    for (_, phase), (m, n, d1, (before, dfl, extra), after) in snaps.items():
        s = convert.state_from_numpy(_np_fields(before))
        tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
        out = _full_port_phase(tm, phase, m, n, d1, s, tdfl, extra)
        pairs = (list(zip(after, out)) if phase == 'diffus'
                 else [(after, out)])
        tol = 1e-8 if phase == 'barotp' else 1e-12
        for ref, port in pairs:
            errs = _rel_errors_any(ref, port)
            bad = {k: v for k, v in errs.items() if v > tol}
            assert not bad, (phase, bad)


@pytest.mark.parametrize('option', ['kpp', 'tidal', 'isopyc_kpp',
                                    'itrtke'])
def test_vertical_physics_options_match_blom_tpu(full_models,
                                                tmp_path_factory, option):
    """The options the port once refused here: KPP, the tidal term (a
    float twedon), KPP on the isopycnic coordinate and the TKE slots on
    the ALE path (where neither package runs the closure).  One step of
    each, phase by phase from blom_tpu's state before each phase
    (test_torch_kpp.py's VRef), within 1e-12 (barotp 1e-8)."""
    from tests.test_torch_kpp import (ISOPYC_PHASES, VRef, phase_errors,
                                      with_vertical_physics)
    from tests.test_torch_tke import with_tke_slots
    coord = 'isopyc' if option == 'isopyc_kpp' else 'ale'
    if coord == 'isopyc':
        jm = shared_build(tmp_path_factory, jst.build_fuk95,
                          vcoord='isopyc_bulkml', **SIZE)
        tm = tst.build_fuk95(vcoord='isopyc_bulkml', device='cpu', **SIZE)
    else:
        jm, tm = full_models
    if option == 'itrtke':
        jm, tm = with_tke_slots(jm, tm, 0, -1)
    else:
        vmix = dict(twedon=1.) if option == 'tidal' else dict(use_kpp=True)
        jm, tm = with_vertical_physics(jm, tm, vmix, {})
    tstep.check_supported(tm.grid, tm.par)
    rec, _ = VRef(jm, coord).run(
        1, ISOPYC_PHASES if coord == 'isopyc' else FULL_PHASES)
    assert not phase_errors(rec, tm, coord, nsteps=1, forced=False)


# ------------------------------------------------- the full default step

FULL_PHASES = ('tmsmt1', 'ale', 'cmnfld', 'difest_lateral', 'eddtra',
               'advect', 'pbcor1', 'diffus', 'pgforc', 'momtum',
               'difest_vertical', 'ale_vdifft', 'ale_vdiffm', 'barotp',
               'pbcor2', 'tmsmt2')


def ref_transport(jm, name, m, n, d1, s, dfl, cf):
    """blom_tpu's advect ('advect') or lateral diffusion ('diffus') as
    its step runs them under jm.par: advect by par.advmth; along neutral
    surfaces with ltedtp 'neutral' on the ALE path (the mixed-layer
    pressure from cmnfld's fields cf; run op by op: see
    test_torch_ndiff.py), along layers otherwise.  The diffusion returns
    (state, diffusion fields)."""
    g, e, par = jm.grid, jm.e, jm.par
    if name == 'advect':
        return ja.advect(g, s, dfl, jm.coeffs_i, jm.coeffs_j, m, n, d1,
                         par.dlt, par.advmth)
    if par.ltedtp == 'neutral' and not par.vcoord_isopyc:
        with jax.disable_jit():
            return jnd.ndiff(g, e, s, dfl, m, n, d1, cf.mld * onem), dfl
    return jdi.diffus(g, e, s, dfl, m, n, d1)


def full_step_items(jm, s, dfl, d1, parities=((0, 1), (1, 0))):
    """blom_tpu's inputs and outputs of every phase of one full step of
    model `jm` per parity (m, n), from state `s` and diffusion fields
    `dfl`, run eagerly phase by phase; on a tripolar grid the step ends
    with the fold's sync ('arctic_sync').  Each entry: (m, n, delt1,
    (state, dfl, extra) before, output).  Yields ((step, phase), entry)
    as each phase is run."""
    g, e, par = jm.grid, jm.e, jm.par
    for step, (m, n) in enumerate(parities):
        s = jstep.init_fluxes(s, m)
        yield (step, 'tmsmt1'), (m, n, d1, (s, dfl, None),
                                 s := jt.tmsmt1(g, s, n))
        yield (step, 'ale'), (m, n, d1, (s, dfl, None), s := (
            jal.ale_regrid_remap(g, e, par.ale, s, m, n, d1)))
        cf = jcf.cmnfld(g, e, s, n)
        yield (step, 'cmnfld'), (m, n, d1, (s, dfl, None), cf)
        yield (step, 'difest_lateral'), (m, n, d1, (s, dfl, cf), dfl := (
            jdf.difest_lateral(g, s, cf, par.difest, dfl, m, n)))
        yield (step, 'eddtra'), (m, n, d1, (s, dfl, cf), dfl := (
            jed.eddtra(g, s, cf, dfl, m, n, d1)))
        yield (step, 'advect'), (m, n, d1, (s, dfl, None), s := (
            ref_transport(jm, 'advect', m, n, d1, s, dfl, None)))
        yield (step, 'pbcor1'), (m, n, d1, (s, dfl, None), s := (
            jp.pbcor1(g, s, m, n, par.dlt)))
        before = (s, dfl, cf)
        s, dfl = ref_transport(jm, 'diffus', m, n, d1, s, dfl, cf)
        yield (step, 'diffus'), (m, n, d1, before, (s, dfl))
        yield (step, 'pgforc'), (m, n, d1, (s, dfl, None), s := (
            jg.pgforc(g, e, s, m, n)))
        before = (s, dfl, None)
        s, ju, jv = jmo.momtum(g, s, jm.forcing, par.momtum, dfl.difwgt,
                               m, n, d1, par.dlt)
        uv = (np.asarray(ju), np.asarray(jv))
        yield (step, 'momtum'), (m, n, d1, before, s)
        vf = jvm.difest_vertical(g, e, s, jm.forcing, jm.swabs, par.vmix, n)
        yield (step, 'difest_vertical'), (m, n, d1, (s, dfl, None), vf)
        dfl = dataclasses.replace(dfl, difvho=vf.Kdiff_t, difvso=vf.Kdiff_s,
                                  difvmo=vf.Kvisc_m, bld=vf.mld * g.ip)
        yield (step, 'ale_vdifft'), (m, n, d1, (s, dfl, vf), s := (
            jvd.ale_vdifft(g, e, s, jm.forcing, vf, m, n, d1)))
        yield (step, 'ale_vdiffm'), (m, n, d1, (s, dfl, vf), s := (
            jvd.ale_vdiffm(g, s, vf, m, n, d1)))
        yield (step, 'barotp'), (m, n, d1, (s, dfl, uv), s := (
            jb.barotp(g, s, ju, jv, m, n, par.lstep, par.dlt, par.barotp)))
        yield (step, 'pbcor2'), (m, n, d1, (s, dfl, None), s := (
            jp.pbcor2(g, e, s, m, n, par.dlt)))
        yield (step, 'tmsmt2'), (m, n, d1, (s, dfl, None), s := (
            jt.tmsmt2(g, s, m, n)))
        if g.arctic:
            from blom_tpu.parallel.arctic import sync_state
            yield (step, 'arctic_sync'), (m, n, d1, (s, dfl, None), s := (
                sync_state(s)))


@pytest.fixture(scope='module')
def full_snapshots(full_models, tmp_path_factory):
    """blom_tpu's inputs and outputs of every phase of the first two
    full steps, run eagerly phase by phase, once per run."""
    jm, _ = full_models
    return shared_items(tmp_path_factory, 'slice_full_snapshots',
                        lambda: full_step_items(jm, jm.state, jm.dfl,
                                                jm.clock.delt1))


def _full_port_phase(tm, name, m, n, d1, s, dfl, extra):
    """The port's phase `name` on converted inputs; returns what the
    snapshot holds for it."""
    g, e, par = tm.grid, tm.e, tm.par
    if name == 'diffus' and par.ltedtp == 'neutral' \
            and not par.vcoord_isopyc:
        cf = convert.cmn_fields_from_numpy(
            {k: np.asarray(v) for k, v in extra._asdict().items()})
        return (tnd.ndiff(g, e, s, dfl, m, n, d1, cf.mld * tcst.onem),
                dfl)
    if name == 'ale':
        return tal.ale_regrid_remap(g, e, par.ale, s, m, n, d1)
    if name == 'cmnfld':
        return tcf.cmnfld(g, e, s, n)
    if name in ('difest_lateral', 'eddtra'):
        cf = convert.cmn_fields_from_numpy(
            {k: np.asarray(v) for k, v in extra._asdict().items()})
        if name == 'eddtra':
            return ted.eddtra(g, s, cf, dfl, m, n, d1)
        return tdf.difest_lateral(g, s, cf, par.difest, dfl, m, n)
    if name == 'diffus':
        return tdi.diffus(g, e, s, dfl, m, n, d1)
    if name == 'difest_vertical':
        return tvm.difest_vertical(g, e, s, tm.forcing, tm.swabs, par.vmix,
                                   n)
    if name in ('ale_vdifft', 'ale_vdiffm'):
        vf = convert.vmix_fields_from_numpy(_np_fields(extra))
        if name == 'ale_vdifft':
            return tvd.ale_vdifft(g, e, s, tm.forcing, vf, m, n, d1)
        return tvd.ale_vdiffm(g, s, vf, m, n, d1)
    if name == 'advect':
        return ta.advect(g, s, dfl, tm.coeffs_i, tm.coeffs_j, m, n, d1,
                         par.dlt, par.advmth)
    if name == 'momtum':
        return tmo.momtum(g, s, tm.forcing, par.momtum, dfl.difwgt, m, n,
                          d1, par.dlt)[0]
    return _port_phase(tm, name, m, n, d1, s, extra)


def _rel_errors_any(ref, port):
    """{field: max|ref - port| / max|ref|} of a dataclass or NamedTuple."""
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


@pytest.mark.parametrize('phase', FULL_PHASES)
@pytest.mark.parametrize('step', [0, 1])
def test_full_phase_matches_blom_tpu(full_models, full_snapshots, step,
                                     phase):
    _, tm = full_models
    m, n, d1, (before, dfl, extra), after = full_snapshots[(step, phase)]
    s = convert.state_from_numpy(_np_fields(before))
    tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
    out = _full_port_phase(tm, phase, m, n, d1, s, tdfl, extra)
    pairs = (list(zip(after, out)) if phase == 'diffus'
             else [(after, out)])
    tol = 1e-8 if phase == 'barotp' else 1e-12
    for ref, port in pairs:
        errs = _rel_errors_any(ref, port)
        bad = {k: v for k, v in errs.items() if v > tol}
        assert not bad, bad


FULL_TOL = dict(pb=1e-5, temp=1e-5, saln=1e-5, dp=3e-2, u=3e-2, v=.2)


def test_full_four_steps_match_blom_tpu(full_models):
    """The full step with bench.py's physics through both drivers, the
    forward first step and both parities; then the port's invariants."""
    jm, tm = full_models
    js, jclock = jst.run(jm, 4)
    model = dataclasses.replace(
        tm, state=convert.state_from_numpy(_np_fields(jm.state)))
    ts, tclock = tst.run(model, 4)
    assert tclock.nstep == jclock.nstep == 4
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items() if v > FULL_TOL.get(k, 1.)}
    assert not bad, bad

    g = tm.grid
    for name in ('dp', 'temp', 'saln', 'u', 'v', 'pb'):
        assert torch.isfinite(getattr(ts, name)).all(), name
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[1].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
    assert float(((ts.saln[1] - 35.) * g.ip).abs().max()) < 1e-12
