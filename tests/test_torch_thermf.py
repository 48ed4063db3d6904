"""Surface restoring (`phys/thermf.py`, the step's thermf phase) in the
port against blom_tpu, on CPU in f64.

- `thermf_relax` on seeded states and SST/SSS climatologies that differ
  from the top layer by up to 3 C and 1 g/kg, so that the trxlim and
  srxlim clamps bite at many points, within 1e-12 (measured: bit for
  bit).
- One step with restoring (trxday = srxday = 30 days) on each vertical
  coordinate: every phase from blom_tpu's state before it, the vertical
  physics reading the restoring fluxes that the thermf phase made
  (test_torch_kpp.py's `VRef` with a 'thermf' phase), each within 1e-12
  (barotp 1e-8, mxlayr test_torch_isopyc.py's MXLAYR_TOL, as
  test_torch_slice.py and test_torch_isopyc.py say why); then the
  port's `standalone.run` for that step against blom_tpu's phases
  chained, within test_torch_slice.py's one-step tolerances (1e-6 for
  the prognostic fields, 1e-5 for the rest) on the ALE path and
  test_torch_isopyc.py's (1e-6, 1e-4) on the isopycnic path.  The
  caller's Forcing is unchanged after the step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import ale_vdiff as jvd
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import mxlayr as jmx
from blom_tpu.phys import thermf as jthermf
from blom_tpu_torch import convert
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.phys import thermf as tthermf
from tests.test_torch_isopyc import MXLAYR_TOL
from tests.test_torch_kpp import (ALE_SIZE, ISOPYC_PHASES, ISOPYC_SIZE,
                                  VRef, port_phase)
from tests.test_torch_slice import FULL_PHASES
from tests.test_torch_tracers import (PROGNOSTIC, TOL, _np_fields,
                                      _port_state, _rel_errors)
from tests.torch_shared import shared_build

RESTORING = dict(trxday=30., srxday=30.)
RUN_TOL = {'ale': 1e-5, 'isopyc': 1e-4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def climatologies(temp0, saln0, seed=3):
    """SST and SSS climatologies (numpy) within 3 C and 1 g/kg of the
    top layer's temperature and salinity, seeded."""
    rng = np.random.default_rng(seed)
    return (temp0 + rng.uniform(-3., 3., temp0.shape),
            saln0 + rng.uniform(-1., 1., saln0.shape))


def with_restoring(jm, tm, **thermf):
    """Both models restoring towards climatologies() of their initial
    top layer (level 1), with ThermfParams(**thermf)."""
    sst, sss = climatologies(np.asarray(jm.state.temp[1, 0]),
                             np.asarray(jm.state.saln[1, 0]))
    jm = dataclasses.replace(
        jm, par=jm.par._replace(thermf=jthermf.ThermfParams(**thermf)),
        forcing=dataclasses.replace(jm.forcing, sstclm=jnp.asarray(sst),
                                    sssclm=jnp.asarray(sss)))
    tm = dataclasses.replace(
        tm, par=tm.par._replace(thermf=tthermf.ThermfParams(**thermf)),
        forcing=dataclasses.replace(tm.forcing, sstclm=torch.tensor(sst),
                                    sssclm=torch.tensor(sss)))
    return jm, tm


@pytest.mark.parametrize('thermf', [dict(trxday=30.), dict(srxday=10.),
                                    dict(RESTORING, trxdpt=5., srxdpt=3.,
                                         trxlim=.7, srxlim=.2)])
def test_thermf_relax_matches_blom_tpu(tmp_path_factory, thermf):
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **ALE_SIZE)
    tm = tst.build_fuk95(device='cpu', **ALE_SIZE)
    jm, tm = with_restoring(jm, tm, **thermf)
    rng = np.random.default_rng(5)
    d = _np_fields(jm.state)
    d['temp'] = d['temp'] + rng.normal(0., 1., d['temp'].shape)
    d['saln'] = d['saln'] + rng.normal(0., .3, d['saln'].shape)
    js = dataclasses.replace(jm.state, temp=jnp.asarray(d['temp']),
                             saln=jnp.asarray(d['saln']))
    par = tm.par.thermf
    for n in (0, 1):
        ref = jthermf.thermf_relax(jm.grid, js, jm.forcing, jm.par.thermf,
                                   n, jm.forcing.sstclm, jm.forcing.sssclm)
        out = tthermf.thermf_relax(tm.grid, convert.state_from_numpy(d),
                                   tm.forcing, par, n, tm.forcing.sstclm,
                                   tm.forcing.sssclm)
        errs = {k: v for k, v in _rel_errors(ref, out).items() if v > TOL}
        assert not errs, (n, errs)
        wet = tm.grid.ip > 0
        for name, day, dpt, lim in (('surrlx', par.trxday, par.trxdpt,
                                     par.trxlim * tthermf.spcifh),
                                    ('salrlx', par.srxday, par.srxdpt,
                                     par.srxlim)):
            f = getattr(out, name)
            if day == 0.:
                assert not f.any(), name
                continue
            bound = dpt * tthermf.onem / tthermf.grav * lim / (day * 86400.)
            assert float(f[wet].abs().max()) == pytest.approx(bound), name
            assert bool((f[wet] != 0.).all()) and not f[~wet].any(), name
    # no climatology, no restoring
    out = tthermf.thermf_relax(tm.grid, tm.state, tm.forcing, par, 1)
    assert not out.surrlx.any() and not out.salrlx.any()


class RestoringRef(VRef):
    """VRef with blom_tpu's thermf phase: it keeps the state and hands
    the vertical physics after it a Forcing with the restoring fluxes
    (kept in `forcings` by step), as blom_tpu's blom_step does."""

    def __init__(self, jm, coord):
        super().__init__(jm, coord)
        self.forcing0 = jm.forcing
        self.forcings = {}

    def fn(self, name, m, n):
        jm = self.jm
        g, e, par = jm.grid, jm.e, jm.par
        if name == 'thermf':
            def thermf(s, dfl, x, d1):
                f = jthermf.thermf_relax(g, s, self.forcing0, par.thermf, n,
                                         self.forcing0.sstclm,
                                         self.forcing0.sssclm)
                self.forcings[len(self.forcings)] = f
                self.jm = dataclasses.replace(self.jm, forcing=f)
                return s
            return thermf
        if name == 'mxlayr':
            return lambda s, dfl, x, d1: jmx.mxlayr(
                g, e, s, jm.forcing, par.mxlayr, m, n, d1, swabs=jm.swabs,
                dfl=dfl)
        if name == 'ale_vdifft':
            return lambda s, dfl, vf, d1: jvd.ale_vdifft(
                g, e, s, jm.forcing, vf, m, n, d1)
        return super().fn(name, m, n)


def restoring_phases(coord):
    """The step's phases with thermf where blom_step runs it: after
    diapfl on the isopycnic path, before the vertical physics on the ALE
    path."""
    phases = ISOPYC_PHASES if coord == 'isopyc' else FULL_PHASES
    at = phases.index('mxlayr' if coord == 'isopyc' else 'difest_vertical')
    return phases[:at] + ('thermf',) + phases[at:]


def restoring_step_errors(jm, tm, coord):
    """{(phase or 'run'): {field: error over its tolerance}} of one step
    of both models (restoring on) from blom_tpu's initial state: phase by
    phase, then the port's standalone.run against blom_tpu's phases
    chained.  Checks that run leaves the model's Forcing as it was."""
    ref = RestoringRef(jm, coord)
    rec, js = ref.run(1, restoring_phases(coord))
    bad = {}
    tf = tm
    for step, name, m, n, d1, (s, dfl, extra), out_ref in rec:
        ts = _port_state(s)
        if name == 'thermf':
            fref = ref.forcings[step]
            out = tthermf.thermf_relax(tf.grid, ts, tm.forcing, tm.par.thermf,
                                       n, tm.forcing.sstclm,
                                       tm.forcing.sssclm)
            pairs = [(fref, out)]
            tf = dataclasses.replace(tm, forcing=convert.forcing_from_numpy(
                _np_fields(fref)))
        else:
            out = port_phase(tf, coord, name, m, n, d1, ts,
                             convert.diffusion_fields_from_numpy(
                                 _np_fields(dfl)), extra)
            pairs = (list(zip(out_ref, out)) if name in ('diffus', 'mxlayr')
                     else [(out_ref[0] if name == 'momtum' else out_ref,
                            out)])
        tol = (1e-8 if name == 'barotp'
               else MXLAYR_TOL['cooling'] if name == 'mxlayr' else TOL)
        errs = {}
        for r, o in pairs:
            errs.update({k: v for k, v in _rel_errors(r, o).items()
                         if v > tol})
        if errs:
            bad[name] = errs

    forcing = {k: v.clone() for k, v in vars(tm.forcing).items()}
    model = dataclasses.replace(tm, state=_port_state(jm.state))
    ts, clock = tst.run(model, 1)
    assert clock.nstep == 1
    for k, v in vars(model.forcing).items():
        assert torch.equal(v, forcing[k]), k
    errs = {k: v for k, v in _rel_errors(js, ts).items()
            if v > (1e-6 if k in PROGNOSTIC else RUN_TOL[coord])}
    if errs:
        bad['run'] = errs
    return bad


def restoring_models(tmp_path_factory, coord, **thermf):
    size = (dict(vcoord='isopyc_bulkml', **ISOPYC_SIZE) if coord == 'isopyc'
            else ALE_SIZE)
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **size)
    tm = tst.build_fuk95(device='cpu', **size)
    if coord == 'ale':
        # bench.py's physics
        jm = dataclasses.replace(jm, par=jm.par._replace(
            difest=jdf.DifestParams(egc=.85, egmndf=100.)))
        tm = dataclasses.replace(tm, par=tm.par._replace(
            difest=tdf.DifestParams(egc=.85, egmndf=100.)))
    return with_restoring(jm, tm, **thermf)


@pytest.mark.parametrize('coord', ['ale', 'isopyc'])
def test_restoring_step_matches_blom_tpu(tmp_path_factory, coord):
    jm, tm = restoring_models(tmp_path_factory, coord, **RESTORING)
    tstep.check_supported(tm.grid, tm.par)
    assert not restoring_step_errors(jm, tm, coord)
