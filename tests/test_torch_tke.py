"""The port's TKE/GLS closure against blom_tpu's, on CPU in f64.

- every module-level constant and derived coefficient of
  `blom_tpu/phys/tke.py`, by name, exactly; `TkeParams`' defaults;
  `init_tke_tracers` exactly;
- `tke_gls_update` within 1e-12 relative (to the largest value of each
  output) with the prognostic psi (use_gls) and the diagnostic one, each
  with and without the surface penetration (tkepf > 0), on random columns
  with thin layers, negative and positive N^2 and a deepest active layer
  that varies from column to column;
- the isopycnic step at 24x8x10 with two tracer slots, the closure on
  (itrtke 0 with itrgls 1, and with itrgls -1: psi diagnostic, read from
  the last slot and not written), phase by phase over both parities from
  blom_tpu's state before each phase (test_torch_kpp.py's `VRef`; barotp
  within 1e-8);
- `_tke_closure` alone on the tripolar grid at 16x12x6 with random
  velocities, wind stress, slots and diffusivities: the fold-tagged j+1
  reads of v and tauy;
- the ALE step with itrtke set, which runs no closure in either package:
  the slots are advected, diffused and remapped as tracers, phase by
  phase over both parities."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.drivers import standalone as jst
from blom_tpu.phys import tke as jtke
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.phys import tke as ttke
from blom_tpu.dynamics import step as jstep
from blom_tpu_torch import convert
from tests.test_torch_kpp import (ISOPYC_PHASES, VRef, _forcing, _kpp_state,
                                  phase_errors)
from tests.test_torch_tracers import _np_fields, _port_state, _rel_errors
from tests.test_torch_slice import FULL_PHASES
from tests.torch_shared import shared_build

TOL = 1e-12
CONSTANTS = (
    'gls_cmu0', 'Pr_t', 'zos', 'gls_p', 'gls_m', 'gls_n', 'gls_c1',
    'gls_c2', 'gls_c3plus', 'gls_c3minus', '_L1', '_L2', '_L3', '_L4',
    '_L5', '_L6', '_L7', '_L8', 'gls_Gh0', 'gls_Ghmin', 'gls_Ghcri',
    'vonKar', 'tke_min', 'gls_psi_min', 'Ls_unlmt_min', 'sqrt2',
    'cmu_fac1', 'cmu_fac2', 'cmu_fac3', 'tke_exp1', 'gls_exp1',
    'gls_fac6', 'gls_s0', 'gls_s1', 'gls_s2', 'gls_s4', 'gls_s5',
    'gls_s6', 'gls_b0', 'gls_b1', 'gls_b2', 'gls_b3', 'gls_b4', 'gls_b5')


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_constants_match_blom_tpu():
    # blom_tpu's module floats: its own and the constants it imports
    names = {k for k, v in vars(jtke).items() if isinstance(v, float)}
    assert names == set(CONSTANTS) | {'alpha0', 'epsilp', 'grav', 'onem'}
    for name in names:
        assert getattr(ttke, name) == getattr(jtke, name), name
    assert ttke.TkeParams()._asdict() == jtke.TkeParams()._asdict()


def test_init_tke_tracers_matches_blom_tpu():
    trc = np.random.default_rng(1).uniform(0., 1., (2, 3, 4, 5, 6))
    for itrtke, itrgls in ((0, 1), (2, 0)):
        ref = jtke.init_tke_tracers(jnp.asarray(trc), itrtke, itrgls)
        out = ttke.init_tke_tracers(_t(trc), itrtke, itrgls)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _columns(seed=2, kk=9, H=(6, 7)):
    """Random inputs of tke_gls_update: thin and massless layers, N^2 of
    both signs, the deepest active layer varying."""
    rng = np.random.default_rng(seed)
    shape = (kk,) + H
    dp = rng.uniform(0., 5e5, shape)
    dp[rng.uniform(size=shape) < .2] = 0.
    dp[rng.uniform(size=shape) < .1] = 5e-12       # thin, not empty
    p_i = np.concatenate([np.zeros((1,) + H), np.cumsum(dp, 0)])
    kmax = rng.integers(2, kk, H)
    return dict(
        tke=rng.uniform(ttke.tke_min, 1e-3, shape),
        gls=rng.uniform(ttke.gls_psi_min, 1e-6, shape),
        difdia=rng.uniform(0., 1e-2, shape),
        du2l=rng.uniform(0., 1e-2, shape),
        bvfsq=rng.normal(2e-5, 3e-5, shape),
        dp_k=dp, p_i=p_i,
        ustar=rng.uniform(0., .02, H),
        ustarb=rng.uniform(0., .01, H)), kmax


@pytest.mark.parametrize('tkepf', [0., .3])
@pytest.mark.parametrize('use_gls', [True, False])
def test_tke_gls_update_matches_blom_tpu(use_gls, tkepf):
    x, kmax = _columns()
    names = ('tke', 'gls', 'difdia', 'du2l', 'bvfsq', 'dp_k', 'p_i',
             'ustar', 'ustarb')
    jpar = jtke.TkeParams(use_gls=use_gls, tkepf=tkepf)
    tpar = ttke.TkeParams(use_gls=use_gls, tkepf=tkepf)
    ref = jtke.tke_gls_update(*(jnp.asarray(x[k]) for k in names),
                              jnp.asarray(kmax), 360., jpar)
    out = ttke.tke_gls_update(*(_t(x[k]) for k in names),
                              torch.tensor(kmax), 360., tpar)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max())
    tke = np.asarray(ref[0])
    # the bottom condition, the floors and production all show
    assert (tke >= ttke.tke_min).all()
    assert tke.max() > 2. * ttke.tke_min
    assert np.asarray(ref[2]).max() > 0.


# ------------------------------------------------------------- the step

ALE_SIZE = dict(itdm=24, jtdm=8, kdm=8)
ISOPYC_SIZE = dict(itdm=24, jtdm=8, kdm=10)


def with_tke_slots(jm, tm, itrtke, itrgls):
    """Both models with two tracer slots at the closure's minima (as
    tests/test_tke.py:103-111 builds them) and the closure's indices."""
    kk = jm.grid.kk
    H = jm.grid.shape
    trc = np.asarray(jtke.init_tke_tracers(jnp.zeros((2, 2, kk) + H), 0, 1))
    jm = dataclasses.replace(
        jm, state=dataclasses.replace(
            jm.state, trc=jnp.asarray(trc),
            trcold=jnp.zeros((2, kk) + H)),
        par=jm.par._replace(itrtke=itrtke, itrgls=itrgls))
    s = tm.state.clone()
    s.trc = ttke.init_tke_tracers(torch.zeros((2, 2, kk) + H,
                                              dtype=torch.float64), 0, 1)
    s.trcold = torch.zeros((2, kk) + H, dtype=torch.float64)
    tm = dataclasses.replace(tm, state=s,
                             par=tm.par._replace(itrtke=itrtke,
                                                 itrgls=itrgls))
    return jm, tm


@pytest.mark.parametrize('itrgls', [1, -1])
def test_isopyc_step_with_closure_matches_blom_tpu(tmp_path_factory, itrgls):
    """Every phase of two steps (both parities), the closure between the
    estimator and diapfl; the closure raises TKE above its floor at the
    bottom and, with itrgls -1, leaves slot 1 to the transport."""
    size = dict(vcoord='isopyc_bulkml', **ISOPYC_SIZE)
    jm, tm = with_tke_slots(shared_build(tmp_path_factory, jst.build_fuk95,
                                         **size),
                            tst.build_fuk95(device='cpu', **size), 0, itrgls)
    tstep.check_supported(tm.grid, tm.par)
    rec, js = VRef(jm, 'isopyc').run(2, ISOPYC_PHASES)
    assert sum(r[1] == 'tke' for r in rec) == 2
    assert not phase_errors(rec, tm, 'isopyc', forced=False)
    wet = np.asarray(jm.grid.ip) > 0
    tke = np.asarray(js.trc[:, 0])[:, :, wet]
    assert tke.max() > 2. * ttke.tke_min
    for step, name, m, n, d1, (s, _, _), out in rec:
        if name == 'tke' and itrgls < 0:
            np.testing.assert_array_equal(np.asarray(out[0].trc[n, 1]),
                                          np.asarray(s.trc[n, 1]))


def test_ale_step_with_tke_slots_runs_no_closure(tmp_path_factory):
    """On the ALE path blom_tpu runs no closure: the slots are tracers.
    Every phase of two steps, both parities."""
    jm, tm = with_tke_slots(shared_build(tmp_path_factory, jst.build_fuk95,
                                         **ALE_SIZE),
                            tst.build_fuk95(device='cpu', **ALE_SIZE), 0, 1)
    tstep.check_supported(tm.grid, tm.par)
    rec, js = VRef(jm, 'ale').run(2, FULL_PHASES)
    assert not any(r[1] == 'tke' for r in rec)
    assert not phase_errors(rec, tm, 'ale', forced=False)
    ts, dfl = tm.state.clone(), tm.dfl
    for m, n, d in ((0, 1, tm.clock.delt1), (1, 0, 2. * tm.par.baclin)):
        ts, dfl = tstep.blom_step(tm.grid, tm.e, tm.par, tm.coeffs_i,
                                  tm.coeffs_j, ts, tm.forcing, dfl, m, n, d,
                                  tm.swabs)
    # without the closure the uniform slots stay at their minima
    wet = tm.grid.ip > 0
    np.testing.assert_allclose(ts.trc[0, 0][:, wet].numpy(), ttke.tke_min,
                               rtol=1e-12)


@pytest.mark.parametrize('itrgls', [1, -1])
def test_tripolar_tke_closure_matches_blom_tpu(tmp_path_factory, itrgls):
    size = dict(itdm=16, jtdm=12, kdm=6)
    jm, tm = with_tke_slots(shared_build(tmp_path_factory,
                                         jst.build_tripolar, **size),
                            tst.build_tripolar(device='cpu', **size), 0,
                            itrgls)
    rng = np.random.default_rng(9)
    s = _kpp_state(jm)
    trc = rng.uniform(ttke.tke_min, 1e-3, np.asarray(jm.state.trc).shape)
    s = dataclasses.replace(s, trc=jnp.asarray(trc),
                            ustarb=jnp.asarray(rng.uniform(0., .01,
                                                           jm.grid.shape)))
    kdiff = rng.uniform(0., 1e-2, np.asarray(s.dp[0]).shape)
    f = _forcing(jm, 'strong_wind')
    f = dataclasses.replace(f, tauy=jnp.asarray(
        rng.normal(0., .1, jm.grid.shape)) * jm.grid.iv)
    ref_s, ref_k = jstep._tke_closure(jm.grid, s, f, jnp.asarray(kdiff),
                                      jm.par, 1, 360.)
    out_s, out_k = tstep._tke_closure(
        tm.grid, _port_state(s), convert.forcing_from_numpy(_np_fields(f)),
        _t(kdiff), tm.par, 1, 360.)
    errs = _rel_errors(ref_s, out_s)
    errs['kdiff'] = float(np.abs(np.asarray(ref_k) - out_k.numpy()).max()
                          / np.abs(np.asarray(ref_k)).max())
    assert not {k: v for k, v in errs.items() if v > TOL}, errs
