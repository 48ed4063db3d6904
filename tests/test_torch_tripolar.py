"""The port's tripolar grid (Arctic bipolar fold, NOINYARCTIC) against
blom_tpu's, on CPU in f64 at 16x12x6.

- The fold primitives of parallel/arctic.py (fold_row at m = 0, 1, 2,
  fold_extend, arctic_sync, jp1_arctic, the xi pairs) and the grid's fold-aware
  jp1, jpn and shift, in every point class with and without the vector
  sign, exactly against blom_tpu.parallel.arctic and blom_tpu's Grid on
  seeded random arrays; sync_state rewrites every field that
  STATE_KINDS and the xi pairs name (each a field of the port's State)
  exactly as blom_tpu's does, and writes none of its input's tensors.
- init_cppm_coeffs(arctic=True) on both axes, and build_tripolar: the
  same grid and CPPM coefficients (the j-sweep's with the three fold
  ghost rows) exactly, the initial state to the rounding
  tests/test_torch_slice.py allows its build.
- Phase by phase, both parities, from a state the port advanced three
  steps with bench.py's lateral diffusivities (so that the top rows
  carry flow): every phase of test_torch_slice.py's FULL_PHASES and the
  fold's sync, blom_tpu run eagerly, each output within 1e-12 relative
  (barotp 1e-8, as test_torch_slice.py says why); the momentum phase
  and coriolis_terms in all three vorticity schemes.
- The whole step of each time-level parity against blom_tpu's compiled
  step, at the tolerances of test_torch_slice.py's four-step test.
- The port's own counterparts of tests/test_tripolar.py: the initial
  state fold-symmetric; symmetric within 1e-6 after 4 steps with the
  end-of-step sync replaced by the identity; physical-row mass conserved
  within 1e-11 over 6 steps with transport across the seam; a uniform
  salinity kept within 1e-9.  An odd itdm and remap advection raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.configs import tripolar as jcfg
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import momtum as jmo
from blom_tpu.dynamics import step as jstep
from blom_tpu.dynamics.difest import DifestParams as JDifest
from blom_tpu.parallel import arctic as jarc
from blom_tpu_torch import convert
from blom_tpu_torch.configs import tripolar as tcfg
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.core.state import State
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import advect as ta
from blom_tpu_torch.dynamics import momtum as tmo
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.dynamics.difest import DifestParams as TDifest
from blom_tpu_torch.parallel import arctic as tarc
from tests.test_torch_slice import (FULL_PHASES, _full_port_phase,
                                    _np_fields, _rel_errors,
                                    _rel_errors_any, full_step_items)
from tests.torch_shared import shared_build, shared_items

SIZE = dict(itdm=16, jtdm=12, kdm=6)
KINDS = ('p', 'u', 'q', 'v')
BENCH = dict(egc=.85, egmndf=100.)
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')
SCHEMES = tmo.MOMMTHS


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arrays(seed=0, shape=(3, 12, 16)):
    """A seeded random array, as numpy, jnp and torch."""
    a = np.random.default_rng(seed).normal(size=shape)
    return a, jnp.asarray(a), torch.from_numpy(a)


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.fixture(scope='module')
def grids():
    """blom_tpu's and the port's tripolar grid of SIZE."""
    return (jcfg.make_grid(itdm=16, jtdm=12, kdm=6),
            tcfg.make_grid(itdm=16, jtdm=12, kdm=6))


@pytest.mark.parametrize('vector', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_fold_primitives_match_blom_tpu(grids, kind, vector):
    """fold_row (m = 0, 1, 2), fold_extend's rows, arctic_sync,
    jp1_arctic and the grid's
    jp1, jpn (m = 1, 2, 3) and shift (di = -1, 0, 1; dj = 0, 1, 2), on a
    (3, J, I) array; an untagged read keeps the closed grid's zeros."""
    jg, tg = grids
    _, ja, ta_ = _arrays()
    for m in range(3):
        _same(tarc.fold_row(ta_, kind, vector, m),
              jarc.fold_row(ja, kind, vector, m))
        _same(tarc.fold_extend(ta_, kind, vector, m + 1)[..., -1, :],
              jarc.fold_row(ja, kind, vector, m))
    _same(tarc.fold_extend(ta_, kind, vector, 3)[..., :-3, :], ja)
    _same(tarc.arctic_sync(ta_, kind, vector),
          jarc.arctic_sync(ja, kind, vector))
    _same(tarc.jp1_arctic(ta_, kind, vector),
          jarc.jp1_arctic(ja, kind, vector))
    _same(tg.jp1(ta_, kind, vector), jg.jp1(ja, kind, vector))
    _same(tg.jp1(ta_), jg.jp1(ja))
    assert float(tg.jp1(ta_)[..., -1, :].abs().max()) == 0.
    for m in (1, 2, 3):
        _same(tg.jpn(ta_, m, kind, vector), jg.jpn(ja, m, kind, vector))
    for di in (-1, 0, 1):
        for dj in (0, 1, 2):
            _same(tg.shift(ta_, di, dj, kind, vector),
                  jg.shift(ja, di, dj, kind, vector))
            _same(tg.shift(ta_, di, dj), jg.shift(ja, di, dj))


@pytest.mark.parametrize('axis', ['u', 'v'])
def test_xi_pairs_match_blom_tpu(axis):
    """The bottom-pressure-sensitivity pairs swap roles with no sign."""
    (_, ja, ta_), (_, jb, tb) = _arrays(1), _arrays(2)
    tsync = tarc.sync_xi_pair_u if axis == 'u' else tarc.sync_xi_pair_v
    jsync = jarc.sync_xi_pair_u if axis == 'u' else jarc.sync_xi_pair_v
    for port, ref in zip(tsync(ta_, tb), jsync(ja, jb)):
        _same(port, ref)


def test_sync_state_matches_blom_tpu(tmp_path_factory):
    """Every name of STATE_KINDS and the xi pairs is a field of the
    port's State; sync_state rewrites exactly those, as blom_tpu's does on
    the same random state, leaves the other fields the same tensors and
    writes none of its input's."""
    names = {f.name for f in dataclasses.fields(State)}
    assert tarc.STATE_KINDS == jarc.STATE_KINDS
    assert (tarc.XI_PAIRS_U, tarc.XI_PAIRS_V) == (jarc.XI_PAIRS_U,
                                                  jarc.XI_PAIRS_V)
    synced = set(tarc.STATE_KINDS) | {
        n for pairs in (tarc.XI_PAIRS_U, tarc.XI_PAIRS_V)
        for pair in pairs for n in pair}
    assert len(synced) == 66 and synced <= names
    jm = shared_build(tmp_path_factory, jst.build_tripolar, **SIZE)
    rng = np.random.default_rng(3)
    d = {name: (np.asarray(a) if name == 'kfpla'
                else rng.normal(size=np.shape(a)))
         for name, a in _np_fields(jm.state).items()}
    js = jarc.sync_state(dataclasses.replace(
        jm.state, **{k: jnp.asarray(v) for k, v in d.items()}))
    ts = convert.state_from_numpy(d)
    before = ts.clone()
    out = tarc.sync_state(ts)
    for name in names:
        _same(getattr(out, name), getattr(js, name))
        assert torch.equal(getattr(ts, name), getattr(before, name)), name
        if name not in synced:
            assert getattr(out, name) is getattr(ts, name), name
        elif getattr(ts, name).numel():
            assert not torch.equal(getattr(out, name),
                                   getattr(ts, name)), name


@pytest.mark.parametrize('periodic', [False, True])
@pytest.mark.parametrize('axis', [-1, -2])
def test_arctic_cppm_coeffs_match_blom_tpu(axis, periodic):
    """init_cppm_coeffs(arctic=True) on either axis, on random land and
    spacing: the NGHOST_ARCTIC mirrored ghost rows join the j-sweep's
    columns or extend the i-sweep's rows, exactly as blom_tpu's."""
    from blom_tpu.dynamics import cppm as jcppm
    from blom_tpu_torch.dynamics import cppm as tcppm
    rng = np.random.default_rng(5)
    ip = (rng.uniform(size=(12, 16)) > .25).astype(float)
    dx = rng.uniform(.6, 1.5, (12, 16))
    ref = jcppm.init_cppm_coeffs(ip, dx, axis=axis, periodic=periodic,
                                 arctic=True)
    out = tcppm.init_cppm_coeffs(ip, dx, axis=axis, periodic=periodic,
                                 arctic=True)
    assert tcppm.NGHOST_ARCTIC == jcppm.NGHOST_ARCTIC == 3
    assert tuple(out.stencil.shape) == (12 + 3, 16)
    for name in out._fields:
        _same(getattr(out, name), getattr(ref, name))


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """Both packages' build_tripolar at SIZE."""
    return (shared_build(tmp_path_factory, jst.build_tripolar, **SIZE),
            tst.build_tripolar(device='cpu', **SIZE))


def test_build_matches_blom_tpu(models):
    """The same grid and CPPM coefficients exactly (the j-sweep's with
    NGHOST_ARCTIC fold ghost rows), the same parameters, and the initial
    state to test_torch_slice.py's build tolerance: the PGF fields are
    differences of a ~1e3 m2 s-2 potential, the sea level a sum that
    cancels to ~1e-14 m."""
    jm, tm = models
    assert tm.grid.arctic and not tm.grid.periodic_j
    for name in TENSOR_FIELDS:
        _same(getattr(tm.grid, name), getattr(jm.grid, name))
    assert tuple(tm.coeffs_j.hevc.shape[-2:]) == (SIZE['jtdm'] + 3,
                                                  SIZE['itdm'])
    for co_j, co_t in ((jm.coeffs_i, tm.coeffs_i),
                       (jm.coeffs_j, tm.coeffs_j)):
        for name in co_t._fields:
            _same(getattr(co_t, name), getattr(co_j, name))
    for name, a in _np_fields(jm.state).items():
        np.testing.assert_allclose(
            getattr(tm.state, name).numpy(), a, rtol=0,
            atol=1e-10 * np.abs(a).max(initial=0.) + 1e-11, err_msg=name)
    for name in ('momtum', 'barotp', 'ale', 'vmix', 'difest', 'thermf'):
        port = getattr(tm.par, name)._asdict()
        ref = getattr(jm.par, name)._asdict()
        assert port == {k: ref[k] for k in port}, name
    assert (tm.par.lstep, tm.par.dlt) == (jm.par.lstep, jm.par.dlt)


def _bench(model, params):
    return dataclasses.replace(model, par=model.par._replace(
        difest=params(**BENCH)))


@pytest.fixture(scope='module')
def advanced(models):
    """Both models with bench.py's lateral diffusivities, from the state
    and diffusion fields the port reaches in three steps (the fold rows
    carry flow), and the leap-frog delt1 of the next step."""
    jm, tm = models
    tm = _bench(tm, TDifest)
    s, clock = tst.run(tm, 3)
    tm = dataclasses.replace(tm, state=s)
    jm = _bench(jm, JDifest)
    jm = dataclasses.replace(
        jm, state=dataclasses.replace(
            jm.state, **{k: jnp.asarray(v)
                         for k, v in _np_fields(s).items()}),
        dfl=dataclasses.replace(
            jm.dfl, **{k: jnp.asarray(v)
                       for k, v in _np_fields(tm.dfl).items()}))
    assert float(s.v[0][:, -1].abs().max()) > 0.
    return jm, tm, clock.delt1


@pytest.fixture(scope='module')
def snapshots(advanced, tmp_path_factory):
    jm, _, d1 = advanced
    return shared_items(tmp_path_factory, 'tripolar_snapshots',
                        lambda: full_step_items(jm, jm.state, jm.dfl, d1))


@pytest.mark.parametrize('phase', FULL_PHASES + ('arctic_sync',))
@pytest.mark.parametrize('step', [0, 1])
def test_phase_matches_blom_tpu(advanced, snapshots, step, phase):
    _, tm, _ = advanced
    m, n, d1, (before, dfl, extra), after = snapshots[(step, phase)]
    s = convert.state_from_numpy(_np_fields(before))
    tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
    if phase == 'arctic_sync':
        out = tarc.sync_state(s)
    else:
        out = _full_port_phase(tm, phase, m, n, d1, s, tdfl, extra)
    pairs = (list(zip(after, out)) if phase == 'diffus'
             else [(after, out)])
    tol = 1e-8 if phase == 'barotp' else 1e-12
    for ref, port in pairs:
        errs = _rel_errors_any(ref, port)
        bad = {k: v for k, v in errs.items() if v > tol}
        assert not bad, bad


@pytest.mark.parametrize('mommth', SCHEMES)
def test_momtum_schemes_match_blom_tpu(advanced, snapshots, mommth):
    """The momentum phase (its stencil core _uv_body) in each scheme from
    the first step's input, and coriolis_terms on that state's fields."""
    jm, tm, _ = advanced
    m, n, d1, (before, dfl, _), _ = snapshots[(0, 'momtum')]
    ref, _, _ = jmo.momtum(jm.grid, before, jm.forcing,
                           jm.par.momtum._replace(mommth=mommth),
                           dfl.difwgt, m, n, d1, jm.par.dlt)
    s = convert.state_from_numpy(_np_fields(before))
    tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
    out, _, _ = tmo.momtum(tm.grid, s, tm.forcing,
                           tm.par.momtum._replace(mommth=mommth),
                           tdfl.difwgt, m, n, d1, tm.par.dlt)
    errs = _rel_errors(ref, out)
    assert max(errs.values()) <= 1e-12, errs

    u, v, dp = (np.asarray(getattr(before, k)[m]) for k in ('u', 'v', 'dp'))
    dpu, dpv = np.asarray(before.dpu[m]), np.asarray(before.dpv[m])
    pv = np.random.default_rng(4).normal(0., 1e-9, u.shape)
    fields = (dp, u, v, u * dpu, v * dpv, pv)
    ref = jmo.coriolis_terms(jm.grid, *map(jnp.asarray, fields), mommth)
    out = tmo.coriolis_terms(tm.grid, *map(torch.tensor, fields),
                             mommth)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert np.abs(r[:, -1]).max() > 0.
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-12,
                                   atol=1e-14 * np.abs(r).max())


@pytest.mark.parametrize('parity', [(0, 1), (1, 0)])
def test_whole_step_matches_blom_tpu(advanced, parity):
    """One step of each time-level parity from the advanced state:
    blom_tpu's blom_step compiled, the port's blom_step; every field
    within test_torch_slice.py's four-step tolerances."""
    jm, tm, d1 = advanced
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


# ------------------------------------------- tests/test_tripolar.py's

def _sym_err(s, fields=('dp', 'temp', 'saln', 'u', 'v', 'pb', 'ub', 'vb',
                        'pbu', 'pbv')):
    """Max deviation of the fold-duplicated degrees of freedom from their
    mirrors."""
    return {name: float((tarc.arctic_sync(getattr(s, name),
                                          *tarc.STATE_KINDS[name])
                         - getattr(s, name)).abs().max())
            for name in fields}


def test_initial_state_symmetric(models):
    _, tm = models
    err = _sym_err(tm.state)
    assert max(err.values()) == 0.0, err


def test_fold_symmetry_preserved_without_sync(models, monkeypatch):
    """Four steps with the end-of-step sync replaced by the identity:
    the stencils' fold reads alone keep the state symmetric."""
    _, tm = models
    monkeypatch.setattr('blom_tpu_torch.parallel.arctic.sync_state',
                        lambda s: s)
    s, _ = tst.run(tm, 4)
    assert torch.isfinite(s.dp).all()
    err = _sym_err(s)
    assert max(err.values()) < 1e-6, err
    assert float(s.v[0].abs().max()) > 0.


def test_physical_mass_conserved_across_seam(models):
    """Mass over the physical rows (all but the duplicated top row) is
    conserved over six steps while transport crosses the fold."""
    _, tm = models
    w = (tm.grid.scp2 * tm.grid.ip)[:-1]

    def mass(s, lev):
        return float((s.dp[lev][:, :-1] * w).sum())

    m0 = mass(tm.state, 0)
    s, _ = tst.run(tm, 6)
    assert abs(mass(s, 0) - m0) / m0 < 1e-11
    assert float(s.vflx[0][:, -1, :].abs().max()) > 0.


def test_uniform_tracer_preserved_across_seam(models):
    """A uniform salinity stays uniform through fold-crossing
    advection."""
    _, tm = models
    s0 = tm.state.clone()
    s0.saln = torch.full_like(s0.saln, 35.)
    s, _ = tst.run(dataclasses.replace(tm, state=s0), 4)
    wet = tm.grid.ip > 0
    assert float((s.saln[0][:, wet] - 35.).abs().max()) < 1e-9


def test_odd_itdm_and_remap_raise(models):
    with pytest.raises(ValueError, match='even'):
        tst.build_tripolar(itdm=15, jtdm=12, kdm=6, device='cpu')
    _, tm = models
    with pytest.raises(NotImplementedError, match='tripolar'):
        ta.advect(tm.grid, tm.state.clone(), tm.dfl, tm.coeffs_i,
                  tm.coeffs_j, 0, 1, 360., tm.par.dlt, advmth='remap')
