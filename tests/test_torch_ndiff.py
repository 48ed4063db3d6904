"""The port's neutral diffusion (ltedtp='neutral') against blom_tpu's, on
CPU in f64.

- `eos.drhodt` and `eos.drhods` on seeded (p, T, S): exactly.
- `_pair_exchange` and `ndiff` on tests/test_ndiff.py's model
  (`build_fuk95(itdm=32, jtdm=12, kdm=8, use_idlage=True)`, difiso 500),
  with a seeded age tracer and a seeded mixed-layer depth (layers above
  it match in pressure, below it in density), in both time-level
  parities; and `ndiff` on a small tripolar grid with seeded temperature
  noise, where the j family's increments come back across the fold
  through the tagged j+1 read: exactly (blom_tpu op by op, see below).
- The port's own properties (tests/test_ndiff.py): tracer content
  conserved to 1e-12, a uniform salinity and a uniform passive tracer
  kept to 1e-10.
- `standalone.run` with ltedtp='neutral' and bench.py's physics for its
  first step against blom_tpu's compiled run, within
  test_torch_isopyc.py's run tolerance (prognostic fields 1e-6, every
  field 1e-4; measured 9e-8 for vflx).  From the second step the
  compiled reference and the port part by ~1e-4 in v: the compiled scan
  over source layers contracts multiply-adds, and where a layer's
  temperature equals several layers' of the neighbour column the match
  turns on rounding.  Over two steps the port agrees with blom_tpu run op
  by op to 1e-11 in every field (measured), so the run is compared over
  the one step.

blom_tpu's `ndiff` scans over the source layers; run compiled (as it is
even outside jit), XLA contracts its multiply-adds, and the salinity
fluxes of a uniform salinity, which are rounding alone, then differ
entirely.  Op by op (`jax.disable_jit()`) it agrees with the port bit for
bit.  Each blom_tpu reference here serves one test and is computed in it;
the blom_tpu models are built once per test run (tests/torch_shared.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core import eos as jeos
from blom_tpu.core.constants import onem
from blom_tpu.core.state import cumulative_p as jcumulative_p
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import ndiff as jnd
from blom_tpu_torch import convert
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import ndiff as tnd
from tests.torch_shared import shared_build

NDIFF_SIZE = dict(itdm=32, jtdm=12, kdm=8, use_idlage=True)
TRIPOLAR_SIZE = dict(itdm=16, jtdm=12, kdm=6)
RUN_SIZE = dict(itdm=24, jtdm=8, kdm=8)
PARITIES = ((0, 1), (1, 0))
DIFISO = 500.
RUN_TOL = 1e-4                     # test_torch_isopyc.py's run tolerance
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


def _rel_errors(ref, port):
    """{field: max|ref - port| / max|ref|} over the non-empty fields of
    two States, ref as numpy fields."""
    out = {}
    for name, a in ref.items():
        if a.size:
            b = getattr(port, name).numpy()
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _inputs(jm, seed, t_noise=0.):
    """blom_tpu's state with seeded passive tracers (and temperature
    noise of amplitude t_noise), diffusion fields with difiso = DIFISO,
    and a seeded mixed-layer pressure between 10 and 60 m."""
    rng = np.random.default_rng(seed)
    s = jm.state
    trc = rng.uniform(0., 5., s.trc.shape) if s.trc.size else s.trc
    temp = np.asarray(s.temp) + t_noise * rng.standard_normal(s.temp.shape)
    s = dataclasses.replace(s, trc=jnp.asarray(trc),
                            temp=jnp.asarray(temp) * jm.grid.ip)
    dfl = dataclasses.replace(jm.dfl,
                              difiso=jnp.full_like(jm.dfl.difiso, DIFISO))
    mld = jnp.asarray(rng.uniform(10., 60., jm.grid.shape)) * onem
    return s, dfl, mld


def _pair_args(jm, s, dfl, mld, n, delt1):
    """_pair_exchange's arguments for the i family (A: the column at
    i-1, B: at i), as blom_tpu's ndiff builds them, in numpy."""
    g = jm.grid
    dp, temp, saln = s.dp[n], s.temp[n], s.saln[n]
    p = jcumulative_p(dp) * g.ip
    pc = p[:-1] + .5 * dp
    drt, drs = jeos.drhodt(pc, temp, saln), jeos.drhods(pc, temp, saln)
    C = jnp.concatenate([temp[None], saln[None], s.trc[n]], 0)
    qu = delt1 * .5 * (g.im1(dfl.difiso) + dfl.difiso) \
        * g.scuy * g.scuxi * g.iu
    col = (C, temp, saln, dp, pc, drt, drs)
    args = ([g.im1(a) for a in col] + list(col)
            + [qu, g.im1(g.scp2), g.scp2, .5 * (g.im1(mld) + mld)])
    return [np.asarray(a) for a in args]


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_fuk95, **NDIFF_SIZE),
            tst.build_fuk95(device='cpu', **NDIFF_SIZE))


@pytest.fixture(scope='module')
def tripolar(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_tripolar,
                         **TRIPOLAR_SIZE),
            tst.build_tripolar(device='cpu', **TRIPOLAR_SIZE))


def test_drhodt_drhods_match_blom_tpu():
    rng = np.random.default_rng(2)
    p = rng.uniform(0., 5e7, (5, 6, 7))
    th = rng.uniform(-2., 30., p.shape)
    s = rng.uniform(30., 38., p.shape)
    for fj, ft in ((jeos.drhodt, teos.drhodt), (jeos.drhods, teos.drhods)):
        np.testing.assert_array_equal(
            ft(_t(p), _t(th), _t(s)).numpy(),
            np.asarray(fj(jnp.asarray(p), jnp.asarray(th), jnp.asarray(s))))


def test_pair_exchange_matches_blom_tpu(models):
    jm, _ = models
    s, dfl, mld = _inputs(jm, 11)
    args = _pair_args(jm, s, dfl, mld, 1, 1800.)
    with jax.disable_jit():
        ref = [np.asarray(a) for a in
               jnd._pair_exchange(*map(jnp.asarray, args))]
    out = tnd._pair_exchange(*map(_t, args))
    # the exchange acts, in density and in pressure space
    assert np.abs(ref[2]).max() > 0.
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize('case', ['fuk95', 'tripolar'])
@pytest.mark.parametrize('m,n', PARITIES)
def test_ndiff_matches_blom_tpu(models, tripolar, case, m, n):
    jm, tm = models if case == 'fuk95' else tripolar
    js, jdfl, mld = (_inputs(jm, 3 + m) if case == 'fuk95'
                     else _inputs(jm, 7 + m, t_noise=.05))
    delt1 = 1800. if case == 'fuk95' else 180.
    with jax.disable_jit():
        after = _np_fields(jnd.ndiff(jm.grid, jm.e, js, jdfl, m, n, delt1,
                                     mld))
    before = _np_fields(js)
    s = convert.state_from_numpy(before)
    out = tnd.ndiff(tm.grid, tm.e, s, convert.diffusion_fields_from_numpy(
        _np_fields(jdfl)), m, n, delt1, _t(np.asarray(mld)))
    assert np.abs(after['temp'][n] - before['temp'][n]).max() > 0.
    assert np.abs(after['utflx'][m]).max() > 0.
    assert np.abs(after['vtflx'][m]).max() > 0.
    bad = {k: v for k, v in _rel_errors(after, out).items() if v > 0.}
    assert not bad, bad


def test_ndiff_conserves_and_preserves_uniform(models):
    jm, tm = models
    n, m = 1, 0
    s0, dfl, mld = _inputs(jm, 5)
    s0 = convert.state_from_numpy(_np_fields(s0))
    tdfl = convert.diffusion_fields_from_numpy(_np_fields(dfl))
    g = tm.grid
    s1 = tnd.ndiff(g, tm.e, s0.clone(), tdfl, m, n, 1800., _t(mld))

    def content(c):
        return float((c * s0.dp[n] * g.scp2 * g.ip).sum())

    for name in ('temp', 'saln'):
        np.testing.assert_allclose(content(getattr(s1, name)[n]),
                                   content(getattr(s0, name)[n]), rtol=1e-12)
    np.testing.assert_allclose(content(s1.trc[n, 0]), content(s0.trc[n, 0]),
                               rtol=1e-12)
    wet = g.ip > 0
    assert torch.isfinite(s1.temp).all()
    np.testing.assert_allclose(s1.saln[n][:, wet].numpy(), 35., atol=1e-10)

    s0.trc.fill_(1.)
    s1 = tnd.ndiff(g, tm.e, s0.clone(), tdfl, m, n, 1800., _t(mld))
    np.testing.assert_allclose(s1.trc[n, 0][:, wet].numpy(), 1., atol=1e-10)


def test_neutral_run_matches_blom_tpu(tmp_path_factory):
    """The first step of standalone.run with ltedtp='neutral' and
    bench.py's physics against blom_tpu's compiled run (see the module
    docstring for why one step)."""
    jm = dataclasses.replace(shared_build(tmp_path_factory, jst.build_fuk95,
                                          **RUN_SIZE))
    tm = tst.build_fuk95(device='cpu', **RUN_SIZE)
    jm.par = jm.par._replace(ltedtp='neutral',
                             difest=jdf.DifestParams(egc=.85, egmndf=100.))
    tm.par = tm.par._replace(ltedtp='neutral',
                             difest=tdf.DifestParams(egc=.85, egmndf=100.))
    js, jclock = jst.run(jm, 1)
    model = dataclasses.replace(
        tm, state=convert.state_from_numpy(_np_fields(jm.state)))
    ts, tclock = tst.run(model, 1)
    assert tclock.nstep == jclock.nstep == 1
    errs = _rel_errors(_np_fields(js), ts)
    bad = {k: v for k, v in errs.items()
           if v > (1e-6 if k in PROGNOSTIC else RUN_TOL)}
    assert not bad, bad
    g = tm.grid
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[0].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
