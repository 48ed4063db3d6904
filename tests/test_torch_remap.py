"""The port's incremental-remapping advection (advmth='remap') against
blom_tpu's, on CPU in f64.

- `triint` and `penint` on seeded vertices: exactly.
- `remap_layer` on test_remap_oracle.py's seeded layers (random land,
  80 % wet: cells with one wet face neighbour and cells whose faces are
  wet and diagonal dry; flux areas of both signs within the CFL bound;
  corner velocities that sweep), in three periodicities and with 1 and
  3 tracers: exactly, and the same call with a leading layer axis gives
  each layer's result.
- `advect(advmth='remap')` on fuk95 at 24x8x8 with seeded velocities and
  3 passive tracers, in both time-level parities: within 1e-12 relative
  (measured: bit for bit).
- The port's `remap_layer` against the loop-level oracle
  tests/oracles/remap_oracle.py at test_remap_oracle.py's parameters and
  tolerance (1e-9).
- The properties of tests/test_remap.py on the port: zero velocity is the
  identity, mass and tracer are conserved, a uniform tracer stays
  uniform, translation makes no new extrema.
- On a tripolar grid advect refuses remap, with blom_tpu's message; any
  advmth but 'remap' runs the CPPM sweeps, as in blom_tpu.
- `standalone.run` with advmth='remap' for two steps (both parities)
  against blom_tpu's compiled run, within test_torch_isopyc.py's run
  tolerance (prognostic fields 1e-6, every field 1e-4; measured 1.3e-8
  for v and 3.5e-6 for vflx).

blom_tpu's remap is plain jnp (no scan), run eagerly.  Each blom_tpu
reference here serves one test and is computed in it; the blom_tpu model
is built once per test run (tests/torch_shared.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import advect as ja
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import remap as jr
from blom_tpu_torch import convert
from blom_tpu_torch.core.grid import finish_grid
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import advect as ta
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import remap as tr
from tests.oracles import remap_oracle as orc
from tests.test_remap_oracle import _setup
from tests.torch_shared import shared_build

SIZE = dict(itdm=24, jtdm=8, kdm=8)
PERIODIC = {'periodic_i': (True, False), 'closed': (False, False),
            'periodic_j': (False, True)}
NTR = (1, 3)
NTR_ADVECT = 3
PARITIES = ((0, 1), (1, 0))
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
    """{field: max|ref - port| / max|ref|} over the non-empty fields."""
    out = {}
    for name, a in _np_fields(ref).items():
        if a.size:
            b = getattr(port, name).numpy()
            out[name] = float(np.abs(a - b).max()
                              / max(np.abs(a).max(), 1e-300))
    return out


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _layer_case(periodic, ntr, seed=0):
    """test_remap_oracle.py's layer on both packages' grids: (jax grid,
    port grid, the numpy inputs pbmin, pbu, pbv, plo, cau, cav, dp,
    tr)."""
    pi, pj = PERIODIC[periodic] if isinstance(periodic, str) else periodic
    (grid, ip, iu, iv, dp, plo, pbmin, pbu, pbv, cau, cav,
     trs) = _setup(seed=seed, ntr=ntr, periodic_i=pi, periodic_j=pj)
    ones = np.ones(dp.shape)
    gs = 20e3
    tgrid = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=np.asarray(grid.depths),
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=pi, periodic_j=pj, kk=1, baclin=1800.)
    return grid, tgrid, (pbmin, pbu, pbv, plo, cau, cav, dp, trs)


def _seeded_state(grid, s, ntr, seed):
    """fuk95's state with seeded velocities (both signs, up to 0.5 m/s)
    and `ntr` seeded passive tracers."""
    rng = np.random.default_rng(seed)
    shape = s.u.shape
    iu, iv = np.asarray(grid.iu), np.asarray(grid.iv)
    trc = rng.uniform(0., 5., (2, ntr) + shape[1:])
    return dataclasses.replace(
        s, u=jnp.asarray(rng.uniform(-.5, .5, shape) * iu),
        v=jnp.asarray(rng.uniform(-.5, .5, shape) * iv),
        trc=jnp.asarray(trc))


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_fuk95, **SIZE),
            tst.build_fuk95(device='cpu', **SIZE))


def test_triint_penint_match_blom_tpu():
    rng = np.random.default_rng(5)
    v = [rng.uniform(-.5, .5, (6, 7)) for _ in range(10)]
    ac = rng.uniform(1e8, 4e8, (6, 7))
    for fj, ft, nv in ((jr.triint, tr.triint, 6),
                       (jr.penint, tr.penint, 10)):
        ref = fj(jnp.asarray(ac), *map(jnp.asarray, v[:nv]))
        out = ft(_t(ac), *map(_t, v[:nv]))
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize('ntr', NTR)
@pytest.mark.parametrize('periodic', PERIODIC)
def test_remap_layer_matches_blom_tpu(periodic, ntr):
    grid, tgrid, args = _layer_case(periodic, ntr)
    pbmin, pbu, pbv, plo, cau, cav, dp, trs = args
    # the cases the layer is built to hold
    iu, iv, ip = (getattr(tgrid, k).numpy() > 0
                  for k in ('iu', 'iv', 'ip'))
    w_ok, e_ok = iu, np.asarray(tgrid.ip1(tgrid.iu)) > 0
    s_ok = iv
    one_sided = ip & (w_ok != e_ok)
    dry_diag = ip & w_ok & s_ok & ~(np.asarray(tgrid.im1(tgrid.jm1(
        tgrid.ip))) > 0)
    assert one_sided.any() and dry_diag.any()
    assert (cau > 0).any() and (cau < 0).any()
    cu = torch.where(_t(cau) > 0, _t(cau) * tgrid.im1(tgrid.scp2i),
                     _t(cau) * tgrid.scp2i) * tgrid.iu
    cv = torch.where(_t(cav) > 0, _t(cav) * tgrid.jm1(tgrid.scp2i),
                     _t(cav) * tgrid.scp2i) * tgrid.iv
    cuc, cvc = tr._corner_velocities(tgrid, cu, cv)
    assert (cvc > 0).any() and (tgrid.jp1(cvc) < 0).any()

    ref = jr.remap_layer(grid, *map(jnp.asarray, args))
    out = tr.remap_layer(tgrid, *map(_t, args))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    # with a leading layer axis: three layers in one call
    kk = 3
    k_args = [_t(np.stack([a] * kk)) for a in (plo, cau, cav, dp)]
    outk = tr.remap_layer(tgrid, _t(pbmin), _t(pbu), _t(pbv), *k_args,
                          _t(np.stack([trs] * kk, 1)))
    for o, ok in zip(out, outk):
        for k in range(kk):
            np.testing.assert_array_equal(
                (ok[:, k] if ok.dim() == 4 else ok[k]).numpy(), o.numpy())


@pytest.mark.parametrize('m,n', PARITIES)
def test_advect_remap_matches_blom_tpu(models, m, n):
    jm, tm = models
    js = _seeded_state(jm.grid, jm.state, NTR_ADVECT, m)
    before = _np_fields(js)
    after = _np_fields(ja.advect(jm.grid, js, jm.dfl, jm.coeffs_i,
                                 jm.coeffs_j, m, n, jm.clock.delt1,
                                 jm.par.dlt, 'remap'))
    s = convert.state_from_numpy(before)
    out = ta.advect(tm.grid, s, tm.dfl, tm.coeffs_i, tm.coeffs_j, m, n,
                    tm.clock.delt1, tm.par.dlt, 'remap')
    errs = {}
    for name, a in after.items():
        if a.size:
            b = getattr(out, name).numpy()
            errs[name] = float(np.abs(a - b).max()
                               / max(np.abs(a).max(), 1e-300))
    # the flow moves mass and every tracer
    assert np.abs(after['uflx'][m]).max() > 0.
    assert np.abs(after['vflx'][m]).max() > 0.
    assert (np.abs(after['trc'][n] - before['trc'][n]).max((1, 2, 3))
            > 0.).all()
    bad = {k: v for k, v in errs.items() if v > 1e-12}
    assert not bad, bad


def test_other_advmth_runs_cppm(models):
    """An advmth other than 'remap' runs the CPPM sweeps, as blom_tpu's
    advect does."""
    jm, tm = models
    before = _np_fields(_seeded_state(jm.grid, jm.state, NTR_ADVECT, 0))
    out = [ta.advect(tm.grid, convert.state_from_numpy(before), tm.dfl,
                     tm.coeffs_i, tm.coeffs_j, 0, 1, tm.clock.delt1,
                     tm.par.dlt, advmth) for advmth in ('cppm', 'upwind')]
    for name, a in _np_fields(out[0]).items():
        np.testing.assert_array_equal(getattr(out[1], name).numpy(), a,
                                      err_msg=name)


@pytest.mark.parametrize('periodic_i,periodic_j',
                         [(True, False), (False, False)])
@pytest.mark.parametrize('seed', [0, 3])
def test_remap_layer_matches_oracle(periodic_i, periodic_j, seed):
    """tests/test_remap_oracle.py on the port, its parameters and its
    tolerance."""
    _, tgrid, args = _layer_case((periodic_i, periodic_j), 3, seed)
    pbmin, pbu, pbv, plo, cau, cav, dp, trs = args
    dp_new, tr_new, fdu, fdv, ftru, ftrv = (
        a.numpy() for a in tr.remap_layer(tgrid, *map(_t, args)))
    ip, iu, iv = (getattr(tgrid, k).numpy() for k in ('ip', 'iu', 'iv'))
    w_dp, w_tr, w_fdu, w_fdv, w_ftu, w_ftv = orc.remap_oracle(
        ip, iu, iv, tgrid.scp2.numpy(), tgrid.scp2i.numpy(),
        pbmin, pbu, pbv, plo, cau, cav, dp, trs,
        periodic_i=periodic_i, periodic_j=periodic_j)
    um, vm, pm = iu > 0, iv > 0, ip > 0
    fscale = max(np.abs(w_fdu).max(), np.abs(w_fdv).max(), 1.)
    np.testing.assert_allclose(fdu[um], w_fdu[um], rtol=1e-9,
                               atol=1e-9 * fscale)
    np.testing.assert_allclose(fdv[vm], w_fdv[vm], rtol=1e-9,
                               atol=1e-9 * fscale)
    tscale = max(np.abs(w_ftu).max(), np.abs(w_ftv).max(), 1.)
    np.testing.assert_allclose(ftru[:, um], w_ftu[:, um], rtol=1e-9,
                               atol=1e-9 * tscale)
    np.testing.assert_allclose(ftrv[:, vm], w_ftv[:, vm], rtol=1e-9,
                               atol=1e-9 * tscale)
    np.testing.assert_allclose(dp_new[pm], w_dp[pm], rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(tr_new[:, pm], w_tr[:, pm], rtol=1e-9,
                               atol=1e-9)


# ------------------------------------------- tests/test_remap.py's properties

@pytest.fixture(scope='module')
def chan():
    """test_remap.py's small all-wet fuk95 grid."""
    return tst.build_fuk95(itdm=32, jtdm=12, kdm=4, device='cpu').grid


def _chan_layer(grid, seed=1):
    """test_remap.py's _layer_setup, in the port."""
    rng = np.random.RandomState(seed)
    shape = grid.shape
    dp = _t(50. * 9806. * (1. + .2 * rng.rand(*shape))) * grid.ip
    trs = torch.stack([_t(10. + rng.rand(*shape)),
                       _t(35. + .5 * rng.rand(*shape))]) * grid.ip
    pbot = dp * 3.
    return (dp, trs, pbot, torch.minimum(pbot, grid.im1(pbot)),
            torch.minimum(pbot, grid.jm1(pbot)), dp * 1.5)


def test_remap_zero_velocity_identity(chan):
    dp, trs, pbmin, pbu, pbv, plo = _chan_layer(chan)
    z = torch.zeros_like(dp)
    dp2, tr2, fdu, fdv, ftru, ftrv = tr.remap_layer(
        chan, pbmin, pbu, pbv, plo, z, z, dp, trs)
    np.testing.assert_allclose(dp2.numpy(), dp.numpy(), atol=1e-9)
    wet = chan.ip.numpy() > 0
    np.testing.assert_allclose(tr2.numpy()[:, wet], trs.numpy()[:, wet],
                               rtol=1e-12)
    np.testing.assert_allclose(fdu.numpy(), 0., atol=1e-20)


def test_remap_conserves_mass_and_tracer(chan):
    dp, trs, pbmin, pbu, pbv, plo = _chan_layer(chan)
    rng = np.random.RandomState(3)
    shape = chan.shape
    cau = _t(.04 * np.cos(np.linspace(0, 2 * np.pi, shape[1]))[None, :]
             * np.ones(shape)) * chan.scuy * 9806. * chan.iu
    cav = _t(.0075 * rng.randn(*shape)) * chan.scvx * 9806. * chan.iv
    dp2, tr2, *_ = tr.remap_layer(chan, pbmin, pbu, pbv, plo, cau, cav,
                                  dp, trs)
    a = chan.scp2
    m0, m1 = float((dp * a).sum()), float((dp2 * a).sum())
    assert abs(m1 - m0) / m0 < 1e-12
    t0 = float((dp * trs[0] * a).sum())
    t1 = float((dp2 * tr2[0] * a).sum())
    assert abs(t1 - t0) / abs(t0) < 1e-9


def test_remap_uniform_tracer_preserved(chan):
    dp, trs, pbmin, pbu, pbv, plo = _chan_layer(chan)
    trs[0] = 7.5 * chan.ip
    rng = np.random.RandomState(4)
    shape = chan.shape
    cau = _t(.1 * rng.randn(*shape)) * chan.scuy * 9806. * chan.iu
    cav = _t(.1 * rng.randn(*shape)) * chan.scvx * 9806. * chan.iv
    _, tr2, *_ = tr.remap_layer(chan, pbmin, pbu, pbv, plo, cau, cav, dp,
                                trs)
    wet = chan.ip.numpy() > 0
    np.testing.assert_allclose(tr2[0].numpy()[wet], 7.5, rtol=5e-9)


def test_remap_monotone(chan):
    dp, trs, pbmin, pbu, pbv, plo = _chan_layer(chan)
    dp = torch.full(chan.shape, 50. * 9806., dtype=torch.float64) * chan.ip
    cau = .35 * chan.scp2 * chan.iu
    cav = .25 * chan.scp2 * chan.iv
    _, tr2, *_ = tr.remap_layer(chan, pbmin, pbu, pbv, plo, cau, cav, dp,
                                trs)
    wet = chan.ip.numpy() > 0
    t_old, t_new = trs[0].numpy()[wet], tr2[0].numpy()[wet]
    assert t_new.max() <= t_old.max() + 1e-7
    assert t_new.min() >= t_old.min() - 1e-7


def test_tripolar_refuses_remap():
    tm = tst.build_tripolar(itdm=16, jtdm=12, kdm=6, device='cpu')
    with pytest.raises(NotImplementedError,
                       match="advmth='remap' does not support tripolar"):
        ta.advect(tm.grid, tm.state.clone(), tm.dfl, tm.coeffs_i,
                  tm.coeffs_j, 0, 1, tm.clock.delt1, tm.par.dlt, 'remap')


def test_remap_run_matches_blom_tpu(models):
    """Two steps of standalone.run (the forward step and both
    parities) with bench.py's physics, against blom_tpu's compiled run."""
    jm, tm = (dataclasses.replace(mo) for mo in models)
    jm.par = jm.par._replace(advmth='remap',
                             difest=jdf.DifestParams(egc=.85, egmndf=100.))
    tm.par = tm.par._replace(advmth='remap',
                             difest=tdf.DifestParams(egc=.85, egmndf=100.))
    js, jclock = jst.run(jm, 2)
    model = dataclasses.replace(
        tm, state=convert.state_from_numpy(_np_fields(jm.state)))
    ts, tclock = tst.run(model, 2)
    assert tclock.nstep == jclock.nstep == 2
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items()
           if v > (1e-6 if k in PROGNOSTIC else RUN_TOL)}
    assert not bad, bad
    g = tm.grid
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[1].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
    assert float(((ts.saln[1] - 35.) * g.ip).abs().max()) < 1e-12
