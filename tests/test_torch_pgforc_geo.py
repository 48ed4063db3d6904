"""The port's geopotential pressure-gradient force against blom_tpu's and
against the loop-level oracle, on CPU in f64.

- `_side_eval` on random columns whose interpolation pressures also lie
  above the surface and below the bottom (the layer index clamped), with
  massless layers, within 1e-12 relative;
- `pgforc(..., 'geopotential')` on fuk95 at 32x12x8 from the state the
  port reaches in four steps (vanishing layers, tilted interfaces), both
  time-level parities, every field within 1e-12 of blom_tpu's; and
  against tests/oracles/pgforc_oracle.py at tests/test_pgforc_oracle.py's
  tolerances;
- an unknown method raises ValueError in both packages;
- chip_smoke's deck D (the main path's variants with PGFMTH =
  'geopotential') through both packages' build_case as fuk95: the same
  parameters, and pgforc from the built state within 1e-12.  As the
  channel, deck D runs in tests/test_torch_case.py with decks A-C (its
  build and one step against blom_tpu's, op by op)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.drivers import case as jcase
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import pgforc as jg
from blom_tpu_torch import convert
from blom_tpu_torch.drivers import case as tcase
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import pgforc as tg
from chip_smoke import DECK_PGFMTH, deck_text
from tests.oracles import pgforc_oracle as orc
from tests.test_torch_tracers import _np_fields, _rel_errors
from tests.torch_shared import shared_build

TOL = 1e-12
SIZE = dict(itdm=32, jtdm=12, kdm=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def test_side_eval_matches_blom_tpu():
    rng = np.random.default_rng(21)
    kk, H = 9, (5, 7)
    dp = rng.uniform(0., 4e5, (kk,) + H)
    dp[rng.uniform(size=dp.shape) < .3] = 0.
    p = np.concatenate([np.zeros((1,) + H), np.cumsum(dp, 0)])
    temp = rng.uniform(-1., 25., (kk,) + H)
    saln = rng.uniform(33., 37., (kk,) + H)
    phi = rng.normal(0., 1e3, (kk + 1,) + H)
    phip = rng.normal(0., 1e2, (kk + 1,) + H)
    # above the surface, inside, on interfaces and below the bottom
    prs = rng.uniform(-1e5, p[-1].max() + 1e5, (kk,) + H)
    prs[0, 0] = p[3, 0]
    ref = jg._side_eval(*map(jnp.asarray, (p, temp, saln, phi, phip, prs)))
    out = tg._side_eval(*map(_t, (p, temp, saln, phi, phip, prs)))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max())


@pytest.fixture(scope='module')
def advanced(tmp_path_factory):
    """Both fuk95 models at SIZE with the state the port reaches in four
    steps."""
    tm = tst.build_fuk95(device='cpu', **SIZE)
    s, _ = tst.run(tm, 4)
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **SIZE)
    js = dataclasses.replace(jm.state, **{
        k: jnp.asarray(v) for k, v in _np_fields(s).items()})
    return jm, tm, js, s


@pytest.mark.parametrize('m,n', [(0, 1), (1, 0)])
def test_pgforc_geopotential_matches_blom_tpu(advanced, m, n):
    jm, tm, js, s = advanced
    ref = jg.pgforc(jm.grid, jm.e, js, m, n, 'geopotential')
    out = tg.pgforc(tm.grid, tm.e, s.clone(), m, n, 'geopotential')
    bad = {k: v for k, v in _rel_errors(ref, out).items() if v > TOL}
    assert not bad, bad
    # the method differs from the default
    de = tg.pgforc(tm.grid, tm.e, s.clone(), m, n)
    assert not torch.equal(de.pgfx[n], out.pgfx[n])


def test_pgforc_geopotential_matches_oracle(advanced):
    """tests/test_pgforc_oracle.py on the port, at its tolerances."""
    _, tm, _, s = advanced
    n = 1
    g = tm.grid
    out = tg.pgforc(g, tm.e, s.clone(), 0, n, 'geopotential')
    ip, iu, iv = (getattr(g, k).numpy() for k in ('ip', 'iu', 'iv'))
    want = orc.oracle_pgforc_geo(
        ip, iu, iv, *(a.numpy() for a in (
            s.dp[n], s.temp[n], s.saln[n], s.phi[g.kk], s.pb_p, s.pbu_p,
            s.pbv_p)))
    np.testing.assert_allclose(out.dpu[n].numpy() * iu, want['dpu'] * iu,
                               rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(out.dpv[n].numpy() * iv, want['dpv'] * iv,
                               rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(out.phi.numpy()[:, ip > 0],
                               want['phi'][:, ip > 0], rtol=1e-9, atol=1e-8)
    for nm, mask in (('pgfx', iu), ('pgfy', iv), ('pgfxm', iu),
                     ('pgfym', iv), ('xixp', iu), ('xixm', iu),
                     ('xiyp', iv), ('xiym', iv)):
        a = getattr(out, nm)[n].numpy() * mask
        b = want[nm] * mask
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-9 * max(1., np.abs(b).max()),
                                   err_msg=nm)


def test_unknown_pgfmth_raises(advanced):
    jm, tm, js, s = advanced
    with pytest.raises(ValueError, match='unsupported'):
        jg.pgforc(jm.grid, jm.e, js, 0, 1, 'sigma')
    with pytest.raises(ValueError, match='unsupported'):
        tg.pgforc(tm.grid, tm.e, s.clone(), 0, 1, 'sigma')


def test_deck_d_builds_and_runs_pgforc_as_blom_tpu(tmp_path):
    """Deck D as fuk95 (the deck's default 156x32x12) through both
    packages' build_case."""
    assert DECK_PGFMTH['D'] == 'geopotential'
    path = tmp_path / 'limits_fuk95_D'
    path.write_text(deck_text('D', 'float64', 'fuk95'))
    jm, jcfg = jcase.build_case(str(path))
    tm, tcfg = tcase.build_case(str(path), device='cpu')
    assert tcfg.pgfmth == jcfg.pgfmth == 'geopotential'
    for f in ('baclin', 'lstep', 'dlt', 'pgfmth', 'advmth',
              'cppm_compatibility', 'cppm_limiting', 'vcoord_isopyc'):
        assert getattr(tm.par, f) == getattr(jm.par, f), f
    for f in ('momtum', 'barotp', 'ale', 'vmix', 'difest'):
        assert getattr(tm.par, f)._asdict() == \
            getattr(jm.par, f)._asdict(), f
    ref = jg.pgforc(jm.grid, jm.e, jm.state, 0, 1, jm.par.pgfmth)
    out = tg.pgforc(tm.grid, tm.e,
                    convert.state_from_numpy(_np_fields(jm.state)), 0, 1,
                    tm.par.pgfmth)
    bad = {k: v for k, v in _rel_errors(ref, out).items() if v > TOL}
    assert not bad, bad
