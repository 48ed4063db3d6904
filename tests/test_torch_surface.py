"""The ben02 chain of the port (`phys/bulktf.py`, `phys/seaice.py`,
`phys/ben02.py`) against blom_tpu's, on CPU in f64.

Every output within 1e-12 of blom_tpu's, relative to its largest
magnitude (max |port - ref| / max |ref|), from the same inputs made from
a seed with numpy:

- the humidity functions `qsatw`, `dqsatw`, `qsati`, `dqsati` and
  `rhoair` from 150 to 320 K;
- `psiu` and `psitq` on both signs of zeta (0 included), `lkb` in each of
  its eight bins and on their edges, and 8 iterations of `bulktf`;
- `asflux` over a seeded atmosphere and ice cover, `thermf_ben02` in
  tests/test_ben02.py's freezing and melting cases (with seeded
  perturbations), and `sfcstr_ben02` without ice and under full cover;
- then tests/test_ben02.py's physical checks on the port's own results.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core import eos as jeos
from blom_tpu.drivers import standalone as jst
from blom_tpu.phys import ben02 as jb2
from blom_tpu.phys import bulktf as jbt
from blom_tpu.phys import seaice as jsi
from blom_tpu.phys import swabs as jsw
from blom_tpu_torch import convert
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.phys import ben02 as tb2
from blom_tpu_torch.phys import bulktf as tbt
from blom_tpu_torch.phys import seaice as tsi
from tests.torch_shared import shared_build

SIZE = dict(itdm=24, jtdm=8, kdm=8)
TOL = 1e-12
DT = 1800.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(obj):
    if hasattr(obj, '_asdict'):
        return {k: np.asarray(v) for k, v in obj._asdict().items()}
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _rel(ref, out):
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-300))


def _assert_close(ref, out, tol=TOL):
    """Every field (dataclass, NamedTuple, dict or tensor) within tol."""
    if isinstance(out, torch.Tensor):
        assert _rel(ref, out) <= tol
        return
    if isinstance(ref, dict):
        pairs = {k: (ref[k], out[k]) for k in ref}
    else:
        pairs = {k: (v, getattr(out, k)) for k, v in _np(ref).items()}
    bad = {k: e for k, (r, o) in pairs.items() if (e := _rel(r, o)) > tol}
    assert not bad, bad


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return (shared_build(tmp_path_factory, jst.build_fuk95, **SIZE),
            tst.build_fuk95(device='cpu', **SIZE))


def test_humidity_functions_match_blom_tpu():
    rng = np.random.default_rng(11)
    t = np.concatenate([[100., 150., 273.15], rng.uniform(150., 320., 200)])
    p = rng.uniform(9.e4, 1.05e5, t.shape)
    q = rng.uniform(0., .02, t.shape)
    for name in ('qsatw', 'dqsatw', 'qsati', 'dqsati'):
        ref = getattr(jb2, name)(jnp.asarray(t), jnp.asarray(p))
        _assert_close(ref, getattr(tb2, name)(_t(t), _t(p)))
    _assert_close(jb2.rhoair(jnp.asarray(t), jnp.asarray(q), jnp.asarray(p)),
                  tb2.rhoair(_t(t), _t(q), _t(p)))


def test_stability_functions_match_blom_tpu():
    rng = np.random.default_rng(12)
    zeta = np.concatenate([[0., -1e-13, 1e-13, -10., 10.],
                           rng.uniform(-5., 5., 200)])
    assert (zeta < 0.).any() and (zeta > 0.).any()
    for name in ('psiu', 'psitq'):
        ref = getattr(jbt, name)(jnp.asarray(zeta))
        out = getattr(tbt, name)(_t(zeta))
        assert torch.isfinite(out).all()
        _assert_close(ref, out)
    # each of the eight bins of lkb, their edges and beyond the last
    edges = np.array(tbt._LKB_RE)
    reu = np.concatenate([edges, edges * (1. - 1e-12), edges * 1.5,
                          [1e-3, .05, 5e3]])
    ref = jbt.lkb(jnp.asarray(reu))
    out = tbt.lkb(_t(reu))
    bins = np.clip(np.searchsorted(edges, reu, side='left'), 0, 7)
    assert set(bins) == set(range(8))
    for r, o in zip(ref, out):
        _assert_close(r, o)


def test_bulktf_iterations_match_blom_tpu():
    rng = np.random.default_rng(13)
    n = 300
    du = rng.uniform(0., 25., n)
    ta = rng.uniform(250., 305., n)
    ts = ta + rng.uniform(-8., 8., n)
    slp = np.full(n, 101325.)
    qa = .8 * np.asarray(jb2.qsatw(jnp.asarray(ta), jnp.asarray(slp)))
    qs = np.asarray(jb2.qsatw(jnp.asarray(ts), jnp.asarray(slp)))
    icec = rng.uniform(0., 1., n) * (rng.uniform(size=n) < .3)
    jc = [jnp.full(n, 1.e-3)] * 3 + [jnp.full(n, 1.e-4)]
    tc = [torch.full((n,), 1.e-3, dtype=torch.float64)] * 3 \
        + [torch.full((n,), 1.e-4, dtype=torch.float64)]
    for _ in range(8):
        jc = jbt.bulktf(jnp.asarray(du), 10., jnp.asarray(ta), 10.,
                        jnp.asarray(qa), 10., jnp.asarray(ts),
                        jnp.asarray(qs), jnp.asarray(icec), *jc)
        tc = tbt.bulktf(_t(du), 10., _t(ta), 10., _t(qa), 10., _t(ts),
                        _t(qs), _t(icec), *tc)
    for r, o in zip(jc, tc):
        assert torch.isfinite(o).all()
        _assert_close(r, o)
    assert ((tc[0] > 5e-4) & (tc[0] < 5e-3)).float().mean() > .9


def _atmosphere(H, seed, **kw):
    """neutral_clim(**kw) of both packages with seeded fluxes, winds,
    surface temperature and ice concentration."""
    rng = np.random.default_rng(seed)
    d = _np(jb2.neutral_clim(H, **kw))
    d['tsrf_d'] = d['tsrf_d'] + rng.uniform(-3., 3., H)
    d['shtfl'] = rng.uniform(-40., 40., H)
    d['lhtfl'] = rng.uniform(-80., 20., H)
    d['tau_d'] = rng.uniform(0., .3, H)
    d['uwnd'] = rng.uniform(-1., 1., H)
    d['vwnd'] = rng.uniform(-1., 1., H)
    d['rice'] = rng.uniform(0., 1., H) * (rng.uniform(size=H) < .3)
    d['rnfins'] = rng.uniform(0., 1e-5, H)
    return (jb2.Ben02Clim(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.ben02_clim_from_numpy(d))


def _ice(ice, **fields):
    jice = dataclasses.replace(
        ice, **{k: jnp.asarray(v) for k, v in fields.items()})
    return jice, convert.seaice_from_numpy(_np(jice))


def _both_asflux(jm, tm, clim, ice, tml, sml):
    jc, tc = clim
    ji, ti = ice
    b = jb2.init_ben02(jm.grid.shape)
    ref = jb2.asflux(jm.e, b, jc, ji, jnp.asarray(tml), jnp.asarray(sml))
    out = tb2.asflux(tm.e, convert.ben02_state_from_numpy(_np(b)), tc, ti,
                     _t(tml), _t(sml))
    return ref, out


def test_asflux_matches_blom_tpu(models):
    jm, tm = models
    H = jm.grid.shape
    rng = np.random.default_rng(14)
    clim = _atmosphere(H, 15)
    ice = _ice(jsi.init_seaice(H),
               ficem=rng.uniform(0., .9, H) * (rng.uniform(size=H) < .4),
               ticem=rng.uniform(255., 272., H))
    tml = rng.uniform(271., 300., H)
    sml = rng.uniform(33., 36., H)
    ref, out = _both_asflux(jm, tm, clim, ice, tml, sml)
    _assert_close(ref, out)
    assert bool(torch.isfinite(out.nsf).all())


def _thermf_case(jm, tm, case):
    """tests/test_ben02.py's freezing ('cold') or melting ('warm') case,
    perturbed from a seed: (asflux's Ben02State, the climatology, the ice
    state, the top layer and the shortwave fields) of both packages."""
    H = jm.grid.shape
    rng = np.random.default_rng(16 if case == 'cold' else 17)
    sotl = 35. + rng.uniform(-1., 1., H)
    if case == 'cold':
        clim = _atmosphere(H, 18, dswrf=0., tsrf=248.)
        ice = _ice(jsi.init_seaice(H))
        totl = np.asarray(jeos.tfrz(jm.e, jnp.asarray(sotl))) + .001
        dp1 = np.full(H, 5. * 9806.)
    else:
        clim = _atmosphere(H, 19, dswrf=300., tsrf=295.)
        ice = _ice(jsi.init_seaice(H), ficem=rng.uniform(.3, .7, H),
                   hicem=rng.uniform(.1, .4, H),
                   hsnwm=rng.uniform(0., .05, H),
                   tsrfm=np.full(H, 270.), ticem=np.full(H, 270.),
                   iagem=rng.uniform(0., 100., H))
        totl = 6. + rng.uniform(-1., 1., H)
        dp1 = np.full(H, 20. * 9806.)
    b = _both_asflux(jm, tm, clim, ice, totl + 273.15, sotl)
    sw = jsw.init_swabs(H, 'jerlov', 3)
    top = (dp1, totl, sotl, np.zeros(H))
    return b, clim, ice, top, sw


def _both_thermf(jm, tm, case):
    (jb, tb), (jc, tc), (ji, ti), top, sw = _thermf_case(jm, tm, case)
    ref = jb2.thermf_ben02(jm.grid, jm.e, jb, jc, ji,
                           *(jnp.asarray(a) for a in top), sw.swfc2,
                           sw.swal2, DT)
    out = tb2.thermf_ben02(tm.grid, tm.e, tb, tc, ti, *(_t(a) for a in top),
                           _t(sw.swfc2), _t(sw.swal2), DT)
    return ji, ref, ti, out


@pytest.mark.parametrize('case', ['cold', 'warm'])
def test_thermf_ben02_matches_blom_tpu(models, case):
    """The ice step and the fluxes; then tests/test_ben02.py's checks on
    the port's result: ice grows under the cold atmosphere (within
    [0, fice_max], hice >= 0, finite salt flux, a heat flux over water),
    and the ice volume shrinks under the warm one."""
    jm, tm = models
    ji, (jice, jflx), ti, (tice, tflx) = _both_thermf(jm, tm, case)
    _assert_close(jice, tice)
    _assert_close(jflx, tflx)
    wet = tm.grid.ip > 0
    if case == 'cold':
        fice = tice.ficem[wet]
        assert bool((fice > 0.).any())
        assert bool((fice <= tsi.fice_max + 1e-12).all())
        assert bool((tice.hicem[wet] >= 0.).all())
        assert bool(torch.isfinite(tflx['salflx']).all())
        assert bool((tflx['surflx'][wet] != 0.).any())
    else:
        vol0 = float((ti.ficem * ti.hicem)[wet].sum())
        vol1 = float((tice.ficem * tice.hicem)[wet].sum())
        assert vol1 < vol0


def test_sfcstr_ben02_matches_blom_tpu(models):
    """Without ice the wind stress alone; under full cover (fice 1, 2 m)
    with zero ice-ocean stress the stress vanishes at the u points
    (tests/test_ben02.py)."""
    jm, tm = models
    H = jm.grid.shape
    jc, tc = _atmosphere(H, 20)
    b = jb2.init_ben02(H)
    b = dataclasses.replace(b, taufac=jnp.asarray(
        np.random.default_rng(21).uniform(.5, 1.5, H)))
    tb = convert.ben02_state_from_numpy(_np(b))
    out = {}
    for name, fields in (('open', {}),
                         ('ice', dict(ficem=np.ones(H),
                                      hicem=np.full(H, 2.)))):
        ji, ti = _ice(jsi.init_seaice(H), **fields)
        ref = jb2.sfcstr_ben02(jm.grid, b, jc, ji)
        out[name] = tb2.sfcstr_ben02(tm.grid, tb, tc, ti)
        for r, o in zip(ref, out[name]):
            _assert_close(r, o)
    iu = tm.grid.iu > 0
    assert float(out['open'][0][iu].abs().max()) > 0.
    assert float(out['ice'][0][iu].abs().max()) < 1e-12


def test_constructors_match_blom_tpu(models):
    """init_seaice, init_ben02 and neutral_clim give blom_tpu's fields,
    and tests/test_ben02.py's neutral asflux checks hold on the port."""
    jm, tm = models
    H = jm.grid.shape
    for jf, tf in ((jsi.init_seaice, tsi.init_seaice),
                   (jb2.init_ben02, tb2.init_ben02)):
        _assert_close(jf(H), tf(H, device='cpu'), 0.)
    _assert_close(jb2.neutral_clim(H, dswrf=10., tsrf=280., slpr=1e5),
                  tb2.neutral_clim(H, dswrf=10., tsrf=280., slpr=1e5,
                                   device='cpu'), 0.)
    b = tb2.asflux(tm.e, tb2.init_ben02(H, device='cpu'),
                   tb2.neutral_clim(H, device='cpu'),
                   tsi.init_seaice(H, device='cpu'),
                   torch.full(H, 288.5, dtype=torch.float64),
                   torch.full(H, 35., dtype=torch.float64))
    np.testing.assert_allclose(b.swa.numpy(), 150. * (1. - .065), rtol=1e-6)
    assert bool((b.nsf.abs() < 500.).all()) and bool((b.dfl < 0.).all())
    assert bool((b.ustarw >= 0.).all()) and bool((b.eva < 1e-3).all())
    assert teos.tfrz(tm.e, 35.) == jeos.tfrz(jm.e, 35.)
