"""The port's sediment (blom_tpu_torch.bgc.sediment) and
`hamocc_step_with_sediment` against blom_tpu's, on CPU in f64.

Each function from the same inputs, made from a seed with numpy
(tests/test_sediment.py's bottom water and solids, perturbed per
column, with a land column and columns whose pore water is hypoxic, so
that denitrification and sulfate reduction run), blom_tpu run op by op
(`jax.disable_jit()`).  Every output field within rtol = atol = 1e-12 of
its largest value; the step with the sediment on fuk95 with detritus
seeded as tests/test_sediment.py:157-190 seeds it, for two calls, every
tracer, every sediment field and every diagnostic."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.bgc import chemistry as jchem
from blom_tpu.bgc import sediment as jsd
from blom_tpu.bgc import step as jbstep
from blom_tpu.bgc.params import NBGC, BgcParams as JBgcParams
from blom_tpu.drivers import standalone as jst
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import chemistry as tchem
from blom_tpu_torch.bgc import sediment as tsd
from blom_tpu_torch.bgc import step as tbstep
from blom_tpu_torch.bgc.params import BgcParams, BgcTracers as T
from blom_tpu_torch.drivers import standalone as tst
from tests.test_torch_bgc import _close, _close_all, _t
from tests.torch_shared import shared_build

DT = 1800.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sed_np(sed):
    return {f.name: np.array(getattr(sed, f.name))
            for f in dataclasses.fields(sed)}


def _jsed(d):
    return jsd.SedState(**{k: jnp.asarray(v) for k, v in d.items()})


def _close_sed(ref, port):
    for f in dataclasses.fields(ref):
        _close(getattr(ref, f.name), getattr(port, f.name), name=f.name)


def test_constants_match_blom_tpu():
    for name in ('DZS', 'SEDDW', 'SEDDZI', 'PORWAT', 'PORSOL', 'PORWAH'):
        np.testing.assert_array_equal(getattr(tsd, name),
                                      getattr(jsd, name), err_msg=name)
    for name in ('KS', 'SOLFU', 'SEDICT', 'SILSAT', 'DISSO_POC',
                 'DISSO_SIL', 'DISSO_CACO3', 'SED_DENIT', 'SED_SULF',
                 'SED_O2THRESH_HYPOXIC', 'SED_O2THRESH_SULF',
                 'SED_NO3THRESH_SULF', 'CALFA', 'OPLFA', 'ORGFA', 'CLAFA',
                 'NPOWTRA', 'POW2OC'):
        assert getattr(tsd, name) == getattr(jsd, name), name
    for cls in ('SedSolid', 'SedPow'):
        for k, v in vars(getattr(jsd, cls)).items():
            if not k.startswith('_'):
                assert getattr(getattr(tsd, cls), k) == v, (cls, k)


def test_init_sediment_and_convert_match_blom_tpu():
    ref = jsd.init_sediment((3, 4))
    port = tsd.init_sediment((3, 4))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(port, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))
    conv = convert.sed_state_from_numpy(_sed_np(ref))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(conv, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))


@pytest.mark.parametrize('with_solrat', [False, True])
def test_powadi_matches_blom_tpu(with_solrat):
    rng = np.random.default_rng(3)
    H = (3, 5)
    bolay = rng.uniform(1., 60., H)
    omask = np.ones(H)
    omask[0, 0] = 0.
    solrat = (rng.uniform(0., 1e-3, (tsd.KS,) + H) if with_solrat
              else np.zeros((tsd.KS,) + H))
    sedb1 = rng.uniform(0., 1e-3, (tsd.KS + 1,) + H)
    with jax.disable_jit():
        ref = jsd.powadi(*map(jnp.asarray, (solrat, sedb1, bolay, omask)),
                         DT)
    _close(ref, tsd.powadi(*map(_t, (solrat, sedb1, bolay, omask)), DT))


def _setup(jj=3, ii=4, kk=6, seed=0):
    """tests/test_sediment.py's `_setup`, perturbed per column: a land
    column, bottom layers at several depths, and hypoxic pore water with
    little nitrate in a row (denitrification and sulfate reduction)."""
    rng = np.random.default_rng(seed)
    H = (jj, ii)
    sed = _sed_np(jsd.init_sediment(H))
    sed['sedlay'][tsd.SedSolid.sso12] = rng.uniform(.5e-4, 2e-4, (tsd.KS,)
                                                    + H)
    sed['sedlay'][tsd.SedSolid.ssc12] = rng.uniform(.5e-2, 2e-2,
                                                    (tsd.KS,) + H)
    sed['sedlay'][tsd.SedSolid.sssil] = rng.uniform(.5e-2, 2e-2,
                                                    (tsd.KS,) + H)
    sed['sedlay'][tsd.SedSolid.sster] = 500.
    sed['powtra'] *= rng.uniform(.8, 1.2, sed['powtra'].shape)
    sed['powtra'][tsd.SedPow.aox, :, 0] = rng.uniform(1e-7, 5e-7,
                                                      (tsd.KS, ii))
    sed['powtra'][tsd.SedPow.no3, 6:, 0] = 1e-7
    oc = np.zeros((NBGC, kk) + H)
    for idx, v in ((T.sco212, 2.25e-3), (T.alkali, 2.35e-3),
                   (T.phosph, 2.e-6), (T.oxygen, 1.5e-4),
                   (T.ano3, 25.e-6), (T.silica, 60.e-6),
                   (T.gasnit, 8.e-4)):
        oc[idx] = v * rng.uniform(.9, 1.1, (kk,) + H)
    oc[T.hi] = 1.e-8
    kbo = rng.integers(2, kk, H)
    kbo_onehot = (np.arange(kk)[:, None, None] == kbo[None]) * 1.
    bolay = rng.uniform(10., 60., H)
    omask = np.ones(H)
    omask[-1, -1] = 0.
    saln_bot = rng.uniform(34., 35.5, H)
    rrho_bot = rng.uniform(1.025, 1.03, H)
    temp_bot = rng.uniform(1., 4., H)
    pbar = rng.uniform(100., 500., H)
    flx = {'prorca': rng.uniform(0., 2e-8, H),
           'prcaca': rng.uniform(0., 1e-8, H),
           'silpro': rng.uniform(0., 2e-8, H),
           'produs': rng.uniform(0., 2e-9, H)}
    return dict(sed=sed, oc=oc, flx=flx, kbo_onehot=kbo_onehot,
                bolay=bolay, omask=omask, saln_bot=saln_bot,
                rrho_bot=rrho_bot, temp_bot=temp_bot, pbar=pbar)


def _keq(c):
    with jax.disable_jit():
        kj = jchem.kequi(*map(jnp.asarray, (c['temp_bot'], c['saln_bot'],
                                            c['pbar'])))
    kt = tchem.kequi(*map(_t, (c['temp_bot'], c['saln_bot'], c['pbar'])))
    return kj, kt


@pytest.mark.parametrize('seed', [0, 1])
def test_powach_matches_blom_tpu(seed):
    c = _setup(seed=seed)
    kj, kt = _keq(c)
    args = ('bolay', 'kbo_onehot', 'omask', 'saln_bot', 'rrho_bot')
    with jax.disable_jit():
        ref = jsd.powach(_jsed(c['sed']), jnp.asarray(c['oc']),
                         {k: jnp.asarray(v) for k, v in c['flx'].items()},
                         kj, *[jnp.asarray(c[a]) for a in args], DT,
                         JBgcParams())
    sed = convert.sed_state_from_numpy(c['sed'])
    oc = _t(c['oc'])
    port = tsd.powach(sed, oc, {k: _t(v) for k, v in c['flx'].items()},
                      kt, *[_t(c[a]) for a in args], DT, BgcParams())
    _close_sed(ref[0], port[0])
    _close(ref[1], port[1], name='oc')
    # the inputs are left as they were
    np.testing.assert_array_equal(oc.numpy(), c['oc'])
    np.testing.assert_array_equal(sed.powtra.numpy(), c['sed']['powtra'])


def test_bot_c03_and_dipowa_match_blom_tpu():
    c = _setup(seed=2)
    kj, kt = _keq(c)
    with jax.disable_jit():
        ref = jsd.bot_c03(jnp.asarray(c['oc']), jnp.asarray(c['kbo_onehot']),
                          kj, jnp.asarray(c['saln_bot']),
                          jnp.asarray(c['rrho_bot']), JBgcParams())
    _close(ref, tsd.bot_c03(_t(c['oc']), _t(c['kbo_onehot']), kt,
                            _t(c['saln_bot']), _t(c['rrho_bot']),
                            BgcParams()))
    args = ('bolay', 'kbo_onehot', 'omask')
    with jax.disable_jit():
        ref = jsd.dipowa(_jsed(c['sed']), jnp.asarray(c['oc']),
                         *[jnp.asarray(c[a]) for a in args], DT)
    port = tsd.dipowa(convert.sed_state_from_numpy(c['sed']), _t(c['oc']),
                      *[_t(c[a]) for a in args], DT)
    _close_sed(ref[0], port[0])
    _close(ref[1], port[1], name='oc')


def test_f32_sediment_stays_f32():
    """The per-layer numpy constants take the state's dtype: an f32
    sediment and ocean stay f32 through powach (with dipowa) and sedshi,
    as blom_tpu's do with 64-bit types off, as on a TPU."""
    c = _setup(seed=3)
    f32 = torch.float32
    kt = tchem.kequi(*(_t(c[k]).to(f32) for k in ('temp_bot', 'saln_bot',
                                                  'pbar')))
    sed = convert.sed_state_from_numpy(c['sed'], dtype=f32)
    sed, oc = tsd.powach(sed, _t(c['oc']).to(f32),
                         {k: _t(v).to(f32) for k, v in c['flx'].items()},
                         kt, *[_t(c[a]).to(f32) for a in (
                             'bolay', 'kbo_onehot', 'omask', 'saln_bot',
                             'rrho_bot')], DT, BgcParams())
    sed = tsd.sedshi(sed, _t(c['omask']).to(f32))
    assert oc.dtype == f32
    for f in dataclasses.fields(sed):
        assert getattr(sed, f.name).dtype == f32, f.name
        assert torch.isfinite(getattr(sed, f.name)).all(), f.name


@pytest.mark.parametrize('case', ['overfilled', 'random'])
def test_sedshi_matches_blom_tpu(case):
    """tests/test_sediment.py's overfilled top layer, and random solids
    over and under the layers' volume, with a land column."""
    H = (3, 4)
    sed = _sed_np(jsd.init_sediment(H))
    rng = np.random.default_rng(4)
    if case == 'overfilled':
        sed['sedlay'][tsd.SedSolid.sster, 0] = 5200.
        sed['sedlay'][tsd.SedSolid.sso12, 0] = 1.e-3
    else:
        sed['sedlay'] = rng.uniform(0., 1., sed['sedlay'].shape) \
            * np.array([5., 10., 10., 3000.])[:, None, None, None]
        sed['burial'] = rng.uniform(0., 1., sed['burial'].shape) \
            * np.array([1e-3, 1e-2, 1e-2, 10.])[:, None, None]
    omask = np.ones(H)
    omask[1, 2] = 0.
    with jax.disable_jit():
        ref = jsd.sedshi(_jsed(sed), jnp.asarray(omask))
    _close_sed(ref, tsd.sedshi(convert.sed_state_from_numpy(sed),
                               _t(omask)))


SIZE = dict(itdm=16, jtdm=8, kdm=8)     # as tests/test_sediment.py:164


def test_hamocc_step_with_sediment_matches_blom_tpu(tmp_path_factory):
    """Two calls from NOINYOC's initial state with the detritus seeded
    at 1e-6, at level 0 then 1: every tracer, every sediment field and
    every diagnostic; then the port's own gate of
    tests/test_sediment.py: the sediment gains POC in every wet
    column."""
    jm = shared_build(tmp_path_factory, jst.build_fuk95, use_bgc=True,
                      **SIZE)
    tm = tst.build_fuk95(use_bgc=True, device='cpu', **SIZE)
    b = jm.par.itrbgc
    js = dataclasses.replace(
        jm.state, trc=jm.state.trc.at[:, b + T.det].set(1.e-6))
    ts = tm.state.clone()
    ts.trc[:, b + T.det] = 1.e-6
    np.testing.assert_array_equal(ts.trc.numpy(), np.asarray(js.trc))
    jsed_, tsed = jsd.init_sediment(jm.grid.shape), tsd.init_sediment(
        tm.grid.shape)
    jf = jbstep.zero_bgc_forcing(jm.grid.shape)
    tf = tbstep.zero_bgc_forcing(tm.grid.shape)
    for n in (0, 1):
        with jax.disable_jit():
            js, jsed_, jd = jbstep.hamocc_step_with_sediment(
                jm.grid, jm.e, jm.par.bgc, js, jf, jsed_, b, n, 1 - n, DT)
        ts, tsed, td = tbstep.hamocc_step_with_sediment(
            tm.grid, tm.e, tm.par.bgc, ts, tf, tsed, b, n, 1 - n, DT)
        for lev in (0, 1):
            for i in range(NBGC):
                _close(np.asarray(js.trc)[lev, i], ts.trc[lev, i],
                       name=f'call {n}: trc[{lev}, {i}]')
        _close_sed(jsed_, tsed)
        _close_all(jd, td)
    assert torch.isfinite(ts.trc).all()
    for f in dataclasses.fields(tsed):
        assert torch.isfinite(getattr(tsed, f.name)).all(), f.name
    wet = tm.grid.ip > 0
    assert (tsed.sedlay[tsd.SedSolid.sso12, 0][wet] > 0.).all()
