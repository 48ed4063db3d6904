"""The port's BGC base chain (blom_tpu_torch.bgc) against blom_tpu's, on
CPU in f64.

Each function from the same inputs, made from a seed with numpy (the
columns of tests/test_bgc.py's `_column`), with blom_tpu run op by op
(`jax.disable_jit()`: its scans and fixed-trip loops then run as the
port's Python loops do).  Every output field within rtol = atol = 1e-12
of its largest value (max |port - ref| <= 1e-12 max |ref|), `carchm`
and `hamocc_step` too, though their 20-pass pH solve carries the ulp
differences of exp, log and pow (PyTorch's and XLA's differ by an ulp)
through every pass (measured: 3e-15 and 6e-16).  The carbon isotopes and
the sediment are held in tests/test_torch_ciso.py and
tests/test_torch_sediment.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.bgc import carchm as jcarchm
from blom_tpu.bgc import chemistry as jchem
from blom_tpu.bgc import inputs as jin
from blom_tpu.bgc import processes as jproc
from blom_tpu.bgc import sinking as jsink
from blom_tpu.bgc import step as jbstep
from blom_tpu.bgc.params import NBGC, BgcParams as JBgcParams
from blom_tpu.drivers import standalone as jst
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import carchm as tcarchm
from blom_tpu_torch.bgc import chemistry as tchem
from blom_tpu_torch.bgc import inputs as tin
from blom_tpu_torch.bgc import processes as tproc
from blom_tpu_torch.bgc import sinking as tsink
from blom_tpu_torch.bgc import step as tbstep
from blom_tpu_torch.bgc.params import BgcParams, BgcTracers as T
from blom_tpu_torch.drivers import standalone as tst
from tests.test_bgc import _column
from tests.torch_shared import shared_build

TOL = 1e-12
DTB = 180. / 86400.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(x):
    a = np.asarray(x)
    if a.dtype == bool:
        return torch.tensor(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32)
    return torch.tensor(a, dtype=torch.float64)


def _close(ref, port, tol=TOL, name=''):
    ref = _np(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else _np(port)
    assert port.shape == ref.shape, name
    scale = max(np.abs(ref).max(initial=0.), 1e-300)
    err = np.abs(port - ref).max(initial=0.)
    assert err <= tol * scale, (name, err / scale)


def _close_all(ref, port, tol=TOL):
    """Tuples, NamedTuples and dicts of fields, field by field."""
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(port)
        for k in ref:
            _close(ref[k], port[k], tol, k)
    else:
        assert len(ref) == len(port)
        names = getattr(ref, '_fields', range(len(ref)))
        for k, r, p in zip(names, ref, port):
            _close(r, p, tol, str(k))


@pytest.fixture(scope='module')
def col():
    """(oc, dz, temp, saln) of a 20-level column block, and depths,
    pressures, a wet mask with a dry column and a massless layer."""
    oc, dz, temp, saln = (_np(a) for a in _column())
    kk, jj, ii = dz.shape
    lyr = np.ones(dz.shape, bool)
    lyr[:, 0, 0] = False
    lyr[7, 1, 2] = False
    dz = np.where(lyr, dz, 0.)
    ptiestw = np.concatenate([np.zeros((1, jj, ii)), np.cumsum(dz, 0)])
    ptiestu = ptiestw[:-1] + .5 * dz
    rng = np.random.default_rng(11)
    return dict(oc=oc, dz=dz, temp=temp, saln=saln, lyr=lyr,
                ptiestu=ptiestu, prb=ptiestu * 98060. * 1.027e-6,
                rho=1.02 + .01 * rng.random(dz.shape),
                omask=np.where(lyr[0], 1., 0.),
                euph=(ptiestw[:-1] < 100.) & lyr)


def _jp():
    return JBgcParams()


def test_kequi_matches_blom_tpu(col):
    with jax.disable_jit():
        ref = jchem.kequi(col['temp'], col['saln'], col['prb'])
    port = tchem.kequi(_t(col['temp']), _t(col['saln']), _t(col['prb']))
    assert port._fields == ref._fields
    _close_all(ref, port)


def test_solve_h_and_dicsat_match_blom_tpu(col):
    t, s, prb = col['temp'], col['saln'], col['prb']
    oc, rho = col['oc'], col['rho']
    args = [oc[T.sco212] / rho, oc[T.alkali] / rho, oc[T.silica] / rho,
            oc[T.phosph] / rho]
    with jax.disable_jit():
        k = jchem.kequi(t, s, prb)
        ref = jchem.solve_h(s, *args, k, oc[T.hi])
        ref_sat = jchem.solve_dicsat(
            s[0], 1.2e-5 * np.ones_like(s[0]), args[1][0], args[2][0],
            args[3][0], jchem.Kequi(*[x[0] for x in k]))
    tk = tchem.kequi(_t(t), _t(s), _t(prb))
    port = tchem.solve_h(_t(s), *map(_t, args), tk, _t(oc[T.hi]))
    port_sat = tchem.solve_dicsat(
        _t(s[0]), _t(1.2e-5 * np.ones_like(s[0])), _t(args[1][0]),
        _t(args[2][0]), _t(args[3][0]), tchem.Kequi(*[x[0] for x in tk]))
    _close_all(ref, port)
    _close(ref_sat, port_sat)
    # no passes: the first guess and its carbonate alkalinity
    with jax.disable_jit():
        ref0 = jchem.solve_h(s, *args, k, oc[T.hi], niter=0)
    _close_all(ref0, tchem.solve_h(_t(s), *map(_t, args), tk,
                                   _t(oc[T.hi]), niter=0))


@pytest.mark.parametrize('name', ['sat_oxygen', 'sat_nitrogen', 'sat_n2o'])
def test_saturations_match_blom_tpu(col, name):
    ref = getattr(jchem, name)(col['temp'], col['saln'])
    _close(ref, getattr(tchem, name)(_t(col['temp']), _t(col['saln'])))


def test_schmidt_numbers_match_blom_tpu(col):
    t = np.linspace(-2., 35., 75)
    _close_all(jchem.schmidt_numbers(jnp.asarray(t)),
               tchem.schmidt_numbers(_t(t)))


def test_swr_absorption_matches_blom_tpu(col):
    with jax.disable_jit():
        ref = jproc.swr_absorption(*_j(col['oc'], col['dz'], col['lyr']),
                                   _jp())
    _close(ref, tproc.swr_absorption(_t(col['oc']), _t(col['dz']),
                                     _t(col['lyr']), BgcParams()))


@pytest.mark.parametrize('fluxes', [False, True])
def test_ocprod_matches_blom_tpu(col, fluxes):
    rng = np.random.default_rng(5)
    strahl = rng.uniform(0., 300., col['dz'].shape[1:])
    satoxy = _np(jchem.sat_oxygen(col['temp'], col['saln']))
    args = (col['oc'], col['temp'], col['dz'], strahl, satoxy, col['lyr'],
            DTB)
    with jax.disable_jit():
        ref = jproc.ocprod(*_j(*args[:-1]), DTB, _jp(),
                           return_fluxes=fluxes)
    port = tproc.ocprod(*map(_t, args[:-1]), DTB, BgcParams(),
                        return_fluxes=fluxes)
    assert len(port) == len(ref) == (3 if fluxes else 2)
    _close(ref[0], port[0], name='oc')
    for r, p in zip(ref[1:], port[1:]):
        _close_all(r, p)


def test_cyano_matches_blom_tpu(col):
    oc = col['oc'].copy()
    oc[T.ano3] *= .3          # nitrate deficit in part of the block
    args = (oc, col['temp'], col['dz'], col['euph'], DTB)
    ref = jproc.cyano(*_j(*args[:-1]), DTB, _jp())
    _close_all(ref, tproc.cyano(*map(_t, args[:-1]), DTB, BgcParams()))


@pytest.mark.parametrize('sedbypass', [True, False])
def test_sinking_matches_blom_tpu(col, sedbypass):
    args = (col['oc'], col['dz'], col['ptiestu'], col['omask'], DTB)
    with jax.disable_jit():
        ref = jsink.sinking(*_j(*args[:-1]), DTB,
                            _jp()._replace(sedbypass=sedbypass))
    port = tsink.sinking(*map(_t, args[:-1]), DTB,
                         BgcParams(sedbypass=sedbypass))
    _close(ref[0], port[0], name='oc')
    _close_all(ref[1], port[1])


def test_sink_speeds_constant_poc_matches_blom_tpu(col):
    par = dict(use_wlin=False)
    _close(jsink.sink_speeds(col['ptiestu'], DTB, _jp()._replace(**par)),
           tsink.sink_speeds(_t(col['ptiestu']), DTB, BgcParams(**par)))


def test_carchm_matches_blom_tpu(col):
    rng = np.random.default_rng(9)
    H = col['dz'].shape[1:]
    kmle = rng.integers(0, 4, H).astype(np.int32)
    surf = (rng.uniform(0., 12., H), rng.uniform(99000., 103000., H),
            rng.uniform(0., .3, H))
    args = (col['oc'], col['temp'], col['saln'], col['rho'], col['dz'],
            col['ptiestu'], col['lyr'], kmle, np.zeros(H)) + surf
    with jax.disable_jit():
        ref = jcarchm.carchm(*_j(*args), 360., _jp())
    port = tcarchm.carchm(*map(_t, args), 360., BgcParams())
    for r, p in zip(ref[:2], port[:2]):
        _close(r, p)
    _close_all(ref[2], port[2])


def test_inputs_match_blom_tpu(col):
    """apply_rivin, apply_ndep, update_boxatm and preftrc."""
    rng = np.random.default_rng(3)
    oc, dz = _j(col['oc'], col['dz'])
    kk, jj, ii = dz.shape
    kmle = np.broadcast_to((np.arange(kk) < 3)[:, None, None] * 1.,
                           dz.shape).copy()
    riv = rng.uniform(0., 1e-3, (jin.NRIV, jj, ii))
    kmle, riv = _j(kmle, riv)
    _close(jin.apply_rivin(oc, riv, dz, kmle, jnp.asarray(DTB), _jp()),
           tin.apply_rivin(_t(oc), _t(riv), _t(dz), _t(kmle),
                           torch.tensor(DTB, dtype=torch.float64),
                           BgcParams()))
    _close(jin.apply_rivin(oc, riv, dz, kmle, DTB, _jp()),
           tin.apply_rivin(_t(oc), _t(riv), _t(dz), _t(kmle), DTB,
                           BgcParams()))
    ndep = rng.uniform(0., 5e-4, (jj, ii))
    _close(jin.apply_ndep(oc, *_j(ndep), dz, *_j(col['lyr'][0]), DTB),
           tin.apply_ndep(_t(oc), _t(ndep), _t(dz), _t(col['lyr'][0]), DTB))
    flux = rng.normal(0., 1e-6, (jj, ii))
    scp2 = rng.uniform(1e9, 1e10, (jj, ii))
    _close(jin.update_boxatm(284.7, *_j(flux, scp2, col['omask'])),
           tin.update_boxatm(284.7, _t(flux), _t(scp2), _t(col['omask'])))
    ext = np.concatenate([oc, rng.uniform(0., 1e-4, (jin.NBGC_PREF - NBGC,
                                                     kk, jj, ii))])
    _close(jin.preftrc(*_j(ext), kmle), tin.preftrc(_t(ext), _t(kmle)))


# ---------------------------------------------------- the step in fuk95

SIZE = dict(itdm=32, jtdm=16, kdm=12)     # as tests/test_bgc.py:196


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope='module')
def bgc_models(tmp_path_factory):
    """Both packages' fuk95 with the BGC tracers."""
    return (shared_build(tmp_path_factory, jst.build_fuk95, use_bgc=True,
                         **SIZE),
            tst.build_fuk95(use_bgc=True, device='cpu', **SIZE))


def test_init_bgc_tracers_matches_blom_tpu(bgc_models):
    jm, tm = bgc_models
    assert tm.par.itrbgc == jm.par.itrbgc == 0
    np.testing.assert_array_equal(tm.state.trc.numpy(),
                                  np.asarray(jm.state.trc))
    for name in jm.bgc_forcing._fields:
        np.testing.assert_array_equal(
            getattr(tm.bgc_forcing, name).numpy(),
            np.asarray(getattr(jm.bgc_forcing, name)), err_msg=name)
    assert tm.par.bgc._asdict() == jm.par.bgc._asdict()


def test_hamocc_step_matches_blom_tpu(bgc_models):
    """One hamocc_step on the initial fuk95 state with perturbed tracers,
    temperatures spanning the clip range, light and wind, at level 1."""
    jm, tm = bgc_models
    rng = np.random.default_rng(21)
    d = _np_fields(jm.state)
    oc = _np(_column(kk=SIZE['kdm'], jj=SIZE['jtdm'], ii=SIZE['itdm'],
                     seed=4)[0])
    wet = d['dp'][1] > 0
    d['trc'] = np.stack([oc * wet, oc * wet]) / 1.025
    d['trc'][:, T.hi] = oc[T.hi] * wet
    d['temp'] = d['temp'] + rng.uniform(-6., 6., d['temp'].shape)
    H = jm.grid.shape
    f = jbstep.BgcForcing(swr=rng.uniform(0., 300., H),
                          fu10=rng.uniform(0., 15., H),
                          slp=rng.uniform(99000., 103000., H),
                          fice=rng.uniform(0., .5, H),
                          dustdep=rng.uniform(0., 1e-9, H))
    js = dataclasses.replace(jm.state, **{k: jnp.asarray(v)
                                          for k, v in d.items()
                                          if k in ('trc', 'temp')})
    with jax.disable_jit():
        ref_s, ref_d = jbstep.hamocc_step(jm.grid, jm.e, jm.par.bgc, js,
                                          f, 0, 1, 0, 360.)
    ts = convert.state_from_numpy(d)
    tf = convert.bgc_forcing_from_numpy(f._asdict())
    port_s, port_d = tbstep.hamocc_step(tm.grid, tm.e, tm.par.bgc, ts, tf,
                                        0, 1, 0, 360.)
    for lev in (0, 1):
        for i in range(NBGC):
            _close(np.asarray(ref_s.trc)[lev, i], port_s.trc[lev, i],
                   name=f'trc[{lev}, {i}]')
    _close_all(ref_d, port_d)
