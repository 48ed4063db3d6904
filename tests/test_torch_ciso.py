"""The port's carbon isotopes (blom_tpu_torch.bgc.ciso, BLOM's
use_cisonew) and NOINYOCISO against blom_tpu's, on CPU in f64.

- every function of ciso.py, sinking with the isotope sinkers, carchm
  and `hamocc_step` with the extended tracer index and the isotope
  parameters (ti, cp), from the same inputs made from a seed with numpy
  (tests/test_ciso.py's columns), blom_tpu run op by op
  (`jax.disable_jit()`), every output field within rtol = atol = 1e-12
  of its largest value, as tests/test_torch_bgc.py holds the base chain;
- `build_fuk95(use_bgc=True, use_ciso=True)` (31 tracers) equal to
  blom_tpu's, and its step at 24x8x8 with bench.py's physics phase by
  phase over both time-level parities and through three steps of `run`,
  at tests/test_torch_tracers.py's tolerances;
- the port's own properties of tests/test_ciso.py: under full ice one
  `hamocc_step` conserves the 13C inventory and scales the 14C inventory
  by c14dec to 1e-9; after a few steps delta13C of DIC stays within
  (-40, 20) permil over water."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.bgc import carchm as jcarchm
from blom_tpu.bgc import chemistry as jchem
from blom_tpu.bgc import ciso as jciso
from blom_tpu.bgc import processes as jproc
from blom_tpu.bgc import sinking as jsink
from blom_tpu.bgc import step as jbstep
from blom_tpu.bgc.params import BgcParams as JBgcParams
from blom_tpu.bgc.params import make_tracer_index as jmake_ti
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import difest as jdf
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import carchm as tcarchm
from blom_tpu_torch.bgc import chemistry as tchem
from blom_tpu_torch.bgc import ciso as tciso
from blom_tpu_torch.bgc import processes as tproc
from blom_tpu_torch.bgc import sinking as tsink
from blom_tpu_torch.bgc import step as tbstep
from blom_tpu_torch.bgc.params import (NBGC, BgcParams, BgcTracers as T,
                                       make_tracer_index)
from blom_tpu_torch.core.constants import onem
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from tests.test_ciso import _column as _ciso_column
from tests.test_torch_bgc import TOL, _close, _close_all, _np_fields, _t
from tests.test_torch_tracers import (PHASES, STEPS, _port, _port_state,
                                      _Ref, _rel_errors, _run_tol)

DTB = 180. / 86400.
TI, JTI = make_tracer_index(use_ciso=True), jmake_ti(use_ciso=True)
CP, JCP = tciso.CisoParams(), jciso.CisoParams()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_index_and_params_match_blom_tpu():
    assert TI.ntotal == JTI.ntotal == NBGC + 12
    assert TI.names == JTI.names
    assert tciso.CISO_NAMES == jciso.CISO_NAMES
    assert tciso.SAFEDIV == jciso.SAFEDIV
    assert CP._asdict() == JCP._asdict()
    for name in ('beta13', 'atm_c13', 'atm_c14', 'c14fac'):
        assert getattr(CP, name) == getattr(JCP, name), name
    for dtb in (DTB, 1., .5):
        assert CP.c14dec(dtb) == JCP.c14dec(dtb)
    assert tciso.extra_sinkers(TI) == jciso.extra_sinkers(JTI)


@pytest.fixture(scope='module')
def col():
    """tests/test_ciso.py's column with its isotope pools initialized,
    a wet mask with a dry column and a massless layer, phytoplankton
    below phytomi in a few cells (the unfractionated branch), and a
    scattered hydrogen ion."""
    oc, dz, temp, saln = (np.array(a) for a in _ciso_column(JTI))
    oc = np.array(jciso.init_ciso_tracers(jnp.asarray(oc), JTI, JCP,
                                          JBgcParams()))
    rng = np.random.default_rng(31)
    oc[T.phy, 0, 0] = 1.e-12
    oc[T.hi] = rng.uniform(5e-9, 2e-8, dz.shape)
    lyr = np.ones(dz.shape, bool)
    lyr[:, 0, 0] = False
    lyr[7, 1, 2] = False
    dz = np.where(lyr, dz, 0.)
    ptiestw = np.concatenate([np.zeros((1,) + dz.shape[1:]),
                              np.cumsum(dz, 0)])
    ptiestu = ptiestw[:-1] + .5 * dz
    return dict(oc=oc, dz=dz, temp=temp, saln=saln, lyr=lyr,
                ptiestu=ptiestu, rho=1.02 + .01 * rng.random(dz.shape),
                omask=np.where(lyr[0], 1., 0.))


def test_init_ciso_tracers_matches_blom_tpu(col):
    oc, _, _, _ = (np.array(a) for a in _ciso_column(JTI, seed=4))
    ref = jciso.init_ciso_tracers(jnp.asarray(oc), JTI, JCP, JBgcParams())
    port = tciso.init_ciso_tracers(_t(oc), TI, CP, BgcParams())
    _close(ref, port)
    np.testing.assert_array_equal(port[:NBGC].numpy(), oc[:NBGC])


def _co2star(col):
    t = np.clip(col['temp'], jchem.TEMP_MIN, jchem.TEMP_MAX)
    s = np.clip(col['saln'], jchem.SALN_MIN, jchem.SALN_MAX)
    prb = col['ptiestu'] * 98060. * 1.027e-6
    with jax.disable_jit():
        kj = jchem.kequi(*map(jnp.asarray, (t, s, prb)))
        ref = jciso.co2star_from_hi(jnp.asarray(col['oc']),
                                    jnp.asarray(col['rho']), kj)
    port = tciso.co2star_from_hi(_t(col['oc']), _t(col['rho']),
                                 tchem.kequi(_t(t), _t(s), _t(prb)))
    return ref, port


def test_co2star_from_hi_matches_blom_tpu(col):
    _close(*_co2star(col))


@pytest.mark.parametrize('dtb', [DTB, .5])
def test_ocprod_ciso_matches_blom_tpu(col, dtb):
    """Each package's ocprod fluxes replayed on its isotopes; every row
    (the base rows unchanged) and the 13C budget closed."""
    rng = np.random.default_rng(5)
    strahl = rng.uniform(0., 300., col['dz'].shape[1:])
    satoxy = np.asarray(jchem.sat_oxygen(col['temp'], col['saln']))
    args = (col['oc'], col['temp'], col['dz'], strahl, satoxy, col['lyr'])
    co2_ref, co2_port = _co2star(col)
    with jax.disable_jit():
        _, _, flx = jproc.ocprod(*map(jnp.asarray, args), dtb, JBgcParams(),
                                 return_fluxes=True)
        ref = jciso.ocprod_ciso(jnp.asarray(col['oc']), JTI, flx, co2_ref,
                                jnp.asarray(col['lyr']), dtb, JBgcParams(),
                                JCP)
    oc = _t(col['oc'])
    _, _, flx = tproc.ocprod(*map(_t, args), dtb, BgcParams(),
                             return_fluxes=True)
    port = tciso.ocprod_ciso(oc, TI, flx, co2_port, _t(col['lyr']), dtb,
                             BgcParams(), CP)
    for i in range(TI.ntotal):
        _close(np.asarray(ref)[i], port[i], name=TI.names[i])
    np.testing.assert_array_equal(oc.numpy(), col['oc'])
    assert float((port[TI.phy13] - oc[TI.phy13]).abs().max()) > 0.


@pytest.mark.parametrize('fice', [0., .4])
def test_carchm_with_isotopes_matches_blom_tpu(col, fice):
    """carchm with ti/cp: the isotope exchange, shell dissolution and
    14C decay after the base carbonate chemistry, every tracer and every
    diagnostic (co2flux13/14 among them)."""
    rng = np.random.default_rng(9)
    H = col['dz'].shape[1:]
    oc = col['oc'].copy()
    oc[T.calc] = rng.uniform(0., 1e-7, oc[T.calc].shape)
    oc[TI.calc13] = oc[T.calc] * .011
    oc[TI.calc14] = oc[T.calc] * .99
    oc[T.alkali, 12:] *= .93            # undersaturated: calcite dissolves
    kmle = rng.integers(0, 4, H).astype(np.int32)
    surf = (rng.uniform(0., 12., H), rng.uniform(99000., 103000., H),
            np.full(H, fice) + rng.uniform(0., .1, H) * (fice > 0))
    args = (oc, col['temp'], col['saln'], col['rho'], col['dz'],
            col['ptiestu'], col['lyr'], kmle, np.zeros(H)) + surf
    with jax.disable_jit():
        ref = jcarchm.carchm(*map(jnp.asarray, args), 360., JBgcParams(),
                             ti=JTI, cp=JCP)
    port = tcarchm.carchm(*map(_t, args), 360., BgcParams(), ti=TI, cp=CP)
    for i in range(TI.ntotal):
        _close(np.asarray(ref[0])[i], port[0][i], name=TI.names[i])
    _close(ref[1], port[1], name='satoxy')
    _close_all(ref[2], port[2])
    assert 'co2flux13' in port[2] and 'co2flux14' in port[2]
    # the isotope shells dissolve somewhere
    assert bool((port[0][TI.calc13] < _t(oc[TI.calc13])).any())


@pytest.mark.parametrize('wlin', [True, False])
@pytest.mark.parametrize('sedbypass', [True, False])
def test_sinking_with_isotopes_matches_blom_tpu(col, sedbypass, wlin):
    par = dict(sedbypass=sedbypass, use_wlin=wlin)
    args = (col['oc'], col['dz'], col['ptiestu'], col['omask'])
    with jax.disable_jit():
        ref = jsink.sinking(*map(jnp.asarray, args), DTB,
                            JBgcParams()._replace(**par),
                            extra=jciso.extra_sinkers(JTI))
    port = tsink.sinking(*map(_t, args), DTB, BgcParams(**par),
                         extra=tciso.extra_sinkers(TI))
    _close(ref[0], port[0], name='oc')
    _close_all(ref[1], port[1])
    assert {'pror13', 'pror14', 'prca13', 'prca14'} <= set(port[1])


def test_sinking_base_rows_unchanged_by_isotopes(col):
    """The base sinkers' arithmetic does not change when the isotope rows
    ride along: the base rows and fluxes are bit for bit those of the
    base call."""
    args = tuple(map(_t, (col['oc'], col['dz'], col['ptiestu'],
                          col['omask'])))
    base = tsink.sinking(*args, DTB, BgcParams())
    iso = tsink.sinking(*args, DTB, BgcParams(),
                        extra=tciso.extra_sinkers(TI))
    assert torch.equal(base[0][:NBGC], iso[0][:NBGC])
    for k, v in base[1].items():
        assert torch.equal(v, iso[1][k]), k


def test_delta_diagnostics_match_blom_tpu(col):
    for name in ('delta13c', 'delta14c'):
        ref = getattr(jciso, name)(jnp.asarray(col['oc']), JTI, JCP)
        _close(ref, getattr(tciso, name)(_t(col['oc']), TI, CP), name=name)


# ------------------------------------------------------ the BGC step

SIZE = dict(itdm=32, jtdm=16, kdm=12)     # as tests/test_torch_bgc.py


@pytest.fixture(scope='module')
def ciso_models():
    """Both packages' fuk95 with the BGC and the carbon isotopes."""
    return (jst.build_fuk95(use_bgc=True, use_ciso=True, **SIZE),
            tst.build_fuk95(use_bgc=True, use_ciso=True, device='cpu',
                            **SIZE))


def test_build_fuk95_with_isotopes_matches_blom_tpu(ciso_models):
    jm, tm = ciso_models
    assert tm.state.trc.shape[1] == jm.state.trc.shape[1] == 31
    np.testing.assert_array_equal(tm.state.trc.numpy(),
                                  np.asarray(jm.state.trc))
    assert tm.par.bgc_ti.names == jm.par.bgc_ti.names
    assert tm.par.bgc_cp._asdict() == jm.par.bgc_cp._asdict()
    assert tm.par.bgc._asdict() == jm.par.bgc._asdict()
    # init_bgc_tracers itself, from a state whose levels differ
    d = _np_fields(jm.state)
    d['dp'] = d['dp'].copy()
    d['dp'][0, -1] = 0.
    ref = jbstep.init_bgc_tracers(
        dataclasses.replace(jm.state, dp=jnp.asarray(d['dp'])), 0, jm.e,
        n=0, ti=JTI, cp=JCP)
    port = tbstep.init_bgc_tracers(convert.state_from_numpy(d), 0, tm.e,
                                   n=0, ti=TI, cp=CP)
    np.testing.assert_array_equal(port.trc.numpy(), np.asarray(ref.trc))


@pytest.mark.parametrize('n', [1, 0])
def test_hamocc_step_with_isotopes_matches_blom_tpu(ciso_models, n):
    """One hamocc_step with ti/cp on the initial state with perturbed
    tracers (isotope pools from them, a few organic ones negative),
    temperatures spanning the clip range, light, wind and partial ice, at
    level n: every tracer of both levels and every diagnostic."""
    jm, tm = ciso_models
    rng = np.random.default_rng(21 + n)
    d = _np_fields(jm.state)
    oc = np.array(_ciso_column(JTI, kk=SIZE['kdm'], jj=SIZE['jtdm'],
                               ii=SIZE['itdm'], seed=4)[0])
    oc = np.array(jciso.init_ciso_tracers(jnp.asarray(oc), JTI, JCP,
                                          JBgcParams()))
    oc[NBGC:] *= rng.uniform(.9, 1.1, oc[NBGC:].shape)
    # small negatives in every organic isotope pool, which trc_limitc
    # clips after sinking
    for nm in tciso.CISO_NAMES[2:]:
        oc[getattr(TI, nm), :, 1, :4] = -1.e-10
    wet = d['dp'][n] > 0
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
                                          f, 0, n, 1 - n, 360., ti=JTI,
                                          cp=JCP)
    ts = convert.state_from_numpy(d)
    tf = convert.bgc_forcing_from_numpy(f._asdict())
    port_s, port_d = tbstep.hamocc_step(tm.grid, tm.e, tm.par.bgc, ts, tf,
                                        0, n, 1 - n, 360., ti=TI, cp=CP)
    for lev in (0, 1):
        for i in range(TI.ntotal):
            _close(np.asarray(ref_s.trc)[lev, i], port_s.trc[lev, i],
                   name=f'trc[{lev}, {TI.names[i]}]')
    _close_all(ref_d, port_d)


def _inventory(s, rows_sco, rows_calc, rows_org, rcar):
    t = s.trc[0].double()
    d = s.dp[0].double() / onem
    org = sum(t[r] for r in rows_org)
    return float(((t[rows_sco] + t[rows_calc] + rcar * org) * d).sum())


def test_hamocc_step_conserves_13c_and_decays_14c():
    """tests/test_ciso.py:144-189 on the port: under full ice (no gas
    exchange) one step conserves the 13C inventory and scales the 14C
    inventory by c14dec, both to 1e-9."""
    m = tst.build_fuk95(itdm=16, jtdm=8, kdm=10, device='cpu')
    shape = (2, TI.ntotal) + tuple(m.state.dp.shape[-3:])
    s = dataclasses.replace(
        m.state, trc=torch.zeros(shape, dtype=torch.float64),
        trcold=torch.zeros(shape[1:], dtype=torch.float64))
    s = tbstep.init_bgc_tracers(s, 0, m.e, n=0, ti=TI, cp=CP)
    f = tbstep.zero_bgc_forcing(m.grid.shape)
    f = f._replace(fice=torch.ones_like(f.fice))
    par, dtsec = BgcParams(), 180.
    s1, _ = tbstep.hamocc_step(m.grid, m.e, par, s.clone(), f, 0, 0, 0,
                               dtsec, ti=TI, cp=CP)
    c13 = (TI.sco213, TI.calc13, (TI.doc13, TI.phy13, TI.zoo13, TI.det13))
    c14 = (TI.sco214, TI.calc14, (TI.doc14, TI.phy14, TI.zoo14, TI.det14))
    np.testing.assert_allclose(_inventory(s1, *c13, par.rcar),
                               _inventory(s, *c13, par.rcar), rtol=1e-9)
    np.testing.assert_allclose(_inventory(s1, *c14, par.rcar),
                               _inventory(s, *c14, par.rcar)
                               * CP.c14dec(dtsec / 86400.), rtol=1e-9)
    assert torch.isfinite(s1.trc).all()


# ------------------------------------------------ the NOINYOCISO step

ALE_SIZE = dict(itdm=24, jtdm=8, kdm=8)
CISO_PHASES = tuple(p for p in PHASES['ale'] if p != 'idlage')


class _CisoRef(_Ref):
    """blom_tpu's phases of the NOINYOCISO step (test_torch_tracers.py's
    ALE path without the age), hamocc with ti/cp, op by op."""

    def fn(self, name, m, n):
        if name != 'hamocc':
            return super().fn(name, m, n)
        jm = self.jm
        g, e, par = jm.grid, jm.e, jm.par

        def hamocc(s, dfl, x, d1):
            with jax.disable_jit():
                return jbstep.hamocc_step(g, e, par.bgc, s, jm.bgc_forcing,
                                          par.itrbgc, n, m, d1,
                                          ti=par.bgc_ti, cp=par.bgc_cp)[0]
        return hamocc


def _ciso_port(tm, name, m, n, d1, s, dfl, extra):
    if name == 'hamocc':
        g, e, par = tm.grid, tm.e, tm.par
        return tbstep.hamocc_step(g, e, par.bgc, s, tm.bgc_forcing,
                                  par.itrbgc, n, m, d1, ti=par.bgc_ti,
                                  cp=par.bgc_cp)[0]
    return _port(tm, 'ale', name, m, n, d1, s, dfl, extra)


def test_noinyociso_step_matches_blom_tpu(monkeypatch):
    """Every phase of the first two steps (both parities) from blom_tpu's
    state before it, within 1e-12 (barotp 1e-8); then three steps of
    standalone.run against blom_tpu's phases chained, at
    test_torch_tracers.py's tolerances; then the port's invariants:
    finite tracers, mass, and delta13C of DIC over water within
    (-40, 20) permil (tests/test_ciso.py:192-207)."""
    monkeypatch.setitem(PHASES, 'ale', CISO_PHASES)
    jm = jst.build_fuk95(use_bgc=True, use_ciso=True, **ALE_SIZE)
    tm = tst.build_fuk95(use_bgc=True, use_ciso=True, device='cpu',
                         **ALE_SIZE)
    jm.par = jm.par._replace(difest=jdf.DifestParams(egc=.85, egmndf=100.))
    tm.par = tm.par._replace(difest=tdf.DifestParams(egc=.85, egmndf=100.))
    assert tm.state.trc.shape[1] == 31
    np.testing.assert_array_equal(tm.state.trc.numpy(),
                                  np.asarray(jm.state.trc))
    rec, js = _CisoRef(jm, 'ale').run(3)
    bad = {}
    for step, name, m, n, d1, (s, dfl, extra), ref in rec:
        if step >= STEPS['ale']:
            continue
        out = _ciso_port(tm, name, m, n, d1, _port_state(s),
                         convert.diffusion_fields_from_numpy(
                             _np_fields(dfl)), extra)
        pairs = (list(zip(ref, out)) if name == 'diffus'
                 else [(ref[0] if name == 'momtum' else ref, out)])
        tol = 1e-8 if name == 'barotp' else TOL
        for r, o in pairs:
            errs = {k: v for k, v in _rel_errors(r, o).items() if v > tol}
            if errs:
                bad[(step, name)] = errs
    assert not bad, bad

    model = dataclasses.replace(tm, state=_port_state(jm.state))
    ts, clock = tst.run(model, 3)
    assert clock.nstep == 3
    errs = _rel_errors(js, ts)
    bad = {k: v for k, v in errs.items() if v > _run_tol('ale', k)}
    assert not bad, bad
    g = tm.grid
    assert torch.isfinite(ts.trc).all()
    mass0 = float((model.state.dp[1].sum(0) * g.scp2 * g.ip).sum())
    mass = float((ts.dp[0].sum(0) * g.scp2 * g.ip).sum())
    assert abs(mass - mass0) / mass0 < 1e-13
    wet = (ts.dp[0] > 1e-6) & (g.ip > 0)[None]
    d13 = tciso.delta13c(ts.trc[0], TI, CP)[wet]
    assert float(d13.min()) > -40. and float(d13.max()) < 20.
