"""The port's mixing phases against the loop-level oracles.

tests/oracles/ holds numpy transcriptions of the reference Fortran,
written independently of both packages; blom_tpu's own tests hold it to
them at 1e-9 (tests/test_eddtra_oracle.py, test_transport_oracles.py,
test_oracle_parity.py).  The same inputs, made from a seed with numpy,
go here through the port on CPU in f64, at the same 1e-9: eddtra with
the depletion limiter idle and firing on many columns, diffus with a
passive tracer, ale_vdifft column by column.

The isopycnic phases, on the random columns of blom_tpu's own oracle
tests (made here with the port's EOS) and at their tolerances: convec
against convec_oracle.py (test_convec_oracle.py:98-102), diapfl against
diapfl_oracle.py and its conservation checks
(test_diapfl_oracle.py:100-103, 129-136), and mxlayr.entrain_energy
against the exact-integral mxlayr_oracle.py (test_mxlayr.py:131-132).
No JAX is involved."""

import numpy as np
import pytest
import torch

from blom_tpu_torch.core import eos
from blom_tpu_torch.core.grid import finish_grid
from blom_tpu_torch.drivers import standalone
from blom_tpu_torch.dynamics import (ale_vdiff, convec, diapfl, diffus,
                                     eddtra, mxlayr)
from blom_tpu_torch.dynamics.cmnfld import CmnFields
from blom_tpu_torch.dynamics.diffusion_fields import zero_diffusion_fields
from blom_tpu_torch.phys.vmix import VmixFields
from tests.oracles import ale_vdiff_oracle as vo
from tests.oracles import convec_oracle as co
from tests.oracles import diapfl_oracle as dpo
from tests.oracles import diffus_oracle as do
from tests.oracles import eddtra_oracle as eo
from tests.oracles import mxlayr_oracle as mo


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


class _S:
    """The fields eddtra reads, at time level 0."""

    def __init__(self, **fields):
        for name, a in fields.items():
            setattr(self, name, _t(a)[None])


@pytest.mark.parametrize('kappa_scale', [1e3, 5e5])
def test_eddtra_matches_oracle(kappa_scale):
    """1e3: the limiter never fires; 5e5: it fires on many columns."""
    rng = np.random.default_rng(0)
    kk, jj, ii = 8, 10, 16
    depths = np.where(rng.uniform(size=(jj, ii)) < .8, 500., 0.)
    depths[0, :] = depths[-1, :] = 0.
    ones = np.ones((jj, ii))
    gs = 50e3
    g = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=depths, corioq=ones * 1e-4,
        coriop=ones * 1e-4, betafp=ones * 1e-11, periodic_i=True,
        periodic_j=False, kk=kk, baclin=1800.)
    ip, iu, iv = (a.numpy() for a in (g.ip, g.iu, g.iv))
    # random wet columns with a few massless bottom layers
    dp = rng.uniform(2e4, 4e5, (kk, jj, ii)) * ip
    nempty = rng.integers(0, 3, (jj, ii))
    for k in range(kk):
        dp[k] = np.where(k >= kk - nempty, 0., dp[k])
    p = np.concatenate([np.zeros((1, jj, ii)), np.cumsum(dp, 0)]) * ip
    pbu = np.minimum(p[kk], np.roll(p[kk], 1, axis=1)) * iu
    pbv = np.minimum(p[kk], np.roll(p[kk], 1, axis=0)) * iv
    dpu = np.minimum(dp, np.roll(dp, 1, axis=2)) * iu
    dpv = np.minimum(dp, np.roll(dp, 1, axis=1)) * iv
    difint = rng.uniform(.2, 1., (kk, jj, ii)) * kappa_scale * ip
    nslpx = rng.normal(0., 1e-4, (kk + 1, jj, ii)) * iu
    nslpy = rng.normal(0., 1e-4, (kk + 1, jj, ii)) * iv
    nslpx[0] = nslpx[kk] = nslpy[0] = nslpy[kk] = 0.
    mld = rng.uniform(5., 80., (jj, ii)) * ip
    delt1 = 3600.

    z = torch.zeros((kk + 1, jj, ii), dtype=torch.float64)
    cf = CmnFields(bfsqi=z, bfsqf=z, nslpx=_t(nslpx), nslpy=_t(nslpy),
                   mld=_t(mld))
    dfl = zero_diffusion_fields(kk, (jj, ii))
    dfl.difint = _t(difint)
    out = eddtra.eddtra(g, _S(dp=dp, dpu=dpu, dpv=dpv, pbu=pbu, pbv=pbv),
                        cf, dfl, 1, 0, delt1)
    want_u, want_v = eo.eddtra_ale_oracle(
        ip, iu, iv, g.scp2.numpy(), g.scu2.numpy(), g.scv2.numpy(),
        g.scuy.numpy(), g.scvx.numpy(), p, dp, dpu, dpv, pbu, pbv, difint,
        nslpx, nslpy, mld, delt1, periodic_i=True, periodic_j=False)
    scale = max(np.abs(want_u).max(), np.abs(want_v).max(), 1.)
    for got, want in ((out.umfltd[1], want_u), (out.vmfltd[1], want_v)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * scale)


def test_diffus_matches_oracle():
    model = standalone.build_fuk95(itdm=16, jtdm=10, kdm=6, device='cpu')
    g, e, s = model.grid, model.e, model.state
    kk, (jj, ii) = g.kk, g.shape
    rng = np.random.default_rng(0)
    ip = g.ip.numpy()
    s.dp = _t(rng.uniform(.2, 3., (2, kk, jj, ii)) * 1e4 * ip)
    s.temp = _t(rng.uniform(2., 18., (2, kk, jj, ii)))
    s.saln = _t(rng.uniform(33., 36., (2, kk, jj, ii)))
    s.trc = _t(rng.uniform(0., 5., (2, 1, kk, jj, ii)))
    difiso = rng.uniform(0., 500., (kk, jj, ii)) * ip
    dfl = zero_diffusion_fields(kk, (jj, ii))
    dfl.difiso = _t(difiso)
    delt1, m, n = 3600., 0, 1
    before = {name: getattr(s, name)[n].numpy().copy()
              for name in ('dp', 'temp', 'saln', 'trc')}

    s2, dfl2 = diffus.diffus(g, e, s, dfl, m, n, delt1)

    def sig_fn(t, sal):
        return float(eos.sig(e, torch.tensor(t, dtype=torch.float64),
                             torch.tensor(sal, dtype=torch.float64)))

    (t_o, s_o, sig_o, trc_o, utf_o, usf_o, vtf_o,
     vsf_o) = do.diffus_oracle(
        ip, g.iu.numpy(), g.iv.numpy(), g.scuy.numpy(), g.scuxi.numpy(),
        g.scvx.numpy(), g.scvyi.numpy(), g.scp2.numpy(), difiso,
        before['dp'], before['temp'], before['saln'], before['trc'],
        delt1, sig_fn, periodic_i=g.periodic_i, periodic_j=g.periodic_j)
    wet = ip > 0
    for got, want, name in ((s2.temp[n], t_o, 'temp'),
                            (s2.saln[n], s_o, 'saln'),
                            (s2.sigma[n], sig_o, 'sigma'),
                            (s2.trc[n, 0], trc_o[0], 'trc'),
                            (dfl2.utflld, utf_o, 'utflld'),
                            (dfl2.usflld, usf_o, 'usflld'),
                            (dfl2.vtflld, vtf_o, 'vtflld'),
                            (dfl2.vsflld, vsf_o, 'vsflld')):
        got = got.numpy()
        if name in ('temp', 'saln', 'sigma', 'trc'):
            got, want = got[:, wet], want[:, wet]
        np.testing.assert_allclose(got, want, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(want).max(), 1.),
                                   err_msg=name)


def test_ale_vdifft_matches_oracle():
    model = standalone.build_fuk95(itdm=24, jtdm=12, kdm=10, device='cpu')
    g, e, s, f = model.grid, model.e, model.state, model.forcing
    kk, H = g.kk, g.shape
    rng = np.random.default_rng(5)
    n = 1
    ip = g.ip.numpy()
    dp = rng.uniform(0.3, 3.0, (kk,) + H) * 1e4 * ip
    temp = rng.uniform(2., 20., (kk,) + H) * ip
    saln = rng.uniform(30., 37., (kk,) + H) * ip
    s.dp[n], s.temp[n], s.saln[n] = _t(dp), _t(temp), _t(saln)
    for name, lo, hi in (('surflx', -200., 200.), ('sswflx', 0., 150.),
                         ('surrlx', -50., 50.), ('salflx', -5e-3, 5e-3),
                         ('brnflx', -2e-3, 0.), ('salrlx', -1e-3, 1e-3)):
        setattr(f, name, _t(rng.uniform(lo, hi, H) * ip))

    def nonloc():
        # monotone penetration profile, 1 at the surface, 0 at the bottom
        cum = np.cumsum(rng.uniform(0., 1., (kk + 1,) + H), axis=0)
        prof = 1.0 - cum / cum[-1]
        prof[0], prof[-1] = 1.0, 0.0
        return prof

    nl = {name: nonloc() for name in ('t_sw', 't_ns', 't_rs', 's_br',
                                      's_nb', 's_rs')}
    kd_t = rng.uniform(0., 5e-3, (kk,) + H)
    kd_s = rng.uniform(0., 5e-3, (kk,) + H)
    vf = VmixFields(
        Kvisc_m=_t(kd_t), Kdiff_t=_t(kd_t), Kdiff_s=_t(kd_s),
        **{f'{k}_nonloc': _t(v) for k, v in nl.items()},
        buoyfl=torch.zeros((kk + 1,) + H, dtype=torch.float64),
        mld=torch.zeros(H, dtype=torch.float64))
    delt1 = 2400.0
    out = ale_vdiff.ale_vdifft(g, e, s, f, vf, 0, n, delt1)
    fl = {name: getattr(f, name).numpy() for name in
          ('surflx', 'sswflx', 'surrlx', 'salflx', 'brnflx', 'salrlx')}
    for j, i in np.argwhere(ip > 0)[::7][:20]:
        t_ref, s_ref = vo.vdifft_column(
            dp[:, j, i], temp[:, j, i], saln[:, j, i], kd_t[:, j, i],
            kd_s[:, j, i], fl['sswflx'][j, i],
            fl['surflx'][j, i] - fl['sswflx'][j, i], fl['surrlx'][j, i],
            fl['brnflx'][j, i], fl['salflx'][j, i] - fl['brnflx'][j, i],
            fl['salrlx'][j, i], nl['t_sw'][:, j, i], nl['t_ns'][:, j, i],
            nl['t_rs'][:, j, i], nl['s_br'][:, j, i], nl['s_nb'][:, j, i],
            nl['s_rs'][:, j, i], delt1, ale_vdiff.dpmin_vdiff)
        np.testing.assert_allclose(out.temp[n][:, j, i].numpy(), t_ref,
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(out.saln[n][:, j, i].numpy(), s_ref,
                                   rtol=1e-9, atol=1e-9)


# ------------------------------------------------ the isopycnic phases

def _eos_callbacks(e):
    def f64(*xs):
        return [torch.tensor(float(x), dtype=torch.float64) for x in xs]
    return dict(
        sig=lambda t, s: float(eos.sig(e, *f64(t, s))),
        sofsig=lambda g, t: float(eos.sofsig(e, *f64(g, t))),
        rho=lambda p, t, s: float(eos.rho(*f64(p, t, s))),
        dsigdt=lambda t, s: float(eos.dsigdt(e, *f64(t, s))),
        dsigds=lambda t, s: float(eos.dsigds(e, *f64(t, s))))


def _columns(model, seed, unstable):
    """The random isopycnic columns of test_convec_oracle.py
    (`unstable`: mixed layer denser than the interior in about half the
    columns, kfplo set around the first thick layer) or of
    test_diapfl_oracle.py, with the same draws, at time level 1."""
    rng = np.random.default_rng(seed)
    g, e, s = model.grid, model.e, model.state
    kk, H = g.kk, g.shape
    ip = g.ip.numpy()
    sigr = s.sigmar.numpy()
    kidx = np.arange(kk)[:, None, None]
    if unstable:
        kfpl = rng.integers(2, kk - 2, H)
        kmax = np.minimum(kk - 1, kfpl + rng.integers(1, kk - 1, H))
        kfplo = np.clip(kfpl + rng.integers(-2, 5, H), 2, kk + 1)
        ml, thick, lo = (25., 35.), 60., .1
    else:
        kfpl = rng.integers(3, kk - 3, H)
        kmax = np.minimum(kk - 1, kfpl + rng.integers(1, kk - 2, H))
        ml, thick, lo = (30., 40.), 80., .2
    dp = np.zeros((kk,) + H)
    dp[0] = ml[0] * 9806. * (1. + .2 * rng.random(H))
    dp[1] = ml[1] * 9806. * (1. + .2 * rng.random(H))
    interior = (kidx >= kfpl) & (kidx <= kmax)
    dp = np.where(interior, thick * 9806. * (lo + rng.random((kk,) + H)),
                  dp)
    dp[2:] = np.where(interior[2:], dp[2:], 0.)
    dp *= ip
    if unstable:
        temp = 14. - .5 * kidx + rng.normal(0., .8, (kk,) + H)
        sig_target = sigr + rng.normal(0., .05, (kk,) + H)
        uns = rng.random(H) < .5
        sig_target[0] = np.where(uns, sigr[kk // 2], sigr[0])
        sig_target[1] = np.where(uns, sigr[kk // 2] + .02, sigr[1])
    else:
        temp = 12. - .6 * kidx + rng.normal(0., .2, (kk,) + H)
        sig_target = sigr + rng.normal(0., .02, (kk,) + H)
    saln = eos.sofsig(e, _t(sig_target), _t(temp))
    n = 1
    s.dp[n], s.temp[n], s.saln[n] = _t(dp), _t(temp), saln
    s.sigma[n] = eos.sig(e, _t(temp), saln)
    if unstable:
        s.kfpla[n] = torch.tensor(kfplo, dtype=torch.int32)
        return s, n
    s.kfpla[n] = torch.tensor(kfpl, dtype=torch.int32)
    s.ustarb = _t(.01 * rng.random(H))
    nu = _t(10 ** rng.uniform(-6., -3., (kk,) + H))
    return s, nu, n


def _wet_columns(g):
    ip = g.ip.numpy() > 0
    return [(j, i) for j in range(g.shape[0]) for i in range(g.shape[1])
            if ip[j, i]]


def test_convec_matches_oracle():
    model = standalone.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, n = _columns(model, 0, unstable=True)
    inputs = {name: getattr(s, name)[n].numpy().copy()
              for name in ('temp', 'saln', 'dp', 'sigma', 'kfpla')}
    sigr = s.sigmar.numpy()
    g = model.grid
    out = convec.convec(g, model.e, s, 0, n)
    cb = _eos_callbacks(model.e)
    cols = _wet_columns(g)
    assert len(cols) > 50
    bad = []
    for j, i in cols:
        tt, ss, dpp, _, _, kfpl = co.column(
            inputs['temp'][:, j, i], inputs['saln'][:, j, i],
            inputs['dp'][:, j, i], inputs['sigma'][:, j, i],
            sigr[:, j, i], int(inputs['kfpla'][j, i]), cb)
        got_t = out.temp[n][:, j, i].numpy()
        got_s = out.saln[n][:, j, i].numpy()
        got_d = out.dp[n][:, j, i].numpy()
        # compare where mass lives (diapfl fills massless T/S later)
        wet = (dpp > 1e-9) | (got_d > 1e-9)
        if not (np.allclose(got_d, dpp, rtol=1e-9, atol=1e-6)
                and np.allclose(got_t[wet], tt[wet], rtol=1e-9, atol=1e-9)
                and np.allclose(got_s[wet], ss[wet], rtol=1e-9, atol=1e-9)
                and int(out.kfpla[n][j, i]) == min(kfpl, g.kk)):
            bad.append((j, i))
    assert not bad, f'{len(bad)}/{len(cols)} columns mismatch: {bad[:5]}'


def test_diapfl_matches_oracle():
    model = standalone.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, nu, n = _columns(model, 0, unstable=False)
    g = model.grid
    inputs = {name: getattr(s, name)[n].numpy().copy()
              for name in ('temp', 'saln', 'dp', 'sigma', 'kfpla')}
    sigr, ust, cor = s.sigmar.numpy(), s.ustarb.numpy(), g.coriop.numpy()
    delt1 = 2. * model.par.baclin
    out = diapfl.diapfl(g, model.e, s, nu, 0, n, delt1)
    cb = _eos_callbacks(model.e)
    c = 9.806 ** 2 * delt1 / (1.e-3 ** 2)
    cols = _wet_columns(g)
    assert len(cols) > 50
    bad = []
    for j, i in cols:
        tt, ss, dpp, _, _, _, _, _ = dpo.column(
            inputs['temp'][:, j, i], inputs['saln'][:, j, i],
            inputs['dp'][:, j, i], inputs['sigma'][:, j, i],
            sigr[:, j, i], nu.numpy()[:, j, i], int(inputs['kfpla'][j, i]),
            float(ust[j, i]), float(cor[j, i]), c, cb)
        if not (np.allclose(out.temp[n][:, j, i].numpy(), tt, rtol=1e-6,
                            atol=1e-6)
                and np.allclose(out.saln[n][:, j, i].numpy(), ss,
                                rtol=1e-6, atol=1e-6)
                and np.allclose(out.dp[n][:, j, i].numpy(), dpp, rtol=1e-6,
                                atol=1e-3 * 9806.)):
            bad.append((j, i))
    assert not bad, f'{len(bad)}/{len(cols)} columns mismatch: {bad[:5]}'


def test_diapfl_conserves_and_keeps_uniform_velocity():
    """Column mass, heat and salt within [kmin, kmax] and a uniform
    velocity kept by the momentum mixing."""
    model = standalone.build_fuk95(itdm=18, jtdm=8, kdm=12, device='cpu')
    s, nu, n = _columns(model, 5, unstable=False)
    g = model.grid
    u0 = .13
    s.u[n] = torch.full_like(s.u[n], u0) * g.iu
    before = {name: getattr(s, name)[n].numpy().copy()
              for name in ('dp', 'temp')}
    wetu = s.dpu[n].numpy()[:, g.iu.numpy() > 0] > 0.
    out = diapfl.diapfl(g, model.e, s, nu, 0, n, 2. * model.par.baclin)
    ip = g.ip.numpy() > 0
    np.testing.assert_allclose(out.dp[n].numpy().sum(0)[ip],
                               before['dp'].sum(0)[ip], rtol=1e-11)
    np.testing.assert_allclose(
        (out.dp[n] * out.temp[n]).numpy().sum(0)[ip],
        (before['dp'] * before['temp']).sum(0)[ip], rtol=1e-9, atol=1e-3)
    du = out.u[n].numpy()[:, g.iu.numpy() > 0]
    assert np.abs(du[wetu] - u0).max() < 1e-9


def test_entrain_energy_matches_oracle():
    """dpe through the truncated p_p_alpha series, within the 1e-5 the
    reference accepts against the exact log form (test_mxlayr.py)."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        p_top = rng.uniform(0., 1e4)
        prk = p_top + rng.uniform(1e4, 2e6)
        pmxl = prk + rng.uniform(1e2, 5e5)
        tk, sk = rng.uniform(-1., 25.), rng.uniform(30., 37.)
        tm0, sm0 = rng.uniform(-1., 25.), rng.uniform(30., 37.)
        uk, vk, um, vm = rng.normal(0., .3, 4)
        dpe0, dke0 = rng.uniform(0., 1e-6, 2)
        delt1, rm5 = 360., .8
        args = (p_top, prk, pmxl, tk, sk, tm0, sm0, dpe0, dke0, uk, vk,
                um, vm)
        got = mxlayr.entrain_energy(*(torch.tensor(float(a),
                                                   dtype=torch.float64)
                                      for a in args), delt1, rm5)
        want = mo.entrain_energy(*args, delt1, rm5)
        for gv, w, name in zip(got, want, ('tmx', 'smx', 'dpe', 'dke')):
            rtol = 1e-5 if name == 'dpe' else 1e-7
            assert np.isclose(float(gv), w, rtol=rtol, atol=1e-12), \
                (name, float(gv), w)
