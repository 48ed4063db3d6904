"""The port's mixing phases against the loop-level oracles.

tests/oracles/ holds numpy transcriptions of the reference Fortran,
written independently of both packages; blom_tpu's own tests hold it to
them at 1e-9 (tests/test_eddtra_oracle.py, test_transport_oracles.py,
test_oracle_parity.py).  The same inputs, made from a seed with numpy,
go here through the port on CPU in f64, at the same 1e-9: eddtra with
the depletion limiter idle and firing on many columns, diffus with a
passive tracer, ale_vdifft column by column.  No JAX is involved."""

import numpy as np
import pytest
import torch

from blom_tpu_torch.core import eos
from blom_tpu_torch.core.grid import finish_grid
from blom_tpu_torch.drivers import standalone
from blom_tpu_torch.dynamics import ale_vdiff, diffus, eddtra
from blom_tpu_torch.dynamics.cmnfld import CmnFields
from blom_tpu_torch.dynamics.diffusion_fields import zero_diffusion_fields
from blom_tpu_torch.phys.vmix import VmixFields
from tests.oracles import ale_vdiff_oracle as vo
from tests.oracles import diffus_oracle as do
from tests.oracles import eddtra_oracle as eo


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
