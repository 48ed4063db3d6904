"""The port's mixing phases against blom_tpu's, each from the same input.

The input is blom_tpu's fuk95 state at 24x8x8 (f64) with random
velocities, a temperature perturbation and surface fluxes made from a
seed with numpy, so that shear, convection, slopes and penetration all
act.  Each phase runs in blom_tpu (eagerly) and in the port on CPU from
that input: cmnfld, difest_lateral (the deck's defaults and bench.py's
egc=.85/egmndf=100), eddtra (bench.py's diffusivities, and a strong one
that makes the depletion limiter sweep several times), diffus,
difest_vertical, ale_vdifft and ale_vdiffm.  They evaluate the same
operations in the same order; the Thomas solves run as compiled scans
in blom_tpu, where XLA may contract multiply-adds, so all agree to
rtol = atol = 1e-12."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blom_tpu.core import eos as jeos
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import ale_vdiff as jvd
from blom_tpu.dynamics import cmnfld as jcf
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import diffus as jdi
from blom_tpu.dynamics import eddtra as jed
from blom_tpu.phys import vmix as jvm
from blom_tpu_torch import convert
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import ale_vdiff as tvd
from blom_tpu_torch.dynamics import cmnfld as tcf
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics import diffus as tdi
from blom_tpu_torch.dynamics import eddtra as ted
from blom_tpu_torch.phys import swabs as tsw
from blom_tpu_torch.phys import vmix as tvm
from tests.torch_shared import shared_build

SIZE = dict(itdm=24, jtdm=8, kdm=8)
TOL = dict(rtol=1e-12, atol=1e-12)
M, N, DELT1 = 0, 1, 360.
BENCH = dict(egc=.85, egmndf=100.)


def _np(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _same(port, ref, names=None):
    ref = ref._asdict() if hasattr(ref, '_asdict') else _np(ref)
    for name in names or ref:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(ref[name]), err_msg=name,
                                   **TOL)


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    """blom_tpu's and the port's containers for one perturbed state."""
    torch.set_num_threads(1)
    jm = shared_build(tmp_path_factory, jst.build_fuk95, **SIZE)
    g = jm.grid
    rng = np.random.default_rng(7)
    s = jm.state
    H3 = s.u.shape[1:]
    ip, iu, iv = (np.asarray(a) for a in (g.ip, g.iu, g.iv))
    temp = np.asarray(s.temp).copy()
    temp[N] += rng.normal(0., .05, H3) * ip
    u = np.asarray(s.u).copy()
    v = np.asarray(s.v).copy()
    u[N] = rng.normal(0., .2, H3) * iu
    v[N] = rng.normal(0., .2, H3) * iv
    sigma = np.asarray(s.sigma).copy()
    sigma[N] = np.asarray(jeos.sig(jm.e, jnp.asarray(temp[N]),
                                   s.saln[N])) * ip
    js = dataclasses.replace(s, temp=jnp.asarray(temp), u=jnp.asarray(u),
                             v=jnp.asarray(v), sigma=jnp.asarray(sigma))
    H2 = g.ip.shape
    fl = {name: rng.normal(0., scale, H2) * ip for name, scale in
          (('surflx', 80.), ('sswflx', 150.), ('salflx', 1e-3),
           ('brnflx', 5e-4), ('surrlx', 10.), ('salrlx', 1e-4))}
    fl['sswflx'] = np.abs(fl['sswflx'])
    jf = dataclasses.replace(jm.forcing,
                             **{k: jnp.asarray(a) for k, a in fl.items()})
    tm = tst.build_fuk95(device='cpu', **SIZE)
    return dict(
        g=g, e=jm.e, s=js, f=jf, dfl=jm.dfl, swabs=jm.swabs,
        tg=tm.grid, te=tm.e, tf=convert.forcing_from_numpy(_np(jf)),
        tdfl=tm.dfl, tswabs=tm.swabs,
        ts=lambda: convert.state_from_numpy(_np(js)))


def test_swabs_jerlov(case):
    _same(case['tswabs'], case['swabs'])
    with pytest.raises(ValueError, match='chl10c'):
        tsw.init_swabs((2, 3), 'chlorophyll_ma94')


def test_cmnfld(case):
    ref = jcf.cmnfld(case['g'], case['e'], case['s'], N)
    out = tcf.cmnfld(case['tg'], case['te'], case['ts'](), N)
    _same(out, ref)


def _cmn(case):
    cf = jcf.cmnfld(case['g'], case['e'], case['s'], N)
    return cf, convert.cmn_fields_from_numpy(cf._asdict())


@pytest.mark.parametrize('par', [{}, BENCH], ids=['defaults', 'bench'])
def test_difest_lateral(case, par):
    cf, tcfv = _cmn(case)
    ref = jdf.difest_lateral(case['g'], case['s'], cf, jdf.DifestParams(**par),
                             case['dfl'], M, N)
    out = tdf.difest_lateral(case['tg'], case['ts'](), tcfv,
                             tdf.DifestParams(**par), case['tdfl'], M, N)
    assert tdf.DifestParams(**par)._asdict() == \
        jdf.DifestParams(**par)._asdict()
    _same(out, ref, ('difint', 'difiso', 'difwgt'))


@pytest.mark.parametrize('strength', [1., 1e3], ids=['bench', 'strong'])
@pytest.mark.parametrize('mn', [(0, 1), (1, 0)])
def test_eddtra(case, strength, mn):
    m, n = mn
    cf, tcfv = _cmn(case)
    dfl = jdf.difest_lateral(case['g'], case['s'], cf,
                             jdf.DifestParams(**BENCH), case['dfl'], m, n)
    # 'strong' scales the diffusivity up so that the depletion limiter
    # clips and needs more than one sweep
    dfl = dataclasses.replace(dfl, difint=dfl.difint * strength)
    ref = jed.eddtra(case['g'], case['s'], cf, dfl, m, n, DELT1)
    syncs0 = ted.host_syncs
    out = ted.eddtra(case['tg'], case['ts'](), tcfv,
                     convert.diffusion_fields_from_numpy(_np(dfl)), m, n,
                     DELT1)
    sweeps = ted.host_syncs - syncs0
    _same(out, ref, ('umfltd', 'vmfltd'))
    assert sweeps >= (2 if strength > 1. else 1)


def test_limit_mfl_multi_sweep():
    """The limiter alone on random fluxes that deplete many cells: it
    sweeps repeatedly and agrees with blom_tpu's while_loop version."""
    rng = np.random.default_rng(3)
    kk, H = 8, (4, 6)
    mfl = rng.normal(0., 3., (kk + 1,) + H)
    avail_w = rng.uniform(0., 2., (kk,) + H)
    avail_c = rng.uniform(0., 2., (kk,) + H)
    area_w = rng.uniform(.5, 1.5, H)
    area_c = rng.uniform(.5, 1.5, H)
    ref = jed._limit_mfl(*(jnp.asarray(a) for a in
                           (mfl, avail_w, avail_c, area_w, area_c)))
    syncs0 = ted.host_syncs
    out = ted._limit_mfl(*(torch.tensor(a) for a in
                           (mfl, avail_w, avail_c, area_w, area_c)))
    assert ted.host_syncs - syncs0 >= 3
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_diffus(case):
    cf, _ = _cmn(case)
    dfl = jdf.difest_lateral(case['g'], case['s'], cf,
                             jdf.DifestParams(**BENCH), case['dfl'], M, N)
    ref_s, ref_d = jdi.diffus(case['g'], case['e'], case['s'], dfl, M, N,
                              DELT1)
    out_s, out_d = tdi.diffus(case['tg'], case['te'], case['ts'](),
                              convert.diffusion_fields_from_numpy(_np(dfl)),
                              M, N, DELT1)
    _same(out_s, ref_s)
    _same(out_d, ref_d, ('utflld', 'usflld', 'vtflld', 'vsflld'))


def _vmix(case):
    vf = jvm.difest_vertical(case['g'], case['e'], case['s'], case['f'],
                             case['swabs'], jvm.VmixParams(), N)
    return vf, convert.vmix_fields_from_numpy(_np(vf))


def test_difest_vertical(case):
    ref, _ = _vmix(case)
    out = tvm.difest_vertical(case['tg'], case['te'], case['ts'](),
                              case['tf'], case['tswabs'], tvm.VmixParams(),
                              N)
    assert tvm.VmixParams()._asdict() == jvm.VmixParams()._asdict()
    _same(out, ref)
    # use_kpp is the step's choice (difest_vertical ignores it); twedon
    # adds the tidal term
    for change in (dict(use_kpp=True), dict(twedon=1.)):
        ref = jvm.difest_vertical(case['g'], case['e'], case['s'],
                                  case['f'], case['swabs'],
                                  jvm.VmixParams(**change), N)
        out = tvm.difest_vertical(case['tg'], case['te'], case['ts'](),
                                  case['tf'], case['tswabs'],
                                  tvm.VmixParams(**change), N)
        _same(out, ref)


def test_ale_vdifft(case):
    vf, tvf = _vmix(case)
    ref = jvd.ale_vdifft(case['g'], case['e'], case['s'], case['f'], vf,
                         M, N, DELT1)
    out = tvd.ale_vdifft(case['tg'], case['te'], case['ts'](), case['tf'],
                         tvf, M, N, DELT1)
    _same(out, ref)


def test_ale_vdiffm(case):
    vf, tvf = _vmix(case)
    ref = jvd.ale_vdiffm(case['g'], case['s'], vf, M, N, DELT1)
    out = tvd.ale_vdiffm(case['tg'], case['ts'](), tvf, M, N, DELT1)
    _same(out, ref)
