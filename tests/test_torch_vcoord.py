"""The port's core/vcoord.py against blom_tpu's, on CPU in f64.

Each function of the reference-density generator and of the sigref
adaption on the same inputs (made from a numpy seed) through both
packages, within 1e-12 relative (the Newton loops run the same fixed trip
count in the same order), and the cases of tests/test_vcoord.py on the
port.  blom_tpu's sigma_fun runs its Bezier loop as a compiled lax.scan;
its values agree to 1e-13 with the port's loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core import vcoord as jvc
from blom_tpu_torch.core import vcoord as tvc

TOL = dict(rtol=1e-12, atol=1e-12)
SPECS = {
    'default': {},
    'bottom': dict(z_bot=.85, s_bot=37.30),
    'top': dict(z_top=.1, s_top=21.),
    'both': dict(sp1=23., zp2=.4, z_top=.05, z_bot=.9),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, **tol):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize('x0', [0.9, 2.8, -1.5])
def test_cubic_root_matches_blom_tpu(x0):
    ref = jvc.cubic_root(1., -2., -5., 6., jnp.asarray(x0))
    out = tvc.cubic_root(1., -2., -5., 6., _t(x0))
    _close(out, ref)


@pytest.mark.parametrize('kmax', [20, 53])
@pytest.mark.parametrize('name', list(SPECS))
def test_sigma_fun_matches_blom_tpu(name, kmax):
    ref = jvc.sigma_fun(jvc.SigmaFunSpec(**SPECS[name]), kmax)
    out = tvc.sigma_fun(tvc.SigmaFunSpec(**SPECS[name]), kmax)
    assert out.dtype == torch.float64 and out.shape == (kmax,)
    _close(out, ref, rtol=1e-13, atol=0.)


def _sra_pair(seed=0, shape=(4, 5)):
    """Both packages' SraState after two days and a year-end, from seeded
    mixed-layer depths and base densities."""
    rng = np.random.default_rng(seed)
    js, ts = jvc.init_sra(shape), tvc.init_sra(shape, device='cpu')
    for day in range(3):
        dp = rng.uniform(1.e4, 5.e5, shape)
        sg = rng.uniform(24., 28., shape)
        js = jvc.sra_find_ml_dmax(js, jnp.asarray(dp), jnp.asarray(sg))
        ts = tvc.sra_find_ml_dmax(ts, _t(dp), _t(sg))
        if day:
            js = jvc.sra_accumulate(js, day % 2)
            ts = tvc.sra_accumulate(ts, day % 2)
    return js, ts


def _same_sra(js, ts):
    for name in ('dpml_dmax', 'sigmlb_dmax', 'dpml_sum', 'sigmlb_sum',
                 'tlev_accnum', 'dpml_clim', 'sigmlb_clim', 'has_clim'):
        _close(getattr(ts, name), getattr(js, name))


def test_sra_accumulate_matches_blom_tpu():
    js, ts = _sra_pair()
    assert ts.tlev_accnum.dtype == torch.int32
    _same_sra(js, ts)


@pytest.mark.parametrize('years', [1, 2])
def test_sra_update_clim_matches_blom_tpu(years):
    js, ts = _sra_pair(1)
    for _ in range(years):
        js = jvc.sra_update_clim(js, 3.)
        ts = tvc.sra_update_clim(ts, 3.)
        js = jvc.sra_accumulate(js, 0)
        ts = tvc.sra_accumulate(ts, 0)
    _same_sra(js, ts)


def _cost_inputs(seed, kdm=20, shape=(4, 5)):
    rng = np.random.default_rng(seed)
    js, ts = _sra_pair(seed, shape)
    js, ts = jvc.sra_update_clim(js), tvc.sra_update_clim(ts)
    plevel = np.linspace(1.e4, 4.e6, kdm)
    wgt = rng.uniform(.5, 1.5, shape)
    mask = (rng.uniform(size=shape) > .2).astype(float)
    return js, ts, plevel, wgt, mask


@pytest.mark.parametrize('name', ['default', 'both'])
def test_sra_cost_matches_blom_tpu(name):
    js, ts, plevel, wgt, mask = _cost_inputs(2)
    sig_j = jvc.sigma_fun(jvc.SigmaFunSpec(**SPECS[name]), 20)
    sig_t = tvc.sigma_fun(tvc.SigmaFunSpec(**SPECS[name]), 20)
    ref = jvc.sra_cost(jnp.asarray(plevel), sig_j, js, jnp.asarray(wgt),
                       jnp.asarray(mask))
    out = tvc.sra_cost(_t(plevel), sig_t, ts, _t(wgt), _t(mask))
    assert float(ref) > 0.
    _close(out, ref)


def test_sra_optimize_matches_blom_tpu():
    js, ts, plevel, wgt, mask = _cost_inputs(3)
    ref = jvc.sra_optimize_sp1_zp2(jvc.SigmaFunSpec(sp1=20., zp2=.45),
                                   jnp.asarray(plevel), js, jnp.asarray(wgt),
                                   jnp.asarray(mask), 20, niter=6)
    out = tvc.sra_optimize_sp1_zp2(tvc.SigmaFunSpec(sp1=20., zp2=.45),
                                   _t(plevel), ts, _t(wgt), _t(mask), 20,
                                   niter=6)
    _close(torch.stack([out.sp1, out.zp2]), [ref.sp1, ref.zp2])


def test_sra_update_filter_matches_blom_tpu():
    kw = dict(frac_of_year=.3, baclin=1800., nday_in_year=360.)
    ref = jvc.sra_update_filter(jvc.SigmaFunSpec(), jvc.SigmaFunSpec(sp1=21.),
                                jvc.SigmaFunSpec(sp1=23., zp2=.4, sp4=37.),
                                **kw)
    out = tvc.sra_update_filter(tvc.SigmaFunSpec(), tvc.SigmaFunSpec(sp1=21.),
                                tvc.SigmaFunSpec(sp1=23., zp2=.4, sp4=37.),
                                **kw)
    for name in ('sp1', 'zp2', 'sp4', 's_bot'):
        _close(np.asarray(getattr(out, name)), getattr(ref, name))


# ------------------------------------------ tests/test_vcoord.py, on the port

def test_cubic_root():
    r = float(tvc.cubic_root(1., -2., -5., 6., _t(0.9)))
    assert r == pytest.approx(1., abs=1e-10)
    r = float(tvc.cubic_root(1., -2., -5., 6., _t(2.8)))
    assert r == pytest.approx(3., abs=1e-10)


def test_sigma_fun_monotone_and_endpoints():
    spec = tvc.SigmaFunSpec(sp1=22., zp2=.3, zp3=.7, sp4=37.2, dsdz_bot=.1)
    sig = tvc.sigma_fun(spec, 53).numpy()
    assert sig[0] == pytest.approx(22., abs=1e-6)
    assert sig[-1] == pytest.approx(37.2, abs=1e-6)
    assert (np.diff(sig) > 0.).all()


def test_sigma_fun_bottom_parabola():
    spec = tvc.SigmaFunSpec(sp1=22., zp2=.3, zp3=.7, sp4=37.2, dsdz_bot=.1,
                            z_bot=.85, s_bot=37.30)
    sig = tvc.sigma_fun(spec, 53).numpy()
    assert sig[-1] == pytest.approx(37.30, abs=1e-6)
    assert (np.diff(sig) > -1e-9).all()


def test_sigma_fun_differentiable():
    """sigma_fun differentiates in the varying parameters (blom_tpu's
    test_sigma_fun_traceable takes jax.grad)."""
    sp1 = torch.tensor(22., dtype=torch.float64, requires_grad=True)
    tvc.sigma_fun(tvc.SigmaFunSpec(sp1=sp1), 20).sum().backward()
    assert np.isfinite(float(sp1.grad)) and float(sp1.grad) != 0.


def test_sra_daily_max_and_accumulate():
    sra = tvc.init_sra((3, 4), device='cpu')
    dp1 = torch.full((3, 4), 100., dtype=torch.float64)
    sg1 = torch.full((3, 4), 26., dtype=torch.float64)
    sra = tvc.sra_find_ml_dmax(sra, dp1, sg1)
    sra = tvc.sra_find_ml_dmax(sra, dp1 * .5, sg1 + 1.)  # shallower
    np.testing.assert_allclose(sra.dpml_dmax.numpy(), 100.)
    np.testing.assert_allclose(sra.sigmlb_dmax.numpy(), 26.)
    sra = tvc.sra_accumulate(sra, 0)
    assert int(sra.tlev_accnum[0]) == 1
    np.testing.assert_allclose(sra.dpml_dmax.numpy(), 0.)
    sra = tvc.sra_update_clim(sra)
    np.testing.assert_allclose(sra.dpml_clim[0].numpy(), 100.)
    assert int(sra.tlev_accnum[0]) == 0


def test_sra_optimize_reduces_cost():
    kdm = 20
    spec = tvc.SigmaFunSpec(sp1=20., zp2=.45, sp4=37.2)
    sra = tvc.init_sra((4, 5), device='cpu')
    sra = tvc.sra_find_ml_dmax(sra, torch.full((4, 5), 5.e5,
                                               dtype=torch.float64),
                               torch.full((4, 5), 27., dtype=torch.float64))
    sra = tvc.sra_accumulate(sra, 0)
    sra = tvc.sra_update_clim(sra)
    plevel = torch.linspace(1.e4, 4.e6, kdm, dtype=torch.float64)
    wgt = torch.ones((4, 5), dtype=torch.float64)
    mask = torch.ones((4, 5), dtype=torch.float64)
    c0 = float(tvc.sra_cost(plevel, tvc.sigma_fun(spec, kdm), sra, wgt,
                            mask))
    spec2 = tvc.sra_optimize_sp1_zp2(spec, plevel, sra, wgt, mask, kdm,
                                     niter=15)
    c1 = float(tvc.sra_cost(plevel, tvc.sigma_fun(spec2, kdm), sra, wgt,
                            mask))
    assert np.isfinite(c0) and np.isfinite(c1)
    assert c1 <= c0 + 1e-9


def test_sra_update_filter_converges():
    old = tvc.SigmaFunSpec(sp1=22.)
    new = tvc.SigmaFunSpec(sp1=23.)
    spec = old
    for _ in range(2000):
        spec = tvc.sra_update_filter(spec, old, new, 1.0, 86400.,
                                     nday_in_year=360., ts1=.01, ts2=.01)
    assert float(spec.sp1) == pytest.approx(23., abs=.01)
