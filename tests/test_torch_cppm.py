"""The port's CPPM sweep (plain PyTorch version) against blom_tpu's.

Same inputs, made from a seed with numpy (the fixture of
tests/test_cppm_pallas.py, with its land cells), go through
blom_tpu.dynamics.cppm._cppm_sweep_body and the port's cppm_sweep on
CPU tensors, in f64, for all four (compatibility, limiting) variants.
Both evaluate the same operations in the same order, so they agree to
rounding: rtol = atol = 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blom_tpu.dynamics import cppm as jcm
from blom_tpu_torch.dynamics import cppm as tcm

COEFF_FIELDS = ('stencil', 'hevc', 'ssc', 'scc', 'd2m', 'tmc0', 'tmcl',
                'tmcr')


def _setup(ax, periodic, nt=3, kk=5, J=12, I=16, seed=0):
    rng = np.random.default_rng(seed)
    ip = np.ones((J, I))
    # land cells to exercise several stencil classes
    ip[3, 5] = 0.
    ip[7, 2:4] = 0.
    ip[0, 0] = 0.
    dx = rng.uniform(.6, 1.5, (J, I))
    h = rng.uniform(.2, 2., (kk, J, I))
    tm = rng.uniform(1., 4., (nt, kk, J, I))
    ca = rng.uniform(-.3, .3, (kk, J, I))
    db = rng.uniform(5., 12., (J, I))
    p = np.concatenate([np.zeros((1, J, I)), np.cumsum(h, axis=0)])
    ai = 1. / rng.uniform(.8, 1.2, (J, I))
    div = rng.uniform(-.1, .1, (kk, J, I))
    return ip, dx, (h, tm, ca, db, p[:-1], p[1:], ai), div


VARIANTS = [('full', 'non_oscillatory'), ('full', 'monotonic'),
            ('partial', 'non_oscillatory'), ('partial', 'monotonic')]


def _both(ax, periodic, with_div, db_ai_3d=False, compat='full',
          lim='non_oscillatory'):
    torch.set_num_threads(1)
    ip, dx, args, div = _setup(ax, periodic)
    if db_ai_3d:
        h = args[0]
        args = args[:3] + (np.broadcast_to(args[3], h.shape).copy(),) \
            + args[4:6] + (np.broadcast_to(args[6], h.shape).copy(),)
    d = div if with_div else None
    co_j = jcm.init_cppm_coeffs(ip, dx, axis=ax, periodic=periodic,
                                dtype=jnp.float64)
    with jcm._axis(ax):
        ref = jcm._cppm_sweep_body(
            *[jnp.asarray(a) for a in args], co_j, periodic,
            None if d is None else jnp.asarray(d), compat, lim)
    co_t = tcm.init_cppm_coeffs(ip, dx, axis=ax, periodic=periodic)
    out = tcm.cppm_sweep(*[torch.from_numpy(np.ascontiguousarray(a))
                           for a in args], co_t, periodic,
                         div_corr=None if d is None else torch.from_numpy(d),
                         compatibility=compat, limiting=lim, ax=ax)
    return ref, out


@pytest.mark.parametrize('compat,lim', VARIANTS)
@pytest.mark.parametrize('with_div', [False, True])
@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('ax', [-1, -2])
def test_sweep_matches_blom_tpu(ax, periodic, with_div, compat, lim):
    ref, out = _both(ax, periodic, with_div, compat=compat, lim=lim)
    for r, o, name in zip(ref, out, ('hn', 'tmn', 'hf', 'htf')):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=f'{name} ax={ax}')


def test_sweep_3d_db_ai():
    """db and ai may be (k, J, I) as well as (J, I)."""
    ref, out = _both(-1, True, True, db_ai_3d=True)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize('periodic', [True, False])
@pytest.mark.parametrize('ax', [-1, -2])
def test_init_cppm_coeffs_match_blom_tpu(ax, periodic):
    ip, dx, _, _ = _setup(ax, periodic)
    co_j = jcm.init_cppm_coeffs(ip, dx, axis=ax, periodic=periodic,
                                dtype=jnp.float64)
    co_t = tcm.init_cppm_coeffs(ip, dx, axis=ax, periodic=periodic)
    for name in COEFF_FIELDS:
        a = np.asarray(getattr(co_j, name))
        b = getattr(co_t, name).numpy()
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize('compat,lim', [('full', 'mono'),
                                        ('compatible', 'monotonic')])
def test_unknown_variant_raises(compat, lim):
    ip, dx, args, _ = _setup(-1, True)
    co = tcm.init_cppm_coeffs(ip, dx, axis=-1, periodic=True)
    with pytest.raises(ValueError, match='cppm'):
        tcm.cppm_sweep(*[torch.from_numpy(np.ascontiguousarray(a))
                         for a in args], co, True, compatibility=compat,
                       limiting=lim)
