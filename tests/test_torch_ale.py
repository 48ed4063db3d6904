"""The port's ALE regrid/remap (plain PyTorch versions) against blom_tpu's.

Inputs are made from a seed with numpy at the sizes of
tests/test_ale_pallas.py (kk=6, J=10, I=12) and go through blom_tpu's
jnp functions and the port's on CPU, in f64.

- hor3map (PPM reconstruction with every ported limiter, the fused
  remap in both of its empty-layer modes), regrid_nudge with the scan
  clamp, regrid_smooth and the whole ale_regrid_remap evaluate the same
  operations in the same order: rtol = atol = 1e-12.
- regrid_plain and remap_plain, the plain versions of the CUDA kernels
  K1 and K2, against blom_tpu's Pallas kernels regrid_call and
  remap_call in interpret mode, at test_ale_pallas.py's tolerances: the
  Pallas K1 uses the cummax form of the monotonic clamp, ~1 ULP of the
  pressure from the scan (rtol 1e-11, atol 1e-6 on p_dst).
- The CUDA wrappers refuse CPU tensors rather than fall back."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blom_tpu.configs import fuk95 as jcfg
from blom_tpu.core import eos as jeos
from blom_tpu.core import state as jstate
from blom_tpu.dynamics import ale as jam
from blom_tpu.dynamics import ale_pallas as jap
from blom_tpu.ops import hor3map as jh3
from blom_tpu_torch import convert
from blom_tpu_torch.configs import fuk95 as tcfg
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.dynamics import ale as tam
from blom_tpu_torch.dynamics import ale_cuda
from blom_tpu_torch.ops import hor3map as th3

KK, J, I = 6, 10, 12
TOL = dict(rtol=1e-12, atol=1e-12)
LIMITERS = (th3.MONOTONIC, th3.NON_OSCILLATORY, th3.NON_OSCILLATORY_POSDEF)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _columns(seed=0, kk=KK, vanish=True):
    """Interfaces, T, S and target densities of test_ale_pallas.py, plus
    (vanish) a few vanishing layers at the column bottoms."""
    rng = np.random.default_rng(seed)
    dp = rng.uniform(.5, 3., (kk, J, I)) * 1.e4
    if vanish:
        dp[-2:, :3, :4] = 0.
    p = np.concatenate([np.zeros((1, J, I)), np.cumsum(dp, axis=0)])
    t = rng.uniform(2., 18., (kk, J, I))
    s = rng.uniform(33., 36., (kk, J, I))
    sigmar = np.sort(rng.uniform(24., 28., (kk, J, I)), axis=0)
    return rng, p, t, s, sigmar


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize('pc_upper', [False, True])
@pytest.mark.parametrize('limiting', LIMITERS)
def test_ppm_reconstruct(limiting, pc_upper):
    _, p, t, s, _ = _columns()
    ref = jh3.ppm_reconstruct(jnp.asarray(p), jnp.asarray(t), limiting,
                              pc_upper)
    out = th3.ppm_reconstruct(_t(p), _t(t), limiting, pc_upper)
    for name in ('c0', 'c1', 'c2'):
        _close(getattr(out, name), getattr(ref, name))


@pytest.mark.parametrize('pc_upper', [False, True])
@pytest.mark.parametrize('limiting', LIMITERS)
def test_ppm_reconstruct_multi(limiting, pc_upper):
    _, p, t, s, _ = _columns(1)
    refs = jh3.ppm_reconstruct_multi(jnp.asarray(p),
                                     [jnp.asarray(t), jnp.asarray(s)],
                                     limiting, pc_upper)
    outs = th3.ppm_reconstruct_multi(_t(p), [_t(t), _t(s)], limiting,
                                     pc_upper)
    for ref, out in zip(refs, outs):
        for name in ('c0', 'c1', 'c2'):
            _close(getattr(out, name), getattr(ref, name))


@pytest.mark.parametrize('bottom_only_empties', [False, True])
def test_remap_groups(bottom_only_empties):
    rng, p, t, s, sigmar = _columns(2)
    e = jeos.init_eos()
    ale = jam.make_ale_params(KK)
    jp = jnp.asarray(p)
    rcs = jh3.ppm_reconstruct_multi(jp, [jnp.asarray(t), jnp.asarray(s)],
                                    pc_upper=True)
    p_dst, _ = jam.regrid_nudge(KK, e, ale, jp, rcs[0], rcs[1],
                                jnp.asarray(sigmar), 1800.)
    u = rng.uniform(-.3, .3, (KK, J, I))
    pu = p * .99
    pu_new = np.asarray(p_dst) * .98
    if not bottom_only_empties:
        # empty destination layers inside the column take point values
        pu_new[3:5, 2:5] = pu_new[3, 2:5]
    ref = jh3.remap_groups(
        [(rcs, p_dst),
         ([jh3.ppm_reconstruct(jnp.asarray(pu), jnp.asarray(u))],
          jnp.asarray(pu_new))], bottom_only_empties)
    trcs = th3.ppm_reconstruct_multi(_t(p), [_t(t), _t(s)], pc_upper=True)
    out = th3.remap_groups(
        [(trcs, _t(p_dst)),
         ([th3.ppm_reconstruct(_t(pu), _t(u))], _t(pu_new))],
        bottom_only_empties)
    for g_ref, g_out in zip(ref, out):
        for a, b in zip(g_out, g_ref):
            _close(a, b)


def test_regrid_nudge_scan():
    _, p, t, s, sigmar = _columns(3)
    je, te = jeos.init_eos(), teos.init_eos()
    jale, tale = jam.make_ale_params(KK), tam.make_ale_params(KK)
    assert jale._asdict() == tale._asdict()
    jrc = jh3.ppm_reconstruct_multi(jnp.asarray(p),
                                    [jnp.asarray(t), jnp.asarray(s)],
                                    pc_upper=True)
    ref = jam.regrid_nudge(KK, je, jale, jnp.asarray(p), jrc[0], jrc[1],
                           jnp.asarray(sigmar), 1800., clamp_impl='scan')
    trc = th3.ppm_reconstruct_multi(_t(p), [_t(t), _t(s)], pc_upper=True)
    out = tam.regrid_nudge(KK, te, tale, _t(p), trc[0], trc[1],
                           _t(sigmar), 1800.)
    for a, b in zip(out, ref):
        _close(a, b)


def _grids(kk=KK):
    jg = jcfg.make_grid(180., I, J, kk)
    tg = tcfg.make_grid(180., I, J, kk)
    return jg, tg


def test_regrid_smooth():
    rng, p, t, s, sigmar = _columns(4)
    jg, tg = _grids()
    ale = jam.make_ale_params(KK)
    ip = np.asarray(jg.ip)
    p_dst = p * ip
    sfac = rng.uniform(0., 1., p.shape)
    ref = jam.regrid_smooth(jg, ale, jnp.asarray(p_dst), jnp.asarray(sfac),
                            360.)
    out = tam.regrid_smooth(tg, tam.make_ale_params(KK), _t(p_dst),
                            _t(sfac), 360.)
    _close(out, ref)


def _state(ntr, seed=5):
    """A random ALE state on the fuk95 grid: time level n = 1 filled."""
    rng, p, t, s, sigmar = _columns(seed)
    jg, tg = _grids()
    ip = np.asarray(jg.ip)
    dp = np.diff(p, axis=0) * ip
    p_i = np.concatenate([np.zeros((1, J, I)), np.cumsum(dp, 0)])
    dpu, dpv = (np.asarray(a) for a in
                jstate.dpu_dpv_upstream(jg, jnp.asarray(p_i)))
    js = jstate.empty_state(jg, jnp.float64, ntr=ntr)

    def lvl(name, a):
        full = np.asarray(getattr(js, name)).copy()
        full[1] = a
        return jnp.asarray(full)

    js = dataclasses.replace(
        js, dp=lvl('dp', dp), temp=lvl('temp', t * ip),
        saln=lvl('saln', s * ip),
        u=lvl('u', rng.uniform(-.3, .3, dp.shape) * np.asarray(jg.iu)),
        v=lvl('v', rng.uniform(-.3, .3, dp.shape) * np.asarray(jg.iv)),
        dpu=lvl('dpu', dpu), dpv=lvl('dpv', dpv),
        trc=lvl('trc', rng.uniform(0., 2., (ntr,) + dp.shape) * ip),
        sigmar=jnp.asarray(sigmar))
    return jg, tg, js


@pytest.mark.parametrize('ntr', [0, 2])
def test_ale_regrid_remap(ntr):
    jg, tg, js = _state(ntr)
    je, te = jeos.init_eos(), teos.init_eos()
    ref = jam.ale_regrid_remap(jg, je, jam.make_ale_params(KK), js, 0, 1,
                               360.)
    ts = convert.state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                   for f in dataclasses.fields(js)})
    out = tam.ale_regrid_remap(tg, te, tam.make_ale_params(KK), ts, 0, 1,
                               360.)
    for f in dataclasses.fields(ref):
        np.testing.assert_allclose(getattr(out, f.name).numpy(),
                                   np.asarray(getattr(ref, f.name)),
                                   err_msg=f.name, **TOL)


@pytest.mark.parametrize('limiting', LIMITERS)
def test_regrid_plain_matches_pallas_k1(limiting):
    # no vanishing layers: next to one, the edge weights reach ~1e297
    # and blom_tpu's Pallas K1 and jnp regrid part ways (ROADMAP §3)
    _, p, t, s, sigmar = _columns(vanish=False)
    je, te = jeos.init_eos(), teos.init_eos()
    ale = jam.make_ale_params(KK)._replace(tracer_limiting=limiting)
    j = jnp.asarray
    ref_pd, ref_sf = jap.regrid_call(je, ale, j(p), j(t), j(s), j(sigmar),
                                     1800., interpret=True)
    pd, sf = tam.regrid_plain(
        te, tam.make_ale_params(KK)._replace(tracer_limiting=limiting),
        _t(p), _t(t), _t(s), _t(sigmar), 1800.)
    _close(pd, ref_pd, rtol=1e-11, atol=1e-6)
    _close(sf, ref_sf)


# (ntr, (tracer_limiting, velocity_limiting)) of the K2 checks: each
# limiter for both groups and two mixed pairs without passive tracers;
# five tracers (two chunks of the Pallas kernel) with two of them; 33
# tracers (nine chunks; more than a CUDA K2 with a cap of 32 would take)
NOSC, POSDEF = th3.NON_OSCILLATORY, th3.NON_OSCILLATORY_POSDEF
K2_CASES = ([(0, (lim, lim)) for lim in LIMITERS]
            + [(0, (POSDEF, NOSC)), (0, (th3.MONOTONIC, POSDEF))]
            + [(5, (NOSC, NOSC)), (5, (POSDEF, NOSC)), (33, (NOSC, NOSC))])


@pytest.mark.parametrize('ntr,lims', K2_CASES)
def test_remap_plain_matches_pallas_k2(ntr, lims):
    rng, p, t, s, sigmar = _columns(vanish=False)
    e = jeos.init_eos()
    lim = dict(tracer_limiting=lims[0], velocity_limiting=lims[1])
    ale = jam.make_ale_params(KK)._replace(**lim)
    j = jnp.asarray
    trc = [rng.uniform(0., 2., (KK, J, I)) for _ in range(ntr)]
    u = rng.uniform(-.3, .3, (KK, J, I))
    v = rng.uniform(-.3, .3, (KK, J, I))
    dpu = rng.uniform(.5, 3., (KK, J, I)) * 1.e4
    pu = np.concatenate([np.zeros((1, J, I)), np.cumsum(dpu, axis=0)])
    rcs = jh3.ppm_reconstruct_multi(j(p), [j(t), j(s)], pc_upper=True)
    p_dst = np.asarray(jam.regrid_nudge(KK, e, ale, j(p), rcs[0], rcs[1],
                                        j(sigmar), 1800.)[0])
    tms = [t, s] + trc
    args = (p, tms, pu, u, pu * 1.01, v, p_dst, p_dst * .98, p_dst * .97)
    ref = jap.remap_call(ale, *[j(a) if not isinstance(a, list)
                                else [j(x) for x in a] for a in args],
                         interpret=True)
    out = tam.remap_plain(tam.make_ale_params(KK)._replace(**lim),
                          *[_t(a) if not isinstance(a, list)
                            else [_t(x) for x in a] for a in args])
    assert len(out[0]) == len(ref[0]) == 2 + ntr
    for a, b in zip(list(out[0]) + [out[1], out[2]],
                    list(ref[0]) + [ref[1], ref[2]]):
        _close(a, b)


def test_cuda_wrappers_refuse_cpu_tensors():
    _, p, t, s, sigmar = _columns()
    ale = tam.make_ale_params(KK)
    with pytest.raises(ValueError, match='not on'):
        ale_cuda.regrid_cuda(teos.init_eos(), ale, _t(p), _t(t), _t(s),
                             _t(sigmar), 1800.)
    with pytest.raises(ValueError, match='not on'):
        ale_cuda.remap_cuda(ale, _t(p), [_t(t), _t(s)], _t(p), _t(t),
                            _t(p), _t(t), _t(p), _t(p), _t(p))
    assert not any(ale_cuda.regrid_launches.values())
    assert not any(ale_cuda.remap_launches.values())


@pytest.mark.parametrize('change', [dict(regrid_method='direct'),
                                    dict(reconstruction_method='pqm')])
def test_ale_options_match_blom_tpu(monkeypatch, change):
    """The ALE options the port once refused here, one ale_regrid_remap
    each from the same state, within 1e-12.  The state has empty bottom
    layers, where PQM's boundary fits are nearly singular and the two
    packages' LAPACK solves part ways (blom_tpu's gives NaN in u at 12
    points, ROADMAP.md §3), so PQM runs with one common solver for both
    (test_torch_hor3map_highorder.py)."""
    from tests.test_torch_hor3map_highorder import use_common_solver
    jg, tg, js = _state(2)
    ref_ale = jam.make_ale_params(KK)._replace(**change)
    if 'reconstruction_method' in change:
        use_common_solver(monkeypatch)
    ref = jam.ale_regrid_remap(jg, jeos.init_eos(), ref_ale, js, 0, 1,
                               360.)
    ts = convert.state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                   for f in dataclasses.fields(js)})
    out = tam.ale_regrid_remap(tg, teos.init_eos(),
                               tam.make_ale_params(KK)._replace(**change),
                               ts, 0, 1, 360.)
    for f in dataclasses.fields(ref):
        np.testing.assert_allclose(getattr(out, f.name).numpy(),
                                   np.asarray(getattr(ref, f.name)),
                                   err_msg=f.name, **TOL)


@pytest.mark.parametrize('change', [dict(tracer_limiting='none'),
                                    dict(velocity_limiting='posdef')])
def test_unknown_limiting_raises(change):
    """Both paths take the three limiters and refuse other names."""
    jg, tg, js = _state(0)
    ts = convert.state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                   for f in dataclasses.fields(js)})
    ale = tam.make_ale_params(KK)._replace(**change)
    with pytest.raises(ValueError, match='limiting'):
        tam.ale_regrid_remap(tg, teos.init_eos(), ale, ts, 0, 1, 360.)
