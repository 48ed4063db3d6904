"""The port's momentum stencil core (plain PyTorch version) against
blom_tpu's, for the three vorticity schemes (enscon, enecon, enedis).

The fixture of tests/test_momtum_pallas.py (random land, closed or
periodic i, periodic j) and its parameters, with nonzero background and
biharmonic viscosities, go through blom_tpu.dynamics.momtum._uv_body
(its jnp path, and its Pallas kernel momtum_uv_pallas in interpret
mode) and the port's momtum_uv on CPU tensors, in f64: rtol 1e-12,
atol 1e-14, test_momtum_pallas.py's tolerance.  The barotropic solver's
Coriolis terms follow the scheme too; one barotp call per scheme is
held to 1e-8 relative, the tolerance of tests/test_torch_slice.py
(blom_tpu compiles the substep loop, where XLA contracts multiply-adds
in terms that cancel by ~1e6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.core.grid import finish_grid as jax_finish_grid
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import barotp as jb
from blom_tpu.dynamics import momtum as jmo
from blom_tpu.dynamics.momtum_pallas import momtum_uv_pallas
from blom_tpu_torch import convert
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.dynamics import barotp as tb
from blom_tpu_torch.dynamics import momtum as tmo
from tests.torch_shared import shared_build

SCHEMES = ('enscon', 'enecon', 'enedis')


def _setup(seed=0, kk=5, jj=12, ii=18, periodic_i=False, periodic_j=True):
    rng = np.random.default_rng(seed)
    depths = np.where(rng.uniform(size=(jj, ii)) < .75, 200., 0.)
    if not periodic_i:
        depths[:, 0] = 0.
        depths[:, -1] = 0.
    ones = np.ones((jj, ii))
    gs = 10e3
    grid = jax_finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=depths,
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=periodic_i, periodic_j=periodic_j, kk=kk,
        baclin=1800.)
    ip = np.asarray(grid.ip)
    iu = np.asarray(grid.iu)
    iv = np.asarray(grid.iv)
    H3 = (kk, jj, ii)
    H2 = (jj, ii)

    dp = rng.uniform(1e4, 3e5, H3) * ip
    dpu = rng.uniform(1e4, 3e5, H3) * iu
    dpv = rng.uniform(1e4, 3e5, H3) * iv
    p = np.concatenate([np.zeros((1, jj, ii)), np.cumsum(dp, 0)])
    pu = np.concatenate([np.zeros((1, jj, ii)), np.cumsum(dpu, 0)])
    pv = np.concatenate([np.zeros((1, jj, ii)), np.cumsum(dpv, 0)])

    f = dict(
        u_m=rng.normal(0., .3, H3) * iu, u_n=rng.normal(0., .3, H3) * iu,
        v_m=rng.normal(0., .3, H3) * iv, v_n=rng.normal(0., .3, H3) * iv,
        dp_m=dp, dpu_m=dpu, dpv_m=dpv,
        p_lo=p[:-1], p_hi=p[1:], pu_lo=pu[:-1], pu_hi=pu[1:],
        pv_lo=pv[:-1], pv_hi=pv[1:],
        stress_u=rng.normal(0., 1e-6, H3) * iu,
        stress_v=rng.normal(0., 1e-6, H3) * iv,
        pgf_u=rng.normal(0., 1e-3, H3) * iu,
        pgf_v=rng.normal(0., 1e-3, H3) * iv)
    d2 = dict(
        ubflxs_m=rng.normal(0., 1e7, H2) * iu,
        ubflxs_n=rng.normal(0., 1e7, H2) * iu,
        vbflxs_m=rng.normal(0., 1e7, H2) * iv,
        vbflxs_n=rng.normal(0., 1e7, H2) * iv,
        pbu_m=pu[-1], pbv_m=pv[-1],
        pbu_n=pu[-1] * 1.01, pbv_n=pv[-1] * 1.01,
        drag=rng.uniform(0., 1e-7, H2) * ip,
        ubrhs=rng.normal(0., 1e-5, H2) * iu,
        vbrhs=rng.normal(0., 1e-5, H2) * iv,
        difwgt=rng.uniform(0., 1., H2) * ip)
    return grid, f, d2


PARAMS = dict(mdv2hi=2., mdv2lo=1., vsc4hi=.1, vsc4lo=.05)


def _port_inputs(jgrid, f, d2):
    tgrid = convert.grid_from_numpy(
        {k: np.asarray(getattr(jgrid, k)) for k in TENSOR_FIELDS},
        periodic_i=jgrid.periodic_i, periodic_j=jgrid.periodic_j,
        kk=jgrid.kk)
    t = torch.from_numpy
    return (tgrid,
            tmo.MomtumKIn(**{k: t(np.ascontiguousarray(a))
                             for k, a in f.items()}),
            tmo.Momtum2DIn(**{k: t(np.ascontiguousarray(a))
                              for k, a in d2.items()}))


@pytest.mark.parametrize('mommth', SCHEMES)
@pytest.mark.parametrize('periodic_i', [True, False])
def test_uv_body_matches_blom_tpu(periodic_i, mommth):
    """Against the jnp body and the Pallas kernel in interpret mode."""
    torch.set_num_threads(1)
    jgrid, f, d2 = _setup(periodic_i=periodic_i)
    tsfac, delt1 = 0.75, 3600.
    jpar = jmo.MomtumParams(mommth=mommth, **PARAMS)
    jf, jd2 = jmo.MomtumKIn(**f), jmo.Momtum2DIn(**d2)
    refs = (jmo._uv_body(jgrid, jpar, jf, jd2, tsfac, delt1),
            momtum_uv_pallas(jgrid, jpar, jf, jd2, tsfac, delt1,
                             interpret=True))
    tgrid, tf, td2 = _port_inputs(jgrid, f, d2)
    u, v = tmo.momtum_uv(tgrid, tmo.MomtumParams(mommth=mommth, **PARAMS),
                         tf, td2, tsfac, delt1)
    for u_ref, v_ref in refs:
        np.testing.assert_allclose(u.numpy(), np.asarray(u_ref),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref),
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize('mommth', SCHEMES)
@pytest.mark.parametrize('periodic_i', [True, False])
def test_coriolis_terms_match_blom_tpu(periodic_i, mommth):
    """cau/cav from the same velocities, fluxes and vorticity."""
    torch.set_num_threads(1)
    jgrid, f, d2 = _setup(periodic_i=periodic_i, seed=1)
    rng = np.random.default_rng(2)
    shape = f['u_m'].shape
    iu, iv = np.asarray(jgrid.iu), np.asarray(jgrid.iv)
    fields = dict(dp_m=f['dp_m'], utotm=f['u_m'], vtotm=f['v_m'],
                  uflux0=f['u_m'] * f['dpu_m'],
                  vflux0=f['v_m'] * f['dpv_m'],
                  potvor=rng.normal(0., 1e-9, shape))
    # exact zeros of pv * u pick the mean of the two flux bounds (enedis)
    fields['potvor'][:, 2, 3:6] = 0.
    ref = jmo.coriolis_terms(jgrid, *[jnp.asarray(a) for a in fields.values()],
                             mommth)
    tgrid, _, _ = _port_inputs(jgrid, f, d2)
    out = tmo.coriolis_terms(tgrid, *[torch.from_numpy(a)
                                      for a in fields.values()], mommth)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-14 * np.abs(np.asarray(r)).max())
    assert np.abs(np.asarray(ref[0]) * iu).max() > 0.
    assert np.abs(np.asarray(ref[1]) * iv).max() > 0.


@pytest.fixture(scope='module')
def fuk95_models(tmp_path_factory):
    torch.set_num_threads(1)
    from blom_tpu_torch.drivers import standalone as tst
    size = dict(itdm=24, jtdm=8, kdm=8)
    return (shared_build(tmp_path_factory, jst.build_fuk95, **size),
            tst.build_fuk95(device='cpu', **size))


@pytest.mark.parametrize('mommth', SCHEMES)
def test_barotp_matches_blom_tpu(fuk95_models, mommth):
    """One barotp call of the fuk95 model with random depth-mean
    tendencies.  The bottom pressure and the barotropic vorticity are
    perturbed by up to 10 % and 50 %: with a uniform vorticity the enscon
    and enecon forms are the same sum, with these the schemes differ by
    ~2e-4 in the transports."""
    jm, tm = fuk95_models
    rng = np.random.default_rng(3)
    shape = np.asarray(jm.grid.iu).shape
    js = dataclasses.replace(
        jm.state, pb=jm.state.pb * rng.uniform(.9, 1.1, shape),
        pvtrop=jm.state.pvtrop * rng.uniform(.5, 1.5, (2,) + shape))
    ut = rng.normal(0., 1e-5, shape) * np.asarray(jm.grid.iu)
    vt = rng.normal(0., 1e-5, shape) * np.asarray(jm.grid.iv)
    jpar = jm.par.barotp._replace(mommth=mommth)
    ref = jb.barotp(jm.grid, js, jnp.asarray(ut), jnp.asarray(vt), 0, 1,
                    jm.par.lstep, jm.par.dlt, jpar)
    s = convert.state_from_numpy(
        {fd.name: np.asarray(getattr(js, fd.name))
         for fd in dataclasses.fields(js)})
    out = tb.barotp(tm.grid, s, torch.from_numpy(ut), torch.from_numpy(vt),
                    0, 1, tm.par.lstep, tm.par.dlt,
                    tm.par.barotp._replace(mommth=mommth))
    for name in ('pb', 'ubflx', 'vbflx', 'ubflxs_p', 'vbflxs_p', 'pvtrop'):
        a = np.asarray(getattr(ref, name))
        b = getattr(out, name).numpy()
        assert np.abs(a - b).max() <= 1e-8 * np.abs(a).max(), name


def test_grid_matches_blom_tpu():
    """The port's finish_grid builds the same metrics and masks."""
    from blom_tpu_torch.core.grid import finish_grid
    jgrid, _, _ = _setup(periodic_i=False)
    ones = np.ones(jgrid.shape)
    gs = 10e3
    tgrid = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=np.asarray(jgrid.depths),
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=False, periodic_j=True, kk=jgrid.kk, baclin=1800.)
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tgrid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)),
                                      err_msg=name)
    assert [f.name for f in dataclasses.fields(tgrid)][4:] == \
        list(TENSOR_FIELDS)


def test_unknown_scheme_raises():
    jgrid, f, d2 = _setup()
    tgrid, tf, td2 = _port_inputs(jgrid, f, d2)
    with pytest.raises(ValueError, match='mommth'):
        tmo.momtum_uv(tgrid, tmo.MomtumParams(mommth='enstrophy'), tf, td2,
                      .5, 60.)


@pytest.mark.parametrize('mommth', SCHEMES)
@pytest.mark.parametrize('periodic_i', [True, False])
def test_uv_body_reach_within_kernel_halo(periodic_i, mommth):
    """The CUDA kernel computes a tile of u_new, v_new from its inputs on a
    ring of momtum_cuda.HALO points around the tile.  Each input of the
    plain body (every MomtumKIn and Momtum2DIn field, every metric plane
    the kernel reads) perturbed at a few wet interior points changes the
    outputs only within HALO points in i and in j, and the widest change
    seen reaches HALO in both."""
    from blom_tpu_torch.dynamics import momtum_cuda
    torch.set_num_threads(1)
    n = 28
    jgrid, f, d2 = _setup(seed=4, kk=1, jj=n, ii=n, periodic_i=periodic_i)
    tgrid, tf, td2 = _port_inputs(jgrid, f, d2)
    par = tmo.MomtumParams(mommth=mommth, **PARAMS)
    tsfac, delt1 = 0.75, 3600.

    def body(grid, kin, d2in):
        return torch.stack(tmo._uv_body(grid, par, kin, d2in, tsfac, delt1))

    base = body(tgrid, tf, td2)
    rng = np.random.default_rng(5)
    ip = np.asarray(jgrid.ip)
    wet = np.argwhere(ip[4:n - 4, 4:n - 4] > 0) + 4
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')

    def cyclic(d):
        d = np.abs(d)
        return np.minimum(d, n - d)

    def perturbed(t, j, i):
        t = t.clone()
        t[..., j, i] += 1e-3 * (t[..., j, i].abs() + t.abs().mean())
        return t

    fields = ([('kin', name) for name in tmo.MomtumKIn._fields]
              + [('d2', name) for name in tmo.Momtum2DIn._fields]
              + [('grid', name) for name in momtum_cuda.METRICS])
    reach = np.zeros(2, int)
    for kind, name in fields:
        for j, i in wet[rng.choice(len(wet), 3, replace=False)]:
            kin, d2in, grid = tf, td2, tgrid
            if kind == 'kin':
                kin = tf._replace(**{name: perturbed(getattr(tf, name), j, i)})
            elif kind == 'd2':
                d2in = td2._replace(
                    **{name: perturbed(getattr(td2, name), j, i)})
            else:
                grid = dataclasses.replace(
                    tgrid, **{name: perturbed(getattr(tgrid, name), j, i)})
            changed = (body(grid, kin, d2in) != base).any(0).any(0).numpy()
            if changed.any():
                far = (cyclic(jj[changed] - j).max(),
                       cyclic(ii[changed] - i).max())
                assert max(far) <= momtum_cuda.HALO, (name, j, i, far)
                reach = np.maximum(reach, far)
    assert tuple(reach) == (momtum_cuda.HALO, momtum_cuda.HALO)


class _RecordingGrid(tmo.Grid):
    """A grid that records every j+1 read: (kind, vector, field)."""

    def jp1(self, a, kind=None, vector=False):
        self.reads.append((kind, vector, a))
        return super().jp1(a, kind, vector)


def _tripolar_inputs(seed, n):
    """_setup's random fields on an n x n grid closed in j and periodic in
    i, carried across with convert.grid_from_numpy(arctic=True): the top
    row on the fold."""
    jgrid, f, d2 = _setup(seed=seed, kk=1, jj=n, ii=n, periodic_i=True,
                          periodic_j=False)
    tgrid = convert.grid_from_numpy(
        {k: np.asarray(getattr(jgrid, k)) for k in TENSOR_FIELDS},
        periodic_i=True, periodic_j=False, kk=jgrid.kk, arctic=True)
    t = torch.from_numpy
    return (tgrid,
            tmo.MomtumKIn(**{k: t(np.ascontiguousarray(a))
                             for k, a in f.items()}),
            tmo.Momtum2DIn(**{k: t(np.ascontiguousarray(a))
                              for k, a in d2.items()}))


@pytest.mark.parametrize('mommth', SCHEMES)
def test_uv_body_reach_across_the_fold(mommth):
    """The tripolar case of the reach above, for the kernel's fold
    pre-pass.  (1) Every value a tagged j+1 read mirrors (rows J-3 of p
    and u fields, J-2 of q and v fields) is the same when the grid has no
    fold: no mirrored value itself reads across the fold, so the pre-pass
    computes them from rows J-5..J-1 alone.  (2) An input perturbed at
    two wet points (j, i) of each of the top six rows changes outputs
    within HALO of it, or, through the fold, only on the top HALO rows at
    columns within HALO of its mirror I-1-i, and only from rows within
    HALO of the top row; the widest change through the fold seen reaches
    HALO in both."""
    from blom_tpu_torch.dynamics import momtum_cuda
    torch.set_num_threads(1)
    n, halo = 28, momtum_cuda.HALO
    tgrid, tf, td2 = _tripolar_inputs(7, n)
    par = tmo.MomtumParams(mommth=mommth, **PARAMS)
    tsfac, delt1 = 0.75, 3600.

    def body(grid, kin, d2in):
        return torch.stack(tmo._uv_body(grid, par, kin, d2in, tsfac, delt1))

    # (1) the mirrored rows without the fold
    runs = []
    for arctic in (True, False):
        grid = _RecordingGrid(**{**tgrid.__dict__, 'arctic': arctic})
        grid.reads = []
        body(grid, tf, td2)
        runs.append(grid.reads)
    tagged = [(a, b) for (kind, vec, a), (_, _, b) in zip(*runs) if kind]
    assert len(runs[0]) == len(runs[1]) and len(tagged) >= 25
    for (kind, vec, a), (_, _, b) in zip(*runs):
        if kind:
            row = n - (3 if kind in 'pu' else 2)
            assert torch.equal(a[..., row, :], b[..., row, :]), kind

    # (2) the reach through the fold
    base = body(tgrid, tf, td2)
    rng = np.random.default_rng(8)
    ip = np.asarray(tgrid.ip)
    wet = np.argwhere(ip[n - 6:] > 0) + [n - 6, 0]
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')

    def cyclic(d):
        d = np.abs(d)
        return np.minimum(d, n - d)

    def perturbed(t, j, i):
        t = t.clone()
        t[..., j, i] += 1e-3 * (t[..., j, i].abs() + t.abs().mean())
        return t

    fields = ([('kin', name) for name in tmo.MomtumKIn._fields]
              + [('d2', name) for name in tmo.Momtum2DIn._fields]
              + [('grid', name) for name in momtum_cuda.METRICS])
    reach = np.zeros(2, int)
    for kind, name in fields:
        # two wet points of each of the top six rows
        pts = [wet[wet[:, 0] == r][k] for r in range(n - 6, n)
               for k in rng.choice((wet[:, 0] == r).sum(), 2, replace=False)]
        for j, i in pts:
            kin, d2in, grid = tf, td2, tgrid
            if kind == 'kin':
                kin = tf._replace(**{name: perturbed(getattr(tf, name), j, i)})
            elif kind == 'd2':
                d2in = td2._replace(
                    **{name: perturbed(getattr(td2, name), j, i)})
            else:
                grid = dataclasses.replace(
                    tgrid, **{name: perturbed(getattr(tgrid, name), j, i)})
            changed = (body(grid, kin, d2in) != base).any(0).any(0).numpy()
            direct = (np.abs(jj - j) <= halo) & (cyclic(ii - i) <= halo)
            fold = changed & ~direct
            if fold.any():
                rows = jj[fold]
                far = (n - 1 - j, cyclic(ii[fold] - (n - 1 - i)).max())
                assert rows.min() >= n - halo, (name, j, i)
                assert max(far) <= halo, (name, j, i, far)
                reach = np.maximum(reach, far)
    assert tuple(reach) == (halo, halo)
