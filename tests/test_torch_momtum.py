"""The port's momentum stencil core (plain PyTorch version) against
blom_tpu's.

The fixture of tests/test_momtum_pallas.py (random land, closed or
periodic i, periodic j) and its parameters, with nonzero background and
biharmonic viscosities, go through blom_tpu.dynamics.momtum._uv_body and
the port's momtum_uv on CPU tensors, in f64: rtol 1e-12, atol 1e-14."""

import dataclasses

import numpy as np
import pytest
import torch

from blom_tpu.core.grid import finish_grid as jax_finish_grid
from blom_tpu.dynamics import momtum as jmo
from blom_tpu_torch import convert
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.dynamics import momtum as tmo


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


@pytest.mark.parametrize('periodic_i', [True, False])
def test_uv_body_matches_blom_tpu(periodic_i):
    torch.set_num_threads(1)
    jgrid, f, d2 = _setup(periodic_i=periodic_i)
    tsfac, delt1 = 0.75, 3600.
    u_ref, v_ref = jmo._uv_body(
        jgrid, jmo.MomtumParams(mommth='enscon', **PARAMS),
        jmo.MomtumKIn(**f), jmo.Momtum2DIn(**d2), tsfac, delt1)

    tgrid = convert.grid_from_numpy(
        {k: np.asarray(getattr(jgrid, k)) for k in TENSOR_FIELDS},
        periodic_i=jgrid.periodic_i, periodic_j=jgrid.periodic_j,
        kk=jgrid.kk)
    t = torch.from_numpy
    u, v = tmo.momtum_uv(
        tgrid, tmo.MomtumParams(mommth='enscon', **PARAMS),
        tmo.MomtumKIn(**{k: t(np.ascontiguousarray(a))
                         for k, a in f.items()}),
        tmo.Momtum2DIn(**{k: t(np.ascontiguousarray(a))
                          for k, a in d2.items()}), tsfac, delt1)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-12,
                               atol=1e-14)


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


@pytest.mark.parametrize('mommth', ['enecon', 'enedis'])
def test_unported_schemes_raise(mommth):
    jgrid, f, d2 = _setup()
    tgrid = convert.grid_from_numpy(
        {k: np.asarray(getattr(jgrid, k)) for k in TENSOR_FIELDS},
        periodic_i=False, periodic_j=True, kk=jgrid.kk)
    t = torch.from_numpy
    with pytest.raises(NotImplementedError):
        tmo.momtum_uv(tgrid, tmo.MomtumParams(mommth=mommth),
                      tmo.MomtumKIn(**{k: t(np.ascontiguousarray(a))
                                       for k, a in f.items()}),
                      tmo.Momtum2DIn(**{k: t(np.ascontiguousarray(a))
                                        for k, a in d2.items()}), .5, 60.)
