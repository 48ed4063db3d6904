"""The port's budgets, checks, checksums, merdia, wdiflx, bgcmean,
point test, timers and `run_case` against blom_tpu, on CPU in f64.

- `budget_sums` bit for bit blom_tpu's on the same state (both levels),
  and `budget_sums_many` bit for bit the separate sums; the step's seven
  checkpoints (`budget_out`) against blom_tpu's `run(..., cnsvdi=True)`
  from the same state: the first, before anything, bit for bit; the
  rest within 1e-12 (the two steps round apart by ~1e-7 in v, but the
  integrals of mass, heat and salt by no more than a few ulps).
- `chkvar` and `chkvar_host` on a good state and on states with a NaN, a
  negative thickness and a salinity out of range: the same flags, counts
  and message.
- `field_crc` and `state_checksums` equal to blom_tpu's on equal arrays.
- merdia (z-level weights and remap, latitude bins, overturning,
  meridional and section transports, the section masks) within 1e-12;
  `wdiflx` the same archive; bgcmean on NOINYOC (the port's two steps
  with the step's `bgc_diag_out`) within 1e-12 and the same file; `ptest`
  the same text; `Timers` blom_tpu's report.
- `run_case` on tests/test_dia_groups.py's deck: the port writes the
  files that test expects (2 'hd', 1 compressed 'hm'), finite over
  water, the rotating restart, run.status and the final dp CRC; and with
  both packages' step replaced by the same map of the state (so that the
  instrumentation sees equal states) the same files, every variable
  within 1e-12, the same restart arrays and the same CRC.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from blom_tpu.bgc import bgcmean as jbm
from blom_tpu.core import state as jstate
from blom_tpu.drivers import case as jcase
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import budget as jbud
from blom_tpu.dynamics import chkvar as jchk
from blom_tpu.dynamics import step as jstep
from blom_tpu.io import checksum as jcks
from blom_tpu.io import merdia as jmer
from blom_tpu.io import wdiflx as jwd
from blom_tpu.utils import pointtest as jpt
from blom_tpu.utils import timing as jtim
from blom_tpu_torch import convert
from blom_tpu_torch.bgc import bgcmean as tbm
from blom_tpu_torch.drivers import case as tcase
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import budget as tbud
from blom_tpu_torch.dynamics import chkvar as tchk
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.io import checksum as tcks
from blom_tpu_torch.io import merdia as tmer
from blom_tpu_torch.io import wdiflx as twd
from blom_tpu_torch.utils import pointtest as tpt
from blom_tpu_torch.utils import timing as ttim
from tests.test_dia_groups import DECK
from tests.test_torch_dia import (grid_np, jax_grid, jax_obj, np_fields,
                                  port_grid, rel_err)
from tests.test_torch_restart import _blom_side, port_model

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope='module')
def blom_side(tmp_path_factory):
    return _blom_side(tmp_path_factory)


@pytest.fixture(scope='module')
def grids():
    m = port_model()
    d = grid_np(m.grid)
    return jax_grid(d), port_grid(d)


def _states(blom_side):
    return (jax_obj(jstate.State, blom_side['state']),
            convert.state_from_numpy(blom_side['state']))


# ------------------------------------------------------------ budgets

@pytest.mark.parametrize('lvl', [0, 1])
def test_budget_sums_bitwise(blom_side, grids, lvl):
    js, ts = _states(blom_side)
    ref = jbud.budget_sums(grids[0], js, lvl)
    out = tbud.budget_sums(grids[1], ts, lvl)
    for k in ('mass', 'heat', 'salt'):
        assert float(getattr(out, k)) == float(getattr(ref, k)), k
    many = tbud.budget_sums_many([tbud.budget_col_sums(grids[1], ts, lv)
                                  for lv in (lvl, 1 - lvl, lvl)])
    for b, lv in zip(many, (lvl, 1 - lvl, lvl)):
        one = tbud.budget_sums(grids[1], ts, lv)
        assert all(float(getattr(b, k)) == float(getattr(one, k))
                   for k in ('mass', 'heat', 'salt'))
    d0 = jbud.budget_deltas(ref, jbud.budget_sums(grids[0], js, 1 - lvl))
    d1 = tbud.budget_deltas(out, tbud.budget_sums(grids[1], ts, 1 - lvl))
    assert d0 == d1


def test_step_budget_checkpoints_match_blom_tpu(blom_side):
    m = port_model()
    m.state = convert.state_from_numpy(blom_side['state'])
    m.dfl = convert.diffusion_fields_from_numpy(blom_side['dfl'])
    m.clock = m.clock.step().step()
    s, c, extras = tst.run(m, 1, cnsvdi=True, chk=True)
    assert extras['ok'].tolist() == blom_side['ok'].tolist() == [True]
    b = extras['budgets']
    for k, ref in blom_side['budgets'].items():
        out = getattr(b, k).numpy()
        assert out.shape == ref.shape == (1, 7), k
        assert out[0, 0] == ref[0, 0], k
        assert np.abs(out - ref).max() <= TOL * np.abs(ref).max(), k


def test_run_hooks_off_unchanged():
    """run with the instrumentation returns the state of the plain run,
    bit for bit (the hooks only read)."""
    from blom_tpu_torch.io import dia as tdia
    m = port_model(idlage=True)
    dfl0 = m.dfl
    s0, _ = tst.run(m, 3)
    m.dfl = dfl0
    g = tdia.init_group(m.grid, m.state, ['sst', 'templvl', 'mldl82'],
                        forcing=m.forcing, dfl=m.dfl)
    s1, _, extras = tst.run(m, 3, dia_group=(g,), cnsvdi=True, chk=True)
    for f in dataclasses.fields(s0):
        assert torch.equal(getattr(s0, f.name), getattr(s1, f.name)), f.name
    assert float(extras['dia_group'][0].nacc) == 3.
    assert extras['budgets'].mass.shape == (3, 7)
    assert extras['ok'].shape == (3,)


# ------------------------------------------------------------ chkvar

def _corrupt(state, name, k, j, i, value):
    d = dict(state)
    d[name] = state[name].copy()
    d[name][1, k, j, i] = value
    return d


@pytest.mark.parametrize('case', ['good', 'nan_temp', 'neg_dp',
                                  'salty', 'two'])
def test_chkvar_matches_blom_tpu(blom_side, grids, case):
    st = blom_side['state']
    if case == 'nan_temp':
        st = _corrupt(st, 'temp', 2, 3, 5, np.nan)
    elif case == 'neg_dp':
        st = _corrupt(st, 'dp', 0, 1, 7, -1.)
    elif case == 'salty':
        st = _corrupt(st, 'saln', 4, 6, 9, 101.)
    elif case == 'two':
        st = _corrupt(_corrupt(st, 'temp', 1, 2, 3, 60.), 'saln', 0, 2, 3,
                      np.inf)
    js, ts = jax_obj(jstate.State, st), convert.state_from_numpy(st)
    jok, jbad = jchk.chkvar(grids[0], js, 1)
    tok, tbad = tchk.chkvar(grids[1], ts, 1)
    assert bool(tok) == bool(jok) == (case == 'good')
    assert {k: int(v) for k, v in tbad.items()} == \
        {k: int(v) for k, v in jbad.items()}
    if case == 'good':
        tchk.chkvar_host(grids[1], ts, 1, nstep=3)
        return
    with pytest.raises(FloatingPointError) as jerr:
        jchk.chkvar_host(grids[0], js, 1, nstep=3)
    with pytest.raises(FloatingPointError) as terr:
        tchk.chkvar_host(grids[1], ts, 1, nstep=3)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ checksums

@pytest.mark.parametrize('dtype', ['f8', 'f4', 'i4'])
def test_field_crc_matches_blom_tpu(dtype):
    a = np.random.default_rng(5).normal(size=(3, 7, 11)).astype(dtype)
    ref = jcks.field_crc(jnp.asarray(a))
    assert tcks.field_crc(torch.from_numpy(a)) == ref
    assert tcks.field_crc(a) == ref


def test_state_checksums_match_blom_tpu(blom_side, capsys):
    js, ts = _states(blom_side)
    assert tcks.state_checksums(ts) == jcks.state_checksums(js)
    jcks.print_checksums('tag', js)
    ref = capsys.readouterr().out
    tcks.print_checksums('tag', ts)
    assert capsys.readouterr().out == ref


# ------------------------------------------------------------ merdia

def test_zlev_matches_blom_tpu(blom_side):
    js, ts = _states(blom_side)
    from blom_tpu.core.state import cumulative_p as jcp
    from blom_tpu_torch.core.state import cumulative_p as tcp
    jp, tp = jcp(js.dp[1]), tcp(ts.dp[1])
    assert rel_err(jmer.zlev_overlap(jp), tmer.zlev_overlap(tp)) <= TOL
    for name in ('temp', 'saln', 'v'):
        f = getattr(js, name)[1], getattr(ts, name)[1]
        assert rel_err(jmer.to_zlev(f[0], jp, fill=-1.),
                       tmer.to_zlev(f[1], tp, fill=-1.)) <= TOL
    np.testing.assert_array_equal(tmer.DEPTHSLEV, jmer.DEPTHSLEV)
    np.testing.assert_array_equal(tmer.DEPTHSLEV_BNDS, jmer.DEPTHSLEV_BNDS)


def test_transports_match_blom_tpu(blom_side):
    js, ts = _states(blom_side)
    rng = np.random.default_rng(7)
    shape = ts.dp.shape[2:]
    vlat = rng.uniform(-80., 80., shape)
    region = (rng.uniform(size=shape) > .3).astype(float)
    lats = np.arange(-89.5, 90., 5.)
    jw = jmer.lat_bin_weights(jnp.asarray(vlat), jnp.asarray(lats),
                              jnp.asarray(region))
    tw = tmer.lat_bin_weights(torch.tensor(vlat), lats, torch.tensor(region))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    for name in ('vflx', 'vtflx', 'vsflx'):
        jf, tf = getattr(js, name)[1], getattr(ts, name)[1]
        scale = float(jnp.abs(jf).sum())
        for fn, kw in ((jmer.overturning_streamfunction, dict(scale=.1)),
                       (jmer.meridional_transport, dict(scale=2.))):
            ref = np.asarray(fn(jf, jw, **kw))
            out = getattr(tmer, fn.__name__)(tf, tw, **kw).numpy()
            assert np.abs(out - ref).max() <= TOL * scale * 2.
    for fn, args in ((jmer.section_masks_along_i, (5,)),
                     (jmer.section_masks_along_i, (3, (1, 6))),
                     (jmer.section_masks_along_j, (2,)),
                     (jmer.section_masks_along_j, (4, (2, 20)))):
        jm = fn(shape, *args)
        tm = getattr(tmer, fn.__name__)(shape, *args)
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        ref = float(jmer.section_transport(js.uflx[1], js.vflx[1], *jm))
        out = float(tmer.section_transport(ts.uflx[1], ts.vflx[1], *tm))
        assert abs(out - ref) <= TOL * float(jnp.abs(js.uflx[1]).sum()
                                             + jnp.abs(js.vflx[1]).sum())


def test_wdiflx_matches_blom_tpu(tmp_path):
    rng = np.random.default_rng(9)
    acc = rng.normal(size=(48, 5, 6))
    count = rng.integers(0, 4, 48)
    ref = jwd.wdiflx(str(tmp_path / 'j.npz'), jnp.asarray(acc),
                     jnp.asarray(count), 'hflx')
    out = twd.wdiflx(str(tmp_path / 't.npz'), torch.tensor(acc),
                     torch.tensor(count), 'hflx')
    np.testing.assert_array_equal(out, ref)
    with np.load(tmp_path / 'j.npz') as a, np.load(tmp_path / 't.npz') as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ bgcmean

@pytest.fixture(scope='module')
def bgc_steps():
    """NOINYOC: the port's two steps with the BGC diagnostics of each."""
    m = tst.build_fuk95(use_idlage=True, use_bgc=True, device='cpu',
                        itdm=24, jtdm=8, kdm=8)
    s, dfl, c = m.state.clone(), m.dfl, m.clock
    steps = []
    for i in range(2):
        mm, n = (0, 1) if i % 2 == 0 else (1, 0)
        diags = []
        s, dfl = tstep.blom_step(m.grid, m.e, m.par, m.coeffs_i,
                                 m.coeffs_j, s, m.forcing, dfl, mm, n,
                                 c.delt1, m.swabs, m.bgc_forcing,
                                 bgc_diag_out=diags)
        c = c.step()
        assert len(diags) == 1
        steps.append((np_fields(s), {k: v.numpy().copy()
                                     for k, v in diags[0].items()}, n))
    return m, steps


def test_bgcmean_matches_blom_tpu(bgc_steps, tmp_path):
    m, steps = bgc_steps
    d = grid_np(m.grid)
    jg, tg = jax_grid(d), port_grid(d)
    fields = tuple(jbm.FIELD_REGISTRY)
    groups = []
    for bm, g, to_state, to_diag in (
            (jbm, jg, lambda s: jax_obj(jstate.State, s), jnp.asarray),
            (tbm, tg, convert.state_from_numpy, torch.tensor)):
        grp = bm.init_bgcm(g, to_state(steps[0][0]), m.par.itrbgc,
                           fields=fields)
        for s, diags, n in steps:
            grp = bm.acc_bgcm(grp, g, to_state(s), n, m.par.itrbgc,
                              {k: to_diag(v) for k, v in diags.items()})
        groups.append(grp)
    jgrp, tgrp = groups
    assert float(tgrp.nacc) == float(jgrp.nacc) == 2.
    jmean, tmean = jbm.finalize_bgcm(jgrp), tbm.finalize_bgcm(tgrp)
    assert list(tmean) == list(jmean) == list(fields)
    for k in fields:
        # no denitrification or N fixation in fuk95's oxygenated,
        # nitrate-rich water after two steps
        if k not in ('intdnit', 'intnfix'):
            assert np.abs(np.asarray(jmean[k])).max() > 0, k
        assert rel_err(jmean[k], tmean[k]) <= TOL, k
    # the writers, given the port's accumulators
    carried = jbm.BgcmGroup(
        nacc=jnp.asarray(tgrp.nacc.numpy()),
        acc={k: jnp.asarray(v.numpy()) for k, v in tgrp.acc.items()},
        wgt={k: jnp.asarray(v.numpy()) for k, v in tgrp.wgt.items()},
        fields=tgrp.fields)
    jbm.write_bgcm(str(tmp_path / 'j.nc'), jg, carried, 2.5)
    tbm.write_bgcm(str(tmp_path / 't.nc'), tg, tgrp, 2.5)
    with netcdf_file(str(tmp_path / 'j.nc'), 'r', mmap=False) as a, \
            netcdf_file(str(tmp_path / 't.nc'), 'r', mmap=False) as b:
        assert list(a.variables) == list(b.variables)
        for k in a.variables:
            np.testing.assert_array_equal(b.variables[k][:],
                                          a.variables[k][:], err_msg=k)
    reset = tbm.reset_bgcm(tgrp)
    assert float(reset.nacc) == 0.
    assert all(not v.any() for v in reset.acc.values())


# ------------------------------------------------------------ utils

def test_ptest_matches_blom_tpu(blom_side, grids):
    js, ts = _states(blom_side)
    for n, i, j in ((0, 3, 2), (1, 10, 5)):
        assert (tpt.ptest(ts, n, i, j, grid=grids[1])
                == jpt.ptest(js, n, i, j, grid=grids[0]))
        assert tpt.ptest(ts, n, i, j) == jpt.ptest(js, n, i, j)


def test_timers_match_blom_tpu(blom_side):
    t, j = ttim.Timers(), jtim.Timers()
    _, ts = _states(blom_side)
    for name in ('step', 'dia', 'step'):
        t.start(name)
        dt = t.stop(name, block_on=ts)
        assert dt >= 0.
    assert t.count == {'step': 2, 'dia': 1}
    for k in ('total', 'count', 'min', 'max'):
        setattr(j, k, dict(getattr(t, k)))
    assert t.statistics() == j.statistics()
    assert t.step_line(7) == j.step_line(7)
    assert t.statistics().splitlines()[0].startswith('timer')


# ------------------------------------------------------------ run_case

def _deck(tmp_path):
    path = tmp_path / 'limits'
    path.write_text(DECK)
    return str(path)


def test_run_case_writes_blom_tpu_files(tmp_path):
    """tests/test_dia_groups.py's deck through the port at 24x8x8 (its
    sub-daily group fires every 2 steps, its compressed group at the end
    of the run)."""
    old = tst.build_fuk95
    tst.build_fuk95 = functools.partial(old, itdm=24, jtdm=8, kdm=8)
    try:
        model, cfg = tcase.build_case(_deck(tmp_path), device='cpu')
    finally:
        tst.build_fuk95 = old
    run = tmp_path / 'run'
    run.mkdir()
    s, clock, crc = tcase.run_case(model, cfg, rundir=str(run), nsteps=4)
    assert clock.nstep == 4
    files = sorted(os.listdir(run))
    hd = [f for f in files if f.startswith('dg001_hd_')]
    hm = [f for f in files if f.startswith('dg001_hm_')]
    assert len(hd) == 2 and len(hm) == 1
    assert 'run.status' in files and 'rstdate.txt' in files
    assert (run / 'run.status').read_text() == 'success\n'
    assert crc == tcks.field_crc(s.dp)
    wet = model.grid.ip.numpy() > 0
    with netcdf_file(str(run / hd[-1]), 'r', mmap=False) as f:
        assert {'sst', 'sss', 'mldl82mx', 'taux', 'tempga'} \
            <= set(f.variables)
        assert np.isfinite(f.variables['sst'][0][wet]).all()
    with netcdf_file(str(run / hm[0]), 'r', mmap=False) as f:
        assert 'pcomp' in f.dimensions
        assert {'temp', 'salnlvl', 'mldl82', 'sst'} <= set(f.variables)
        assert np.isfinite(f.variables['temp'][:]).all()


def _fake_step_jax(grid, e, par, ci, cj, s, forcing, dfl, m, n, delt1,
                   *args, budget_out=None, bgc_diag_out=None):
    """The same map of the state in both packages: level n from level m."""
    return dataclasses.replace(
        s, temp=s.temp.at[n].set(s.temp[m] + .01),
        saln=s.saln.at[n].set(s.saln[m] - .001),
        dp=s.dp.at[n].set(s.dp[m] * 1.001),
        u=s.u.at[n].set(s.u[m] * .9 + .001),
        v=s.v.at[n].set(s.v[m] * .9 - .001)), dfl


def _fake_step_torch(grid, e, par, ci, cj, s, forcing, dfl, m, n, delt1,
                     *args, budget_out=None, bgc_diag_out=None):
    s.temp[n] = s.temp[m] + .01
    s.saln[n] = s.saln[m] - .001
    s.dp[n] = s.dp[m] * 1.001
    s.u[n] = s.u[m] * .9 + .001
    s.v[n] = s.v[m] * .9 - .001
    return s, dfl


def test_run_case_matches_blom_tpu_on_equal_steps(tmp_path, monkeypatch):
    deck = _deck(tmp_path)
    for mod, size in ((jst, dict(itdm=24, jtdm=8, kdm=8)),
                      (tst, dict(itdm=24, jtdm=8, kdm=8))):
        monkeypatch.setattr(mod, 'build_fuk95',
                            functools.partial(mod.build_fuk95, **size))
    jmodel, jcfg = jcase.build_case(deck)
    tmodel, tcfg = tcase.build_case(deck, device='cpu')
    tmodel.state = convert.state_from_numpy(np_fields(jmodel.state))
    monkeypatch.setattr(jstep, 'blom_step', _fake_step_jax)
    monkeypatch.setattr(jst, 'blom_step', _fake_step_jax)
    monkeypatch.setattr(tst, 'blom_step', _fake_step_torch)
    dirs = {'j': tmp_path / 'j', 't': tmp_path / 't'}
    for d in dirs.values():
        d.mkdir()
    with jax.disable_jit():
        js, jclock, jcrc = jcase.run_case(jmodel, jcfg, rundir=str(dirs['j']),
                                          nsteps=4)
    ts, tclock, tcrc = tcase.run_case(tmodel, tcfg, rundir=str(dirs['t']),
                                      nsteps=4)
    assert tcrc == jcrc
    files = sorted(os.listdir(dirs['j']))
    assert sorted(os.listdir(dirs['t'])) == files
    assert len([f for f in files if f.endswith('.nc')]) == 3
    for name in files:
        if name.endswith('.nc'):
            with netcdf_file(str(dirs['j'] / name), 'r', mmap=False) as a, \
                    netcdf_file(str(dirs['t'] / name), 'r',
                                mmap=False) as b:
                assert dict(a.dimensions) == dict(b.dimensions)
                assert list(a.variables) == list(b.variables)
                for k in a.variables:
                    ref = a.variables[k][:]
                    assert b.variables[k].dimensions \
                        == a.variables[k].dimensions, k
                    assert rel_err(ref, b.variables[k][:]) <= TOL, \
                        (name, k)
        elif name.endswith('.npz'):
            with np.load(dirs['j'] / name) as a, \
                    np.load(dirs['t'] / name) as b:
                for k in a.files:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert ((dirs['t'] / name).read_text()
                    == (dirs['j'] / name).read_text())
