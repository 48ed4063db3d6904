"""Exact restarts in the port (`io/restart.py`) and the restart files of
both packages, on CPU in f64 at 24x8x8 with bench.py's physics.

- ERS (the exact-restart test of tools/testsuite.py:97-126, here for
  NOINY and NOINYAGE): 4 steps straight against 2 steps, write_restart,
  read_restart and 2 more steps; every State field bit for bit, with the
  second half started from the diffusion fields the first half left
  (carried) and from a fresh model's (zero).
- A file blom_tpu wrote, of the port's state after two steps, reads in
  the port as that state, bit for bit, with blom_tpu's clock; the port's
  step from it agrees with blom_tpu's step from the same file within
  test_torch_slice.py's one-step tolerances (1e-6 for the prognostic
  fields, 1e-5 for the rest: the two steps round apart, barotp most,
  ~1e-7).  The reverse: a file the port wrote reads in blom_tpu as that
  state, bit for bit.
- restart_filename (the rotation by count and by month, the annual
  names), restart_write_rotating and rstdate.txt against blom_tpu's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from blom_tpu.core import modeltime as jmt
from blom_tpu.core import state as jstate
from blom_tpu.drivers import standalone as jst
from blom_tpu.dynamics import difest as jdf
from blom_tpu.dynamics import diffusion_fields as jdff
from blom_tpu.io import restart as jrst
from blom_tpu_torch import convert
from blom_tpu_torch.core import modeltime as tmt
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import difest as tdf
from blom_tpu_torch.dynamics.diffusion_fields import zero_diffusion_fields
from blom_tpu_torch.io import restart as trst
from tests.test_torch_dia import jax_obj, np_fields
from tests.torch_shared import shared, shared_build

SIZE = dict(itdm=24, jtdm=8, kdm=8)
BENCH = dict(egc=.85, egmndf=100.)
PROGNOSTIC = ('u', 'v', 'dp', 'temp', 'saln', 'pb')
CLOCK_KEYS = ('calendar', 'baclin', 'batrop', 'lstep', 'dlt',
              'nstep_in_day', 'date0', 'date', 'nstep0', 'nstep', 'time0',
              'time')


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def port_model(idlage=False):
    m = tst.build_fuk95(use_idlage=idlage, device='cpu', **SIZE)
    m.par = m.par._replace(difest=tdf.DifestParams(**BENCH))
    return m


def clock_dict(c):
    return {k: (getattr(c, k).to_ymd() if k.startswith('date')
                else getattr(c, k)) for k in CLOCK_KEYS}


def assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


# ------------------------------------------------------------------ ERS

@pytest.mark.parametrize('dfl', ['carried', 'fresh'])
@pytest.mark.parametrize('case', ['NOINY', 'NOINYAGE'])
def test_ers_bitwise(tmp_path, case, dfl):
    m = port_model(idlage=case == 'NOINYAGE')
    dfl0 = m.dfl
    s4, c4 = tst.run(m, 4)
    m.dfl = dfl0
    s2, c2 = tst.run(m, 2)
    path = str(tmp_path / 'rest.npz')
    trst.write_restart(path, s2, c2)
    sr, cr = trst.read_restart(path, device='cpu')
    assert_states_equal(s2, sr)
    assert clock_dict(cr) == clock_dict(c2)
    if dfl == 'fresh':
        m.dfl = zero_diffusion_fields(m.grid.kk, m.grid.shape,
                                      torch.float64, 'cpu')
    s4r, c4r = tst.run(dataclasses.replace(m, state=sr, clock=cr), 2)
    assert clock_dict(c4r) == clock_dict(c4)
    assert_states_equal(s4, s4r)
    if case == 'NOINYAGE':
        assert float(s4.trc[1, 0].max()) > 0.


# ------------------------------------------- files across the packages

def _snapshot():
    m = port_model()
    s, c = tst.run(m, 2)
    return np_fields(s), np_fields(m.dfl)


def _blom_side(tmp_path_factory):
    """The port's state after two steps, written by the port; blom_tpu
    reads that file and steps once from it (jitted driver)."""
    def build():
        state, dfl = _snapshot()
        path = str(tmp_path_factory.mktemp('port_file') / 'port.npz')
        c = tmt.init_timevars('fuk95', 180., 6., 20000101, 20000101)
        c = c.step().step()
        trst.write_restart(path, convert.state_from_numpy(state), c)
        js, jc = jrst.read_restart(path)
        jm = shared_build(tmp_path_factory, jst.build_fuk95, **SIZE)
        jm = dataclasses.replace(
            jm, state=js, clock=jc,
            dfl=jax_obj(jdff.DiffusionFields, dfl),
            par=jm.par._replace(difest=jdf.DifestParams(**BENCH)))
        s1, c1, extras = jst.run(jm, 1, cnsvdi=True, chk=True)
        return dict(state=state, dfl=dfl, read=np_fields(js),
                    read_clock=clock_dict(jc), clock=clock_dict(c),
                    step=np_fields(s1), step_clock=clock_dict(c1),
                    budgets={k: np.asarray(v) for k, v
                             in extras['budgets']._asdict().items()},
                    ok=np.asarray(extras['ok']))
    return shared(tmp_path_factory, 'restart_blom_side', build)


@pytest.fixture(scope='module')
def blom_side(tmp_path_factory):
    return _blom_side(tmp_path_factory)


def test_port_file_reads_in_blom_tpu(blom_side):
    assert blom_side['read'].keys() == blom_side['state'].keys()
    for k, a in blom_side['state'].items():
        b = blom_side['read'][k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert blom_side['read_clock'] == blom_side['clock']


def test_blom_tpu_file_reads_in_port(blom_side, tmp_path):
    """blom_tpu writes the state it read; the port reads it bit for bit
    and steps once from it, as blom_tpu did."""
    js = jax_obj(jstate.State, blom_side['read'])
    jc = jmt.init_timevars('fuk95', 180., 6., 20000101,
                           20000101).step().step()
    path = str(tmp_path / 'blom.npz')
    jrst.write_restart(path, js, jc)
    ts, tc = trst.read_restart(path, device='cpu')
    assert_states_equal(js, ts)
    assert clock_dict(tc) == blom_side['clock']

    m = port_model()
    m.dfl = convert.diffusion_fields_from_numpy(blom_side['dfl'])
    s1, c1 = tst.run(dataclasses.replace(m, state=ts, clock=tc), 1)
    assert clock_dict(c1) == blom_side['step_clock']
    for k, ref in blom_side['step'].items():
        if not ref.size:
            continue
        err = (np.abs(getattr(s1, k).numpy() - ref).max()
               / max(np.abs(ref).max(), 1e-300))
        assert err <= (1e-6 if k in PROGNOSTIC else 1e-5), (k, err)


def test_read_restart_dtype_and_device(tmp_path, monkeypatch):
    m = port_model(idlage=True)
    path = str(tmp_path / 'r.npz')
    trst.write_restart(path, m.state, m.clock)
    s, _ = trst.read_restart(path, dtype=torch.float32, device='cpu')
    assert s.dp.dtype == torch.float32 and s.trc.dtype == torch.float32
    assert s.kfpla.dtype == torch.int32
    np.testing.assert_array_equal(s.dp.numpy(),
                                  m.state.dp.numpy().astype(np.float32))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        trst.read_restart(path)


# ------------------------------------------------------ names and logs

def _clocks(mt, ymd, nsteps, baclin=4320.):
    c = mt.init_timevars('fuk95', baclin, 60., ymd, ymd)
    out = []
    for _ in range(nsteps):
        c = c.step()
        out.append(c)
    return out


@pytest.mark.parametrize('kw', [dict(), dict(rstfrq=5.), dict(rstfrq=.5),
                                dict(rstmon=True), dict(annual=True)])
def test_restart_filename_matches_blom_tpu(kw):
    for ymd in (20000115, 20001201):
        for tc, jc in zip(_clocks(tmt, ymd, 200), _clocks(jmt, ymd, 200)):
            assert (trst.restart_filename('run1', tc, **kw)
                    == jrst.restart_filename('run1', jc, **kw))


def test_rotating_restarts_match_blom_tpu(tmp_path):
    """Five rotating writes (and one annual) into a directory per
    package: the same files, the same arrays in them, the same
    rstdate.txt."""
    m = port_model()
    js = jax_obj(jstate.State, np_fields(m.state))
    dirs = {'t': tmp_path / 't', 'j': tmp_path / 'j'}
    for d in dirs.values():
        d.mkdir()
    tcl, jcl = _clocks(tmt, 20000101, 100), _clocks(jmt, 20000101, 100)
    for i in (19, 39, 59, 79, 99):
        for annual in (False, True) if i == 99 else (False,):
            trst.restart_write_rotating(str(dirs['t']), 'run1', m.state,
                                        tcl[i], rstfrq=20., annual=annual)
            jrst.restart_write_rotating(str(dirs['j']), 'run1', js, jcl[i],
                                        rstfrq=20., annual=annual)
    names = sorted(os.listdir(dirs['t']))
    assert names == sorted(os.listdir(dirs['j']))
    assert len(names) == 5      # three slots, the annual file, rstdate.txt
    assert ((dirs['t'] / 'rstdate.txt').read_text()
            == (dirs['j'] / 'rstdate.txt').read_text())
    for name in names:
        if not name.endswith('.npz'):
            continue
        with np.load(dirs['t'] / name) as a, np.load(dirs['j'] / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
