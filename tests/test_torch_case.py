"""The port's limits-deck path against blom_tpu's, on CPU in f64.

The three channel decks of chip_smoke.py (A: enecon, partial /
non-oscillatory CPPM, monotonic ALE limiters; B: enedis, full /
monotonic CPPM, posdef tracer limiter; C: enscon, partial / monotonic
CPPM) are written to files in f64 and read by both packages:

- `load_limits` gives the same configuration, field for field;
- `build_case` builds the same channel at 16x24x8 (both packages'
  `configs/channel.py` sizes patched, which `build_channel` reads when
  called): the grid and the CPPM coefficients exactly, the initial state
  to rounding, the same step parameters;
- one step of each deck, from the same state, agrees to 1e-10 relative
  with blom_tpu's step run op by op (`jax.disable_jit`).  Compiled, its
  scans contract multiply-adds: the barotropic substeps then differ by
  ~1e-7 relative (terms that cancel by ~1e6, as in test_torch_slice.py)
  and the Thomas solves of the vertical diffusion by ~3e-10 in massless
  bottom layers, whose values are rounding amplified by the solver's
  1e-30 diagonal; run op by op the two agree to rounding;
- in f32 blom_tpu's own channel turns NaN in its first ALE
  regrid/remap (run as on a TPU, without 64-bit types): next to the
  vanishing bottom layers of the shelf columns the 4th-order edge
  weights overflow f32 (ROADMAP section 3).  The port's ALE step gives
  NaN in exactly the same places and agrees elsewhere to f32 rounding;
- in f64 blom_tpu's own channel, run op by op, turns NaN within a few
  steps too (deck C at 16x24x8: finite after the first step, NaN after
  the ninth; ROADMAP section 3);
- a fuk95 deck with &VCOORD VCOORD_TYPE = 'isopyc_bulkml' builds the
  isopycnic fuk95 through both packages' build_case, with the same
  parameters and (to rounding) the same initial state;
- a &DIAPHY group gives blom_tpu's dia_groups; the other experiments
  (single_column, noforcing, ben02clim, ben02syn, cesm) build as
  blom_tpu builds them."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from blom_tpu.configs import channel as jch
from blom_tpu.core import config as jconfig
from blom_tpu.drivers import case as jcase
from blom_tpu.dynamics import ale as jal
from blom_tpu.dynamics import step as jstep
from blom_tpu_torch import convert
from blom_tpu_torch.configs import channel as tch
from blom_tpu_torch.core import config as tconfig
from blom_tpu_torch.core.grid import TENSOR_FIELDS
from blom_tpu_torch.drivers import case as tcase
from blom_tpu_torch.dynamics import ale as tal
from blom_tpu_torch.dynamics import step as tstep

from chip_smoke import DECKS, deck_text

SIZE = dict(ITDM=16, JTDM=24, KDM=8)


@pytest.fixture(autouse=True)
def _small_channel(monkeypatch):
    torch.set_num_threads(1)
    for mod in (jch, tch):
        for name, v in SIZE.items():
            monkeypatch.setattr(mod, name, v)


def _deck(tmp_path, name, **subs):
    text = deck_text(name, 'float64')
    for old, new in subs.items():
        text = text.replace(old, new)
    path = tmp_path / f'limits_{name}'
    path.write_text(text)
    return str(path)


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not isinstance(getattr(obj, f.name), (bool, int))}


@pytest.mark.parametrize('name', sorted(DECKS))
def test_load_limits_matches_blom_tpu(tmp_path, name):
    path = _deck(tmp_path, name)
    ref = dataclasses.asdict(jconfig.load_limits(path))
    out = dataclasses.asdict(tconfig.load_limits(path))
    assert out == ref
    mommth, compat, lim, tlim, vlim = DECKS[name]
    assert (out['mommth'], out['cppm_compatibility'], out['cppm_limiting'],
            out['ale']['tracer_limiting'], out['ale']['velocity_limiting'],
            out['expcnf'], out['dtype']) == (mommth, compat, lim, tlim, vlim,
                                             'channel', 'float64')


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    """Both packages' build_case of every deck, at the small size."""
    mp = pytest.MonkeyPatch()
    for mod in (jch, tch):
        for name, v in SIZE.items():
            mp.setattr(mod, name, v)
    out = {}
    tmp = tmp_path_factory.mktemp('decks')
    try:
        for name in DECKS:
            path = _deck(tmp, name)
            out[name] = (jcase.build_case(path)[0],
                         tcase.build_case(path, device='cpu')[0])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize('name', sorted(DECKS))
def test_build_case_matches_blom_tpu(built, name):
    jm, tm = built[name]
    assert tm.grid.shape == (SIZE['JTDM'], SIZE['ITDM'])
    assert tm.grid.kk == SIZE['KDM']
    assert (tm.grid.periodic_i, tm.grid.periodic_j) == (True, False)
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm.grid, f).numpy(),
                                      np.asarray(getattr(jm.grid, f)),
                                      err_msg=f)
    for co_j, co_t in ((jm.coeffs_i, tm.coeffs_i),
                       (jm.coeffs_j, tm.coeffs_j)):
        for f in co_t._fields:
            np.testing.assert_array_equal(getattr(co_t, f).numpy(),
                                          np.asarray(getattr(co_j, f)),
                                          err_msg=f)
    for f, a in _np_fields(jm.state).items():
        b = getattr(tm.state, f).numpy()
        assert b.shape == a.shape, f
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-10 * np.abs(a).max(initial=0.) + 1e-11,
            err_msg=f)
    for f, a in _np_fields(jm.forcing).items():
        np.testing.assert_array_equal(getattr(tm.forcing, f).numpy(), a,
                                      err_msg=f)
    assert float(tm.forcing.taux.min()) == -.05
    for f in ('baclin', 'lstep', 'dlt', 'pgfmth', 'advmth',
              'cppm_compatibility', 'cppm_limiting', 'vcoord_isopyc'):
        assert getattr(tm.par, f) == getattr(jm.par, f), f
    for f in ('momtum', 'barotp', 'ale', 'vmix', 'difest'):
        assert getattr(tm.par, f)._asdict() == \
            getattr(jm.par, f)._asdict(), f
    mommth, compat, lim, tlim, vlim = DECKS[name]
    assert (tm.par.momtum.mommth, tm.par.barotp.mommth,
            tm.par.cppm_compatibility, tm.par.cppm_limiting,
            tm.par.ale.tracer_limiting, tm.par.ale.velocity_limiting) == \
        (mommth, mommth, compat, lim, tlim, vlim)


@pytest.mark.parametrize('name', sorted(DECKS))
def test_one_step_matches_blom_tpu(built, name):
    jm, tm = built[name]
    d1 = jm.clock.delt1
    with jax.disable_jit():
        js, _ = jstep.blom_step(jm.grid, jm.e, jm.par, jm.coeffs_i,
                                jm.coeffs_j, jm.state, jm.forcing, jm.dfl,
                                0, 1, d1, jm.swabs)
    s = convert.state_from_numpy(_np_fields(jm.state))
    ts, _ = tstep.blom_step(tm.grid, tm.e, tm.par, tm.coeffs_i, tm.coeffs_j,
                            s, tm.forcing, tm.dfl, 0, 1, d1, tm.swabs)
    bad = {}
    for f, a in _np_fields(js).items():
        if a.size:
            err = float(np.abs(a - getattr(ts, f).numpy()).max()
                        / max(np.abs(a).max(), 1e-300))
            if err > 1e-10:
                bad[f] = err
    assert not bad, bad
    # the wind drives a current
    assert float((ts.u[1] + ts.ub[1]).abs().max()) > 0.


def test_f32_channel_ale_matches_blom_tpu(tmp_path):
    path = _deck(tmp_path, 'C', **{"'float64'": "'float32'"})
    with jax.enable_x64(False):
        jm = jcase.build_case(path)[0]
        js = jal.ale_regrid_remap(jm.grid, jm.e, jm.par.ale, jm.state, 0, 1,
                                  jm.clock.delt1)
        ref = _np_fields(js)
        start = _np_fields(jm.state)
    tm = tcase.build_case(path, device='cpu')[0]
    ts = tal.ale_regrid_remap(
        tm.grid, tm.e, tm.par.ale,
        convert.state_from_numpy(start, dtype=torch.float32), 0, 1,
        tm.clock.delt1)
    assert not np.isfinite(ref['temp']).all()      # the reference fault
    for f in ('dp', 'temp', 'saln', 'sigma', 'u', 'v'):
        a, b = ref[f], getattr(ts, f).numpy()
        assert b.dtype == a.dtype == np.float32, f
        fin = np.isfinite(a)
        np.testing.assert_array_equal(np.isfinite(b), fin, err_msg=f)
        np.testing.assert_allclose(
            b[fin], a[fin], rtol=0,
            atol=1e-5 * np.abs(a[fin]).max(initial=0.), err_msg=f)


def test_f64_channel_turns_nan_in_blom_tpu(built):
    """blom_tpu's own channel in f64, deck C at 16x24x8, run op by op:
    finite after its first step, NaN within 12 (after the ninth here)."""
    jm = built['C'][0]
    s, dfl, clock = jm.state, jm.dfl, jm.clock
    finite = []
    with jax.disable_jit():
        while len(finite) < 12 and all(finite):
            m, n = (0, 1) if len(finite) % 2 == 0 else (1, 0)
            s, dfl = jstep.blom_step(jm.grid, jm.e, jm.par, jm.coeffs_i,
                                     jm.coeffs_j, s, jm.forcing, dfl, m, n,
                                     clock.delt1, jm.swabs)
            clock = clock.step()
            finite.append(all(np.isfinite(np.asarray(getattr(s, f))).all()
                              for f in ('dp', 'temp', 'saln', 'u', 'v',
                                        'pb')))
    assert finite[0] and not finite[-1], finite


def test_isopyc_deck_builds_as_blom_tpu(tmp_path):
    """The deck's vertical coordinate reaches build_fuk95: the isopycnic
    fuk95 at the deck's default size, with blom_tpu's parameters and
    initial state."""
    path = tmp_path / 'limits_fuk95_isopyc'
    path.write_text(deck_text('C', 'float64', 'fuk95')
                    + "&VCOORD\n  VCOORD_TYPE = 'isopyc_bulkml'\n/\n")
    jm, jcfg = jcase.build_case(str(path))
    tm, tcfg = tcase.build_case(str(path), device='cpu')
    assert tcfg.vcoord.vcoord_type == jcfg.vcoord.vcoord_type \
        == 'isopyc_bulkml'
    assert tm.par.vcoord_isopyc and tm.par.ale is None
    for f in ('baclin', 'lstep', 'dlt', 'pgfmth', 'advmth',
              'cppm_compatibility', 'cppm_limiting', 'vcoord_isopyc', 'ale',
              'ltedtp'):
        assert getattr(tm.par, f) == getattr(jm.par, f), f
    for f in ('momtum', 'barotp', 'vmix', 'difest', 'mxlayr'):
        assert getattr(tm.par, f)._asdict() == \
            getattr(jm.par, f)._asdict(), f
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm.grid, f).numpy(),
                                      np.asarray(getattr(jm.grid, f)),
                                      err_msg=f)
    for f, a in _np_fields(jm.state).items():
        np.testing.assert_allclose(
            getattr(tm.state, f).numpy(), a, rtol=0,
            atol=1e-10 * np.abs(a).max(initial=0.) + 1e-11, err_msg=f)
    tstep.check_supported(tm.grid, tm.par)


@pytest.mark.parametrize('method', ['ppm_ih4', 'pqm', 'plm'])
def test_reconstruction_method_deck_matches_blom_tpu(tmp_path, monkeypatch,
                                                     method):
    """A fuk95 deck with &ALE_REGRID_REMAP RECONSTRUCTION_METHOD builds
    in both packages with the same ALE parameters, which the port's step
    takes, and one step from the same state agrees to 1e-10 with
    blom_tpu's step run op by op.  'plm' is not a method of either
    package: blom_tpu's dispatch runs explicit-edge PPM for it, and so
    does the port's, off the ALE kernels as in blom_tpu.  The implicit
    edges solve nearly singular systems next to the empty bottom layers,
    where the two packages' LAPACK round apart (1e-10 of T after one
    step), so both solve with one common solver here
    (test_torch_hor3map_highorder.py)."""
    from blom_tpu.configs import fuk95 as jfuk
    from tests.test_torch_hor3map_highorder import use_common_solver
    from blom_tpu_torch.configs import fuk95 as tfuk
    for mod in (jfuk, tfuk):
        for name, v in dict(ITDM=24, JTDM=8, KDM=8).items():
            monkeypatch.setattr(mod, name, v)
    path = tmp_path / f'limits_fuk95_{method}'
    path.write_text(deck_text('C', 'float64', 'fuk95').replace(
        '&ALE_REGRID_REMAP\n',
        f"&ALE_REGRID_REMAP\n  RECONSTRUCTION_METHOD = '{method}',\n"))
    jm, tm = jcase.build_case(str(path))[0], tcase.build_case(
        str(path), device='cpu')[0]
    assert tm.par.ale._asdict() == jm.par.ale._asdict()
    assert tm.par.ale.reconstruction_method == method
    assert not tal.ale_kernels_ok(tm.par.ale)
    tstep.check_supported(tm.grid, tm.par)
    use_common_solver(monkeypatch)
    d1 = jm.clock.delt1
    with jax.disable_jit():
        js, _ = jstep.blom_step(jm.grid, jm.e, jm.par, jm.coeffs_i,
                                jm.coeffs_j, jm.state, jm.forcing, jm.dfl,
                                0, 1, d1, jm.swabs)
    s = convert.state_from_numpy(_np_fields(jm.state))
    ts, _ = tstep.blom_step(tm.grid, tm.e, tm.par, tm.coeffs_i, tm.coeffs_j,
                            s, tm.forcing, tm.dfl, 0, 1, d1, tm.swabs)
    bad = {}
    for f, a in _np_fields(js).items():
        if a.size:
            err = float(np.abs(a - getattr(ts, f).numpy()).max()
                        / max(np.abs(a).max(), 1e-300))
            if err > 1e-10:
                bad[f] = err
    assert not bad, bad


def test_diaphy_matches_blom_tpu(tmp_path):
    """A deck with &DIAPHY: the port's load_limits gives blom_tpu's
    dia_groups (the groups of tests/test_dia_groups.py's deck), and the
    rest of the config as before."""
    from tests.test_dia_groups import DECK
    path = _deck(tmp_path, 'A')
    with open(path, 'a') as f:
        f.write(DECK[DECK.index('&DIAPHY'):])
    ref = jconfig.load_limits(path)
    out = tconfig.load_limits(path)
    assert len(out.dia_groups) == len(ref.dia_groups) == 2
    for a, b in zip(out.dia_groups, ref.dia_groups):
        assert not b.sharded_output
        assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)} \
            == {f.name: getattr(b, f.name) for f in dataclasses.fields(a)}
    assert ('mldl82', 'max') in out.dia_groups[0].fields
    ref.dia_groups = out.dia_groups = ()
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


@pytest.mark.parametrize('expcnf', ['single_column', 'noforcing',
                                    'ben02clim', 'ben02syn', 'cesm'])
def test_expcnf_matches_blom_tpu(tmp_path, expcnf):
    """Deck C as each of the other experiments of blom_tpu's dispatch:
    the single column (noforcing builds it too, as in blom_tpu) and the
    grid-file configurations from a GRFILE written by
    gridfiles.write_grid_file (the fuk95 geometry at 16x8, 4500 m deep,
    KDM 6; no ICFILE, so build_gridfile's fallback profile): the
    grid, CPPM coefficients, clock, EOS and parameters equal blom_tpu's,
    the state within 1e-12."""
    from test_torch_gridfile import _check_build, _fuk95_file
    subs = {"'channel'": f"'{expcnf}'"}
    if expcnf in ('ben02clim', 'ben02syn', 'cesm'):
        grfile = _fuk95_file(tmp_path, depth=4500.)
        subs['  DTYPE'] = (f"  GRFILE   = '{grfile}',\n"
                           "  KDM      = 6,\n  DTYPE")
    path = _deck(tmp_path, 'C', **subs)
    jm, jcfg = jcase.build_case(path)
    tm, tcfg = tcase.build_case(path, device='cpu')
    assert tcfg.expcnf == jcfg.expcnf == expcnf
    _check_build(jm, tm)
    assert tm.par.momtum.mommth == DECKS['C'][0]
    assert tm.grid.shape == ((1, 1) if expcnf in ('single_column',
                                                  'noforcing') else (8, 16))


def test_gridfile_deck_needs_grfile(tmp_path):
    path = _deck(tmp_path, 'C', **{"'channel'": "'cesm'"})
    for case in (jcase, tcase):
        with pytest.raises(ValueError, match='GRFILE'):
            case.build_case(path, **({} if case is jcase
                                     else {'device': 'cpu'}))


def test_build_case_needs_cuda_or_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tcase.build_case(_deck(tmp_path, 'A'))
