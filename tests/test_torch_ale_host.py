"""The CUDA ALE kernels K1 and K2 (blom_tpu_torch/csrc/ale_regrid.cu,
ale_remap.cu) on the CPU.

g++ compiles each kernel against the host shim blom_tpu_torch/csrc/
host_shim.h (each launch rewritten into a loop over blocks, one thread
per block, so every block-strided stage runs whole between two
barriers) into a library under tmp_path, called with ctypes on CPU
tensors; one case of each kernel runs each block as the launch's
threads, host threads meeting at a real barrier, which checks the
kernel's mapping of points to threads.  K2's layer means are held
against the plain version ale.remap_plain, K1's interfaces and
smooth_fac against ale.regrid_plain, in f64 on a small ragged grid (the
last tile of columns ends inside the grid) at |err| <= 1e-12 (1 + |ref|):
the kernels multiply by 1/3 and by 1/stab_fac_limit as PyTorch does on
the card, the CPU divides, so the two differ by ulps.  One f32 case of
each runs the f32 tile within 1e-4 of max |ref|, chip_smoke's f32
tolerance, and one takes more levels than the former cap of 64.  Skips
when g++ is absent."""

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from blom_tpu_torch.core import eos
from blom_tpu_torch.dynamics import ale
from blom_tpu_torch.ops import hor3map as h3

CSRC = Path(__file__).resolve().parents[1] / 'blom_tpu_torch' / 'csrc'
KK, J, I = 8, 3, 11          # 33 columns: f64 tiles of 16, f32 of 32
SHARED_OPTIN = 232448        # host_shim.h's opt-in shared memory
NOSC, POSDEF = h3.NON_OSCILLATORY, h3.NON_OSCILLATORY_POSDEF
PAIRS = [(lim, lim) for lim in ale.LIMITERS] + [(POSDEF, NOSC)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _host_build(tmp_path_factory, name, nargs):
    """csrc/<name>.cu built by g++ against the host shim and loaded: its
    entry points <name>_f32 and <name>_f64 take `nargs` pointers, and
    <name>_kk_max, where the library has one, an int and a long.  Built
    once per test run: under pytest-xdist in the run's directory common
    to its workers, which load the same library."""
    from filelock import FileLock

    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip(f'g++ is not installed: the host build of {name} needs '
                    'it')
    root = tmp_path_factory.getbasetemp()
    if os.environ.get('PYTEST_XDIST_WORKER'):
        root = root.parent
    d = root / f'{name}_host'
    so = d / f'lib{name}_host.so'
    with FileLock(f'{d}.lock'):
        if not so.is_file():
            d.mkdir(exist_ok=True)
            (d / 'cuda_runtime.h').write_text(
                f'#include "{CSRC / "host_shim.h"}"\n')
            for h in CSRC.glob('*.cuh'):
                shutil.copy(h, d / h.name)
            src = (CSRC / f'{name}.cu').read_text()
            src = re.sub(r'(\w+(?:<[^<>;]*>)?)\s*<<<([^,]+),([^,]+),([^,]+),'
                         r'[^>]+>>>\((.*?)\);',
                         r'shim_launch(\1, \2, \3, \4, \5);', src)
            src = re.sub(r'extern __shared__[^;]*\b(\w+)\[\];',
                         r'unsigned char *\1 = shim_shared();', src)
            assert 'shim_launch(' in src and 'shim_shared()' in src
            (d / f'{name}.cpp').write_text(src)
            part = d / f'lib{name}_host.part'
            subprocess.run([gxx, '-std=c++17', '-O1', '-ffp-contract=off',
                            '-shared', '-fPIC', '-pthread', '-I', str(d),
                            '-o', str(part), str(d / f'{name}.cpp')],
                           check=True, capture_output=True, text=True)
            part.replace(so)
    out = ctypes.CDLL(str(so))
    for t in ('f32', 'f64'):
        getattr(out, f'{name}_{t}').argtypes = [ctypes.c_void_p] * nargs
        getattr(out, f'{name}_{t}').restype = ctypes.c_int
    if hasattr(out, f'{name}_kk_max'):
        getattr(out, f'{name}_kk_max').argtypes = [ctypes.c_int,
                                                  ctypes.c_longlong]
        getattr(out, f'{name}_kk_max').restype = ctypes.c_int
    out.shim_set_block_threads.argtypes = [ctypes.c_int]
    return out


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """ale_remap.cu (K2) built by g++ against the host shim."""
    return _host_build(tmp_path_factory, 'ale_remap', 3)


@pytest.fixture(scope='module')
def k1(tmp_path_factory):
    """ale_regrid.cu (K1) built by g++ against the host shim."""
    return _host_build(tmp_path_factory, 'ale_regrid', 4)


def _inputs(dtype, ntr, kk=KK, seed=3):
    """chip_smoke.ale_inputs at a small size, with p_dst from the plain
    regrid and the velocity destination grids scaled from it; a few
    vanishing bottom layers, a u column whose interfaces decrease, a v
    column whose destination edges are out of order, a row of u columns
    whose destination edges are their source interfaces and a row of v
    columns whose edges lie an ulp above theirs."""
    rng = np.random.default_rng(seed)
    H3 = (kk, J, I)

    def cum(dp):
        return np.concatenate([np.zeros((1, J, I)), np.cumsum(dp, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype)
    dp = rng.uniform(.5, 3., H3) * 1.e4
    dp[-2:, 0, :3] = 0.
    p = cum(dp)
    temp, saln = rng.uniform(2., 18., H3), rng.uniform(33., 36., H3)
    sigmar = np.sort(rng.uniform(24., 28., H3), axis=0)
    trc = [rng.uniform(0., 2., H3) for _ in range(ntr)]
    u, v = rng.uniform(-.3, .3, H3), rng.uniform(-.3, .3, H3)
    pu = cum(rng.uniform(.5, 3., H3) * 1.e4)
    pv = cum(rng.uniform(.5, 3., H3) * 1.e4)
    pu[2, 1, 2] = pu[4, 1, 2] + 10.
    par = ale.make_ale_params(kk)
    p_dst = ale.regrid_plain(eos.init_eos(pref=0., expcnf='fuk95'), par,
                             t(p), t(temp), t(saln), t(sigmar), 360.)[0]
    pu_new, pv_new = p_dst * .98, p_dst * .97
    pv_new[2, 1, 1] = pv_new[kk - 1, 1, 1]
    pu_new[:, 0] = t(pu[:, 0])
    pv_new[:, 2] = torch.nextafter(t(pv[:, 2]), t(np.inf))
    return [t(p), [t(temp), t(saln)] + [t(a) for a in trc], t(pu), t(u),
            t(pv), t(v), p_dst, pu_new, pv_new]


def _run(lib, par, p_src, tms, pu_q, u, pv_q, v, p_dst, pu_new, pv_new):
    """The kernel's (means, u_mean, v_mean) for CPU tensors."""
    kk = p_src.shape[0] - 1
    means = [torch.full_like(tm, torch.nan) for tm in tms]
    u_out = torch.full_like(u, torch.nan)
    v_out = torch.full_like(v, torch.nan)
    fields = list(tms) + [u, v] + means + [u_out, v_out]
    table = torch.tensor([f.data_ptr() for f in fields], dtype=torch.int64)
    tensors = [p_src, pu_q, pv_q, p_dst, pu_new, pv_new, table]
    ptrs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in tensors])
    iargs = (ctypes.c_int * 7)(kk, J * I, len(tms),
                               int(par.tracer_pc_upper),
                               int(par.velocity_pc_upper),
                               ale.LIMITERS.index(par.tracer_limiting),
                               ale.LIMITERS.index(par.velocity_limiting))
    fn = lib.ale_remap_f64 if p_src.dtype == torch.float64 \
        else lib.ale_remap_f32
    assert fn(ptrs, iargs, None) == 0
    return means, u_out, v_out


def _check(out, ref, dtype):
    outs = list(out[0]) + [out[1], out[2]]
    refs = list(ref[0]) + [ref[1], ref[2]]
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        o, r = o.double().numpy(), r.double().numpy()
        np.testing.assert_array_equal(np.isnan(o), np.isnan(r))
        fin = np.isfinite(r)
        err = np.abs(o - r)[fin]
        if dtype == torch.float64:
            assert (err <= 1e-12 * (1. + np.abs(r[fin]))).all(), err.max()
        else:
            assert err.max() <= 1e-4 * np.abs(r[fin]).max(), err.max()


CASES = ([('float64', ntr, pair, KK) for ntr in (0, 5) for pair in PAIRS]
         + [('float32', 5, (NOSC, NOSC), KK),
            ('float64', 0, (NOSC, NOSC), 70)])


@pytest.mark.parametrize('dtype,ntr,lims,kk', CASES)
def test_k2_host_matches_remap_plain(lib, dtype, ntr, lims, kk):
    """Every limiter pair and deck B's, with and without passive tracers,
    the f32 tile, and kk above the former cap of 64 levels."""
    dtype = getattr(torch, dtype)
    par = ale.make_ale_params(kk)._replace(tracer_limiting=lims[0],
                                           velocity_limiting=lims[1])
    args = _inputs(dtype, ntr, kk)
    _check(_run(lib, par, *args), ale.remap_plain(par, *args), dtype)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_k2_host_block_threads(lib, dtype):
    """The launch's own threads per block, meeting at real barriers:
    every point of every stage covered by some thread."""
    dtype = getattr(torch, dtype)
    par = ale.make_ale_params(KK)._replace(tracer_limiting=POSDEF)
    args = _inputs(dtype, 3)
    lib.shim_set_block_threads(-1)
    try:
        out = _run(lib, par, *args)
    finally:
        lib.shim_set_block_threads(1)
    _check(out, ale.remap_plain(par, *args), dtype)


def test_k2_host_nonfinite_columns(lib):
    """A NaN mean, an inf interface and a NaN destination edge give the
    plain version's NaN and values in their columns, nowhere else."""
    par = ale.make_ale_params(KK)
    args = _inputs(torch.float64, 1)
    args[1][2][3, 1, 4] = torch.nan          # a tracer's mean
    args[0][5:, 2, 7] = torch.inf            # the source interfaces
    args[6][4, 0, 9] = torch.nan             # a destination edge
    _check(_run(lib, par, *args), ale.remap_plain(par, *args),
           torch.float64)


def test_k2_refuses_kk_above_its_limit(lib):
    """kk_max is the most levels a tile fits in the shared memory; one
    more level is refused before launch (cudaErrorInvalidValue)."""
    kmax = lib.ale_remap_kk_max(1, SHARED_OPTIN)
    assert 100 <= kmax < 1000
    assert lib.ale_remap_kk_max(0, SHARED_OPTIN) >= 100
    t = torch.zeros(1)
    ptrs = (ctypes.c_void_p * 7)(*([t.data_ptr()] * 7))
    iargs = (ctypes.c_int * 7)(kmax + 1, 1, 0, 1, 1, 1, 1)
    assert lib.ale_remap_f64(ptrs, iargs, None) == 1


# ------------------------------------------------------------------ K1

EOS = eos.init_eos(pref=0., expcnf='fuk95')
DELT1 = 360.


def _edge_pair(dtype):
    """Interfaces a < b of `dtype` for which a + (b - a) rounds above b:
    a pressure b lies in the layer [a, b) too, for the kernel's search as
    for the plain version's."""
    f = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(11)
    for _ in range(1000):
        a, b = f(rng.uniform(1.e3, 2.e4)), f(rng.uniform(5.e4, 6.e4))
        if a + (b - a) > b:
            return float(a), float(b)
    raise AssertionError('no pair rounds up')


def _k1_par(kk, dtype, **kw):
    """make_ale_params(kk) with pmin(4) on the edge of _edge_pair."""
    par = ale.make_ale_params(kk)
    plevel = list(par.plevel)
    plevel[4] = _edge_pair(dtype)[1]
    return par._replace(plevel=tuple(plevel), **kw)


def _k1_inputs(dtype, kk=KK, seed=5):
    """chip_smoke.ale_inputs' columns at a small size, with vanishing
    layers at the bottom and inside a column, and these columns: (1, 2)
    has interfaces that decrease so that pmin(4) lies in two of its
    layers, a dense one and a light one, with sigmar(4) between them (the
    first in k order counts); (0, 7) is shallow, its pmin below it from
    the second level on; (2, 9) has a NaN temperature in a wet layer (its
    densest density is not finite, so sig_max is 0, and three of its
    targets lie below 0); (0, 5) has targets all denser than its water
    (kdmx 1); (2, 3) has a thick top layer on a density gradient and a
    target that puts interface 2 in the isopycnal regime, where the top
    layer's reconstruction (tracer_pc_upper) counts; (1, 8) has the
    interfaces of _edge_pair around pmin(4) of _k1_par, a dense layer
    over a light one and sigmar(4) between them (the upper layer
    counts); (0, 9) has pmin(k) on its interface k, light layers 1 and 4
    over a dense bottom layer and sigmar(1), sigmar(4) between them."""
    rng = np.random.default_rng(seed)
    H3 = (kk, J, I)
    dp = rng.uniform(.5, 3., H3) * 1.e4
    dp[-2:, 0, :3] = 0.
    dp[3, 2, 5] = 0.
    dp[:8, 1, 2] = [2e4, 2e4, 1e4, 1.5e4, -1e4, 2.5e4, 2e4, 2e4]
    dp[:, 0, 7] *= .1
    dp[0, 2, 3] = 3e4
    p = np.concatenate([np.zeros((1, J, I)), np.cumsum(dp, 0)])
    a, b = _edge_pair(dtype)
    p[:, 1, 8] = b + (np.arange(kk + 1) - 4) * 1.25e4
    p[:4, 1, 8] = (0., .5 * a, .75 * a, a)
    plevel = np.array(_k1_par(kk, dtype).plevel)
    p[:, 0, 9] = np.append(plevel, plevel[-1] + 1.e4)
    temp, saln = rng.uniform(2., 18., H3), rng.uniform(33., 36., H3)
    sigmar = np.sort(rng.uniform(24., 28., H3), axis=0)
    temp[3:6:2, 1, 2], saln[3:6:2, 1, 2] = (2., 18.), (36., 33.)
    sigmar[4, 1, 2] = 26.
    temp[2, 2, 9] = np.nan
    sigmar[:3, 2, 9] -= 30.
    sigmar[:, 0, 5] += 10.
    temp[:3, 2, 3], saln[:3, 2, 3] = (16., 12., 8.), (34., 35., 36.)
    sigmar[1, 2, 3] = 25.
    temp[3:5, 1, 8], saln[3:5, 1, 8] = (2., 18.), (36., 33.)
    sigmar[4, 1, 8] = 26.
    temp[[1, 4, -1], 0, 9] = (18., 18., 2.)
    saln[[1, 4, -1], 0, 9] = (33., 33., 36.)
    sigmar[[1, 4], 0, 9] = 26.
    return [torch.tensor(a, dtype=dtype) for a in (p, temp, saln, sigmar)]


def _run_k1(k1, par, p, temp, saln, sigmar):
    """The kernel's (p_dst, smooth_fac) for CPU tensors."""
    kk = p.shape[0] - 1
    p_dst = torch.full_like(p, torch.nan)
    sfac = torch.full_like(p, torch.nan)
    plevel = torch.tensor(par.plevel, dtype=torch.float64)
    ptrs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in (
        p, temp, saln, sigmar, plevel, p_dst, sfac)])
    iargs = (ctypes.c_int * 5)(kk, J * I, par.k_range_plevel,
                               int(par.tracer_pc_upper),
                               ale.LIMITERS.index(par.tracer_limiting))
    e = EOS
    dvals = [DELT1 / par.regrid_nudge_ts, par.dpmin_interior,
             par.stab_fac_limit, e.ap11, e.ap12, e.ap13, e.ap14, e.ap15,
             e.ap16, e.ap21, e.ap22, e.ap23, e.ap24, e.ap25, e.ap26]
    dargs = (ctypes.c_double * len(dvals))(*dvals)
    fn = k1.ale_regrid_f64 if p.dtype == torch.float64 else k1.ale_regrid_f32
    assert fn(ptrs, iargs, dargs, None) == 0
    return p_dst, sfac


def _check_k1(k1, par, args, threads=1):
    k1.shim_set_block_threads(threads)
    try:
        out = _run_k1(k1, par, *args)
    finally:
        k1.shim_set_block_threads(1)
    ref = ale.regrid_plain(EOS, par, *args, DELT1)
    _check(([], *out), ([], *ref), args[0].dtype)


K1_CASES = [(lim, pc, kb) for lim in ale.LIMITERS
            for pc, kb in ((True, 1), (False, 4))]


@pytest.mark.parametrize('lim,pc_upper,kb', K1_CASES)
def test_k1_host_matches_regrid_plain(k1, lim, pc_upper, kb):
    """Every limiter, with and without the piecewise-constant top layer,
    in f64 on the ragged grid and its special columns."""
    par = _k1_par(KK, torch.float64, tracer_limiting=lim,
                  tracer_pc_upper=pc_upper, k_range_plevel=kb)
    _check_k1(k1, par, _k1_inputs(torch.float64))


@pytest.mark.parametrize('dtype,kk,threads', [
    ('float32', KK, 1), ('float64', 70, 1), ('float64', KK, -1),
    ('float32', KK, -1)])
def test_k1_host_tile(k1, dtype, kk, threads):
    """The f32 tile; kk above the former cap of 64 levels; the launch's
    own threads per block, meeting at real barriers (-1)."""
    dtype = getattr(torch, dtype)
    par = _k1_par(kk, dtype, tracer_limiting=POSDEF)
    _check_k1(k1, par, _k1_inputs(dtype, kk), threads)


def test_k1_refuses_kk_above_its_limit(k1):
    """kk_max is the most levels a tile fits in the shared memory (~170
    in f32 on an H100); one more level is refused before launch."""
    kmax = k1.ale_regrid_kk_max(0, SHARED_OPTIN)
    assert 150 <= kmax < 200
    assert k1.ale_regrid_kk_max(1, SHARED_OPTIN) >= 150
    t = torch.zeros(1)
    ptrs = (ctypes.c_void_p * 7)(*([t.data_ptr()] * 7))
    iargs = (ctypes.c_int * 5)(kmax + 1, 1, 4, 1, 1)
    dargs = (ctypes.c_double * 15)()
    assert k1.ale_regrid_f32(ptrs, iargs, dargs, None) == 1
