"""The CUDA kernel K2 (blom_tpu_torch/csrc/ale_remap.cu) on the CPU.

g++ compiles the kernel against the host shim blom_tpu_torch/csrc/
host_shim.h (each launch rewritten into a loop over blocks, one thread
per block, so every block-strided stage runs whole between two
barriers) into a library under tmp_path, called with ctypes on CPU
tensors; one case runs each block as the launch's threads, host threads
meeting at a real barrier, which checks the kernel's mapping of points
to threads.  Its layer means are held against the plain version
ale.remap_plain in f64 on a small ragged grid (the last tile of
columns ends inside the grid) at |err| <= 1e-12 (1 + |ref|): the kernel
multiplies by 1/3 as PyTorch does on the card, the CPU divides, so the
two differ by ulps.  One f32 case runs the f32 tile within 1e-4 of
max |ref|, chip_smoke's f32 tolerance.  Skips when g++ is absent."""

import ctypes
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


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """ale_remap.cu built by g++ against the host shim."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('g++ is not installed: the host build of K2 needs it')
    d = tmp_path_factory.mktemp('k2_host')
    (d / 'cuda_runtime.h').write_text(
        f'#include "{CSRC / "host_shim.h"}"\n')
    for h in CSRC.glob('*.cuh'):
        shutil.copy(h, d / h.name)
    src = (CSRC / 'ale_remap.cu').read_text()
    src = re.sub(r'(\w+(?:<[^<>;]*>)?)\s*<<<([^,]+),([^,]+),([^,]+),[^>]+>>>'
                 r'\((.*?)\);', r'shim_launch(\1, \2, \3, \4, \5);', src)
    src = re.sub(r'extern __shared__[^;]*\b(\w+)\[\];',
                 r'unsigned char *\1 = shim_shared();', src)
    assert 'shim_launch(' in src and 'shim_shared()' in src
    (d / 'ale_remap.cpp').write_text(src)
    so = d / 'libale_remap_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-ffp-contract=off',
                    '-shared', '-fPIC', '-pthread', '-I', str(d), '-o',
                    str(so),
                    str(d / 'ale_remap.cpp')], check=True,
                   capture_output=True, text=True)
    out = ctypes.CDLL(str(so))
    for name in ('ale_remap_f32', 'ale_remap_f64'):
        getattr(out, name).argtypes = [ctypes.c_void_p] * 3
        getattr(out, name).restype = ctypes.c_int
    out.ale_remap_kk_max.argtypes = [ctypes.c_int, ctypes.c_longlong]
    out.ale_remap_kk_max.restype = ctypes.c_int
    out.shim_set_block_threads.argtypes = [ctypes.c_int]
    return out


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
