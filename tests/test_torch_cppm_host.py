"""The CUDA CPPM sweep (blom_tpu_torch/csrc/cppm_sweep.cu) on the CPU.

g++ compiles the kernel against the host shim blom_tpu_torch/csrc/
host_shim.h, as tests/test_torch_ale_host.py does for the ALE kernels,
and the library is called with ctypes on CPU tensors as the wrapper
dynamics/cppm_cuda.py calls it (the kernel picks its block shape).
Its hn, tm_new, hf and htf are held against the plain version
cppm._cppm_sweep_body in f64 at |err| <= 1e-12 (1 + |ref|), in all
four (compatibility, limiting) variants, on both axes, closed and
periodic, with and without the transverse divergence correction, at
nt = 2, and in every variant on both axes at nt = 0, 1 and 3 (the tracer
loop run no time, once and past its second pass), on a small ragged grid (the j-sweep's last block of lines ends
inside the grid) whose land gives every stencil class.  One f32 case
runs within 1e-4 of max |ref|, chip_smoke's f32 tolerance; one case of
each axis runs each block as the launch's threads, host threads meeting
at a real barrier; one case of each dtype sweeps the channel's 512-cell
j-lines, with fewer lines per block; every variant sweeps periodic
lines of length 1, 2 and 3 on each axis, where a stencil offset of +-2
passes more than one period.  Skips when g++ is absent."""

import ctypes

import numpy as np
import pytest
import torch

from blom_tpu_torch.dynamics import cppm
from blom_tpu_torch.dynamics.cppm import CppmCoeffs, init_cppm_coeffs

from test_torch_ale_host import _host_build

KK, J, I, NT = 3, 10, 13, 2
VARIANTS = [('full', 'non_oscillatory'), ('full', 'monotonic'),
            ('partial', 'non_oscillatory'), ('partial', 'monotonic')]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """cppm_sweep.cu built by g++ against the host shim."""
    return _host_build(tmp_path_factory, 'cppm_sweep', 3)


def _inputs(ax, periodic, dtype, shape=(KK, J, I), seed=4, nt=NT):
    """chip_smoke.cppm_inputs at a small size: land on 30 % of the
    cells, walls at the ends of a closed sweep axis."""
    KK, J, I = shape
    rng = np.random.default_rng(seed)
    ip = np.ones((J, I))
    ip[rng.uniform(size=(J, I)) < .3] = 0.
    if not periodic:
        if ax == -1:
            ip[:, 0] = ip[:, -1] = 0.
        else:
            ip[0, :] = ip[-1, :] = 0.
    dx = rng.uniform(.6, 1.5, (J, I))
    co = CppmCoeffs(*[c if c.dtype == torch.int32 else c.to(dtype)
                      for c in init_cppm_coeffs(ip, dx, axis=ax,
                                                periodic=periodic)])
    h = rng.uniform(.2, 2., (KK, J, I))
    p = np.concatenate([np.zeros((1, J, I)), np.cumsum(h, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype)
    args = (t(h), t(rng.uniform(1., 4., (nt, KK, J, I))),
            t(rng.uniform(-.3, .3, (KK, J, I))),
            t(rng.uniform(5., 12., (J, I))), t(p[:-1]), t(p[1:]),
            t(1. / rng.uniform(.8, 1.2, (J, I))))
    div = t(rng.uniform(-.1, .1, (KK, J, I)))
    return co, args, div


def _run(lib, args, co, periodic, div, ax, compat, lim):
    """The kernel's (hn, tm_new, hf, htf) for CPU tensors, called as
    cppm_cuda.cppm_sweep_cuda calls it."""
    hm, tm, ca, db, du, dl, ai = args
    nt, kk, J, I = tm.shape
    hn, hf = (torch.full_like(hm, torch.nan) for _ in range(2))
    tmn, htf = (torch.full_like(tm, torch.nan) for _ in range(2))
    ptrs = [hm, tm, ca, db, du, dl, ai, div, co.stencil, co.hevc, co.ssc,
            co.scc, co.d2m, co.tmc0, co.tmcl, co.tmcr, hn, tmn, hf, htf]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(
        *[0 if x is None else x.data_ptr() for x in ptrs])
    iargs = (ctypes.c_int * 10)(kk, J, I, nt, ax, int(periodic), 0, 0,
                                int(compat == 'full'),
                                int(lim == 'monotonic'))
    fn = lib.cppm_sweep_f64 if hm.dtype == torch.float64 \
        else lib.cppm_sweep_f32
    assert fn(ptr_arr, iargs, None) == 0
    return hn, tmn, hf, htf


def _check(lib, ax, periodic, with_div, compat, lim, dtype=torch.float64,
           threads=1, shape=(KK, J, I), nt=NT):
    co, args, div = _inputs(ax, periodic, dtype, shape, nt=nt)
    d = div if with_div else None
    lib.shim_set_block_threads(threads)
    try:
        out = _run(lib, args, co, periodic, d, ax, compat, lim)
    finally:
        lib.shim_set_block_threads(1)
    ref = cppm._cppm_sweep_body(*args, co, periodic, d, ax,
                                compatibility=compat, limiting=lim)
    for o, r, name in zip(out, ref, ('hn', 'tm_new', 'hf', 'htf')):
        o, r = o.double().numpy(), r.double().numpy()
        assert o.shape == r.shape, name
        assert np.isfinite(r).all(), name
        err = np.abs(o - r)
        if dtype == torch.float64:
            assert (err <= 1e-12 * (1. + np.abs(r))).all(), \
                (name, err.max())
        else:
            assert err.max() <= 1e-4 * np.abs(r).max(), (name, err.max())


@pytest.mark.parametrize('ax', [-1, -2])
@pytest.mark.parametrize('periodic', [False, True])
def test_inputs_have_every_stencil_class(ax, periodic):
    co = _inputs(ax, periodic, torch.float64)[0]
    assert set(co.stencil.flatten().tolist()) == set(range(9))


@pytest.mark.parametrize('compat,lim', VARIANTS)
@pytest.mark.parametrize('with_div', [False, True])
@pytest.mark.parametrize('periodic', [False, True])
@pytest.mark.parametrize('ax', [-1, -2])
def test_host_sweep_matches_plain(lib, ax, periodic, with_div, compat,
                                  lim):
    """Every variant, axis, periodicity and div_corr case in f64."""
    _check(lib, ax, periodic, with_div, compat, lim)


@pytest.mark.parametrize('compat,lim', VARIANTS)
@pytest.mark.parametrize('ax', [-1, -2])
@pytest.mark.parametrize('nt', [0, 1, 3])
def test_host_sweep_tracer_counts(lib, nt, ax, compat, lim):
    """Every variant on both axes (each with the main path's
    periodicity: closed in i, periodic in j) with the divergence
    correction, at the other tracer counts."""
    _check(lib, ax, ax == -2, True, compat, lim, nt=nt)


def test_host_sweep_f32(lib):
    """The f32 instantiation of the main path's variant, j-sweep."""
    _check(lib, -2, True, False, 'full', 'non_oscillatory',
           dtype=torch.float32)


@pytest.mark.parametrize('ax', [-1, -2])
def test_host_sweep_block_threads(lib, ax):
    """The launch's own threads per block, meeting at real barriers:
    every cell of every stage covered by some thread, and every stage's
    reads of its neighbours behind a barrier."""
    _check(lib, ax, ax == -2, True, 'full', 'non_oscillatory', threads=-1)


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_host_sweep_long_lines(lib, dtype):
    """The channel's 512-cell j-lines: fewer lines per block where the
    lines do not fit in the shared memory (in f64 two, in f32 four)."""
    f64 = dtype == 'float64'
    fn = lib.cppm_sweep_shared_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    line = fn(512, -1, int(f64))          # an i-sweep block: one line
    assert fn(512, -2, int(f64)) == (2 if f64 else 4) * line
    _check(lib, -2, True, True, 'full', 'non_oscillatory',
           dtype=getattr(torch, dtype), shape=(2, 512, 11))


@pytest.mark.parametrize('compat,lim', VARIANTS)
@pytest.mark.parametrize('n', [1, 2, 3])
@pytest.mark.parametrize('ax', [-1, -2])
def test_host_sweep_short_periodic_lines(lib, ax, n, compat, lim):
    """Periodic lines shorter than the stencil: a neighbour two cells
    away wraps by the remainder, as torch.roll does (the single-column
    grid sweeps lines of length 1 on both axes)."""
    _check(lib, ax, True, True, compat, lim,
           shape=(KK, J, n) if ax == -1 else (KK, n, I))
