"""Wrappers of the CUDA ALE kernels (csrc/ale_regrid.cu, csrc/ale_remap.cu).

`regrid_cuda` replaces blom_tpu's Pallas kernel K1
(`dynamics/ale_pallas.py` regrid_call), `remap_cuda` its kernel K2
(`_remap_chunk` / remap_call).  Each wrapper checks devices, dtypes,
shapes and contiguity, allocates the outputs, launches on the current
stream and counts its launches per instantiation: `regrid_launches` by
the tracer limiter of the T/S reconstruction, `remap_launches` by the
(tracer, velocity) limiter pair.  Both kernels take the three limiters
of ops/hor3map.py, and as many levels as their tile of columns fits in
the device's shared memory (`regrid_kk_max`, `remap_kk_max`); K2 takes
any number of tracers.  They take CUDA tensors only;
`ale.ale_regrid_remap` sends CPU tensors to the plain versions
`ale.regrid_plain` and `ale.remap_plain`."""

from __future__ import annotations

import ctypes
import functools

import torch

from .ale import LIMITERS, check_kernel_method

regrid_launches = dict.fromkeys(LIMITERS, 0)
remap_launches = {(t, v): 0 for t in LIMITERS for v in LIMITERS}

_DTYPES = {torch.float32: 'f32', torch.float64: 'f64'}


def _fn(name, dtype, nargs):
    from ..cuda_build import library
    fn = getattr(library(name), f'{name}_{_DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_void_p] * nargs
    fn.restype = ctypes.c_int
    return fn


def _check(ale, named, ref):
    """Raise unless every tensor lies on ref's CUDA device with ref's
    float dtype and is contiguous, and the kernels compute the ALE
    method."""
    check_kernel_method(ale)
    if ref.dtype not in _DTYPES:
        raise TypeError(f'unsupported dtype {ref.dtype}')
    for name, t in named.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f'{name} is not on {ref.device}')
        if t.dtype != ref.dtype:
            raise TypeError(f'{name} is {t.dtype}, expected {ref.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} is not contiguous')


def _shapes(kk, J, I, k1, k0, kmax):
    """Raise unless 3 <= kk <= kmax (the kernel's kk_max) and the (kk+1)-
    and kk-level fields have their shapes."""
    if not 3 <= kk <= kmax:
        raise ValueError(f'kk={kk} is outside [3, {kmax}]: kk_max={kmax} is '
                         'the most levels its tile fits in shared memory')
    for shape, fields in (((kk + 1, J, I), k1), ((kk, J, I), k0)):
        for name, t in fields.items():
            if tuple(t.shape) != shape:
                raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                                 f'expected {shape}')


def regrid_cuda(e, ale, p_src, temp, saln, sigmar, delt1):
    """Same contract as ale.regrid_plain, on the card: (p_dst,
    smooth_fac)."""
    kk1, J, I = p_src.shape
    kk = kk1 - 1
    k1 = {'p_src': p_src}
    k0 = {'temp': temp, 'saln': saln, 'sigmar': sigmar}
    _check(ale, {**k1, **k0}, p_src)
    _shapes(kk, J, I, k1, k0, regrid_kk_max(p_src.dtype, p_src.device))
    if len(ale.plevel) != kk:
        raise ValueError(f'plevel has {len(ale.plevel)} levels, not {kk}')

    p_dst = torch.empty_like(p_src)
    sfac = torch.empty_like(p_src)
    plevel = _plevel(tuple(ale.plevel), p_src.device)
    ptrs = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in (
        p_src, temp, saln, sigmar, plevel, p_dst, sfac)])
    iargs = (ctypes.c_int * 5)(kk, J * I, ale.k_range_plevel,
                               int(ale.tracer_pc_upper),
                               LIMITERS.index(ale.tracer_limiting))
    ap = [e.ap11, e.ap12, e.ap13, e.ap14, e.ap15, e.ap16,
          e.ap21, e.ap22, e.ap23, e.ap24, e.ap25, e.ap26]
    dvals = [delt1 / ale.regrid_nudge_ts, ale.dpmin_interior,
             ale.stab_fac_limit] + ap
    dargs = (ctypes.c_double * len(dvals))(*dvals)
    stream = torch.cuda.current_stream(p_src.device).cuda_stream
    with torch.cuda.device(p_src.device):
        err = _fn('ale_regrid', p_src.dtype, 4)(ptrs, iargs, dargs, stream)
    from ..cuda_build import check
    check(err, 'ale_regrid')
    regrid_launches[ale.tracer_limiting] += 1
    return p_dst, sfac


@functools.lru_cache(maxsize=None)
def _plevel(plevel, device):
    """The minimum interface depths on `device`, in double, as K1 reads
    them."""
    return torch.tensor(plevel, dtype=torch.float64, device=device)


def shared_bytes(name, dtype, kk):
    """Dynamic shared memory of one block of kernel `name` ('ale_regrid',
    'ale_remap') at kk levels."""
    from ..cuda_build import library
    fn = getattr(library(name), f'{name}_shared_bytes')
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(kk, int(dtype == torch.float64))


@functools.lru_cache(maxsize=None)
def _kk_max(name, dtype, device):
    from ..cuda_build import library
    fn = getattr(library(name), f'{name}_kk_max')
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
    fn.restype = ctypes.c_int
    limit = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    return fn(int(dtype == torch.float64), limit)


def regrid_kk_max(dtype, device):
    """The largest kk K1 takes in `dtype` on `device`: what its tile fits
    in the device's opt-in shared memory per block."""
    return _kk_max('ale_regrid', dtype, torch.device(device))


def remap_kk_max(dtype, device):
    """The largest kk K2 takes in `dtype` on `device`: what its tile fits
    in the device's opt-in shared memory per block."""
    return _kk_max('ale_remap', dtype, torch.device(device))


def remap_cuda(ale, p_src, tms, pu_q, u, pv_q, v, p_dst, pu_new, pv_new):
    """Same contract as ale.remap_plain, on the card: (means, u_mean,
    v_mean) with one mean per tracer of tms, any number of them."""
    kk1, J, I = p_src.shape
    kk = kk1 - 1
    nt = len(tms)
    k1 = {'p_src': p_src, 'pu_q': pu_q, 'pv_q': pv_q, 'p_dst': p_dst,
          'pu_new': pu_new, 'pv_new': pv_new}
    k0 = {'u': u, 'v': v, **{f'tms[{t}]': tm for t, tm in enumerate(tms)}}
    _check(ale, {**k1, **k0}, p_src)
    _shapes(kk, J, I, k1, k0, remap_kk_max(p_src.dtype, p_src.device))

    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    means = [torch.empty_like(tm) for tm in tms]
    # the fields' addresses, which the kernel reads from the card; copied
    # from pinned memory on the stream, so the host does not wait
    fields = list(tms) + [u, v] + means + [u_out, v_out]
    table = torch.tensor([t.data_ptr() for t in fields],
                         dtype=torch.int64).pin_memory().to(
                             p_src.device, non_blocking=True)
    tensors = [p_src, pu_q, pv_q, p_dst, pu_new, pv_new, table]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr()
                                              for t in tensors])
    iargs = (ctypes.c_int * 7)(kk, J * I, nt, int(ale.tracer_pc_upper),
                               int(ale.velocity_pc_upper),
                               LIMITERS.index(ale.tracer_limiting),
                               LIMITERS.index(ale.velocity_limiting))
    stream = torch.cuda.current_stream(p_src.device).cuda_stream
    with torch.cuda.device(p_src.device):
        err = _fn('ale_remap', p_src.dtype, 3)(ptrs, iargs, stream)
    from ..cuda_build import check
    check(err, 'ale_remap')
    remap_launches[(ale.tracer_limiting, ale.velocity_limiting)] += 1
    return means, u_out, v_out
