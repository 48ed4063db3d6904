"""Wrapper of the CUDA CPPM sweep kernel (csrc/cppm_sweep.cu).

Replaces blom_tpu's Pallas kernel `dynamics/cppm_pallas.py`.  The
wrapper checks devices, dtypes, shapes and contiguity, allocates the
outputs, launches on the current stream and counts its launches in
`launches`, per (compatibility, limiting) variant.  It takes CUDA
tensors only; `cppm.cppm_sweep` sends CPU tensors to the plain
version."""

from __future__ import annotations

import ctypes

import torch

from .cppm import COMPATIBILITIES, LIMITINGS, CppmCoeffs, check_variant

launches = {(c, lim): 0 for c in COMPATIBILITIES for lim in LIMITINGS}

_DTYPES = {torch.float32: 'f32', torch.float64: 'f64'}


def _fn(dtype):
    from ..cuda_build import library
    fn = getattr(library('cppm_sweep'), f'cppm_sweep_{_DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(n: int, ax: int, dtype) -> int:
    """Dynamic shared memory of a block of the sweep over lines of n
    cells on axis ax (the kernel picks the block's shape)."""
    from ..cuda_build import library
    fn = library('cppm_sweep').cppm_sweep_shared_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(n, ax, int(dtype == torch.float64))


def cppm_sweep_cuda(hm, tm, ca, db, du, dl, ai, co: CppmCoeffs,
                    periodic: bool, div_corr=None, ax: int = -1,
                    compatibility: str = 'full',
                    limiting: str = 'non_oscillatory'):
    """Same contract as cppm._cppm_sweep_body, on the card."""
    check_variant(compatibility, limiting)
    if ax not in (-1, -2):
        raise ValueError(f'sweep axis {ax}')
    dtype = hm.dtype
    if dtype not in _DTYPES:
        raise TypeError(f'cppm_sweep_cuda: unsupported dtype {dtype}')
    kk, J, I = hm.shape
    nt = tm.shape[0]
    fields = {'hm': hm, 'ca': ca, 'du': du, 'dl': dl}
    if div_corr is not None:
        fields['div_corr'] = div_corr
    for name, t in fields.items():
        if tuple(t.shape) != (kk, J, I):
            raise ValueError(f'{name} has shape {tuple(t.shape)}')
    if tuple(tm.shape) != (nt, kk, J, I):
        raise ValueError(f'tm has shape {tuple(tm.shape)}')
    for name, t in (('db', db), ('ai', ai)):
        if tuple(t.shape) not in ((J, I), (kk, J, I)):
            raise ValueError(f'{name} has shape {tuple(t.shape)}')
    coef = {'hevc': co.hevc, 'ssc': co.ssc, 'scc': co.scc, 'd2m': co.d2m,
            'tmc0': co.tmc0, 'tmcl': co.tmcl, 'tmcr': co.tmcr}
    for name, t, n in (('hevc', co.hevc, 4), ('tmc0', co.tmc0, 12),
                       ('tmcl', co.tmcl, 12), ('tmcr', co.tmcr, 12)):
        if tuple(t.shape) != (n, J, I):
            raise ValueError(f'{name} has shape {tuple(t.shape)}')
    if tuple(co.stencil.shape) != (J, I) or co.stencil.dtype != torch.int32:
        raise ValueError('stencil must be int32 (J, I)')
    tensors = dict(fields, tm=tm, db=db, ai=ai, stencil=co.stencil, **coef)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != hm.device:
            raise ValueError(f'{name} is not on {hm.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} is not contiguous')
        if name != 'stencil' and t.dtype != dtype:
            raise TypeError(f'{name} is {t.dtype}, expected {dtype}')

    hn = torch.empty_like(hm)
    hf = torch.empty_like(hm)
    tmn = torch.empty_like(tm)
    htf = torch.empty_like(tm)
    ptrs = [hm, tm, ca, db, du, dl, ai, div_corr, co.stencil, co.hevc,
            co.ssc, co.scc, co.d2m, co.tmc0, co.tmcl, co.tmcr,
            hn, tmn, hf, htf]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    iargs = (ctypes.c_int * 10)(
        kk, J, I, nt, ax, int(periodic), int(db.dim() == 3),
        int(ai.dim() == 3), int(compatibility == 'full'),
        int(limiting == 'monotonic'))
    stream = torch.cuda.current_stream(hm.device).cuda_stream
    with torch.cuda.device(hm.device):
        err = _fn(dtype)(ptr_arr, iargs, stream)
    from ..cuda_build import check
    check(err, 'cppm_sweep')
    launches[(compatibility, limiting)] += 1
    return hn, tmn, hf, htf
