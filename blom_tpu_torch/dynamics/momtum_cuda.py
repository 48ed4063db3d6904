"""Wrapper of the CUDA momentum stencil kernel (csrc/momtum_uv.cu).

Replaces blom_tpu's Pallas kernel `dynamics/momtum_pallas.py`.  One call
launches the kernel of `par.mommth` once on the current stream; it keeps
its intermediates in shared memory, tile by tile.  On a tripolar grid the
fold pre-pass runs first, also once: it writes the derived fields that
blom_tpu's tagged j+1 reads take across the fold, mirrored, into a ghost
buffer the main kernel reads at the top row.  `launches` counts the main
kernel's launches per scheme, `fold_launches` the pre-pass's.  The
wrapper checks devices, dtypes, shapes and contiguity and allocates the
outputs.  It takes CUDA tensors only; `momtum.momtum_uv` sends CPU
tensors to the plain version."""

from __future__ import annotations

import ctypes

import torch

from .momtum import MOMMTHS, Momtum2DIn, MomtumKIn, MomtumParams

launches = dict.fromkeys(MOMMTHS, 0)
fold_launches = dict.fromkeys(MOMMTHS, 0)

# grid planes the kernel reads, in the order of its G_* enum
METRICS = ('ip', 'iu', 'iv', 'iq', 'scux', 'scuy', 'scvx', 'scvy', 'scuxi',
           'scvyi', 'scu2', 'scv2', 'scp2i', 'scq2i', 'scpx', 'scpy', 'scqx',
           'scqy', 'difmxp', 'difmxq', 'corioq')
# points past a tile of u_new, v_new at which the kernel reads the inputs
# of the tile's outputs (the reach of momtum._uv_body in i and in j, off
# the fold)
HALO = 2
_DTYPES = {torch.float32: 'f32', torch.float64: 'f64'}


def _lib():
    from ..cuda_build import library
    return library('momtum_uv')


def _fn(name, dtype):
    fn = getattr(_lib(), f'{name}_{_DTYPES[dtype]}')
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(dtype, mommth) -> int:
    """Dynamic shared memory of one block of the kernel, in bytes."""
    fn = _lib().momtum_uv_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    return fn(torch.finfo(dtype).bits // 8, MOMMTHS.index(mommth))


def ghost_fields() -> int:
    """Fields per level of the fold pre-pass's ghost buffer."""
    fn = _lib().momtum_uv_ghost_fields
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def momtum_uv_cuda(grid, par: MomtumParams, f: MomtumKIn, d2: Momtum2DIn,
                   tsfac, delt1):
    """Same contract as momtum._uv_body, on the card."""
    if par.mommth not in MOMMTHS:
        raise ValueError(f'mommth={par.mommth!r}: expected one of {MOMMTHS}')
    scheme = MOMMTHS.index(par.mommth)
    dtype = f.u_m.dtype
    if dtype not in _DTYPES:
        raise TypeError(f'momtum_uv_cuda: unsupported dtype {dtype}')
    kk, J, I = f.u_m.shape
    if grid.arctic and (grid.periodic_j or J < 4):
        raise ValueError('momtum_uv_cuda: a tripolar grid must be closed '
                         f'in j with at least 4 rows (J={J})')
    dev = f.u_m.device
    planes = [getattr(grid, name) for name in METRICS]
    checks = ([(n, t, (kk, J, I)) for n, t in zip(MomtumKIn._fields, f)]
              + [(n, t, (J, I)) for n, t in zip(Momtum2DIn._fields, d2)]
              + [(n, t, (J, I)) for n, t in zip(METRICS, planes)])
    for name, t, shape in checks:
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(t.shape)}')
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'{name} is not on {dev}')
        if t.dtype != dtype:
            raise TypeError(f'{name} is {t.dtype}, expected {dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} is not contiguous')

    u_new = torch.empty_like(f.u_m)
    v_new = torch.empty_like(f.v_m)
    ghost = (torch.empty((kk, ghost_fields(), I), dtype=dtype, device=dev)
             if grid.arctic else None)
    ptrs = [*f, *d2, *planes, u_new, v_new]
    ptr_arr = (ctypes.c_void_p * (len(ptrs) + 1))(
        *[t.data_ptr() for t in ptrs],
        None if ghost is None else ghost.data_ptr())
    dargs = (ctypes.c_double * 10)(
        tsfac, delt1, par.mdv2hi, par.mdv2lo, par.mdv4hi, par.mdv4lo,
        par.vsc2hi, par.vsc2lo, par.vsc4hi, par.vsc4lo)
    iargs = (ctypes.c_int * 7)(kk, J, I, int(grid.periodic_i),
                               int(grid.periodic_j), scheme,
                               int(grid.arctic))
    stream = torch.cuda.current_stream(dev).cuda_stream
    from ..cuda_build import check
    with torch.cuda.device(dev):
        if grid.arctic:
            check(_fn('momtum_fold', dtype)(ptr_arr, dargs, iargs, stream),
                  'momtum_fold')
            fold_launches[par.mommth] += 1
        check(_fn('momtum_uv', dtype)(ptr_arr, dargs, iargs, stream),
              'momtum_uv')
    launches[par.mommth] += 1
    return u_new, v_new
