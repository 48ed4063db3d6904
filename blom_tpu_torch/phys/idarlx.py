"""Apply and diagnose heat and salt relaxation-flux climatologies.

Counterpart of `blom_tpu/phys/idarlx.py` (BLOM's mod_idarlx.F90:20-99):
48-slice annual climatologies of the diagnosed heat (tflxdi) and salt
(sflxdi) relaxation fluxes for thermf's aptflx/apsflx options, read from
array files, applied through intp1d over the 5 neighbouring slices
(mod_thermf_ben02.F90:508-512) and accumulated slot by slot."""

from __future__ import annotations

import numpy as np
import torch

from .intp1d import clim_indices, intp1d

NSLICES = 48


def load_flux_clim(path: str, varname: str, dtype=torch.float64,
                   device=None):
    """A (48, jdm, idm) diagnosed flux climatology from .npz/.npy
    (idarlx, mod_idarlx.F90:36-95), as a tensor on `device` (CUDA
    unless the caller names one)."""
    from ..drivers.standalone import _device
    if path.endswith('.npz'):
        arr = np.load(path)[varname]
    else:
        arr = np.load(path)
    if arr.shape[0] != NSLICES:
        raise ValueError(f'expected {NSLICES} slices, got {arr.shape}')
    return torch.as_tensor(arr, dtype=dtype, device=_device(device))


def apply_flux_clim(flxap, nday_of_year, frac_of_day,
                    nday_in_year: float = 365.):
    """The climatology at the current time; the caller subtracts it from
    surrlx/salrlx (mod_thermf_ben02.F90:508-512)."""
    m1, m2, m3, m4, m5, x = clim_indices(nday_of_year, frac_of_day,
                                         NSLICES, nday_in_year)
    return intp1d(flxap[m1], flxap[m2], flxap[m3], flxap[m4],
                  flxap[m5], x)


def diagnose_flux(acc, count, flx, slot: int):
    """A relaxation flux added into climatology slot `slot` (the
    ditflx/disflx accumulation, mod_thermf_ben02.F90:514-517); acc (48,
    jdm, idm), count (48,) ints.  Returns new tensors: the caller's stay
    as they are."""
    acc = acc.clone()
    acc[slot] += flx
    count = count.clone()
    count[slot] += 1
    return acc, count
