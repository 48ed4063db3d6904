"""Climatological sea-surface salinity ingest.

Counterpart of `blom_tpu/phys/rdcsss.py` (BLOM's mod_rdcsss.F90): the
12-month SSS climatology that the srxday restoring reads (sssclm of
mod_forcing), its missing values flood-filled month by month, from an
.npz archive or a classic NetCDF file (scipy), variable 'sss'."""

from __future__ import annotations

import numpy as np
import torch

from ..core.geoenv import fill_global


def rdcsss(path: str, mask=None, varname: str = 'sss', missing=-9.99e33,
           dtype=torch.float64, device=None):
    """The (12, jdm, idm) monthly SSS climatology (rdcsss,
    mod_rdcsss.F90; the fill of mod_fill_global), as a tensor on
    `device` (CUDA unless the caller names one)."""
    from ..drivers.standalone import _device
    if path.endswith('.npz'):
        arr = np.load(path)[varname].astype(np.float64)
    else:
        from scipy.io import netcdf_file
        with netcdf_file(path, 'r', mmap=False) as f:
            arr = np.asarray(f.variables[varname][:], np.float64).copy()
    if arr.shape[0] != 12:
        raise ValueError(f'expected 12 months, got {arr.shape}')
    if mask is not None:
        mask = np.asarray(torch.as_tensor(mask).cpu())
    out = np.empty_like(arr)
    for m in range(12):
        out[m] = fill_global(arr[m], missing, mask=mask)
    return torch.as_tensor(out, dtype=dtype, device=_device(device))
