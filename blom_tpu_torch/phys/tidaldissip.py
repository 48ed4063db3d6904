"""Tidal wave energy dissipation input field.

Counterpart of `blom_tpu/phys/tidaldissip.py` (mod_tidaldissip.F90):
`twedon`, the tidal wave energy dissipation divided by the bottom
Brunt-Vaisala frequency, read on the host from .npz/.npy archives or
classic NetCDF, and the tidally driven diffusivity profile that the
vertical-mixing estimator adds to the tracer diffusivity
(mod_difest.F90:2929-2941)."""

from __future__ import annotations

import numpy as np
import torch


def _device(device):
    """The entry points' device: CUDA unless the caller names one
    (imported here: the drivers import this module through the step)."""
    from ..drivers.standalone import _device as entry_device
    return entry_device(device)


def inivar_tidaldissip(shape, dtype=torch.float64, device=None):
    """Zero field (inivar_tidaldissip, mod_tidaldissip.F90:47-60)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=_device(device))


def read_tidaldissip(path: str, varname: str = 'twedon',
                     dtype=torch.float64, device=None):
    """Load the dissipation field (read_tidaldissip,
    mod_tidaldissip.F90:63-155) from a .npz or .npy archive or a classic
    NetCDF file (scipy), as a tensor of `dtype` on `device`."""
    if path.endswith('.npz'):
        arr = np.load(path)[varname]
    elif path.endswith('.npy'):
        arr = np.load(path)
    else:
        from scipy.io import netcdf_file
        with netcdf_file(path, 'r', mmap=False) as f:
            arr = f.variables[varname][:].copy()
    arr = np.asarray(arr)
    # NetCDF stores big-endian; torch takes the native byte order only
    arr = arr.astype(arr.dtype.newbyteorder('='))
    return torch.as_tensor(arr, dtype=dtype, device=_device(device))


def tidal_diffusivity(twedon, bvfbot, bvfsq, p_i, dp_k, grav: float,
                      tdmq: float = 1. / 3., dmxeff: float = .2,
                      tdmls0: float = 500. * 9806.,
                      tdmls1: float = 500. * 9806.,
                      tdclat: float = 0., tddlat: float = 1., plat=None):
    """Tidally driven diapycnal diffusivity profile (the tdmflg branch,
    mod_difest.F90:2929-2941): a bottom-intensified vertical structure
    function times the local dissipation."""
    if plat is None:
        q = tdmls0
    else:
        w = .5 * (torch.tanh(4. * (torch.abs(plat) - tdclat) / tddlat - 2.)
                  + 1.)
        q = (1. - w) * tdmls0 + w * tdmls1
    pbot = p_i[-1]
    vsf = ((torch.exp(p_i[1:] / q) - torch.exp(p_i[:-1] / q))
           / (torch.clamp(dp_k, min=1.e-12)
              * torch.clamp(torch.exp(pbot / q) - 1., min=1.e-12)))
    return (grav * tdmq * dmxeff * twedon[None] * bvfbot[None] * vsf
            / torch.clamp(bvfsq, min=1.e-12))
