"""Climatological initial conditions (WOA-style z-level ingest).

The port's own copy of `blom_tpu/core/inicon.py` (BLOM's
mod_inicon.F90:343-561 inicon_woa_file): flood-fill the climatology's
missing values, build a destination interface grid by index
interpolation of the source z-grid onto kk layers clipped to the local
depth, and remap T and S onto it conservatively by bin averaging, as
blom_tpu does.  Host numpy, as in blom_tpu; the ALE regrid then relaxes
the layers toward their reference densities during the run."""

from __future__ import annotations

import numpy as np
import torch

from . import eos
from .constants import grav
from .geoenv import fill_global


def dst_interfaces(depth_bnds: np.ndarray, kk: int) -> np.ndarray:
    """Destination interface depths (positive down, (kk+1,)) by index
    interpolation of the source grid (inicon_woa_file,
    mod_inicon.F90:424-436)."""
    kdm_src = depth_bnds.shape[0]
    z_src = np.concatenate([[depth_bnds[0, 0]], depth_bnds[:, 1]])
    z_dst = np.empty(kk + 1)
    z_dst[0] = z_src[0]
    for k in range(1, kk):
        rk = kdm_src * k / kk + 1.
        k_src = int(rk)
        dk = rk - k_src
        z_dst[k] = z_src[k_src - 1] * (1. - dk) + z_src[k_src] * dk
    z_dst[kk] = z_src[-1]
    return z_dst


def inicon_woa(grid, e: eos.EosParams, t_src, s_src, depth_bnds,
               fval=-9.99e33):
    """Numpy (temp, saln, sigmar, phi) initial fields from a z-level T/S
    climatology (inicon_woa_file, mod_inicon.F90:343-561).

    t_src/s_src: (ksrc, J, I) on the model's horizontal grid;
    depth_bnds: (ksrc, 2) source-bin bounds [m]."""
    kk = grid.kk
    depths = grid.depths.cpu().double().numpy()
    ipm = grid.ip.cpu().double().numpy()
    ksrc = t_src.shape[0]
    t = np.array(t_src, np.float64)
    s = np.array(s_src, np.float64)

    # mask levels below the sea floor and fill missing data laterally
    # (mod_inicon.F90:386-402)
    for k in range(ksrc):
        below = depths < depth_bnds[k, 0]
        t[k] = np.where((ipm == 0) | below, np.nan, t[k])
        s[k] = np.where((ipm == 0) | below, np.nan, s[k])
        t[k] = fill_global(t[k], np.nan, mask=ipm,
                           cyclic_i=grid.periodic_i)
        s[k] = fill_global(s[k], np.nan, mask=ipm,
                           cyclic_i=grid.periodic_i)

    # destination interfaces clipped to the local depth (:430-445)
    z_ref = dst_interfaces(np.asarray(depth_bnds), kk)
    z_dst = np.minimum(z_ref[:, None, None], depths[None])
    z_src = np.concatenate([[depth_bnds[0, 0]], depth_bnds[:, 1]])

    # per-column remap onto the column's clipped destinations
    up = z_src[:-1][:, None, None, None]
    lo = z_src[1:][:, None, None, None]
    w = np.maximum(0., np.minimum(lo, z_dst[None, 1:])
                   - np.maximum(up, z_dst[None, :-1]))
    den = w.sum(0)
    temp = np.einsum('sdji,sji->dji', w, np.nan_to_num(t)) \
        / np.maximum(den, 1e-30)
    saln = np.einsum('sdji,sji->dji', w, np.nan_to_num(s)) \
        / np.maximum(den, 1e-30)
    # massless bins inherit from above
    for k in range(1, kk):
        empty = den[k] <= 0.
        temp[k] = np.where(empty, temp[k - 1], temp[k])
        saln[k] = np.where(empty, saln[k - 1], saln[k])
    temp[:, ipm == 0] = 10.
    saln[:, ipm == 0] = 35.

    # reference densities from the initial profile, monotonized
    sigmar = eos.sig(e, torch.from_numpy(temp),
                     torch.from_numpy(saln)).numpy()
    sigmar = np.maximum.accumulate(sigmar, axis=0)

    # interface geopotential from the clipped destination depths
    phi = -grav * z_dst
    return temp, saln, sigmar, phi
