"""Grid-file geometry ingest and the flood fill of missing input data.

The port's own copy of `blom_tpu/core/geoenv.py`: `geoenv_file` reads a
BLOM-convention grid file (BLOM's mod_geoenv.F90:45-884: the
pdx/pdy/../qdx/qdy scale factors, plat/plon/qlat and pdepth), from
classic NetCDF through scipy or from a .npz archive with the same
variable names, with the CWMOD channel-width modifications; `fill_global`
is BLOM's mod_fill_global.F90.  File ingest is host numpy; the grid is
built on `device`."""

from __future__ import annotations

import numpy as np
import torch

from . import grid as grid_mod

OMEGA = 7.292e-5   # Earth rotation rate [1/s]

GRID_VARS = ('pdx', 'pdy', 'udx', 'udy', 'vdx', 'vdy', 'qdx', 'qdy',
             'plat', 'plon', 'qlat', 'pdepth')


def _load_vars(path: str, names):
    """The named variables of a .npz archive or a NetCDF file, as f64
    numpy arrays."""
    if path.endswith('.npz'):
        data = np.load(path)
        return {n: np.asarray(data[n], np.float64) for n in names}
    from scipy.io import netcdf_file
    with netcdf_file(path, 'r', mmap=False) as f:
        return {n: np.asarray(f.variables[n][:], np.float64).copy()
                for n in names}


def apply_cwmod(v, cwmod):
    """Channel-width modifications (the CWMOD namelist,
    mod_geoenv.F90:777-862): override the along-edge scale factor of a
    named strait cell, udy (scuy) for a 'u' edge and vdx (scvx) for a 'v'
    edge, with a prescribed width; the edge areas scu2/scv2 follow when
    the grid is finished.  cwmod entries are (cwmtag, cwmedg, cwmi,
    cwmj, cwmwth) with 1-based global Fortran indices."""
    for tag, edg, ci, cj, wth in cwmod:
        jtdm, itdm = v['pdx'].shape
        if edg not in ('u', 'v'):
            raise ValueError(
                f"cwmod {tag!r}: edge must be 'u' or 'v' "
                '(mod_geoenv.F90:826-832)')
        if not (1 <= ci <= itdm and 1 <= cj <= jtdm):
            raise ValueError(f'cwmod {tag!r}: indices out of bounds '
                             '(mod_geoenv.F90:833-839)')
        key = 'udy' if edg == 'u' else 'vdx'
        v[key][cj - 1, ci - 1] = float(wth)
    return v


def geoenv_file(path: str, kk: int, baclin: float,
                periodic_i: bool = True, arctic: bool = False,
                dtype=torch.float64, cwmod=(), device='cpu'):
    """A Grid from a BLOM-convention grid file (geoenv_file,
    mod_geoenv.F90:45-884: scale factors from the *dx/*dy variables,
    Coriolis from qlat/plat, depths from pdepth), closed in j.  cwmod is
    an optional sequence of channel-width modifications (apply_cwmod)."""
    v = _load_vars(path, GRID_VARS)
    if cwmod:
        v = apply_cwmod(v, cwmod)
    corioq = 2. * OMEGA * np.sin(np.radians(v['qlat']))
    coriop = 2. * OMEGA * np.sin(np.radians(v['plat']))
    rearth = 6.37122e6
    betafp = (2. * OMEGA * np.cos(np.radians(v['plat'])) / rearth)
    return grid_mod.finish_grid(
        scpx=v['pdx'], scpy=v['pdy'], scux=v['udx'], scuy=v['udy'],
        scvx=v['vdx'], scvy=v['vdy'], scqx=v['qdx'], scqy=v['qdy'],
        plon=v['plon'], plat=v['plat'], depths=v['pdepth'],
        corioq=corioq, coriop=coriop, betafp=betafp,
        periodic_i=periodic_i, periodic_j=False, kk=kk,
        baclin=baclin, arctic=arctic, dtype=dtype, device=device)


def fill_global(a: np.ndarray, missing, mask=None, cyclic_i: bool = True,
                maxiter: int = 1000) -> np.ndarray:
    """Flood-fill missing values by iterated neighbour averaging
    (mod_fill_global.F90: the reference sweeps until no missing point
    remains inside the ocean mask); points never reached become 0."""
    a = np.array(a, np.float64)
    if np.isnan(missing):
        miss = np.isnan(a)
    else:
        miss = np.abs(a - missing) < abs(missing) * 1e-6 + 1e-30
    if mask is not None:
        want = (np.asarray(mask) > 0)
    else:
        want = np.ones_like(a, bool)
    a[miss] = np.nan

    for _ in range(maxiter):
        bad = np.isnan(a) & want
        if not bad.any():
            break
        nb = []
        for (dj, di) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            sh = np.roll(a, (dj, di), axis=(0, 1))
            if dj == 1:
                sh[0, :] = np.nan
            if dj == -1:
                sh[-1, :] = np.nan
            if not cyclic_i:
                if di == 1:
                    sh[:, 0] = np.nan
                if di == -1:
                    sh[:, -1] = np.nan
            nb.append(sh)
        nb = np.stack(nb)
        cnt = np.sum(~np.isnan(nb), axis=0)
        ssum = np.nansum(np.where(np.isnan(nb), 0., nb), axis=0)
        fill = bad & (cnt > 0)
        a[fill] = ssum[fill] / cnt[fill]
    a[np.isnan(a)] = 0.
    return a
