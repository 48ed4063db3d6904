"""Synthetic tripolar (bipolar-fold) configuration.

Counterpart of `blom_tpu/configs/tripolar.py`: a tnx*-class topology at
any size, i-periodic, closed southern wall, and the top row on the
Arctic bipolar fold (nreg=2 in BLOM, mod_xc.F90:1457-1461; fold
semantics :2405-2700).  Uniform metrics and a constant f keep the
fold-symmetry requirement on the grid trivial while every fold code
path of the dynamics runs (the CPPM j-sweep's ghost rows, the tagged j+1
reads, the top-row sync).  Geometry and profiles are host numpy; the
grid is built on `device`."""

from __future__ import annotations

import numpy as np
import torch

from ..core import eos
from ..core.grid import Grid, finish_grid

H0 = 100.0          # flat bottom depth [m]
GS = 20.e3          # uniform grid spacing [m]
F0 = 1.e-4          # Coriolis [s-1]


def make_grid(baclin: float = 180., itdm: int = 32, jtdm: int = 24,
              kdm: int = 6, dtype=torch.float64, device='cpu') -> Grid:
    depths = np.full((jtdm, itdm), H0)
    depths[0, :] = 0.0          # southern wall

    ones = np.ones((jtdm, itdm))
    iidx = np.arange(itdm)[None, :] * ones
    jidx = np.arange(jtdm)[:, None] * ones
    plon = iidx * 360. / itdm
    plat = 40. + jidx * 40. / jtdm

    return finish_grid(
        scpx=ones * GS, scpy=ones * GS, scux=ones * GS, scuy=ones * GS,
        scvx=ones * GS, scvy=ones * GS, scqx=ones * GS, scqy=ones * GS,
        plon=plon, plat=plat, depths=depths,
        corioq=ones * F0, coriop=ones * F0, betafp=ones * 0.,
        periodic_i=True, periodic_j=False, kk=kdm, baclin=baclin,
        arctic=True, dtype=dtype, device=device)


def initial_profiles(itdm: int = 32, jtdm: int = 24, kdm: int = 6,
                     blob_amp: float = 2.0):
    """Stratified resting state plus a warm blob adjacent to the fold
    row (the blob straddles the seam once advected northward).  Returns
    numpy (z_i, temp, saln, sigmar, phi); the duplicated top row is
    synced by the caller (sync_state)."""
    e = eos.init_eos(pref=0.)

    z_i = np.linspace(0., H0, kdm + 1)
    sigma_k = 24.0 + 4.0 * np.arange(kdm) / max(kdm - 1, 1)

    saln = np.full((kdm, jtdm, itdm), 35.0)
    sigma = np.broadcast_to(sigma_k[:, None, None],
                            (kdm, jtdm, itdm)).copy()

    temp = eos.tofsig(e, torch.from_numpy(sigma),
                      torch.from_numpy(saln)).numpy()

    # warm anomaly in the row below the fold, centred mid-channel
    ii = np.arange(itdm)[None, :]
    jj = np.arange(jtdm)[:, None]
    blob = blob_amp * np.exp(-(((ii - itdm / 4.) / 3.) ** 2
                               + ((jj - (jtdm - 3)) / 2.) ** 2))
    temp = temp + blob[None, :, :] * np.exp(
        -np.arange(kdm) / 2.)[:, None, None]

    grav = 9.806
    phi = -grav * np.broadcast_to(z_i[:, None, None],
                                  (kdm + 1, jtdm, itdm)).copy()
    sigmar = sigma.copy()
    return z_i, temp, saln, sigmar, phi
