"""Single-column experiment: a 1x1 horizontal grid, vertical physics only.

Counterpart of `blom_tpu/configs/single_column.py` (BLOM's
single_column/mod_single_column.F90): a 1000 m column at 11 km grid
spacing with zero Coriolis, periodic in i and j; BLOM reads its initial
stratification from a WOA-derived inicon.nc, blom_tpu replaces it with
an analytic exponential thermocline, and so does the port.  Geometry and
profiles are host numpy; the grid is built on `device`."""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as c
from ..core.grid import Grid, finish_grid

ITDM, JTDM, KDM = 1, 1, 25
DEPTH = 1000.


def make_grid(baclin: float = 1800., kdm=KDM, dtype=torch.float64,
              device='cpu') -> Grid:
    ones = np.ones((JTDM, ITDM))
    return finish_grid(
        scpx=ones * 11000., scpy=ones * 11000., scux=ones * 11000.,
        scuy=ones * 11000., scvx=ones * 11000., scvy=ones * 11000.,
        scqx=ones * 11000., scqy=ones * 11000.,
        plon=ones * -165.5, plat=ones * 0., depths=ones * DEPTH,
        corioq=ones * 0., coriop=ones * 0., betafp=ones * 0.,
        periodic_i=True, periodic_j=True, kk=kdm, baclin=baclin,
        dtype=dtype, device=device)


def initial_profiles(kdm=KDM, t_surf=28., t_deep=4., efold=300.,
                     s_surf=34.5, s_deep=34.8):
    """Analytic tropical stratification, an exponential thermocline:
    numpy (z, temp, saln, phi)."""
    kk = kdm
    z = np.zeros((kk + 1, JTDM, ITDM))
    for k in range(kk + 1):
        z[k] = DEPTH * k / kk
    zmid = .5 * (z[1:] + z[:-1])
    temp = t_deep + (t_surf - t_deep) * np.exp(-zmid / efold)
    saln = s_deep + (s_surf - s_deep) * np.exp(-zmid / efold)
    phi = -c.grav * z
    return z, temp, saln, phi
