"""Idealized zonal channel with shelf-slope topography.

Counterpart of `blom_tpu/configs/channel.py` (BLOM's
channel/mod_channel.F90): periodic in i with land walls at the first and
last j rows, tanh continental slopes on both flanks with random
roughness and optional sinusoidal corrugations (geoenv_channel,
:61-209), a layered-sigma initial stratification (inicon_channel,
:211-325) and constant wind stress (inifrc_channel, :327-421).
Geometry and profiles are host numpy, computed as blom_tpu computes
them, so the two packages build the same depths from the same seed.
`ITDM`, `JTDM` and `KDM` are read when the channel is built.  With the
default 30 layers the sigma ladder of `initial_profiles` passes the
densest water the EOS has at S = 35, so the initial temperature is NaN
below layer 17, in blom_tpu as here; 16 layers or fewer stay finite."""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as c
from ..core.grid import Grid, finish_grid

ITDM, JTDM, KDM = 208, 512, 30


def make_grid(baclin: float = 300., itdm=ITDM, jtdm=JTDM, kdm=KDM,
              scxy: float = 2000., sfdepth: float = 300.,
              sldepth: float = 3700., rdepth: float = 50.,
              swidth: float = 8.e4, cwidth: float = 1.e5,
              corio0: float = -1.1e-4, beta0: float = 1.4e-11,
              acorru=(), wlcorru=(), seed: int = 1144153914,
              dtype=torch.float64, device='cpu') -> Grid:
    """Channel geometry (geoenv_channel, mod_channel.F90:61-209)."""
    rng = np.random.default_rng(seed)
    r0 = rng.random((jtdm, itdm))

    iidx = np.arange(1, itdm + 1)[None, :] * np.ones((jtdm, 1))
    jidx = np.arange(1, jtdm + 1)[:, None] * np.ones((1, itdm))

    y_s = scxy * jidx               # distance from the south wall
    y_n = scxy * (jtdm - jidx)      # distance from the north wall

    d_corru = np.zeros((jtdm, itdm))
    for a, wl in zip(acorru, wlcorru):
        d_corru += a * np.sin(2. * np.pi * scxy * iidx / wl)

    def slope(y):
        return sfdepth + rdepth * r0 + .5 * sldepth * (
            1. + np.tanh(np.pi * (y - swidth - d_corru) / cwidth))

    depths = np.where(y_s < swidth + cwidth, slope(y_s),
                      np.where(y_n < swidth + cwidth, slope(y_n),
                               sfdepth + rdepth * r0 + sldepth))
    depths[0, :] = 0.0
    depths[-1, :] = 0.0

    ones = np.ones((jtdm, itdm))
    return finish_grid(
        scpx=ones * scxy, scpy=ones * scxy, scux=ones * scxy,
        scuy=ones * scxy, scvx=ones * scxy, scvy=ones * scxy,
        scqx=ones * scxy, scqy=ones * scxy,
        plon=ones * 0., plat=ones * 0., depths=depths,
        corioq=ones * corio0, coriop=ones * corio0, betafp=ones * beta0,
        periodic_i=True, periodic_j=False, kk=kdm, baclin=baclin,
        dtype=dtype, device=device)


def initial_profiles(grid: Grid, itdm=ITDM, jtdm=JTDM, kdm=KDM,
                     s0: float = 35., sig0: float = 26.,
                     sig0dz: float = .05, sigdz: float = .6,
                     sigscl: float = 1., dztop: float = 30.,
                     dzmax: float = 400., dzscl: float = 1.):
    """Layered-sigma initial stratification (inicon_channel,
    mod_channel.F90:211-325): a tanh sigma ladder with tanh-growing
    layer thicknesses, truncated at the grid's bathymetry (in the grid's
    dtype, as blom_tpu reads it).  Returns numpy z, sigmar, saln, phi."""
    kk = kdm
    sigmr0 = np.zeros(kk)
    dz0 = np.zeros(kk)
    sigmr0[0] = sigmr0[1] = sig0
    dz0[0] = dz0[1] = dztop
    for k in range(2, kk):
        sigmr0[k] = sigmr0[k - 1] + sig0dz + sigdz * (
            1. - np.tanh(sigscl * np.pi * k / kk))
        dz0[k] = dzmax * np.tanh(dzscl * np.pi * k / kk)

    depths = grid.depths.cpu().numpy()
    z = np.zeros((kk + 1, jtdm, itdm))
    for k in range(kk):
        z[k + 1] = np.minimum(depths, z[k] + dz0[k])
    # collapse vanished layers onto the bottom (mod_channel.F90:292-305)
    for k in range(1, kk):
        z[k] = np.where(z[kk] - z[k] < 1e-6, depths, z[k])
    z[kk] = depths

    sigmar = sigmr0[:, None, None] * np.ones((kk, jtdm, itdm))
    saln = np.full((kk, jtdm, itdm), s0)
    phi = -c.grav * z
    return z, sigmar, saln, phi


def wind_stress(shape, ztx0: float = -.05, mty0: float = 0.):
    """Constant zonal wind stress [N m-2] (inifrc_channel,
    mod_channel.F90:327-421)."""
    taux = np.full(shape, ztx0)
    tauy = np.full(shape, mty0)
    return taux, tauy
