"""fuk95 experiment: periodic-channel jet instability.

Counterpart of `blom_tpu/configs/fuk95.py` (Fukamachi et al. 1995;
BLOM's mod_fuk95.F90): analytic geometry (geoenv_fuk95, :121-238), zero
forcing and a geostrophically balanced density front as initial
condition (inicon_fuk95: :352-416 for the cntiso_hybrid coordinate,
:281-350 for isopyc_bulkml).  Walls at i = 0 and i = itdm-1,
periodic in j.  Geometry and profiles are host numpy."""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as c
from ..core.grid import Grid, finish_grid

# Experiment constants (mod_fuk95.F90:47-60).
u0 = .3          # maximum jet velocity [m s-1]
h1 = 1.e2        # depth of active layer [m]
h0 = 2.e2        # depth of water column [m]
l0 = 2.e4        # half-width of the jet [m]
drho = 0.19      # active-layer density difference [kg m-3]
rhoc = 1025.9    # density at center of active layer [kg m-3]
rhob = 1027.0    # density beneath active layer [kg m-3]
f = 1.e-4        # Coriolis parameter [s-1]
lat0 = 45.       # center latitude [deg]
lam = 20.8e3     # channel length [m]
mindz = 1.       # minimum interior layer thickness [m]
saln0 = 35.      # constant salinity [g kg-1]

ITDM, JTDM, KDM = 156, 32, 12


def grid_spacing():
    """Grid spacing [m]: the reference's 650 m at every size, so a
    scaled-up grid grows the domain and keeps the deck's time steps
    stable."""
    return lam / JTDM


def _x_nudge(ri, rj, itdm, jtdm):
    """Perturbed cross-channel position (mod_fuk95.F90:74-84); ri, rj are
    1-based global indices."""
    return ((ri - itdm // 2 - .5
             + .1 * np.sin(2. * (rj - 1) * np.pi / jtdm))
            * grid_spacing())


def _x_psi(x):
    """Integral of the jet shape function (mod_fuk95.F90:100-115)."""
    inside = .5 * (x + l0 / np.pi * np.sin(np.pi * x / l0))
    return np.where(x <= -l0, -.5 * l0, np.where(x >= l0, .5 * l0, inside))


def make_grid(baclin: float = 180., itdm=ITDM, jtdm=JTDM, kdm=KDM,
              dtype=torch.float64, device='cpu') -> Grid:
    """The fuk95 analytic grid (geoenv_fuk95, mod_fuk95.F90:121-238)."""
    depths = np.full((jtdm, itdm), h0)
    depths[:, 0] = 0.0
    depths[:, -1] = 0.0

    gs = grid_spacing()
    dlat = gs * c.radian / c.rearth
    dlon = dlat * np.sin(lat0 / c.radian)

    iidx = np.arange(1, itdm + 1)[None, :] * np.ones((jtdm, 1))
    jidx = np.arange(1, jtdm + 1)[:, None] * np.ones((1, itdm))

    plon = (jidx + .5) * dlon
    plat = (iidx - itdm // 2) * dlat + lat0

    ones = np.ones((jtdm, itdm))
    return finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=plon, plat=plat, depths=depths,
        corioq=ones * f, coriop=ones * f,
        betafp=ones * (f / (np.tan(lat0 / c.radian) * c.rearth)),
        periodic_i=False, periodic_j=True, kk=kdm, baclin=baclin,
        dtype=dtype, device=device)


def initial_profiles(itdm=ITDM, jtdm=JTDM, kdm=KDM):
    """Initial interface depths z (kdm+1), layer sigma, saln, sigmar and
    phi for the cntiso_hybrid coordinate (inicon_fuk95,
    mod_fuk95.F90:352-416 default branch).  Returns numpy arrays."""
    kk = kdm
    # Reference sigma ladder (mod_fuk95.F90:369-380).
    drhojet = rhoc * f * u0 * l0 / (c.grav * h1)
    dsig = (drho + drhojet) / (kk - 5)
    sigref = np.zeros(kk)
    sigref[kk - 3] = rhoc + .5 * (drho + drhojet - dsig) - c.rho0
    for k in range(kk - 4, -1, -1):
        sigref[k] = sigref[k + 1] - dsig
    sigref[kk - 1] = rhob - c.rho0
    sigref[kk - 2] = (2. * sigref[kk - 3] + sigref[kk - 1]) / 3.
    sigref[kk - 1] = (sigref[kk - 3] + 2. * sigref[kk - 1]) / 3.

    iidx = np.arange(1, itdm + 1)[None, :] * np.ones((jtdm, 1))
    jidx = np.arange(1, jtdm + 1)[:, None] * np.ones((1, itdm))
    x = _x_nudge(iidx, jidx, itdm, jtdm)

    # Constant z-level interfaces initially (mod_fuk95.F90:382-398).
    z = np.zeros((kk + 1, jtdm, itdm))
    for k in range(kk + 1):
        z[k] = k * h0 / kk

    s0 = rhob - c.rho0
    sigm = rhoc * (1. + f * u0 * _x_psi(x) / (c.grav * h1)) - c.rho0
    sigma = np.zeros((kk, jtdm, itdm))
    for k in range(kk):
        zl, zu = z[k + 1], z[k]
        s1 = sigm + .5 * drho * (zl + zu - h1) / h1
        sigma[k] = ((s1 * np.maximum(0., np.minimum(zl, h1) - zu)
                     + s0 * np.maximum(0., zl - np.maximum(zu, h1)))
                    / (zl - zu))

    saln = np.full((kk, jtdm, itdm), saln0)
    sigmar = sigref[:, None, None] * np.ones((kk, jtdm, itdm))
    phi = -c.grav * z
    return z, sigma, saln, sigmar, phi


mltmin = 5.   # minimum mixed layer thickness [m] (mod_mxlayr.F90:73)


def initial_profiles_isopyc(itdm=ITDM, jtdm=JTDM, kdm=KDM):
    """Initial state for the isopyc_bulkml vertical coordinate
    (inicon_fuk95 first branch, mod_fuk95.F90:281-350): bulk mixed layer
    at the minimum thickness, isopycnic layer interfaces placed where the
    jet's density profile crosses the reference-density midpoints, and
    clamped to the mixed layer's base above it, so that many interior
    layers start massless.  Returns numpy arrays (z, sigma, saln, sigmar,
    phi)."""
    kk = kdm
    drhojet = rhoc * f * u0 * l0 / (c.grav * h1)
    dsig = (drho + drhojet) / (kk - 4)
    sigref = np.zeros(kk)
    sigref[kk - 1] = rhob - c.rho0
    sigref[kk - 2] = rhoc + .5 * (drho + drhojet) - c.rho0
    for k in range(kk - 3, -1, -1):
        sigref[k] = sigref[k + 1] - dsig

    iidx = np.arange(1, itdm + 1)[None, :] * np.ones((jtdm, 1))
    jidx = np.arange(1, jtdm + 1)[:, None] * np.ones((1, itdm))
    x = _x_nudge(iidx, jidx, itdm, jtdm)
    sigm = rhoc * (1. + f * u0 * _x_psi(x) / (c.grav * h1)) - c.rho0

    z = np.zeros((kk + 1, jtdm, itdm))
    z[1] = .5 * mltmin
    z[2] = mltmin
    z[kk - 1] = h1
    z[kk] = h0
    for k in range(3, kk - 1):          # 0-based interfaces 3..kk-2
        sigi = .5 * (sigref[k - 1] + sigref[k])
        zk = ((sigi - sigm) / drho + .5) * h1
        z[k] = np.minimum(z[kk - 1] - mindz * (kk - 1 - k),
                          np.maximum(z[2], zk))

    sigma = sigref[:, None, None] * np.ones((kk, jtdm, itdm))
    sigma[0] = sigm + .5 * drho * (z[1] + z[0] - h1) / h1
    sigma[1] = sigm + .5 * drho * (z[2] + z[1] - h1) / h1

    saln = np.full((kk, jtdm, itdm), saln0)
    sigmar = sigref[:, None, None] * np.ones((kk, jtdm, itdm))
    phi = -c.grav * z
    return z, sigma, saln, sigmar, phi
