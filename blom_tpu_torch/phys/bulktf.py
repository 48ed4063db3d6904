"""Bulk turbulent air-sea transfer coefficients (Fairall et al. 1996).

Counterpart of `blom_tpu/phys/bulktf.py` (BLOM's ben02/mod_bulktf.F90):
the Monin-Obukhov stability functions, the Liu-Katsaros-Businger
roughness-Reynolds scaling and one iteration of the bulk flux algorithm,
elementwise over tensors; the reference's sequential bin search in `lkb`
is a vectorised piecewise power law.  A Python number divided by a
tensor is written as a tensor division (`_rdiv`), since PyTorch
computes ``c / x`` as ``c * (1 / x)``."""

from __future__ import annotations

import math

import torch

EPS = 0.62197              # molecular weight ratio dry air / vapour
CV = 1. / EPS - 1.
T0 = 273.15
ZI = 600.                  # inversion height [m]
G = 9.8
BETA = 1.2                 # gustiness constant
ALPHA = .011               # Charnock constant
KARMAN = .4

_SQRT3 = 1.732050807568877
_SQRT3I = .5773502691896258


def _rdiv(c, x):
    """c / x for a Python number c, divided elementwise as blom_tpu does."""
    return torch.full_like(x, c) / x


def _psi_conv(zeta, kin_log2):
    """The convective branch: the Kansas-type and free-convective forms
    blended (mod_bulktf.F90:40-97)."""
    x = (1. - 16. * zeta) ** .25
    psik = kin_log2(x)
    y = (1. - 12.87 * zeta) ** (1. / 3.)
    psic = (1.5 * torch.log((y * y + y + 1.) / 3.)
            - _SQRT3 * torch.atan((2. * y + 1.) * _SQRT3I)
            + math.pi * _SQRT3I)
    f = _rdiv(1., 1. + zeta * zeta)
    return f * psik + (1. - f) * psic


def psiu(zeta):
    """Velocity profile function (mod_bulktf.F90:40-67).  Both branches
    are evaluated; the convective one on zeta clamped below 0, so that it
    stays finite where the stable one is taken."""
    zneg = torch.clamp(zeta, max=-1.e-12)
    conv = _psi_conv(
        zneg,
        lambda x: (2. * torch.log((1. + x) * .5)
                   + torch.log((1. + x * x) * .5)
                   - 2. * torch.atan(x) + math.pi * .5))
    return torch.where(zeta >= 0., -4.7 * zeta, conv)


def psitq(zeta):
    """Temperature/humidity profile function (mod_bulktf.F90:71-97)."""
    zneg = torch.clamp(zeta, max=-1.e-12)
    conv = _psi_conv(zneg, lambda x: 2. * torch.log((1. + x * x) * .5))
    return torch.where(zeta >= 0., -4.7 * zeta, conv)


# LKB roughness-Reynolds tables (mod_bulktf.F90:116-119)
_LKB_RE = (0.11, 0.825, 3.0, 10.0, 30.0, 100., 300., 1000.)
_LKB_AT = (0.177, 1.376, 1.026, 1.625, 4.661, 34.904, 1667.19, 5.88e5)
_LKB_BT = (0., 0.929, -0.599, -1.018, -1.475, -2.067, -2.907, -3.935)
_LKB_AQ = (0.292, 1.808, 1.393, 1.956, 4.994, 30.709, 1448.68, 2.98e5)
_LKB_BQ = (0., 0.826, -0.528, -0.870, -1.297, -1.845, -2.682, -3.616)


def lkb(reu):
    """Roughness Reynolds numbers for temperature and humidity (Liu,
    Katsaros & Businger 1979; mod_bulktf.F90:101-131)."""
    def tab(v):
        return torch.tensor(v, dtype=reu.dtype, device=reu.device)
    i = torch.clamp(torch.searchsorted(tab(_LKB_RE), reu.contiguous(),
                                       right=False), 0, 7)
    ret = tab(_LKB_AT)[i] * reu ** tab(_LKB_BT)[i]
    req = tab(_LKB_AQ)[i] * reu ** tab(_LKB_BQ)[i]
    return ret, req


def bulktf(du, zu, ta, zt, qa, zq, ts, qs, icec, cd, ch, ce, wg2):
    """One iteration of the bulk transfer-coefficient algorithm
    (mod_bulktf.F90:135-248).  Returns the updated (cd, ch, ce, wg2)."""
    tv = ta * (1. + CV * qa)
    tac = ta - T0
    visca = 1.326e-5 * (1. + tac * (6.542e-3 + tac
                                    * (8.301e-6 - tac * 4.84e-9)))
    dt = ta - ts + .0098 * zt
    dq = qa - qs

    du1 = torch.clamp(du, min=1.e-2)
    du2 = du1 * du1
    s = torch.sqrt(du2 + wg2)
    ustar2 = cd * s * du1
    ustar = torch.sqrt(ustar2)
    fac = ustar / (cd * du1)
    tstar = fac * ch * dt
    qstar = fac * ce * dq

    tvstar = tstar * (1 + CV * qa) + CV * ta * qstar
    li = torch.clamp(G * KARMAN * tvstar / (ustar2 * tv), max=3. / zu)

    w3 = -ZI * G * ustar * tvstar / ta
    wg = torch.clamp(BETA * torch.clamp(w3, min=0.) ** (1. / 3.), min=.1)
    s = torch.sqrt(du2 + wg * wg)

    zetau = zu * li
    zetat = zt * li
    zetaq = zq * li

    z0 = icec * 2.e-3 + (1. - icec) * (0.11 * visca / ustar
                                       + ALPHA * ustar2 / G)
    cd2 = _rdiv(KARMAN, torch.clamp(torch.log(_rdiv(zu, z0)) - psiu(zetau),
                                    min=7.))
    ustar = cd2 * torch.sqrt(s * du1)

    reu = ustar * z0 / visca
    ret, req = lkb(reu)
    fac = visca / ustar
    z0t = fac * ret
    z0q = fac * req
    ct2 = _rdiv(KARMAN, torch.clamp(torch.log(_rdiv(zt, z0t))
                                    - psitq(zetat), min=7.))
    cq2 = _rdiv(KARMAN, torch.clamp(torch.log(_rdiv(zq, z0q))
                                    - psitq(zetaq), min=7.))

    return cd2 * cd2, cd2 * ct2, cd2 * cq2, wg * wg
