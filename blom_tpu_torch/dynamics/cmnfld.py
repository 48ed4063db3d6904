"""Shared derived fields: buoyancy frequency, neutral slopes, MLD.

Counterpart of `blom_tpu/dynamics/cmnfld.py` (BLOM's
mod_cmnfld_routines.F90): interface buoyancy frequency squared with a
1-2-1 vertical filter, the neutral-slope vectors at the interior
interfaces, and a density-criterion mixed-layer depth."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import grav, onem, onemu, rho0
from ..core.grid import Grid
from ..core.state import State, cumulative_p

bfsqmn = 1.e-7   # minimum filtered BFSQ [s-2] (mod_cmnfld.F90)


class CmnFields(NamedTuple):
    bfsqi: torch.Tensor   # (kk+1, H) interface buoyancy freq^2 [s-2]
    bfsqf: torch.Tensor   # (kk+1, H) filtered, bounded below
    nslpx: torch.Tensor   # (kk+1, H) x neutral slope at u []
    nslpy: torch.Tensor   # (kk+1, H) y neutral slope at v
    mld: torch.Tensor     # (H) mixed layer depth [m]


def cmnfld(grid: Grid, e: eos.EosParams, s: State, n: int) -> CmnFields:
    """BFSQ, neutral slopes and MLD of time level n (cmnfld2,
    mod_cmnfld_routines.F90:1158-1240)."""
    kk = grid.kk
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    im1, jm1 = grid.im1, grid.jm1

    dp = s.dp[n]
    temp, saln = s.temp[n], s.saln[n]
    p = cumulative_p(dp) * ip

    # interface BFSQ: in-situ densities of the two layers at the shared
    # interface pressure (:92-100)
    pm = p[1:-1]
    rho_lo = eos.rho(pm, temp[1:], saln[1:])
    rho_up = eos.rho(pm, temp[:-1], saln[:-1])
    dp_mid = torch.clamp(.5 * (dp[:-1] + dp[1:]), min=onemu)
    n2 = grav * grav * (rho_lo - rho_up) / dp_mid      # (kk-1, H)
    zt = torch.zeros_like(n2[:1])
    bfsqi = torch.cat([n2[:1], n2, n2[-1:]], 0)

    # vertical 1-2-1 smoothing with a lower bound (:118-210)
    up = torch.cat([bfsqi[:1], bfsqi[:-1]], 0)
    dn = torch.cat([bfsqi[1:], bfsqi[-1:]], 0)
    bfsqf = torch.clamp(.25 * up + .5 * bfsqi + .25 * dn, min=bfsqmn)

    # interface geopotential, hydrostatic from the bottom (:436-453)
    phi_bot = s.phi[kk]
    dphi_layer = eos.p_alpha(p[:-1], p[1:], temp, saln)
    phi = torch.cat(
        [phi_bot[None] + torch.flip(torch.cumsum(torch.flip(dphi_layer, [0]),
                                                 0), [0]),
         phi_bot[None]], 0)

    # neutral slopes at interior interfaces (:497-528):
    # nslp = (g*rho_x/(rho0*bfsqf) + phi_x/g) / dx
    pmn_u = .5 * (pm + im1(pm))
    rho_c = eos.rho(pmn_u, temp[:-1], saln[:-1])
    rho_cl = eos.rho(pmn_u, temp[1:], saln[1:])
    rho_x = .5 * ((rho_c - im1(rho_c)) + (rho_cl - im1(rho_cl)))
    phi_x = phi[1:-1] - im1(phi[1:-1])
    bfsqm_u = .5 * (bfsqf[1:-1] + im1(bfsqf[1:-1]))
    nslpx_i = (grav * rho_x / (rho0 * bfsqm_u) + phi_x / grav) \
        * grid.scuxi * iu
    nslpx = torch.cat([zt, nslpx_i, zt], 0)

    pmn_v = .5 * (pm + jm1(pm))
    rho_c = eos.rho(pmn_v, temp[:-1], saln[:-1])
    rho_cl = eos.rho(pmn_v, temp[1:], saln[1:])
    rho_y = .5 * ((rho_c - jm1(rho_c)) + (rho_cl - jm1(rho_cl)))
    phi_y = phi[1:-1] - jm1(phi[1:-1])
    bfsqm_v = .5 * (bfsqf[1:-1] + jm1(bfsqf[1:-1]))
    nslpy_i = (grav * rho_y / (rho0 * bfsqm_v) + phi_y / grav) \
        * grid.scvyi * iv
    nslpy = torch.cat([zt, nslpy_i, zt], 0)

    # MLD: density criterion (:933-1084)
    mld = mixed_layer_depth(e, temp, saln, p, dp)
    return CmnFields(bfsqi=bfsqi * ip, bfsqf=bfsqf * ip,
                     nslpx=nslpx, nslpy=nslpy, mld=mld * ip)


def mixed_layer_depth(e: eos.EosParams, temp, saln, p, dp):
    """Depth [m] of the first layer centre whose surface-referenced
    density exceeds the top layer's by 0.03 kg m-3, at least 1 m."""
    sig0v = eos.sig0(e, temp, saln)
    deeper = sig0v > sig0v[0] + .03
    z_mid = (p[:-1] + .5 * dp) / onem
    mld = torch.where(deeper, z_mid, p[-1] / onem).amin(0)
    return torch.clamp(mld, min=1.0)
