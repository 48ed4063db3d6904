"""Lateral (along-layer) diffusion of tracers.

Counterpart of `blom_tpu/dynamics/diffus.py` (BLOM's
mod_diffus.F90:41-187): depth-limited diffusive fluxes q*(c(i-1) - c(i))
with q = delt1 * mean(difiso) * dy/dx * max(min(dp), eps), applied to T,
S and the passive tracers."""

from __future__ import annotations

import dataclasses

import torch

from ..core import eos
from ..core.grid import Grid
from ..core.state import State
from .diffusion_fields import DiffusionFields

dpeps = 1.e-5    # (mod_diffus.F90:56)


def diffus(grid: Grid, e: eos.EosParams, s: State, dfl: DiffusionFields,
           m: int, n: int, delt1):
    """Diffuse time level n in place; returns (state, dfl) with dfl
    holding the step's heat/salt fluxes (utflld, usflld, vtflld,
    vsflld)."""
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    im1, ip1, jm1 = grid.im1, grid.ip1, grid.jm1

    dp = s.dp[n]
    qu = delt1 * .5 * (im1(dfl.difiso) + dfl.difiso) \
        * grid.scuy * grid.scuxi \
        * torch.clamp(torch.minimum(im1(dp), dp), min=dpeps) * iu
    qv = delt1 * .5 * (jm1(dfl.difiso) + dfl.difiso) \
        * grid.scvx * grid.scvyi \
        * torch.clamp(torch.minimum(jm1(dp), dp), min=dpeps) * iv

    def apply(c):
        uf = qu * (im1(c) - c)
        vf = qv * (jm1(c) - c)
        div = (ip1(uf) - uf + grid.jp1(vf, 'v', True) - vf)
        qi = 1.0 / (grid.scp2 * torch.clamp(dp, min=dpeps))
        return (c - qi * div) * ip, uf, vf

    temp_new, utf, vtf = apply(s.temp[n])
    saln_new, usf, vsf = apply(s.saln[n])
    s.temp[n] = temp_new
    s.saln[n] = saln_new
    s.sigma[n] = eos.sig(e, temp_new, saln_new) * ip
    s.utflx[m] += utf
    s.vtflx[m] += vtf
    s.usflx[m] += usf
    s.vsflx[m] += vsf
    for t in range(s.trc.shape[1]):
        s.trc[n, t] = apply(s.trc[n, t])[0]
    dfl = dataclasses.replace(dfl, utflld=utf, usflld=usf, vtflld=vtf,
                              vsflld=vsf)
    return s, dfl
