"""Lateral eddy diffusivity estimate.

Counterpart of `blom_tpu/dynamics/difest.py` (BLOM's mod_difest.F90
difest_lateral_hybrid): an Eden & Greatbatch (2008) style diffusivity
from the Eady growth rate and an eddy length scale, the
Rossby-radius-resolution weight difwgt, and the layer diffusivities
difint/difiso bounded by [egmndf, egmxdf] and the grid's stability
limit difmxp."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.constants import grav
from ..core.grid import Grid
from ..core.state import State
from .cmnfld import CmnFields
from .diffusion_fields import DiffusionFields


class DifestParams(NamedTuple):
    # &DIFFUSION (mod_diffusion.F90:200-546)
    egc: float = 0.
    eggam: float = 200.
    eglsmn: float = 4000.    # min eddy length scale [m]
    egmndf: float = 0.       # min diffusivity [m2 s-1]
    egmxdf: float = 1500.    # max diffusivity [m2 s-1]
    egidfq: float = 1.       # difiso = egidfq * difint
    ri0: float = 1.2


def difest_lateral(grid: Grid, s: State, cf: CmnFields,
                   par: DifestParams, dfl: DiffusionFields,
                   m: int, n: int) -> DiffusionFields:
    """dfl with new difint, difiso and difwgt (difest_lateral_hybrid,
    mod_difest.F90)."""
    ip = grid.ip
    dp = s.dp[n]

    # first-baroclinic Rossby radius: (1/|f|) * int N dz / pi
    n_int = torch.sqrt(torch.clamp(cf.bfsqi[1:-1], min=0.))
    dz_mid = .5 * (dp[:-1] + dp[1:]) * 1.e-3 / grav
    cint = torch.sum(n_int * dz_mid, 0)
    absf = torch.clamp(grid.coriop.abs(), min=1.e-6)
    rossby = cint / (math.pi * absf)

    # resolution weight, -> 1 where the radius is unresolved
    dx = torch.sqrt(grid.scp2)
    difwgt = (dx * dx / (dx * dx + rossby * rossby)) * ip

    # interface slope -> large-scale Richardson number -> Eady rate
    slp_u = .5 * (cf.nslpx + grid.ip1(cf.nslpx))
    slp_v = .5 * (cf.nslpy + grid.jp1(cf.nslpy, 'v', True))
    slp2 = slp_u * slp_u + slp_v * slp_v
    ri = 1.0 / torch.clamp(slp2, min=1e-12)
    sigma_eady = absf / torch.sqrt(ri * (ri + par.eggam))

    L = torch.clamp(torch.minimum(rossby, dx), min=par.eglsmn)
    K_i = torch.clamp(par.egc * sigma_eady * L * L,
                      par.egmndf, par.egmxdf) * ip     # (kk+1, H)

    # min(difmxp, egmxdf, max(egmndf, K)) (mod_difest.F90:1910-1921)
    difint = torch.minimum(grid.difmxp, .5 * (K_i[:-1] + K_i[1:]))
    difiso = torch.minimum(grid.difmxp,
                           torch.clamp(par.egidfq * difint,
                                       par.egmndf, par.egmxdf))
    return dataclasses.replace(dfl, difint=difint, difiso=difiso,
                               difwgt=difwgt)
