"""Surface restoring: relaxation heat and salt fluxes.

Counterpart of `blom_tpu/phys/thermf.py` (BLOM's mod_thermf.F90 and the
relaxation part of its per-experiment thermf variants): heat and salt
fluxes that restore the top layer towards the SST/SSS climatologies
with e-folding times trxday/srxday over a depth trxdpt/srxdpt, the
differences clamped to trxlim/srxlim (mod_forcing.F90:194-443 declares
the knobs).  fuk95 and the channel keep both times at 0: no restoring."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.constants import grav, onem, spcifh
from ..core.grid import Grid
from ..core.state import State
from .forcing import Forcing


class ThermfParams(NamedTuple):
    trxday: float = 0.    # SST relaxation e-folding [days]; 0 = off
    srxday: float = 0.    # SSS relaxation e-folding [days]; 0 = off
    trxdpt: float = 1.    # relaxation depth [m]
    srxdpt: float = 1.
    trxlim: float = 1.5   # max |SST - clim| used [C]
    srxlim: float = .5    # max |SSS - clim| [g kg-1]


def thermf_relax(grid: Grid, s: State, forcing: Forcing, par: ThermfParams,
                 n: int, sstclm=None, sssclm=None) -> Forcing:
    """A new Forcing with the surrlx/salrlx restoring fluxes of time
    level n; the caller's `forcing` is left as it is."""
    surrlx = torch.zeros_like(forcing.surrlx)
    salrlx = torch.zeros_like(forcing.salrlx)

    if par.trxday > 0. and sstclm is not None:
        dt_lim = torch.clamp(sstclm - s.temp[n][0], -par.trxlim, par.trxlim)
        mass = par.trxdpt * onem / grav            # [kg m-2]
        surrlx = spcifh * mass * dt_lim / (par.trxday * 86400.) * grid.ip

    if par.srxday > 0. and sssclm is not None:
        ds_lim = torch.clamp(sssclm - s.saln[n][0], -par.srxlim, par.srxlim)
        mass = par.srxdpt * onem / grav
        salrlx = mass * ds_lim / (par.srxday * 86400.) * grid.ip

    return dataclasses.replace(forcing, surrlx=surrlx, salrlx=salrlx)
