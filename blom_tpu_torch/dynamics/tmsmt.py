"""Leap-frog time smoothing.

Counterpart of `blom_tpu/dynamics/tmsmt.py` (BLOM's mod_tmsmt.F90): the
pre-step saves (tmsmt1, :215-280) and the post-step thickness/scalar
blend (tmsmt2, :282-412).  Velocity smoothing lives in momtum."""

from __future__ import annotations

import torch

from ..core.constants import epsilp
from ..core.grid import Grid
from ..core.state import State, cumulative_p, dpu_dpv_upstream

# Smoothing weights (mod_tmsmt.F90:46-51).
wuv1 = .75
wuv2 = .125
wts1 = .875
wts2 = .0625
wbaro = .125


def tmsmt1(grid: Grid, s: State, n: int, vcoord_isopyc: bool = False) -> State:
    """Save old-time-level fields for later smoothing; in the isopycnic
    coordinate also the layer thicknesses at u and v points."""
    s.dpold[n] = s.dp[n]
    s.told.copy_(s.temp[n])
    s.sold.copy_(s.saln[n])
    s.trcold.copy_(s.trc[n])
    if vcoord_isopyc:
        s.dpuold.copy_(s.dpu[n])
        s.dpvold.copy_(s.dpv[n])
    return s


def tmsmt2(grid: Grid, s: State, m: int, n: int,
           vcoord_isopyc: bool = False) -> State:
    """Blend the mid level with old/new thickness-weighted fields; in the
    isopycnic coordinate re-derive the mid level's dpu/dpv from the
    blended interfaces."""
    ip = grid.ip

    dpold_n = s.dpold[n]
    dp_n = s.dp[n]
    dp_m = s.dp[m]

    pbfaco = s.pb[m] / torch.clamp(torch.sum(dpold_n, 0), min=epsilp)
    pbfacn = s.pb[m] / torch.clamp(torch.sum(dp_n, 0), min=epsilp)

    pold = torch.clamp(dpold_n * pbfaco, min=0.)
    pmid = torch.clamp(dp_m, min=0.)
    pnew = torch.clamp(dp_n * pbfacn, min=0.)
    dp_m_new = (wts1 * pmid + wts2 * (pold + pnew)) * ip
    pold = pold + epsilp
    pmid = pmid + epsilp
    pnew = pnew + epsilp
    denom = dp_m_new + epsilp
    temp_m = (wts1 * pmid * s.temp[m]
              + wts2 * (pold * s.told + pnew * s.temp[n])) / denom * ip
    saln_m = (wts1 * pmid * s.saln[m]
              + wts2 * (pold * s.sold + pnew * s.saln[n])) / denom * ip
    trc_m = (wts1 * pmid[None] * s.trc[m]
             + wts2 * (pold[None] * s.trcold
                       + pnew[None] * s.trc[n])) / denom[None] * ip

    s.dp[m] = dp_m_new
    s.temp[m] = temp_m
    s.saln[m] = saln_m
    s.trc[m] = trc_m
    s.p = cumulative_p(dp_m_new) * ip
    if vcoord_isopyc:
        s.dpu[m], s.dpv[m] = dpu_dpv_upstream(grid, s.p)
    return s
