"""Baroclinic mass-flux correction toward the barotropic bottom pressure.

Counterpart of `blom_tpu/dynamics/pbcor.py` (BLOM's mod_pbcor.F90,
'uc' upstream-column method): pbcor1 (:66-414) corrects the advected
new-level thicknesses toward the predicted bottom pressure before the
barotropic solve; pbcor2 (:416-759) corrects the mid level toward the
solved bottom pressure."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import epsilp
from ..core.grid import Grid
from ..core.state import State, cumulative_p

dpeps1 = 1.e-5   # (mod_pbcor.F90:57-60)
dpeps2 = 1.e-7


def _upstream_column_fluxes(grid: Grid, utot, vtot, dp_k, temp_k, saln_k,
                            p_bot):
    """'uc' column fluxes: the residual barotropic transport spread over
    layers in proportion to the upstream column's thickness profile
    (mod_pbcor.F90:167-238)."""
    im1, jm1 = grid.im1, grid.jm1
    pb_safe = torch.clamp(p_bot, min=epsilp)
    frac_w = im1(dp_k) / torch.clamp(im1(pb_safe), min=epsilp)
    frac_c = dp_k / pb_safe
    upos = utot > 0.
    uflux = torch.where(upos, utot * frac_w, utot * frac_c) * grid.iu
    uflux2 = uflux * torch.where(upos, im1(saln_k), saln_k)
    uflux3 = uflux * torch.where(upos, im1(temp_k), temp_k)

    frac_s = jm1(dp_k) / torch.clamp(jm1(pb_safe), min=epsilp)
    vpos = vtot > 0.
    vflux = torch.where(vpos, vtot * frac_s, vtot * frac_c) * grid.iv
    vflux2 = vflux * torch.where(vpos, jm1(saln_k), saln_k)
    vflux3 = vflux * torch.where(vpos, jm1(temp_k), temp_k)
    return uflux, uflux2, uflux3, vflux, vflux2, vflux3


def _div(grid: Grid, uf, vf):
    """Flux divergence ip1(uf) - uf + jp1(vf) - vf."""
    return grid.ip1(uf) - uf + grid.jp1(vf, 'v', True) - vf


def pbcor1(grid: Grid, s: State, m: int, n: int, dlt) -> State:
    """Pre-barotropic thickness correction (mod_pbcor.F90:66-414)."""
    ip, iu, iv = grid.ip, grid.iu, grid.iv

    p = cumulative_p(s.dp[n]) * ip
    p_bot = p[grid.kk]

    utot = (dlt * s.ubflxs_p[m] - torch.sum(s.uflx[m], 0)) * iu
    vtot = (dlt * s.vbflxs_p[m] - torch.sum(s.vflx[m], 0)) * iv

    uflux, uflux2, uflux3, vflux, vflux2, vflux3 = _upstream_column_fluxes(
        grid, utot, vtot, s.dp[n], s.temp[n], s.saln[n], p_bot)
    upos, vpos = (utot > 0.)[None], (vtot > 0.)[None]
    uflxtr = uflux[None] * torch.where(upos, grid.im1(s.trc[n]), s.trc[n])
    vflxtr = vflux[None] * torch.where(vpos, grid.jm1(s.trc[n]), s.trc[n])

    dpo = s.dp[n]
    dp_new = torch.clamp(dpo - _div(grid, uflux, vflux) * grid.scp2i,
                         min=0.) * ip
    dpo_e = dpo + dpeps1
    dpni = 1. / (dp_new + dpeps1)
    saln_new = (dpo_e * s.saln[n]
                - _div(grid, uflux2, vflux2) * grid.scp2i) * dpni * ip
    temp_new = (dpo_e * s.temp[n]
                - _div(grid, uflux3, vflux3) * grid.scp2i) * dpni * ip
    trc_new = (dpo_e[None] * s.trc[n]
               - _div(grid, uflxtr, vflxtr) * grid.scp2i) * dpni[None] * ip
    dp_new = torch.where(dp_new < dpeps2, torch.zeros_like(dp_new), dp_new)

    # rescale column to the predicted bottom pressure (mod_pbcor.F90:376-400)
    pbot_new = torch.sum(dp_new, 0)
    pbfac = s.pb_p / torch.clamp(pbot_new, min=epsilp)
    dp_new = dp_new * pbfac * ip

    s.dp[n] = dp_new
    s.temp[n] = temp_new
    s.saln[n] = saln_new
    s.trc[n] = trc_new
    s.uflx[m] += uflux
    s.vflx[m] += vflux
    s.usflx[m] += uflux2
    s.utflx[m] += uflux3
    s.vsflx[m] += vflux2
    s.vtflx[m] += vflux3
    return s


def pbcor2(grid: Grid, e: eos.EosParams, s: State, m: int, n: int,
           dlt) -> State:
    """Post-barotropic thickness correction (mod_pbcor.F90:416-759)."""
    ip, iu, iv = grid.ip, grid.iu, grid.iv

    dp_m = (torch.clamp(s.dp[m], min=0.) + epsilp) * ip
    p = cumulative_p(dp_m) * ip
    p_bot = p[grid.kk]

    utot = (dlt * s.ubflxs[n] - torch.sum(s.uflx[n], 0)) * iu
    vtot = (dlt * s.vbflxs[n] - torch.sum(s.vflx[n], 0)) * iv

    uflux, uflux2, uflux3, vflux, vflux2, vflux3 = _upstream_column_fluxes(
        grid, utot, vtot, dp_m, s.temp[m], s.saln[m], p_bot)
    upos, vpos = (utot > 0.)[None], (vtot > 0.)[None]
    uflxtr = uflux[None] * torch.where(upos, grid.im1(s.trc[m]), s.trc[m])
    vflxtr = vflux[None] * torch.where(vpos, grid.jm1(s.trc[m]), s.trc[m])

    dpo = dp_m
    dp_new = dpo - grid.scp2i * _div(grid, uflux, vflux)
    dpni = ip / torch.clamp(dp_new, min=epsilp * .5)
    saln_new = (dpo * s.saln[m]
                - grid.scp2i * _div(grid, uflux2, vflux2)) * dpni
    temp_new = (dpo * s.temp[m]
                - grid.scp2i * _div(grid, uflux3, vflux3)) * dpni
    trc_new = (dpo[None] * s.trc[m]
               - grid.scp2i * _div(grid, uflxtr, vflxtr)) * dpni[None]
    sigma_new = eos.sig(e, temp_new, saln_new) * ip
    dp_new = dp_new - epsilp
    dp_new = torch.where(dp_new < dpeps2, torch.zeros_like(dp_new),
                         dp_new) * ip

    # rescale column to the barotropic bottom pressure (mod_pbcor.F90:716-741)
    pbot_new = torch.sum(dp_new, 0)
    pbfac = s.pb[m] / torch.clamp(pbot_new, min=epsilp)
    dp_new = dp_new * pbfac * ip

    s.dp[m] = dp_new
    s.temp[m] = temp_new
    s.saln[m] = saln_new
    s.trc[m] = trc_new
    s.sigma[m] = sigma_new
    s.p = cumulative_p(dp_new) * ip
    s.uflx[n] += uflux
    s.vflx[n] += vflux
    s.usflx[n] += uflux2
    s.utflx[n] += uflux3
    s.vsflx[n] += vflux2
    s.vtflx[n] += vflux3
    return s
