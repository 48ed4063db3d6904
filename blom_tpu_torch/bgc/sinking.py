"""Particle sinking of detritus, calcite, opal and dust.

Counterpart of `blom_tpu/bgc/sinking.py` (BLOM's
hamocc/mo_vertical_fluxes.F90 sinking and get_ws), base configuration.
The per-column implicit-upstream update with a running donor layer is a
Python loop over k carrying (donor concentration, donor speed) for the
four sinking tracers; the per-column mass normalization (tco/tcn) and
the sediment-bypass redistribution of the bottom fluxes are column sums.

Layers thinner than dp_min_sink take the donor concentration and do not
advance the donor (mo_vertical_fluxes.F90:196-210); the bottom flux
leaves from the last thick layer at that layer's sinking speed.  The
carbon-isotope pools sink as `extra` rows beside the four base sinkers,
each at the speed of its class.
"""

from __future__ import annotations

import torch

from ..ops.reduce import ksum as ksum_k
from .params import BgcParams, BgcTracers as T

SINKERS = (T.det, T.calc, T.opal, T.fdust)
SPEED_CLASS = {'poc': 0, 'cal': 1, 'opal': 2, 'dust': 3}


def sink_speeds(ptiestu, dtb, p: BgcParams):
    """Sinking speeds [m/timestep] at layer centres (get_ws,
    mo_vertical_fluxes.F90:47-75; WLIN branch = depth-linear POC),
    (4, K, J, I) in the order of SINKERS."""
    if p.use_wlin:
        wpoc = torch.clamp_max(p.wmin + p.wlin * ptiestu, p.wmax) * dtb
    else:
        wpoc = torch.full_like(ptiestu, p.wpoc_const) * dtb
    wcal = torch.full_like(ptiestu, p.wcal_const) * dtb
    wopal = torch.full_like(ptiestu, p.wopal_const) * dtb
    wdust = torch.full_like(ptiestu, p.wdust_const) * dtb
    return torch.stack([wpoc, wcal, wopal, wdust])


def _ksum(a):
    """Column sum over axis 1 of (N, K, J, I), chained in ascending k
    (blom_tpu's own fixed-order sum in sinking, not ops.reduce.ksum's
    axis-0 form)."""
    col = a[:, 0]
    for k in range(1, a.shape[1]):
        col = col + a[:, k]
    return col


def sinking(oc, dz, ptiestu, omask, dtb, p: BgcParams, extra=()):
    """Advance sinking for one timestep.  Returns (oc, fluxes): fluxes
    holds prorca/prcaca/silpro/produs [kmol m-2/timestep] (zero where
    sedbypass redistributes them over the column) and the bottom carbon,
    calcite and opal fluxes.

    extra: (tracer index, speed class, flux name, redistribution index)
    of further sinkers riding the base speeds, the carbon isotopes
    det13/det14 (poc speed) and calc13/calc14 (cal speed)
    (mo_vertical_fluxes.F90:208-217); their bottom fluxes go into the
    fluxes under their names.  Under sedbypass each returns to the water
    column at its redistribution index (:496-526: the organic isotopes
    stay detritus, the shell isotopes remineralize to the DIC isotopes;
    the 14C flux is pror14, where BLOM's flor14 line reads pror13)."""
    oc = oc.clone()
    cls = list(range(len(SINKERS))) + [SPEED_CLASS[e[1]] for e in extra]
    idxs = tuple(SINKERS) + tuple(e[0] for e in extra)
    w = sink_speeds(ptiestu, dtb, p)[cls]         # (N, K, J, I)
    conc = oc[list(idxs)]                         # (N, K, J, I)
    thick = dz > p.dp_min_sink                    # (K, J, I)
    wet = dz > p.dp_min

    # surface layer: no inflow; the WLIN outflow speed clamps to wmin
    # (mo_vertical_fluxes.F90:146-159), in every poc-class row
    if p.use_wlin:
        for i, c in enumerate(cls):
            if c == SPEED_CLASS['poc']:
                w[i, 0] = p.wmin * dtb

    tco = _ksum(torch.where(wet[None], conc * dz[None], 0.))

    dconc = torch.zeros_like(conc[:, 0])          # donor conc/speed (N,J,I)
    dw = torch.zeros_like(conc[:, 0])
    new = []
    for k in range(dz.shape[0]):
        ck, dzk, wk, thickk, wetk = conc[:, k], dz[k], w[:, k], thick[k], \
            wet[k]
        dzs = torch.clamp_min(dzk, 1.e-12)
        # blom_tpu pins these two products apart (an optimization
        # barrier); PyTorch does not contract them either
        new_thick = (ck * dzk + dconc * dw) / (dzs + wk)
        nk = torch.where(thickk[None], new_thick,
                         torch.where(wetk[None], dconc, ck))
        dconc = torch.where(thickk[None], nk, dconc)
        dw = torch.where(thickk[None], wk, dw)
        new.append(nk)
    new_conc = torch.stack(new, 1)                # (N, K, J, I)

    bot = dconc * dw                              # bottom flux per tracer
    tcn = _ksum(torch.where(wet[None], new_conc * dz[None], 0.)) + bot
    q = torch.where((tco > 1.e-12) & (tcn > 1.e-12), tco / tcn, 1.)
    new_conc = torch.where(wet[None], new_conc * q[:, None], new_conc)
    bot = bot * q

    bot = bot * omask[None]
    prorca, prcaca, silpro, produs = bot[:4]
    xbot = {e[2]: bot[4 + i] for i, e in enumerate(extra)}

    for i, idx in enumerate(idxs):
        oc[idx] = torch.where(omask > 0.5, new_conc[i], oc[idx])

    if p.sedbypass:
        # redistribute bottom fluxes over the column; opal and CaCO3
        # remineralize instantaneously (mo_vertical_fluxes.F90:472-534)
        colz = torch.clamp_min(ksum_k(torch.where(wet, dz, 0.), axis=0),
                               1.e-12)
        florca = torch.where(wet, (prorca / colz)[None], 0.)
        flcaca = torch.where(wet, (prcaca / colz)[None], 0.)
        flsil = torch.where(wet, (silpro / colz)[None], 0.)
        oc[T.det] = oc[T.det] + florca
        oc[T.alkali] = oc[T.alkali] + 2. * flcaca
        oc[T.sco212] = oc[T.sco212] + flcaca
        oc[T.silica] = oc[T.silica] + flsil
        z = torch.zeros_like(prorca)
        for i, e in enumerate(extra):
            oc[e[3]] = oc[e[3]] + torch.where(
                wet, (bot[4 + i] / colz)[None], 0.)
            xbot[e[2]] = z
        flx = {'prorca': z, 'prcaca': z, 'silpro': z, 'produs': produs,
               'carflx_bot': prorca * p.rcar, 'calflx_bot': prcaca,
               'bsiflx_bot': silpro}
    else:
        flx = {'prorca': prorca, 'prcaca': prcaca, 'silpro': silpro,
               'produs': produs, 'carflx_bot': prorca * p.rcar,
               'calflx_bot': prcaca, 'bsiflx_bot': silpro}
    flx.update(xbot)
    return oc, flx
