"""External BGC inputs and auxiliary tracers: river loads, nitrogen
deposition, box atmosphere, preformed tracers.

Counterpart of `blom_tpu/bgc/inputs.py` (BLOM's
hamocc/mo_apply_rivin.F90 base path, mo_apply_ndep.F90, mo_boxatm.F90
update_boxatm, mo_preftrc.F90).  Input climatologies arrive as tensors
already on the model grid.  No step calls these yet; each returns a new
concentration block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.reduce import ksum
from .chemistry import _over
from .params import BgcParams, BgcTracers as T


class RiverFields:
    """River input field indices (mo_param1_bgc.F90:196-205,550-557)."""
    rdin = 0    # dissolved inorganic nitrogen [kmol m-2 yr-1]
    rdip = 1    # dissolved inorganic phosphorus
    rsi = 2     # dissolved silicate
    ralk = 3    # alkalinity
    riron = 4   # dissolved iron
    rdoc = 5    # dissolved organic carbon
    rdet = 6    # particulate carbon


NRIV = 7
DFE_FRAC = 0.01   # bioavailable fraction of riverine iron


def apply_rivin(oc, rivin, dz, kmle_mask, dtb, p: BgcParams):
    """Distribute river loads over the mixed layer
    (apply_rivin, mo_apply_rivin.F90:30-160 base path).

    rivin: (NRIV, J, I) [kmol m-2 yr-1]; kmle_mask: (K, J, I) 1 within
    the mixed layer."""
    oc = oc.clone()
    fdt = dtb / 365.
    volij = torch.clamp_min(ksum(dz * kmle_mask, axis=0), 1.e-12)
    q = kmle_mask * _over(fdt, volij)[None]    # (K, J, I) per-volume

    def add(idx, field):
        oc[idx] = oc[idx] + q * field[None]

    add(T.ano3, rivin[RiverFields.rdin])
    add(T.phosph, rivin[RiverFields.rdip])
    add(T.silica, rivin[RiverFields.rsi])
    add(T.iron, rivin[RiverFields.riron] * DFE_FRAC)
    add(T.alkali, rivin[RiverFields.ralk])
    # without the terrestrial-DOC tracers, riverine organic carbon
    # enters the marine DOC/detritus pools (P units via rcar), and the
    # associated carbonate enters DIC (mo_apply_rivin.F90:150-156)
    add(T.doc, rivin[RiverFields.rdoc] / p.rcar)
    add(T.det, rivin[RiverFields.rdet] / p.rcar)
    add(T.sco212, rivin[RiverFields.ralk])
    return oc


def apply_ndep(oc, ndep_noy, dz, lyr0, dtb):
    """Surface NOy deposition: +NO3, -alkalinity
    (apply_ndep, mo_apply_ndep.F90)."""
    oc = oc.clone()
    flx = ndep_noy * dtb / 365.
    dz0 = torch.clamp_min(dz[0], 1.e-12)
    upd = torch.where(lyr0, flx / dz0, 0.)
    oc[T.ano3, 0] = oc[T.ano3, 0] + upd
    oc[T.alkali, 0] = oc[T.alkali, 0] + (-upd)
    return oc


def update_boxatm(atm_co2_ppm, co2flux, scp2, mask):
    """Prognostic one-box atmosphere CO2 update from the global
    air-sea flux (update_boxatm, mo_boxatm.F90:25-90): the area-summed
    flux [kmol C] converts to ppm via 12 g/mol and 2.13 PgC/ppm."""
    pg2ppm = 1. / 2.13
    total = torch.sum(co2flux * scp2 * mask)      # [kmol C], + to atm
    return atm_co2_ppm + total * 12. * 1.e-12 * pg2ppm


class PrefTracers(NamedTuple):
    """Indices of the preformed tracers within the (extended) BGC
    block (mo_param1_bgc.F90 i_pref block)."""
    prefo2: int = 19
    prefpo4: int = 20
    prefsilica: int = 21
    prefalk: int = 22
    prefdic: int = 23


NBGC_PREF = 24   # base block (19) + 5 preformed tracers


def preftrc(oc, kmle_mask, idx: PrefTracers = PrefTracers()):
    """Reset preformed tracers to their source values within the mixed
    layer (preftrc, mo_preftrc.F90:25-45); below it they advect as
    passive tracers, keeping the surface-origin signal."""
    oc = oc.clone()
    pairs = ((idx.prefo2, T.oxygen), (idx.prefpo4, T.phosph),
             (idx.prefsilica, T.silica), (idx.prefalk, T.alkali),
             (idx.prefdic, T.sco212))
    for pidx, src in pairs:
        oc[pidx] = torch.where(kmle_mask > 0., oc[src], oc[pidx])
    return oc
