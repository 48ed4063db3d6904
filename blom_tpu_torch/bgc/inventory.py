"""Global BGC inventory: the conservation audit.

Counterpart of `blom_tpu/bgc/inventory.py` (BLOM's
hamocc/mo_inventory_bgc.F90:28-512 inventory_bgc): volume-integrated
totals and mean concentrations of every ocean tracer, the pore-water,
sediment and burial totals when the sediment runs, and the element
budgets (C, P, Si, N, O2, alkalinity) of BLOM's use_PBGC_OCNP_TIMESTEP
per-process audit (extN_inv_check, mo_extNwatercol.F90:457-474).  The
sums are parallel/repsum.py's fixed-order f64 strip sums.
"""

from __future__ import annotations

import torch

from ..parallel.repsum import repsum_2d, repsum_3d
from .params import TRACER_NAMES, BgcParams, BgcTracers as T


def inventory_bgc(oc, dz, area, omask, p: BgcParams, ti=None, sed=None,
                  atm_co2_ppm=None, names=None):
    """The BGC inventory (inventory_bgc, mo_inventory_bgc.F90:28-460).

    oc: (ntr, K, J, I) concentrations [kmol/m3]; dz: (K, J, I) layer
    thickness [m]; area: (J, I) cell areas [m2]; ti: the extended tracer
    index (params.make_tracer_index), if any; sed: a sediment.SedState,
    if the sediment runs; atm_co2_ppm: the global-mean atmospheric CO2
    folded into the total carbon (ppm2con = 0.35e-3 kmol/m2/ppm,
    mo_inventory_bgc.F90:82-84).

    Returns a dict of 0-d f64 tensors: per-tracer totals
    ('total_<name>') and mean concentrations ('mean_<name>'), the ocean
    volume and area, the ODZ volume and the element aggregates."""
    f64 = torch.float64
    w = (dz * area[None] * omask[None]).to(f64)     # cell volumes
    ztotvol = repsum_3d(w)
    ztotarea = repsum_2d((area * omask * (dz[0] > 0)).to(f64))

    ntr = oc.shape[0]
    if names is None:
        names = ti.names if ti is not None else TRACER_NAMES
        if len(names) < ntr:
            names = list(names) + [f'trc{i}' for i in
                                   range(len(names), ntr)]
    tot = repsum_3d(oc.to(f64) * w[None])           # (ntr,)

    inv = {'totvol': ztotvol, 'totarea': ztotarea}
    for i in range(ntr):
        inv[f'total_{names[i]}'] = tot[i]
        inv[f'mean_{names[i]}'] = tot[i] / ztotvol

    def t(idx):
        return tot[idx]

    # ODZ volume, O2 below 20 umol/m3 (mo_inventory_bgc.F90:102)
    inv['odz_volume'] = repsum_3d(torch.where(oc[T.oxygen] < 20.e-6, w, 0.))

    # element aggregates (mo_inventory_bgc.F90:405-460)
    organic = t(T.det) + t(T.doc) + t(T.phy) + t(T.zoo)
    totalcarbon = organic * p.rcar + t(T.sco212) + t(T.calc)
    totalphos = organic + t(T.phosph)
    totalsil = t(T.silica) + t(T.opal)
    totalnitr = (organic * p.rnit + t(T.ano3) + t(T.gasnit) * 2.
                 + t(T.an2o) * 2.)
    totaloxy = (t(T.oxygen) + t(T.an2o) * 0.5
                - organic * p.ro2ut + t(T.sco212) + t(T.calc))
    totalalk = t(T.alkali)
    if ti is not None and hasattr(ti, 'anh4'):
        totalnitr = totalnitr + t(ti.anh4) + t(ti.ano2)
    if ti is not None and hasattr(ti, 'bromo'):
        inv['total_bromoform'] = t(ti.bromo)

    if sed is not None:
        # pore water, solid sediment and burial (mo_inventory_bgc.F90:
        # 130-198,405-412); the sediment volumes are the fixed
        # porosity-weighted layer thicknesses, in the state's dtype
        from .sediment import (SEDDW, PORWAT, PORSOL, SedPow, SedSolid,
                               layer_tensor)
        aw = (area * omask)[None]
        pw = (layer_tensor(SEDDW * PORWAT, area) * aw).to(f64)
        ps = (layer_tensor(SEDDW * PORSOL, area) * aw).to(f64)
        powtot = repsum_3d(sed.powtra.to(f64) * pw[None])
        sedtot = repsum_3d(sed.sedlay.to(f64) * ps[None])
        burtot = repsum_2d(sed.burial.to(f64) * aw)
        inv['total_powtra'] = powtot
        inv['total_sedlay'] = sedtot
        inv['total_burial'] = burtot
        totalcarbon = (totalcarbon + powtot[SedPow.aic]
                       + sedtot[SedSolid.ssc12]
                       + (sedtot[SedSolid.sso12]
                          + burtot[SedSolid.sso12]) * p.rcar
                       + burtot[SedSolid.ssc12])
        totalphos = (totalphos + powtot[SedPow.aph]
                     + sedtot[SedSolid.sso12]
                     + burtot[SedSolid.sso12])
        totalsil = (totalsil + powtot[SedPow.asi]
                    + sedtot[SedSolid.sssil] + burtot[SedSolid.sssil])

    if atm_co2_ppm is not None:
        ppm2con = 0.35e-3
        totalcarbon = totalcarbon + atm_co2_ppm * ppm2con * ztotarea

    inv['totalcarbon'] = totalcarbon
    inv['totalphos'] = totalphos
    inv['totalsil'] = totalsil
    inv['totalnitr'] = totalnitr
    inv['totaloxy'] = totaloxy
    inv['totalalk'] = totalalk
    return inv


def inventory_deltas(inv0: dict, inv1: dict, keys=('totalcarbon',
                     'totalphos', 'totalsil', 'totalnitr',
                     'totalalk')):
    """Relative drift of the element aggregates between two inventories
    (the printed audit of extN_inv_check / use_PBGC_OCNP_TIMESTEP), as
    Python floats."""
    out = {}
    for k in keys:
        a, b = inv0[k], inv1[k]
        out[k] = float((b - a) / torch.clamp_min(torch.abs(a), 1.e-30))
    return out
