"""BGC step orchestration and the BLOM<->BGC interface.

Counterpart of `blom_tpu/bgc/step.py` (BLOM's hamocc/mo_hamocc_step.F90
hamocc_step -> mo_hamocc4bcm.F90 hamocc4bcm, mo_intfcblom.F90
blom2hamocc / hamocc2blom, mo_vgrid.F90 set_vgrid, mo_trc_limitc.F90),
base path.

The model state carries the BGC tracers in BLOM's per-mass units inside
the generic trc block; each BGC step converts them to concentrations
[kmol/m3] with the in-situ density (bgc_rho, mo_intfcblom.F90:81-116),
runs the process chain on dense (K, J, I) tensors and converts back, so
`ocetra * dz == trc * dp/onem` and the model's mass advection conserves
the BGC inventories.  The hydrogen-ion slot `hi` is no concentration and
is carried through unscaled.

Process order (mo_hamocc4bcm.F90:229-346): dust deposition -> ocprod ->
sinking -> limitc -> cyano -> carchm, the sediment bypassed; with the
carbon isotopes (ti, cp) their chain (ciso.py) runs beside the base
processes, and `hamocc_step_with_sediment` runs the sediment (sediment.py)
after the step.  Nothing here reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core import eos
from ..core.constants import onem, rho0
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from . import carchm as carchm_mod
from . import chemistry as chem
from . import processes, sinking as sinking_mod
from .params import NBGC, BgcParams, BgcTracers as T


class BgcForcing(NamedTuple):
    """Surface fields the BGC needs beyond the physics forcing
    (arguments of hamocc4bcm, mo_hamocc4bcm.F90:28-60)."""
    swr: torch.Tensor      # surface shortwave [W m-2] (strahl)
    fu10: torch.Tensor     # 10-m wind speed [m s-1] (pfu10)
    slp: torch.Tensor      # sea-level pressure [Pa] (ppao)
    fice: torch.Tensor     # sea-ice fraction (psicomo)
    dustdep: torch.Tensor  # dust deposition [kg m-2/step] (dust input)


def zero_bgc_forcing(shape, dtype=torch.float64, device='cpu', swr=50.,
                     fu10=5., slp=101325.) -> BgcForcing:
    """Uniform shortwave, wind and pressure; no sea ice, no dust."""
    H = tuple(shape)

    def f(v):
        return torch.full(H, v, dtype=dtype, device=device)
    return BgcForcing(swr=f(swr), fu10=f(fu10), slp=f(slp), fice=f(0.),
                      dustdep=f(0.))


def init_bgc_tracers(s: State, itrbgc: int, e: eos.EosParams,
                     n: int = 0, ti=None, cp=None) -> State:
    """Initial BGC tracer values on wet layers (BLOM's constant
    fallbacks, mo_ini_fields.F90:196-236, and uniform nutrient levels in
    per-mass units), at both time levels; `n` is the level whose
    thickness says which layers are wet.  With ti/cp the carbon-isotope
    pools are set from them at the preindustrial atmospheric ratio and
    the biogenic fractionation (mo_ini_fields.F90:166-200; the ratios
    hold per mass as per volume, so ciso.init_ciso_tracers applies to
    the per-mass block), level by level."""
    trc = s.trc.clone()
    wet = (s.dp[n] > 0.).to(trc.dtype)
    for idx, val in ((T.sco212, 2.27e-3), (T.alkali, 2.37e-3),
                     (T.phosph, 2.17e-6), (T.oxygen, 2.2e-4),
                     (T.ano3, 31.e-6), (T.silica, 90.e-6),
                     (T.gasnit, 1.e-10), (T.doc, 1.e-8), (T.phy, 1.e-8),
                     (T.zoo, 1.e-8), (T.det, 1.e-8), (T.calc, 0.),
                     (T.opal, 1.e-8), (T.an2o, 0.), (T.dms, 0.),
                     (T.fdust, 0.), (T.iron, 0.6e-9), (T.dicsat, 1.e-8),
                     (T.hi, 1.e-8)):
        trc[:, itrbgc + idx] = val * wet
    if ti is not None and cp is not None:
        from . import ciso as ciso_mod
        blk = slice(itrbgc, itrbgc + ti.ntotal)
        for lev in range(trc.shape[0]):
            trc[lev, blk] = ciso_mod.init_ciso_tracers(trc[lev, blk], ti,
                                                       cp, BgcParams())
    return dataclasses.replace(s, trc=trc)


def _vgrid(dz, dp_min_sink, dp_ez):
    """Derived vertical-grid fields (set_vgrid, mo_vgrid.F90:80-200):
    layer-centre depths, euphotic mask, bottom-layer index."""
    ptiestw = torch.cat([torch.zeros_like(dz[:1]), torch.cumsum(dz, 0)], 0)
    ptiestu = ptiestw[:-1] + 0.5 * dz
    euph = ptiestw[:-1] < dp_ez
    kidx = torch.arange(dz.shape[0], dtype=torch.int32,
                        device=dz.device)[:, None, None]
    kbo = torch.where(dz > dp_min_sink, kidx, 0).amax(0)
    return ptiestu, euph, kbo


def hamocc_step(grid: Grid, e: eos.EosParams, par: BgcParams,
                s: State, f: BgcForcing, itrbgc: int, n: int, nn: int,
                dtsec: float, kmle: Optional[torch.Tensor] = None,
                ti=None, cp=None):
    """One BGC step on time level n (hamocc_step,
    mo_hamocc_step.F90:27-105), updating s.trc in place.  nn is unused
    (kept for blom_tpu's signature).  Returns (s, diags).

    ti/cp: the extended tracer index and the carbon-isotope parameters;
    with both the block is ti.ntotal wide and the isotope chain
    (ciso.py, BLOM's use_cisonew) runs beside the base processes."""
    ciso = ti is not None and cp is not None
    dp = s.dp[n]
    temp = s.temp[n]
    saln = s.saln[n]

    # blom2hamocc (mo_intfcblom.F90:81-136): in-situ density and
    # geometric layer thickness
    p_i = cumulative_p(dp)
    pmid = p_i[:-1] + 0.5 * dp
    bgc_rho = eos.rho(pmid, temp, saln) / rho0      # [g/cm3]
    omask = grid.ip
    lyr = (dp > par.dp_min * onem) & (omask > 0.5)
    dz = torch.where(lyr, dp / (onem * bgc_rho), 0.)   # [m]

    blk = slice(itrbgc, itrbgc + (ti.ntotal if ti is not None else NBGC))
    oc = s.trc[n, blk] * bgc_rho[None]
    oc[T.hi] = s.trc[n, itrbgc + T.hi]               # hi is no conc.

    ptiestu, euph, _ = _vgrid(dz, par.dp_min_sink, par.dp_ez)
    euph = euph & lyr
    if kmle is None:
        kmle = torch.full(grid.shape, 1, dtype=torch.int32,
                          device=dp.device)          # kmle_static = 2

    dtb = dtsec / 86400.

    # dust / iron deposition (mo_apply_fedep.F90: the surface layer gets
    # dust [kg] -> fdust [kg/m3] and soluble iron, 3.5 % Fe, 1 % soluble)
    dz0 = torch.clamp_min(dz[0], 1.e-12)
    wet0 = lyr[0]
    oc[T.fdust, 0] = oc[T.fdust, 0] + torch.where(
        wet0, f.dustdep / dz0, 0.)
    oc[T.iron, 0] = oc[T.iron, 0] + torch.where(
        wet0, f.dustdep * 0.035 * 0.01 / 55.85 / dz0, 0.)

    satoxy = chem.sat_oxygen(temp, saln)
    if ciso:
        from . import ciso as ciso_mod
        # co2star for the Laws-1997 fractionation, from the persistent pH
        # tracer (the previous step's carbonate solve)
        tcl = torch.clamp(temp, chem.TEMP_MIN, chem.TEMP_MAX)
        scl = torch.clamp(saln, chem.SALN_MIN, chem.SALN_MAX)
        keq = chem.kequi(tcl, scl, ptiestu * 98060. * 1.027e-6)
        co2star = ciso_mod.co2star_from_hi(oc, bgc_rho, keq)
        # ocprod and ocprod_ciso each work on a copy: oc stays the
        # pre-production state both read
        oc_pre = oc
        oc, prod_diags, prod_flx = processes.ocprod(
            oc, temp, dz, f.swr, satoxy, lyr, dtb, par, return_fluxes=True)
        oc_iso = ciso_mod.ocprod_ciso(oc_pre, ti, prod_flx, co2star, lyr,
                                      dtb, par, cp)
        iso_rows = [getattr(ti, nm) for nm in ciso_mod.CISO_NAMES]
        oc[iso_rows] = oc_iso[iso_rows]
        extra = ciso_mod.extra_sinkers(ti)
    else:
        oc, prod_diags = processes.ocprod(oc, temp, dz, f.swr, satoxy,
                                          lyr, dtb, par)
        extra = ()
    oc, bot_flx = sinking_mod.sinking(oc, dz, ptiestu, omask, dtb, par,
                                      extra=extra)

    # trc_limitc (mo_trc_limitc.F90): clip small negatives on organics
    organics = [T.phy, T.zoo, T.det, T.doc, T.calc, T.opal, T.dms]
    if ciso:
        organics += [ti.phy13, ti.phy14, ti.zoo13, ti.zoo14, ti.det13,
                     ti.det14, ti.doc13, ti.doc14, ti.calc13, ti.calc14]
    for idx in organics:
        oc[idx] = torch.clamp_min(oc[idx], 0.)

    oc, intnfix = processes.cyano(oc, temp, dz, euph, dtb, par)
    oc, satoxy, carb_diags = carchm_mod.carchm(
        oc, temp, saln, bgc_rho, dz, ptiestu, lyr, kmle,
        f.swr, f.fu10, f.slp, f.fice, dtsec, par, ti=ti, cp=cp)

    # hamocc2blom (mo_intfcblom.F90:396-470): back to per-mass units
    trc_new = oc / bgc_rho[None]
    trc_new[T.hi] = oc[T.hi]
    s.trc[n, blk] = torch.where(lyr[None], trc_new, s.trc[n, blk])

    diags = dict(prod_diags)
    diags.update(bot_flx)
    diags.update(carb_diags)
    diags['intnfix'] = intnfix
    return s, diags


def hamocc_step_with_sediment(grid: Grid, e: eos.EosParams,
                              par: BgcParams, s: State, f: BgcForcing,
                              sed, itrbgc: int, n: int, nn: int,
                              dtsec: float,
                              kmle: Optional[torch.Tensor] = None):
    """hamocc_step followed by the sediment (the use_sedbypass=False
    path of mo_hamocc4bcm.F90:355-402: powach with dipowa, then sedshi),
    updating s.trc in place.  The sediment state `sed` (a
    sediment.SedState) is carried beside the ocean state; the bottom
    particle fluxes feed it instead of being redistributed over the
    column.  Returns (s, sed, diags)."""
    from . import sediment as sd

    par_nosb = par._replace(sedbypass=False)
    s, diags = hamocc_step(grid, e, par_nosb, s, f, itrbgc, n, nn, dtsec,
                           kmle)

    dp = s.dp[n]
    temp = s.temp[n]
    saln = s.saln[n]
    p_i = cumulative_p(dp)
    pmid = p_i[:-1] + 0.5 * dp
    rho = eos.rho(pmid, temp, saln) / rho0
    lyr = (dp > par.dp_min * onem) & (grid.ip > 0.5)
    dz = torch.where(lyr, dp / (onem * rho), 0.)
    _, _, kbo = _vgrid(dz, par.dp_min_sink, par.dp_ez)
    kk = dp.shape[0]
    kbo_onehot = (torch.arange(kk, device=dp.device)[:, None, None]
                  == kbo[None]).to(dp.dtype)
    bolay = torch.clamp_min((dz * kbo_onehot).sum(0), 1.e-3)
    saln_bot = (saln * kbo_onehot).sum(0)
    temp_bot = (temp * kbo_onehot).sum(0)
    rrho_bot = (rho * kbo_onehot).sum(0)
    pbot_bar = (pmid * kbo_onehot).sum(0) * 98060. * 1.027e-6 / onem
    keq = chem.kequi(temp_bot, saln_bot, pbot_bar)

    blk = slice(itrbgc, itrbgc + NBGC)
    oc = s.trc[n, blk] * rho[None]
    oc[T.hi] = s.trc[n, itrbgc + T.hi]

    flx = {k: diags[k] for k in ('prorca', 'prcaca', 'silpro', 'produs')}
    sed, oc = sd.powach(sed, oc, flx, keq, bolay, kbo_onehot, grid.ip,
                        saln_bot, rrho_bot, dtsec, par)
    sed = sd.sedshi(sed, grid.ip)

    trc_new = oc / rho[None]
    trc_new[T.hi] = oc[T.hi]
    s.trc[n, blk] = torch.where(lyr[None], trc_new, s.trc[n, blk])
    return s, sed, diags
