"""Optional iHAMOCC subsystems: the extended N cycle, bromoform, natural
DIC and the shelf-sea residence time.

Counterpart of `blom_tpu/bgc/extensions.py` (BLOM's compile-flag
extensions):

- the extended nitrogen cycle (use_extNcycle): nitrification
  (NH4 -> NO2 -> NO3 with dark carbon fixation and O2-dependent N2O
  branching), denitrification / dissimilatory NO3 reduction, anammox and
  the combined NO2 denitrification + DNRA step
  (hamocc/mo_extNwatercol.F90:83-474, defaults mo_param_bgc.F90:371-427,
  765-767);
- bromoform (use_BROMO): production tied to primary production with an
  opal dependence, UV photolysis, hydrolysis and halide substitution,
  air-sea exchange (mo_ocprod.F90:548-563, mo_carchm.F90:295,360-388,
  421,547-548,612-626, mo_param_bgc.F90:231,508-513);
- the natural carbon (use_natDIC): the biological tendencies mirrored
  and a parallel carbonate system against a preindustrial atmosphere
  (mo_carchm.F90:245-257,444-451,545,598-604,633-658);
- the shelf-sea water residence time (use_shelfsea_res_time), an
  age-like tracer (mo_shelfsea_restime.F90:36-71).

Every function is elementwise over dense (K, J, I) tensors and works on a
copy of its `oc`; `dtb` is the timestep in days.  The extension tracers
sit in slots after the base block (params.make_tracer_index).  Integer
powers are products in blom_tpu's order, a number over a tensor divides
as blom_tpu does (chemistry.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .chemistry import _over
from .params import BgcParams, BgcTracers as T

_EPS = 2.220446049250313e-16


class ExtNParams(NamedTuple):
    """Extended-N-cycle rate constants (mo_param_bgc.F90:371-427; the
    derived constants of :182-196,765-767).  Rates in 1/day."""
    # nitrification on NH4 (:371-382)
    ranh4nitr: float = 0.6
    q10anh4nitr: float = 3.3
    trefanh4nitr: float = 20.
    bkoxamox: float = 0.333e-6
    bkanh4nitr: float = 0.133e-6
    bkamoxn2o: float = 0.1e-6
    n2omaxy: float = 0.003
    n2oybeta: float = 18.
    bkyamox: float = 0.333e-6
    # nitrification on NO2 (:385-390)
    rano2nitr: float = 0.75
    q10ano2nitr: float = 2.7
    trefano2nitr: float = 20.
    bkoxnitr: float = 0.788e-6
    bkano2nitr: float = 0.287e-6
    nob2aoay: float = 0.44
    # denitrification on NO3 (:393-397)
    rano3denit: float = 0.0001
    q10ano3denit: float = 2.
    trefano3denit: float = 10.
    sc_ano3denit: float = 0.12e6
    bkano3denit: float = 5.e-6
    # anammox (:400-406)
    rano2anmx: float = 0.001
    q10anmx: float = 1.6
    trefanmx: float = 10.
    alphaanmx: float = 0.45e6
    bkoxanmx: float = 11.3e-6
    bkano2anmx: float = 5.e-6
    # denitrification on NO2 (:409-413)
    rano2denit: float = 0.002
    q10ano2denit: float = 2.0
    trefano2denit: float = 10.
    bkoxano2denit: float = 2.e-6
    bkano2denit: float = 5.6e-6
    # DNRA on NO2 (:416-420)
    rdnra: float = 0.0001
    q10dnra: float = 2.
    trefdnra: float = 10.
    bkoxdnra: float = 2.5e-6
    bkdnra: float = 0.05e-6
    # denitrification on N2O (:423-427)
    ran2odenit: float = 0.00035
    q10an2odenit: float = 3.
    trefan2odenit: float = 10.
    bkoxan2odenit: float = 10.e-6
    bkan2odenit: float = 0.1e-6
    # N2O pathway split (derived, :765-767)
    yield_n2o_inf: float = 0.077
    # stoichiometry (:182-196)
    max_limiter: float = 0.9999
    ro2utammo: float = 140.
    rnoxp: float = 280.
    rno2anmx: float = 1144.
    rnh4anmx: float = 880.
    rno2dnra: float = 93. + 1. / 3.

    @property
    def mufn2o(self):
        return 0.11 / (50. * 1.e6 * self.bkoxamox)

    @property
    def bn2o(self):
        return self.yield_n2o_inf / (50. * self.mufn2o)

    @property
    def bkanh4anmx(self):
        return self.bkano2anmx * self.rnh4anmx / self.rno2anmx

    @property
    def rnh4dnra(self):
        return self.rno2dnra + 16.        # rnit of BgcParams' defaults


def _tclip(ptho):
    """merge(ptho, 10, ptho < 40) of BLOM."""
    return torch.where(ptho < 40., ptho, 10.)


def _q10(q10, temp, tref):
    """q10 ** ((temp - tref) / 10), a number to a tensor power."""
    return torch.pow(q10, (temp - tref) / 10.)


def _o2_hill(o2, bk):
    """bk**2 / (o2**2 + bk**2), the O2 inhibition of the NO2 and N2O
    reductions."""
    return _over(bk ** 2, o2 * o2 + bk ** 2)


def nitrification(oc, ti, ptho, wet, dtb, p: BgcParams, ep: ExtNParams):
    """NH4 -> NO2 -> NO3 nitrification with dark carbon fixation and
    O2-dependent N2O production (mo_extNwatercol.F90:83-211).

    ti: a tracer index with the base slots and anh4/ano2.  Returns
    (oc, diags)."""
    oc = oc.clone()
    rnoi = 1. / p.rnit
    rc2n = p.rcar / p.rnit
    ro2nnit = ep.ro2utammo / p.rnit
    rnm1 = p.rnit - 1.
    temp = _tclip(ptho)
    o2 = oc[T.oxygen]
    nh4 = oc[ti.anh4].clone()
    no2 = oc[ti.ano2].clone()

    # ammonium oxidation (amox)
    tdep = _q10(ep.q10anh4nitr, temp, ep.trefanh4nitr)
    o2lim = o2 / (o2 + ep.bkoxamox)
    nut1 = nh4 / (nh4 + ep.bkanh4nitr)
    anh4new = nh4 / (1. + ep.ranh4nitr * dtb * tdep * o2lim * nut1)
    potdnh4amox = torch.clamp_min(nh4 - anh4new, 0.)

    # pathway split (Santoro et al. 2021 / Ji et al. 2018 form)
    fn2o = (ep.mufn2o * (ep.bn2o + _over((1. - ep.bn2o) * ep.bkoxamox,
                                          o2 + ep.bkoxamox))
            * nh4 / (nh4 + ep.bkamoxn2o))
    fno2 = o2 / (o2 + ep.bkoxamox)
    fdetamox = (ep.n2omaxy * 2. * (1. + ep.n2oybeta) * o2 * ep.bkyamox
                / (o2 * o2 + 2. * o2 * ep.bkyamox + ep.bkyamox ** 2))
    ftot = fn2o + fno2 + fdetamox + _EPS
    fn2o = fn2o / ftot
    fno2 = fno2 / ftot
    fdetamox = 1. - (fn2o + fno2)

    # NO2 oxidation (nitr)
    tdep2 = _q10(ep.q10ano2nitr, temp, ep.trefano2nitr)
    o2lim2 = o2 / (o2 + ep.bkoxnitr)
    nut2 = no2 / (no2 + ep.bkano2nitr)
    ano2new = no2 / (1. + ep.rano2nitr * dtb * tdep2 * o2lim2 * nut2)
    potdno2nitr = torch.clamp_min(no2 - ano2new, 0.)

    no2fdetamox = ep.nob2aoay * ep.n2omaxy * 2. * (1. + ep.n2oybeta) \
        * o2 * ep.bkyamox \
        / (o2 * o2 + 2. * o2 * ep.bkyamox + ep.bkyamox ** 2)
    # BLOM recomputes no2fn2o/no2fno2 with the formulas of fn2o/fno2
    # before their normalization (mo_extNwatercol.F90:152-160)
    no2fn2o = (ep.mufn2o * (ep.bn2o + _over((1. - ep.bn2o) * ep.bkoxamox,
                                             o2 + ep.bkoxamox))
               * nh4 / (nh4 + ep.bkamoxn2o))
    no2fno2 = o2 / (o2 + ep.bkoxamox)
    fdetnitr = no2fdetamox / (no2fno2 + no2fn2o + _EPS)

    totd = potdnh4amox + potdno2nitr
    amoxfrac = potdnh4amox / (totd + _EPS)
    nitrfrac = 1. - amoxfrac

    ml = ep.max_limiter
    fdet = fdetamox * amoxfrac + fdetnitr * nitrfrac
    lim = torch.minimum(
        ml * o2
        / ((1.5 * fno2 + fn2o - ro2nnit * fdetamox) * amoxfrac
           + (0.5 - ro2nnit * fdetnitr) * nitrfrac + _EPS),
        ml * oc[T.alkali]
        / ((2. * fno2 + fn2o + rnm1 * rnoi * fdetamox) * amoxfrac
           + rnm1 * rnoi * fdetnitr * nitrfrac + _EPS))
    lim = torch.minimum(
        ml * oc[T.iron] / (p.riron * rnoi * fdet + _EPS), lim)
    lim = torch.minimum(ml * oc[T.phosph] / (rnoi * fdet + _EPS), lim)
    lim = torch.minimum(ml * oc[T.sco212] / (rc2n * fdet + _EPS), lim)
    lim = torch.minimum(
        ml * nh4 / (amoxfrac + fdetnitr * nitrfrac + _EPS), lim)
    totd = torch.clamp_min(torch.minimum(totd, lim), 0.)
    amox = torch.where(wet, amoxfrac * totd, 0.)
    nitr = torch.where(wet, nitrfrac * totd, 0.)

    om = rnoi * (fdetamox * amox + fdetnitr * nitr)
    oc[ti.anh4] = oc[ti.anh4] + (-amox - fdetnitr * nitr)
    oc[T.an2o] = oc[T.an2o] + 0.5 * fn2o * amox
    oc[ti.ano2] = oc[ti.ano2] + (fno2 * amox - nitr)
    oc[T.ano3] = oc[T.ano3] + nitr
    oc[T.det] = oc[T.det] + om
    oc[T.sco212] = oc[T.sco212] + -rc2n * (fdetamox * amox
                                           + fdetnitr * nitr)
    oc[T.phosph] = oc[T.phosph] + -om
    oc[T.iron] = oc[T.iron] + -p.riron * om
    oc[T.oxygen] = oc[T.oxygen] + (
        -(1.5 * fno2 + fn2o - ro2nnit * fdetamox) * amox
        - (0.5 - ro2nnit * fdetnitr) * nitr)
    oc[T.alkali] = oc[T.alkali] + (
        -(2. * fno2 + fn2o + rnm1 * rnoi * fdetamox) * amox
        - rnm1 * rnoi * fdetnitr * nitr)
    diags = {'nitr_NH4': amox, 'nitr_NO2': nitr,
             'nitr_N2O_prod': 0.5 * fn2o * amox,
             'nitr_NH4_OM': rnoi * fdetamox * amox,
             'nitr_NO2_OM': rnoi * fdetnitr * nitr}
    return oc, diags


def denit_no3_to_no2(oc, ti, ptho, wet, dtb, p: BgcParams,
                     ep: ExtNParams):
    """Denitrification / dissimilatory NO3 reduction, NO3 -> NO2
    (mo_extNwatercol.F90:214-265)."""
    oc = oc.clone()
    temp = _tclip(ptho)
    rnoxpi = 1. / ep.rnoxp
    rnm1 = p.rnit - 1.
    no3 = oc[T.ano3].clone()
    tdep = _q10(ep.q10ano3denit, temp, ep.trefano3denit)
    o2inhib = 1. - torch.tanh(ep.sc_ano3denit * oc[T.oxygen])
    nutlim = no3 / (no3 + ep.bkano3denit)
    no3new = no3 / (1. + ep.rano3denit * dtb * tdep * o2inhib * nutlim)
    d = torch.clamp_min(torch.minimum(
        no3 - no3new, ep.max_limiter * oc[T.det] * ep.rnoxp), 0.)
    d = torch.where(wet, d, 0.)
    oc[T.ano3] = oc[T.ano3] + -d
    oc[ti.ano2] = oc[ti.ano2] + d
    oc[T.det] = oc[T.det] + -d * rnoxpi
    oc[ti.anh4] = oc[ti.anh4] + d * p.rnit * rnoxpi
    oc[T.sco212] = oc[T.sco212] + d * p.rcar * rnoxpi
    oc[T.phosph] = oc[T.phosph] + d * rnoxpi
    oc[T.iron] = oc[T.iron] + d * p.riron * rnoxpi
    oc[T.alkali] = oc[T.alkali] + d * rnm1 * rnoxpi
    return oc, {'denit_NO3': d}


def anammox(oc, ti, ptho, wet, dtb, p: BgcParams, ep: ExtNParams):
    """Anaerobic ammonium oxidation (mo_extNwatercol.F90:268-326)."""
    oc = oc.clone()
    temp = _tclip(ptho)
    rno2anmxi = 1. / ep.rno2anmx
    rnm1 = p.rnit - 1.
    no2 = oc[ti.ano2].clone()
    nh4 = oc[ti.anh4].clone()
    tdep = _q10(ep.q10anmx, temp, ep.trefanmx)
    ex = torch.exp(torch.clamp(
        ep.alphaanmx * (oc[T.oxygen] - ep.bkoxanmx), -50., 50.))
    o2inhib = 1. - ex / (1. + ex)
    nut1 = no2 / (no2 + ep.bkano2anmx)
    nut2 = nh4 / (nh4 + ep.bkanh4anmx)
    no2new = no2 / (1. + ep.rano2anmx * dtb * tdep * o2inhib
                    * nut1 * nut2)
    ml = ep.max_limiter
    lim = torch.minimum(ml * oc[T.iron] * ep.rno2anmx / p.riron,
                        ml * oc[T.alkali] * ep.rno2anmx / rnm1)
    lim = torch.minimum(ml * oc[T.phosph] * ep.rno2anmx, lim)
    lim = torch.minimum(ml * oc[T.sco212] * ep.rno2anmx / p.rcar, lim)
    lim = torch.minimum(ml * nh4 * ep.rno2anmx / ep.rnh4anmx, lim)
    d = torch.clamp_min(torch.minimum(no2 - no2new, lim), 0.)
    d = torch.where(wet, d, 0.)
    oc[ti.ano2] = oc[ti.ano2] + -d
    oc[ti.anh4] = oc[ti.anh4] + -d * ep.rnh4anmx * rno2anmxi
    oc[T.gasnit] = oc[T.gasnit] + d * (ep.rnh4anmx - p.rnit) * rno2anmxi
    oc[T.ano3] = oc[T.ano3] + d * ep.rnoxp * rno2anmxi
    oc[T.det] = oc[T.det] + d * rno2anmxi
    oc[T.sco212] = oc[T.sco212] + -d * p.rcar * rno2anmxi
    oc[T.phosph] = oc[T.phosph] + -d * rno2anmxi
    oc[T.iron] = oc[T.iron] + -d * p.riron * rno2anmxi
    oc[T.alkali] = oc[T.alkali] + -d * rnm1 * rno2anmxi
    return oc, {'anmx_N2_prod': d * (ep.rnh4anmx - p.rnit) * rno2anmxi,
                'anmx_OM_prod': d * rno2anmxi}


def denit_dnra(oc, ti, ptho, wet, dtb, p: BgcParams, ep: ExtNParams):
    """NO2 -> N2O -> N2 denitrification and DNRA NO2 -> NH4
    (mo_extNwatercol.F90:329-454)."""
    oc = oc.clone()
    temp = _tclip(ptho)
    rnoxpi = 1. / ep.rnoxp
    rno2dnrai = 1. / ep.rno2dnra
    rnh4dnra = ep.rnh4dnra
    rnm1 = p.rnit - 1.
    o2 = oc[T.oxygen]
    no2 = oc[ti.ano2].clone()
    n2o = oc[T.an2o].clone()

    # denitrification on N2O
    tdep = _q10(ep.q10an2odenit, temp, ep.trefan2odenit)
    o2in = _o2_hill(o2, ep.bkoxan2odenit)
    nut = n2o / (n2o + ep.bkan2odenit)
    an2onew = n2o / (1. + ep.ran2odenit * dtb * tdep * o2in * nut)
    an2odenit = torch.clamp_min(torch.minimum(n2o, n2o - an2onew), 0.)

    # potential denitrification rate on NO2
    tdep = _q10(ep.q10ano2denit, temp, ep.trefano2denit)
    o2in = _o2_hill(o2, ep.bkoxano2denit)
    nut = no2 / (no2 + ep.bkano2denit)
    rpotden = torch.clamp_min(ep.rano2denit * dtb * tdep * o2in * nut, 0.)

    # potential DNRA rate on NO2
    tdep = _q10(ep.q10dnra, temp, ep.trefdnra)
    o2in = _o2_hill(o2, ep.bkoxdnra)
    nut = no2 / (no2 + ep.bkdnra)
    rpotdnra = torch.clamp_min(ep.rdnra * dtb * tdep * o2in * nut, 0.)

    potno2new = no2 / (1. + rpotden + rpotdnra)
    potdno2 = torch.clamp_min(torch.minimum(no2, no2 - potno2new), 0.)
    fdenit = rpotden / (rpotden + rpotdnra + _EPS)
    fdnra = 1. - fdenit
    ano2denit = fdenit * potdno2
    ano2dnra = fdnra * potdno2

    # detritus limitation
    potddet = rnoxpi * (ano2denit + an2odenit) + rno2dnrai * ano2dnra
    fdet1 = rnoxpi * ano2denit / (potddet + _EPS)
    fdet2 = rnoxpi * an2odenit / (potddet + _EPS)
    fdet3 = 1. - fdet1 - fdet2
    potddet = torch.clamp_min(torch.minimum(
        potddet, ep.max_limiter * oc[T.det]), 0.)
    potddet = torch.where(wet, potddet, 0.)

    ano2denit = fdet1 * ep.rnoxp * potddet
    an2odenit = fdet2 * ep.rnoxp * potddet
    ano2dnra = fdet3 * ep.rno2dnra * potddet

    oc[ti.ano2] = oc[ti.ano2] + (-ano2denit - ano2dnra)
    oc[T.an2o] = oc[T.an2o] + (-an2odenit + 0.5 * ano2denit)
    oc[T.gasnit] = oc[T.gasnit] + an2odenit
    oc[ti.anh4] = oc[ti.anh4] + (
        p.rnit * rnoxpi * (ano2denit + an2odenit)
        + rnh4dnra * rno2dnrai * ano2dnra)
    oc[T.det] = oc[T.det] + (-(ano2denit + an2odenit) * rnoxpi
                             - ano2dnra * rno2dnrai)
    oc[T.sco212] = oc[T.sco212] + (
        p.rcar * rnoxpi * (ano2denit + an2odenit)
        + p.rcar * rno2dnrai * ano2dnra)
    oc[T.phosph] = oc[T.phosph] + ((ano2denit + an2odenit) * rnoxpi
                                   + ano2dnra * rno2dnrai)
    oc[T.iron] = oc[T.iron] + (
        p.riron * rnoxpi * (ano2denit + an2odenit)
        + p.riron * rno2dnrai * ano2dnra)
    oc[T.alkali] = oc[T.alkali] + (
        (295. * ano2denit + rnm1 * an2odenit) * rnoxpi
        + (ep.rno2dnra + rnh4dnra - 1.) * rno2dnrai * ano2dnra)
    return oc, {'denit_NO2': ano2denit, 'denit_N2O': an2odenit,
                'DNRA_NO2': ano2dnra}


def extn_watercol(oc, ti, ptho, wet, dtb, p: BgcParams,
                  ep: ExtNParams = ExtNParams()):
    """The extNcycle process sequence as ocprod calls it
    (mo_ocprod.F90:940-955): nitrification -> denitrification NO3->NO2
    -> anammox -> denitrification/DNRA.  Returns (oc, diags)."""
    oc, d1 = nitrification(oc, ti, ptho, wet, dtb, p, ep)
    oc, d2 = denit_no3_to_no2(oc, ti, ptho, wet, dtb, p, ep)
    oc, d3 = anammox(oc, ti, ptho, wet, dtb, p, ep)
    oc, d4 = denit_dnra(oc, ti, ptho, wet, dtb, p, ep)
    for d in (d2, d3, d4):
        d1.update(d)
    return oc, d1


# ----------------------------------------------------------------------
# Bromoform (use_BROMO)
# ----------------------------------------------------------------------

class BromoParams(NamedTuple):
    """Bromoform constants (mo_param_bgc.F90:508-513, atm_bromo :231)."""
    rbro: float = 2.4e-6 * 16.       # production per phosy [P units]
    fbro1: float = 1.0
    fbro2: float = 1.0
    atm_bromo: float = 3.4           # atmospheric CHBr3 [ppt]


def bromo_ocprod(bromo, phosy, avsil, strahl, swa_clim0, abs_uv,
                 bkopal, dtb, bp: BromoParams, wet):
    """Production from primary production and the UV photolysis sink
    (mo_ocprod.F90:548-563).  swa_clim0: the climatological surface
    shortwave that normalizes the UV profile; abs_uv: the fractional UV
    penetration per layer (K, J, I).  Returns (bromo, diags)."""
    bro_beta = bp.rbro * (bp.fbro1 * avsil / (avsil + bkopal)
                          + _over(bp.fbro2 * bkopal, avsil + bkopal))
    safe = torch.clamp_min(swa_clim0, 1.e-30)
    bro_uv = torch.where(
        swa_clim0 > 0.,
        0.0333 * dtb * 0.3 * (strahl / safe)[None] * abs_uv * bromo,
        0.)
    d = torch.where(wet, bro_beta * phosy - bro_uv, 0.)
    return bromo + d, {'int_chbr3_prod': bro_beta * phosy,
                       'int_chbr3_uv': bro_uv}


def bromo_deep_decay(bromo, tk, kw_water, ah1, dtsec, wet):
    """Hydrolysis (Stemmler et al. 2015 eq. 2-4) and halide substitution
    (eq. 5-6) (mo_carchm.F90:612-626).  tk: temperature [K]; kw_water:
    the water dissociation product Kw; ah1: the hydrogen-ion
    concentration."""
    kb1 = 2.05e12 * torch.exp(_over(-1.073e5, 8.314 * tk)) * dtsec
    b = bromo * (1.0 - kb1 * kw_water / torch.clamp_min(ah1, 1.e-30))
    lsub = 7.33e-10 * torch.exp(1.250713e4 * (1.0 / 298. - _over(1.0, tk))) \
        * dtsec
    b = b * (1.0 - lsub)
    return torch.where(wet, b, bromo)


def bromo_surface_flux(bromo0, temp0, fice, fu10, slp, dz0, dtsec,
                       bp: BromoParams, wet0):
    """Air-sea CHBr3 exchange (mo_carchm.F90:295,360,386-387,547-548).
    Returns (the new surface bromoform, the flux into the atmosphere
    [kmol/m2])."""
    t = temp0
    t2, t3 = t * t, t * t * t
    tk = t + 273.15
    sch = 4662.8 - 319.45 * t + 9.9012 * t2 - 0.1159 * t3
    a_bromo = torch.exp(13.16 - _over(4973.0, tk))
    kw = ((1. - fice) * 1.e-2 / 3600.
          * (0.222 * (fu10 * fu10) + 0.33 * fu10)
          * torch.pow(_over(660., torch.clamp_min(sch, 1.)), 0.5))
    flux = kw * dtsec * (_over(bp.atm_bromo, a_bromo) * 1.0e-12 * slp
                         * 1.0e-5 / (tk * 0.083) - bromo0)
    flux = torch.where(wet0, flux, 0.)
    new = bromo0 + flux / torch.clamp_min(dz0, 1.e-12)
    return torch.where(wet0, new, bromo0), -flux


# ----------------------------------------------------------------------
# Natural DIC (use_natDIC)
# ----------------------------------------------------------------------

def natdic_bio_mirror(oc_pre, oc_post, ti):
    """The biological DIC, alkalinity and calcite tendencies applied to
    the natural-carbon tracers.  BLOM adds identical terms to inat* in
    every biological process (e.g. mo_ocprod.F90:528-543,
    mo_extNwatercol.F90:190-196); mirroring the net biological change is
    the same algebra and keeps the option out of the base processes.
    Call after ocprod/cyano/extN, before carchm."""
    oc = oc_post.clone()
    oc[ti.natsco212] = oc[ti.natsco212] + (oc_post[T.sco212]
                                           - oc_pre[T.sco212])
    oc[ti.natalkali] = oc[ti.natalkali] + (oc_post[T.alkali]
                                           - oc_pre[T.alkali])
    oc[ti.natcalc] = oc[ti.natcalc] + (oc_post[T.calc] - oc_pre[T.calc])
    return oc


def carchm_nat(oc, ti, ptho, psao, prho, dz, ptiestu, lyr, fu10, slp,
               fice, dtsec, p: BgcParams, atm_co2_nat: float = 284.7):
    """The carbonate system of the natural (preindustrial) carbon tracers
    (the use_natDIC branches of mo_carchm.F90:245-257,444-451,545,
    598-604,633-658; atm_co2_nat mo_param_bgc.F90:230): the pH solve for
    (natsco212, natalkali), the natural air-sea CO2 flux against a fixed
    preindustrial atmosphere and the dissolution of natcalc.  Returns
    (oc, diags with natco2flux, natpco2 and natomegac)."""
    from . import chemistry as chem
    from .carchm import SRFDIC_MIN, XCONVXA

    oc = oc.clone()
    t = torch.clamp(ptho, chem.TEMP_MIN, chem.TEMP_MAX)
    s = torch.clamp(psao, chem.SALN_MIN, chem.SALN_MAX)
    tk = t + chem.TZERO
    prb = ptiestu * 98060. * 1.027e-6
    k = chem.kequi(t, s, prb)
    rrho = prho

    tc = oc[ti.natsco212] / rrho
    ta = oc[ti.natalkali] / rrho
    sit = oc[T.silica] / rrho
    pt = oc[T.phosph] / rrho
    ah1 = torch.clamp(oc[ti.nathi], p.ah_min, p.ah_max)
    ah1, ac = chem.solve_h(s, tc, ta, sit, pt, k, ah1, p.niter,
                           p.ah_min, p.ah_max)
    oc[ti.nathi] = torch.where(lyr, ah1, oc[ti.nathi])

    cu = (2. * tc - ac) / (2. + k.K1 / ah1)
    cb = k.K1 * cu / ah1
    cc = k.K2 * cb / ah1
    natco3 = cc * rrho

    # natural surface CO2 flux (mo_carchm.F90:444-451,545)
    t0 = t[0]
    tk0 = tk[0]
    scco2 = chem.schmidt_numbers(t0)[0]
    opn = 1. - fice
    kwco2 = opn * XCONVXA * (fu10 * fu10) * torch.sqrt(_over(660., scco2))
    rpp0 = slp / 101325.
    tk02 = tk0 * tk0
    Bvir = (-1636.75 + 12.0408 * tk0 - 0.0327957 * tk02
            + 0.0000316528 * (tk0 * tk02))
    delta = 57.7 - 0.118 * tk0
    fc = torch.exp(rpp0 * (Bvir + 2. * delta) / (82.057 * tk0))
    pH2O = torch.exp(24.4543 - 67.4509 * _over(100., tk0)
                     - 4.8489 * torch.log(tk0 / 100.) - 0.000544 * s[0])
    dz0 = torch.clamp_min(dz[0], 1.e-12)
    natcu_sat = k.Kh0[0] * atm_co2_nat * 1.e-6 * (rpp0 - pH2O) * fc
    fluxd = natcu_sat * kwco2 * dtsec * rrho[0]
    fluxu = cu[0] * kwco2 * dtsec * rrho[0]
    fluxu = torch.minimum(
        fluxu, fluxd - (SRFDIC_MIN - oc[ti.natsco212, 0]) * dz0)
    wet0 = lyr[0]
    oc[ti.natsco212, 0] = oc[ti.natsco212, 0] + torch.where(
        wet0, (fluxd - fluxu) / dz0, 0.)

    # natural calcite dissolution (mo_carchm.F90:633-658)
    natomega = (chem.CALCON * s / 35.) * cc
    natomegaC = natomega / k.Kspc
    natsupsat = natco3 - natco3 / torch.clamp_min(natomegaC, 1.e-12)
    natundsa = torch.clamp_min(-natsupsat, 0.)
    dtb = dtsec / 86400.
    natdissol = torch.where(lyr, torch.minimum(
        natundsa, p.dremcalc * dtb * oc[ti.natcalc]), 0.)
    oc[ti.natcalc] = oc[ti.natcalc] - natdissol
    oc[ti.natalkali] = oc[ti.natalkali] + 2. * natdissol
    oc[ti.natsco212] = oc[ti.natsco212] + natdissol

    natpco2 = cu[0] * 1.e6 / k.Kh0[0] / fc
    return oc, {'natco2flux': torch.where(wet0, fluxu - fluxd, 0.),
                'natpco2': torch.where(wet0, natpco2, 0.),
                'natomegac': natomegaC}


# ----------------------------------------------------------------------
# Shelf-sea residence time (use_shelfsea_res_time)
# ----------------------------------------------------------------------

def shelfsea_residence_time(shelfage, shelfmask, wet, dtb):
    """An age-like tracer: + dtb on shelf columns, relaxed toward zero
    elsewhere (shelfsea_residence_time, mo_shelfsea_restime.F90:36-71)."""
    upd = torch.where(shelfmask[None], shelfage + dtb,
                      torch.clamp_min(shelfage - dtb, 0.))
    return torch.where(wet, upd, shelfage)
