"""Carbon isotopes (13C / 14C) of the BGC model: BLOM's `use_cisonew`.

Counterpart of `blom_tpu/bgc/ciso.py` (the cisonew paths of BLOM's
hamocc: the isco213..icalc14 tracer block, mo_param1_bgc.F90:77-90 and
:330-346; the atmospheric and fractionation constants,
mo_param_bgc.F90:176,235-241,287-288,636-648,756,791-792; the isotope
equivalents of the ocprod fluxes, mo_ocprod.F90:411-532,605-745,886-905,
977-996; the air-sea exchange of 13CO2/14CO2, mo_carchm.F90:460-491; the
dissolution of the isotope shells and the 14C decay, :647-675; the
sinking isotope pools, mo_vertical_fluxes.F90:208-243,496-526).  Every
function is elementwise over dense (K, J, I) tensors and works on a copy
of its `oc`.

The 14C tracers are carried normalized by c14fac (~1.2e-12), so they
have the magnitude of the 12C pools (mo_ini_fields.F90:172-177).  The
photosynthetic fractionation needs the dissolved CO2, which is computed
from the persistent hydrogen-ion tracer and the current DIC
(co2star = DIC / (1 + K1/h + K1 K2/h^2)), as blom_tpu does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .params import BgcParams, BgcTracers as T

SAFEDIV = 1.e-25   # safe-division epsilon (mo_ocprod.F90 safediv)

#: isotope tracer names in BLOM's assignment order
#: (mo_param1_bgc.F90:334-346)
CISO_NAMES = ('sco213', 'sco214', 'doc13', 'doc14', 'phy13', 'phy14',
              'zoo13', 'zoo14', 'det13', 'det14', 'calc13', 'calc14')


class CisoParams(NamedTuple):
    """cisonew constants (mo_param_bgc.F90:176,235-241,287-288)."""
    prei13: float = -6.5          # atm delta13C preindustrial [permil]
    prei14: float = 0.            # atm bigD14C preindustrial [permil]
    re1312: float = 0.0112372     # 13C/12C standard (PDB)
    re14to: float = 1.170e-12     # 14C/C standard (Karlen 1965/Orr 2017)
    bifr13_ini: float = 0.98      # initial biogenic fractionation
    c14_t_half: float = 5700. * 365.   # 14C half life [days]
    atm_co2: float = 284.7        # matches BgcParams.atm_co2 [ppm]

    @property
    def beta13(self):
        # mo_param_bgc.F90:637
        return self.prei13 / 1000. + 1.

    @property
    def atm_c13(self):
        # mo_param_bgc.F90:641
        return (self.beta13 * self.re1312 * self.atm_co2
                / (1. + self.beta13 * self.re1312))

    @property
    def atm_c14(self):
        # mo_param_bgc.F90:638-644
        alpha14 = 2. * (self.prei13 + 25.)
        d14cat = (self.prei14 + alpha14) / (1. - alpha14 / 1000.)
        return (d14cat / 1000. + 1.) * self.re14to * self.atm_co2

    @property
    def c14fac(self):
        # normalization factor of the stored 14C tracers (:646)
        return self.atm_c14 / self.atm_co2

    def c14dec(self, dtb):
        """Per-step decay factor (mo_param_bgc.F90:792)."""
        return 1. - (math.log(2.) / self.c14_t_half) * dtb


def init_ciso_tracers(oc, ti, cp: CisoParams, p: BgcParams):
    """Initial isotope pools: the DIC isotopes at the preindustrial
    atmospheric ratio, the organic and shell pools at the biogenically
    fractionated ratio (mo_ini_fields.F90:166-200, the delta-13C/14C
    input profiles taken as prei13/prei14)."""
    oc = oc.clone()
    r13 = cp.beta13 * cp.re1312 / (1. + cp.beta13 * cp.re1312)
    r14 = 1.0   # stored 14C is normalized by c14fac: ratio to 12C ~ 1
    b13, b14 = cp.bifr13_ini, cp.bifr13_ini ** 2
    oc[ti.sco213] = oc[T.sco212] * r13
    oc[ti.sco214] = oc[T.sco212] * r14
    for base, i13, i14 in ((T.doc, ti.doc13, ti.doc14),
                           (T.phy, ti.phy13, ti.phy14),
                           (T.zoo, ti.zoo13, ti.zoo14),
                           (T.det, ti.det13, ti.det14)):
        oc[i13] = oc[base] * r13 * b13
        oc[i14] = oc[base] * r14 * b14
    oc[ti.calc13] = oc[T.calc] * r13
    oc[ti.calc14] = oc[T.calc] * r14
    return oc


def _ratio(num, den):
    return num / (den + SAFEDIV)


def co2star_from_hi(oc, prho, k):
    """Dissolved CO2 [mol/kg] from DIC and the persistent pH tracer (the
    previous carbonate solve): tc / (1 + K1/h + K1 K2/h^2)."""
    tc = oc[T.sco212] / prho
    h = torch.clamp_min(oc[T.hi], 1.e-14)
    return tc / (1. + k.K1 / h + k.K1 * k.K2 / (h * h))


def ocprod_ciso(oc, ti, flx, co2star, wet, dtb, p: BgcParams,
                cp: CisoParams):
    """The isotope equivalents of the ocprod fluxes.

    oc: (ntr, K, J, I) concentrations BEFORE ocprod, with the isotope
    slots; flx: the flux dict of processes.ocprod(return_fluxes=True);
    co2star [mol/kg].  Returns a copy of oc with only the 12 isotope
    slots updated: the base slots are ocprod's, on the same pre-state,
    and the caller combines the two."""
    oc = oc.clone()
    # --- production (mo_ocprod.F90:411-470) --------------------------
    phosy = flx['phosy']
    # Laws (1997) growth fractionation; bifr13 = 1 below phytomi
    phy0 = oc[T.phy]
    phygrowth = ((phy0 + phosy) / (phy0 + SAFEDIV)) / dtb
    growth_co2 = phygrowth / (co2star * 1.e6 + SAFEDIV)
    bifr13_perm = (6.03 + 5.5 * growth_co2) / (0.225 + growth_co2)
    bifr13_perm = torch.clamp(bifr13_perm, 5., 26.)
    bifr13 = torch.where(phy0 < p.phytomi, 1.,
                         (1000. - bifr13_perm) / 1000.)
    bifr14 = bifr13 * bifr13

    rco2 = (_ratio(oc[ti.sco213], oc[T.sco212]),
            _ratio(oc[ti.sco214], oc[T.sco212]))
    rphy = (_ratio(oc[ti.phy13], phy0), _ratio(oc[ti.phy14], phy0))
    rzoo = (_ratio(oc[ti.zoo13], oc[T.zoo]),
            _ratio(oc[ti.zoo14], oc[T.zoo]))

    out = {}
    for n, (bifr, rco, rph, rzo) in enumerate(
            ((bifr13, rco2[0], rphy[0], rzoo[0]),
             (bifr14, rco2[1], rphy[1], rzoo[1]))):
        phosy_i = phosy * bifr * rco
        grazing_i = flx['grazing'] * rph
        graton_i = p.epsher * (1. - p.zinges) * grazing_i
        gratpoc_i = (1. - p.epsher) * grazing_i
        grawa_i = p.epsher * p.zinges * grazing_i
        phymor_i = flx['phymor'] * rph
        zoomor_i = flx['zoomor'] * rzo
        excdoc_i = flx['excdoc'] * rzo
        exud_i = flx['exud'] * rph
        export_i = (zoomor_i * (1. - p.ecan) + phymor_i + gratpoc_i)
        delcar_i = (p.rcalc * export_i * p.bkopal
                    / (flx['avsil'] + p.bkopal))
        dtr_i = -phosy_i + graton_i + p.ecan * zoomor_i
        out[n] = dict(phosy=phosy_i, grazing=grazing_i,
                      phymor=phymor_i, zoomor=zoomor_i,
                      excdoc=excdoc_i, exud=exud_i, grawa=grawa_i,
                      export=export_i, delcar=delcar_i, dtr=dtr_i)

    def upd(idx, d):
        oc[idx] = oc[idx] + torch.where(wet, d, 0.)

    for n, (idet, isco, iphy, izoo, idoc, icalc) in enumerate(
            ((ti.det13, ti.sco213, ti.phy13, ti.zoo13, ti.doc13,
              ti.calc13),
             (ti.det14, ti.sco214, ti.phy14, ti.zoo14, ti.doc14,
              ti.calc14))):
        o = out[n]
        # mo_ocprod.F90:516-532
        upd(idet, o['export'])
        upd(isco, -o['delcar'] + p.rcar * o['dtr'])
        upd(iphy, o['phosy'] - o['grazing'] - o['phymor'] - o['exud'])
        upd(izoo, o['grawa'] - o['excdoc'] - o['zoomor'])
        upd(idoc, o['excdoc'] + o['exud'])
        upd(icalc, o['delcar'])

    # --- aerobic remineralization (mo_ocprod.F90:605-750) ------------
    # ratios on the post-production pools (BLOM reads ocetra after the
    # production update within the same k-loop pass)
    det_mid = oc[T.det] + flx['export']
    doc_mid = oc[T.doc] + flx['excdoc'] + flx['exud']
    for idet, idoc, isco in ((ti.det13, ti.doc13, ti.sco213),
                             (ti.det14, ti.doc14, ti.sco214)):
        pocrem_i = flx['pocrem'] * _ratio(oc[idet], det_mid)
        docrem_i = flx['docrem'] * _ratio(oc[idoc], doc_mid)
        upd(idet, -pocrem_i)
        upd(idoc, -docrem_i)
        upd(isco, p.rcar * (pocrem_i + docrem_i))

    # --- denitrification (mo_ocprod.F90:886-905) ---------------------
    det_mid2 = det_mid - flx['pocrem']
    for idet, isco in ((ti.det13, ti.sco213), (ti.det14, ti.sco214)):
        rem_i = flx['remin_dn'] * _ratio(oc[idet], det_mid2)
        upd(idet, -rem_i)
        upd(isco, p.rcar * rem_i)

    # --- sulfate reduction (mo_ocprod.F90:977-996) -------------------
    det_mid3 = det_mid2 - flx['remin_dn']
    for idet, isco in ((ti.det13, ti.sco213), (ti.det14, ti.sco214)):
        rem_i = flx['remin_su'] * _ratio(oc[idet], det_mid3)
        upd(idet, -rem_i)
        upd(isco, p.rcar * rem_i)

    return oc


def carchm_ciso(oc, ti, t0, tk0, s0, cu, cb, cc, Kh0_0, kwco2, rpp0,
                pH2O, fc, rrho0, dz0, wet0, dissol, lyr, dtsec,
                p: BgcParams, cp: CisoParams):
    """Air-sea 13CO2/14CO2 exchange with fractionation, dissolution of
    the isotope shells and 14C decay (mo_carchm.F90:460-491,647-675).

    The scalars and 2-D fields are the locals of carchm's surface
    section; cu/cb/cc the full (K, J, I) speciation; dissol the calcite
    dissolution [kmol/m3/step], computed on the base calcite before
    carchm decremented it.  The stored 14C is normalized by c14fac, so
    the atmospheric boundary value is atm_c14/c14fac = atm_co2.
    Returns (oc, diags)."""
    oc = oc.clone()
    rco213 = _ratio(oc[ti.sco213, 0], oc[T.sco212, 0])
    rco214 = _ratio(oc[ti.sco214, 0], oc[T.sco212, 0])
    cu13 = cu[0] * rco213
    cu14 = cu[0] * rco214
    atco213 = cp.atm_c13
    atco214 = cp.atm_c14 / cp.c14fac
    cu_sat13 = Kh0_0 * atco213 * 1.e-6 * (rpp0 - pH2O) * fc
    cu_sat14 = Kh0_0 * atco214 * 1.e-6 * (rpp0 - pH2O) * fc

    # Zhang et al. (1995) fractionation (mo_carchm.F90:471-475)
    frac_k = 0.99912
    frac_aqg = (0.0049 * t0 - 1.31) / 1000. + 1.
    dicfrac = cc[0] / (cc[0] + cu[0] + cb[0] + SAFEDIV)
    frac_dicg = (0.0144 * t0 * dicfrac - 0.107 * t0 + 10.53) / 1000. + 1.
    fk = frac_aqg * frac_k

    flux13d = cu_sat13 * kwco2 * dtsec * rrho0 * frac_aqg * frac_k
    flux13u = cu13 * kwco2 * dtsec * rrho0 * frac_aqg * frac_k / frac_dicg
    flux14d = cu_sat14 * kwco2 * dtsec * rrho0 * (fk * fk)
    flux14u = (cu14 * kwco2 * dtsec * rrho0 * (fk * fk)
               / (frac_dicg * frac_dicg))

    oc[ti.sco213, 0] = oc[ti.sco213, 0] + torch.where(
        wet0, (flux13d - flux13u) / dz0, 0.)
    oc[ti.sco214, 0] = oc[ti.sco214, 0] + torch.where(
        wet0, (flux14d - flux14u) / dz0, 0.)

    # dissolution of the isotope shells (mo_carchm.F90:647-664); dissol
    # was computed on the base calcite before it was decremented
    calc_pre = oc[T.calc] + dissol
    for icalc, isco in ((ti.calc13, ti.sco213), (ti.calc14, ti.sco214)):
        dis_i = dissol * _ratio(oc[icalc], calc_pre)
        oc[icalc] = oc[icalc] - torch.where(lyr, dis_i, 0.)
        oc[isco] = oc[isco] + torch.where(lyr, dis_i, 0.)

    # 14C decay (mo_carchm.F90:667-675)
    dec = cp.c14dec(dtsec / 86400.)
    for idx in (ti.sco214, ti.det14, ti.calc14, ti.doc14, ti.phy14,
                ti.zoo14):
        oc[idx] = oc[idx] * dec

    diags = {'co2flux13': torch.where(wet0, flux13u - flux13d, 0.),
             'co2flux14': torch.where(wet0, flux14u - flux14d, 0.)}
    return oc, diags


def extra_sinkers(ti):
    """(tracer index, speed class, bottom-flux name, sedbypass target) of
    the sinking isotope pools (mo_vertical_fluxes.F90:208-217; the flux
    names of mo_sedmnt's pror13/pror14/prca13/prca14; redistribution
    :496-526: the organic isotopes return as detritus isotopes, the shell
    isotopes remineralize to the DIC isotopes)."""
    return ((ti.det13, 'poc', 'pror13', ti.det13),
            (ti.det14, 'poc', 'pror14', ti.det14),
            (ti.calc13, 'cal', 'prca13', ti.sco213),
            (ti.calc14, 'cal', 'prca14', ti.sco214))


def delta13c(oc, ti, cp: CisoParams):
    """delta13C of DIC [permil] (mo_carbch's d13C output)."""
    r = _ratio(oc[ti.sco213], oc[T.sco212] - oc[ti.sco213])
    return (r / cp.re1312 - 1.) * 1000.


def delta14c(oc, ti, cp: CisoParams):
    """Delta14C of DIC [permil]; the stored 14C is normalized, so ratio 1
    is c14fac in absolute units."""
    r = _ratio(oc[ti.sco214], oc[T.sco212]) * cp.c14fac
    return (r / cp.re14to - 1.) * 1000.
