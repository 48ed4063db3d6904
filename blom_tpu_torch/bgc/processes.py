"""Biological production, remineralization, N2 fixation.

Counterpart of `blom_tpu/bgc/processes.py` (BLOM's hamocc/mo_ocprod.F90
ocprod and mo_cyano.F90 cyano), base configuration (no AGG, isotopes or
extended N cycle).  Every update is elementwise over dense
(ntr, K, J, I) concentration tensors; the one sequential piece, the
downward light-attenuation recurrence, is a Python loop over k.

`oc` holds concentrations in kmol/m3 (P units for the organic pools);
`dtb` is the timestep in days.  Each function works on a copy of `oc`
and returns it.
"""

from __future__ import annotations

import torch

from ..ops.reduce import ksum
from .chemistry import _over
from .params import BgcParams, BgcTracers as T


def swr_absorption(oc, dz, lyr, p: BgcParams):
    """Mean shortwave absorption factor per layer (ocprod vloop,
    mo_ocprod.F90:243-278): the fraction of surface irradiance available
    in each wet layer, (K, J, I), 0 elsewhere."""
    absorption = torch.ones_like(dz[0])
    out = []
    for k in range(dz.shape[0]):
        dzk, wet = dz[k], lyr[k]
        atten = p.atten_w + p.atten_c * torch.clamp_min(oc[T.phy, k], 0.)
        dzs = torch.clamp_min(dzk, 1.e-12)
        att = torch.exp(-atten * dzs)
        ab = (absorption / atten) * (1. - att) / dzs
        out.append(torch.where(wet, ab, 0.))
        absorption = torch.where(wet, absorption * att, absorption)
    return torch.stack(out)


def ocprod(oc, ptho, dz, strahl, satoxy, lyr, dtb, p: BgcParams,
           return_fluxes: bool = False):
    """Production + remineralization + denitrification + sulfate
    reduction (ocprod loops 1-3, mo_ocprod.F90:294-1010).

    Returns (oc, diags), diags the vertically integrated export and
    production fields; with return_fluxes=True (oc, diags, flx), flx the
    per-layer process fluxes (what blom_tpu's carbon-isotope replay
    reads)."""
    oc = oc.clone()
    abs_bgc = swr_absorption(oc, dz, lyr, p)

    temp = torch.clamp(ptho, -3., 40.)

    # --- production loop (mo_ocprod.F90:330-520) -------------------
    phofa = p.pi_alpha * strahl[None] * abs_bgc
    temfa = 0.6 * torch.pow(1.066, temp)
    pho = dtb * phofa * temfa / torch.sqrt(phofa * phofa + temfa * temfa)

    avphy = torch.clamp_min(oc[T.phy], p.phytomi)
    avgra = torch.clamp_min(oc[T.zoo], p.grami)
    avsil = torch.clamp_min(oc[T.silica], 0.)
    avdic = torch.clamp_min(oc[T.sco212], 0.)
    avanut = torch.clamp_min(torch.minimum(oc[T.phosph],
                                           oc[T.ano3] / p.rnit), 0.)
    avanfe = torch.clamp_min(torch.minimum(avanut, oc[T.iron] / p.riron),
                             0.)
    xa = avanfe
    xn = xa / (1. + pho * avphy / (xa + p.bkphy))
    phosy = torch.clamp_min(xa - xn, 0.)
    phosy = torch.where(avdic <= p.rcar * phosy, avdic / p.rcar, phosy)

    ya = avphy + phosy
    yn = ((ya + p.grazra * dtb * avgra * p.phytomi / (avphy + p.bkzoo))
          / (1. + p.grazra * dtb * avgra / (avphy + p.bkzoo)))
    grazing = torch.clamp_min(ya - yn, 0.)
    graton = p.epsher * (1. - p.zinges) * grazing
    gratpoc = (1. - p.epsher) * grazing
    grawa = p.epsher * p.zinges * grazing

    phythresh = torch.clamp_min(oc[T.phy] - 2. * p.phytomi, 0.)
    zoothresh = torch.clamp_min(oc[T.zoo] - 2. * p.grami, 0.)
    phymor = p.dyphy * dtb * phythresh
    exud = p.gammap * dtb * phythresh
    zoomor = p.spemor * dtb * zoothresh * zoothresh
    excdoc = p.gammaz * dtb * zoothresh
    export = zoomor * (1. - p.ecan) + phymor + gratpoc

    delsil = torch.minimum(p.ropal * export * avsil / (avsil + p.bkopal),
                           0.5 * avsil)
    delcar = p.rcalc * export * p.bkopal / (avsil + p.bkopal)

    tp = temp + p.dmsp1
    dmsprod = ((p.dmsp5 * delsil + p.dmsp4 * delcar)
               * (1. + _over(1., tp * tp)))
    dms_uv = p.dmsp2 * dtb * phofa / p.pi_alpha * oc[T.dms]

    dtr = -phosy + graton + p.ecan * zoomor

    wet = lyr
    upd = {
        T.phosph: dtr,
        T.ano3: dtr * p.rnit,
        T.alkali: -2. * delcar - (p.rnit + 1.) * dtr,
        T.oxygen: -dtr * p.ro2ut,
        T.det: export,
        T.dms: dmsprod - dms_uv,
        T.sco212: -delcar + p.rcar * dtr,
        T.phy: phosy - grazing - phymor - exud,
        T.zoo: grawa - excdoc - zoomor,
        T.doc: excdoc + exud,
        T.calc: delcar,
        T.silica: -delsil,
        T.opal: delsil,
        T.iron: dtr * p.riron,
    }
    for idx, d in upd.items():
        oc[idx] = oc[idx] + torch.where(wet, d, 0.)

    intphosy = ksum(torch.where(wet, phosy * p.rcar * dz, 0.), axis=0)
    expoor = ksum(torch.where(wet, export * p.rcar * dz, 0.), axis=0)
    expoca = ksum(torch.where(wet, delcar * dz, 0.), axis=0)
    exposi = ksum(torch.where(wet, delsil * dz, 0.), axis=0)

    # --- aerobic remineralization (mo_ocprod.F90:620-800) ----------
    aerob = oc[T.oxygen] > p.o2thresh_aerob
    pocrem = torch.minimum(p.drempoc * dtb * oc[T.det],
                           0.33 * oc[T.oxygen] / p.ro2ut)
    docrem = torch.minimum(p.remido * dtb * oc[T.doc],
                           0.33 * oc[T.oxygen] / p.ro2ut)
    pocrem = torch.where(aerob & wet, torch.clamp_min(pocrem, 0.), 0.)
    docrem = torch.where(aerob & wet, torch.clamp_min(docrem, 0.), 0.)
    remin = pocrem + docrem

    oc[T.det] = oc[T.det] - pocrem
    oc[T.doc] = oc[T.doc] - docrem
    oc[T.phosph] = oc[T.phosph] + remin
    oc[T.ano3] = oc[T.ano3] + remin * p.rnit
    oc[T.alkali] = oc[T.alkali] + (-(p.rnit + 1.) * remin)
    oc[T.oxygen] = oc[T.oxygen] + (-p.ro2ut * remin)
    oc[T.sco212] = oc[T.sco212] + p.rcar * remin
    oc[T.iron] = oc[T.iron] + (
        remin * p.riron
        - torch.where(wet, p.relaxfe * dtb
                      * torch.clamp_min(oc[T.iron] - p.fesoly, 0.), 0.))

    # opal dissolution (mo_ocprod.F90:771-781)
    opalrem = torch.where(wet, p.dremopal * dtb * 0.1 * (temp + 3.)
                          * oc[T.opal], 0.)
    opalrem = torch.clamp_min(opalrem, 0.)
    oc[T.opal] = oc[T.opal] - opalrem
    oc[T.silica] = oc[T.silica] + opalrem

    # N2O production from remineralization (mo_ocprod.F90:783-794)
    aou = satoxy - oc[T.oxygen]
    refra = 1. + 3. * (0.5 + torch.sign(aou - 1.97e-4) * 0.5)
    dn2o = remin * 1.e-4 * p.ro2ut * refra
    oc[T.an2o] = oc[T.an2o] + dn2o
    oc[T.gasnit] = oc[T.gasnit] + (-dn2o)
    oc[T.oxygen] = oc[T.oxygen] + (-0.5 * dn2o)

    # bacterial DMS decomposition (mo_ocprod.F90:797-799)
    dms = oc[T.dms]
    dms_bac = (p.dmsp3 * dtb * torch.abs(temp + 3.) * dms
               * (dms / (p.dmsp6 + dms)))
    oc[T.dms] = oc[T.dms] + (-torch.where(wet, dms_bac, 0.))

    # --- denitrification (ocprod loop2, mo_ocprod.F90:874-930) -----
    hypox = (oc[T.oxygen] < p.o2thresh_hypoxic) & wet
    remin_dn = p.drempoc_anaerob * dtb * torch.minimum(
        oc[T.det], 0.5 * oc[T.ano3] / p.rdnit1)
    remin2o = p.dremn2o * dtb * torch.minimum(
        oc[T.det], 0.003 * oc[T.an2o] / p.rdn2o1)
    remin_dn = torch.where(hypox, torch.clamp_min(remin_dn, 0.), 0.)
    remin2o = torch.where(hypox, torch.clamp_min(remin2o, 0.), 0.)

    oc[T.alkali] = oc[T.alkali] + ((p.rdnit1 - 1.) * remin_dn - remin2o)
    oc[T.sco212] = oc[T.sco212] + p.rcar * (remin_dn + remin2o)
    oc[T.det] = oc[T.det] + (-(remin_dn + remin2o))
    oc[T.phosph] = oc[T.phosph] + (remin_dn + remin2o)
    oc[T.ano3] = oc[T.ano3] + (-p.rdnit1 * remin_dn)
    oc[T.gasnit] = oc[T.gasnit] + (p.rdnit2 * remin_dn + p.rdn2o2 * remin2o)
    oc[T.iron] = oc[T.iron] + p.riron * (remin_dn + remin2o)
    oc[T.an2o] = oc[T.an2o] + (-p.rdn2o1 * remin2o)
    intdnit = ksum(p.rdnit0 * remin_dn * dz, axis=0)

    # --- sulfate reduction (ocprod loop3, mo_ocprod.F90:965-1010) --
    sul = hypox & (oc[T.ano3] < p.no3thresh_sulf)
    remin_su = torch.where(sul, p.dremsul * dtb * oc[T.det], 0.)
    oc[T.det] = oc[T.det] - remin_su
    oc[T.alkali] = oc[T.alkali] + (-(p.rnit + 1.) * remin_su)
    oc[T.sco212] = oc[T.sco212] + p.rcar * remin_su
    oc[T.phosph] = oc[T.phosph] + remin_su
    oc[T.ano3] = oc[T.ano3] + p.rnit * remin_su
    oc[T.iron] = oc[T.iron] + p.riron * remin_su

    diags = {'intphosy': intphosy, 'expoor': expoor, 'expoca': expoca,
             'exposi': exposi, 'intdnit': intdnit}
    if return_fluxes:
        def w(a):
            return torch.where(wet, a, 0.)
        flx = {'phosy': w(phosy), 'grazing': w(grazing),
               'phymor': w(phymor), 'zoomor': w(zoomor),
               'excdoc': w(excdoc), 'exud': w(exud),
               'export': w(export), 'avsil': avsil,
               'pocrem': pocrem, 'docrem': docrem,
               'remin_dn': remin_dn + remin2o, 'remin_su': remin_su}
        return oc, diags, flx
    return oc, diags


def cyano(oc, ptho, dz, euph, dtb, p: BgcParams):
    """Cyanobacteria N2 fixation in the euphotic zone
    (mo_cyano.F90:28-100, base path without the extended N cycle).

    euph: boolean (K, J, I) euphotic-zone wet mask (k <= kwrbioz)."""
    oc = oc.clone()
    ttemp = torch.clamp(ptho, -3., 40.)
    nfixtfac = torch.clamp_min(
        p.tf2 * ttemp * ttemp + p.tf1 * ttemp + p.tf0, 0.) / p.tff
    deficit = euph & (oc[T.ano3] < p.rnit * oc[T.phosph])
    blue = p.bluefix * dtb * nfixtfac
    new_no3 = (oc[T.ano3] * (1. - blue)
               + blue * p.rnit * oc[T.phosph])
    dansp = torch.where(deficit, new_no3 - oc[T.ano3], 0.)
    oc[T.ano3] = oc[T.ano3] + dansp
    oc[T.gasnit] = oc[T.gasnit] + (-dansp * 0.5)
    oc[T.oxygen] = oc[T.oxygen] + (-dansp * 1.25)
    oc[T.alkali] = oc[T.alkali] + (-dansp)
    intnfix = ksum(dansp * dz, axis=0)
    return oc, intnfix
