"""Sediment: pore-water chemistry, diffusion and burial shifting.

Counterpart of `blom_tpu/bgc/sediment.py` (BLOM's hamocc/mo_sedmnt.F90
grid and state, mo_powadi.F90 the implicit dissolution-diffusion solve,
mo_powach.F90 the pore-water chemistry, mo_dipowa.F90 the pore-water
diffusion, mo_sedshi.F90 the burial shifting).  Four solid constituents
(POC, CaCO3, opal, clay) in KS = 12 layers over 7 pore-water tracers
coupled to the bottom water.  The tridiagonal solves are whole-field
Thomas eliminations unrolled over the fixed KS + 1 levels in blom_tpu's
order; every per-point branch is a `torch.where`.

The per-layer constants are numpy arrays, as in blom_tpu; as tensors
they take the dtype of the state they meet (blom_tpu's f32 run, with
64-bit types off as on a TPU, computes them in f32 too).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.reduce import ksum
from . import chemistry as chem
from .params import BgcParams, BgcTracers as T

KS = 12

# sediment grid (namelist dzs default and sed_porosity,
# namelist_definition_blom.xml:4863-4897; ini_sedmnt mo_sedmnt.F90:87-212):
# dzs [m], 13 interface spacings
DZS = np.array([0.001, 0.003, 0.005, 0.007, 0.009, 0.011, 0.013,
                0.015, 0.017, 0.019, 0.021, 0.023, 0.025])
SEDDW = .5 * (DZS[:-1] + DZS[1:])          # (ks,) layer volume weight
SEDDZI = 1. / DZS                           # (ks+1,)
PORWAT = np.array([0.85, 0.83, 0.8, 0.79, 0.77, 0.75, 0.73, 0.7,
                   0.68, 0.66, 0.64, 0.62])
PORSOL = 1. - PORWAT
PORWAH = np.concatenate([[.5 * (1. + PORWAT[0])],
                         .5 * (PORWAT[1:] + PORWAT[:-1])])
SOLFU = float((SEDDW * PORSOL).sum())

# rate constants (mo_param_bgc.F90:546-572), per second; scaled by dt
SEDICT = 1.e-9      # pore-water molecular diffusivity [m2/s]
SILSAT = 0.001      # silicate saturation [kmol/m3]
DISSO_POC = 3.9e-7  # [1/(kmol O2/m3 s)]
DISSO_SIL = 1.0e-7
DISSO_CACO3 = 1.0e-7
SED_DENIT = 0.01 / 86400.
SED_SULF = 0.01 / 86400.
SED_O2THRESH_HYPOXIC = 1.e-6
SED_O2THRESH_SULF = 3.e-6
SED_NO3THRESH_SULF = 3.e-6

# solid weight/density volume factors (mo_sedmnt.F90:103-106)
CALFA = 100. / 2600.
OPLFA = 60. / 2200.
ORGFA = 30. / 1000.
CLAFA = 1. / 2600.


class SedSolid:
    """Solid constituent indices (mo_param1_bgc.F90:212-215)."""
    sso12 = 0   # POC [kmol P / m3 solid]
    ssc12 = 1   # CaCO3
    sssil = 2   # opal
    sster = 3   # clay [kg / m3 solid]


class SedPow:
    """Pore-water tracer indices (mo_param1_bgc.F90:232-238) and their
    ocean counterparts (map_por2octra)."""
    aic = 0     # DIC
    aal = 1     # alkalinity
    aph = 2     # phosphate
    aox = 3     # oxygen
    n2 = 4      # dinitrogen
    no3 = 5     # nitrate
    asi = 6     # silicate


NPOWTRA = 7
POW2OC = (T.sco212, T.alkali, T.phosph, T.oxygen, T.gasnit, T.ano3,
          T.silica)


@dataclasses.dataclass
class SedState:
    sedlay: torch.Tensor   # (4, ks, J, I) solids
    powtra: torch.Tensor   # (7, ks, J, I) pore water [kmol/m3]
    burial: torch.Tensor   # (4, J, I)
    sedhpl: torch.Tensor   # (ks, J, I) pore-water [H+]


def layer_tensor(a, like):
    """The numpy per-layer array `a` as a (n, 1, 1) tensor in the dtype
    and on the device of `like`."""
    return torch.as_tensor(a, dtype=like.dtype,
                           device=like.device)[:, None, None]


def init_sediment(shape, dtype=torch.float64, device='cpu') -> SedState:
    """Empty solids and burial, uniform pore water and pore-water [H+]."""
    H = tuple(shape)
    powtra = torch.zeros((NPOWTRA, KS) + H, dtype=dtype, device=device)
    for idx, val in ((SedPow.aic, 2.27e-3), (SedPow.aal, 2.37e-3),
                     (SedPow.aox, 2.e-4), (SedPow.no3, 30.e-6),
                     (SedPow.asi, 1.e-4), (SedPow.n2, 1.e-10),
                     (SedPow.aph, 2.e-6)):
        powtra[idx] = val
    return SedState(
        sedlay=torch.zeros((4, KS) + H, dtype=dtype, device=device),
        powtra=powtra,
        burial=torch.zeros((4,) + H, dtype=dtype, device=device),
        sedhpl=torch.full((KS,) + H, 1.e-8, dtype=dtype, device=device))


def powadi(solrat, sedb1, bolay, omask, dt):
    """Implicit dissolution-diffusion tridiagonal solve over the
    (ks+1)-level pore-water column with the bottom-water box on top
    (powadi, mo_powadi.F90:25-110).

    solrat: (ks, J, I) dissolution sink coefficients; sedb1: (ks+1, J, I)
    right-hand side (level 0 the bottom water); returns sediso
    (ks+1, J, I)."""
    sedict = SEDICT * dt
    lo = [None] * (KS + 1)
    up = [None] * (KS + 1)
    dg = [None] * (KS + 1)
    zero = torch.zeros_like(bolay)
    # rows 1..ks (mo_powadi.F90:36-46)
    for k in range(1, KS + 1):
        asu = sedict * SEDDZI[k - 1] * PORWAH[k - 1]
        alo = sedict * SEDDZI[k] * PORWAH[k] if k < KS else 0.
        up[k] = torch.full_like(bolay, -asu)
        lo[k] = torch.full_like(bolay, -alo)
        dg[k] = (SEDDW[k - 1] * PORWAT[k - 1] + asu + alo
                 + solrat[k - 1] * PORWAT[k - 1] * SEDDW[k - 1])
    # row 0: the bottom-water box (:48-61); dg[0] is 1 on land
    alo0 = sedict * SEDDZI[0] * PORWAH[0]
    wet = omask > .5
    up[0] = zero
    lo[0] = torch.where(wet, torch.full_like(bolay, -alo0), zero)
    dg[0] = torch.where(wet, bolay + alo0, torch.ones_like(bolay))

    # forward elimination (:63-77)
    b = [sedb1[k] for k in range(KS + 1)]
    for k in range(1, KS + 1):
        w = up[k] / dg[k - 1]
        dg[k] = dg[k] - lo[k - 1] * w
        b[k] = b[k] - w * b[k - 1]
    # back substitution (:79-93)
    out = [None] * (KS + 1)
    out[KS] = b[KS] / dg[KS]
    for k in range(KS - 1, -1, -1):
        out[k] = (b[k] - lo[k] * out[k + 1]) / dg[k]
    return torch.stack(out)


def powach(sed: SedState, oc, bot_flx, keq, bolay, kbo_onehot, omask,
           saln_bot, rrho_bot, dt, p: BgcParams):
    """Pore-water chemistry (powach, mo_powach.F90:28-656): opal
    dissolution, aerobic POC remineralization, denitrification, sulfate
    reduction, CaCO3 dissolution with the pore-water carbonate chemistry,
    then the pore-water diffusion (dipowa) and the clay input.

    oc: (ntr, K, J, I) ocean concentrations (the bottom exchange acts on
    the kbo layer through kbo_onehot (K, J, I)); bot_flx: prorca,
    prcaca, silpro, produs [kmol m-2/step]; keq: the Kequi of the bottom
    layer; bolay: the bottom layer's thickness [m].  Returns (sed, oc),
    new objects."""
    sedlay = sed.sedlay.clone()
    powtra = sed.powtra.clone()
    oc = oc.clone()
    umfa = layer_tensor(PORSOL / PORWAT, bolay)
    seddw_w = layer_tensor(SEDDW * PORWAT, bolay)
    psol1 = PORSOL[0] * SEDDW[0]

    def bot(idx):
        return (oc[idx] * kbo_onehot).sum(0)

    def set_bot(idx, val):
        oc[idx] = torch.where(kbo_onehot > 0., val[None], oc[idx])

    # ---------------- opal (:110-165) --------------------------------
    disso = DISSO_SIL * dt
    undsa = SILSAT - powtra[SedPow.asi]
    sedb1 = torch.cat(
        [(bolay * (SILSAT - bot(T.silica)))[None],
         seddw_w * (SILSAT - powtra[SedPow.asi])])
    sil1 = sedlay[SedSolid.sssil, 0] + bot_flx['silpro'] / psol1
    solrat = (sedlay[SedSolid.sssil] * disso / (1. + disso * undsa)
              * umfa)
    solrat[0] = sil1 * disso / (1. + disso * undsa[0]) * umfa[0]
    sediso = powadi(solrat, sedb1, bolay, omask, dt)
    set_bot(T.silica, SILSAT - sediso[0])
    sedlay[SedSolid.sssil, 0] = (sedlay[SedSolid.sssil, 0]
                                 + bot_flx['silpro'] / psol1)
    solrat2 = sedlay[SedSolid.sssil] * disso / (1. + disso * sediso[1:])
    sedlay[SedSolid.sssil] = sedlay[SedSolid.sssil] - sediso[1:] * solrat2
    powtra[SedPow.asi] = SILSAT - sediso[1:]

    # ---------------- aerobic POC (:170-260) -------------------------
    disso = DISSO_POC * dt
    undsa = powtra[SedPow.aox]
    sedb1 = torch.cat(
        [(bolay * bot(T.oxygen))[None], seddw_w * powtra[SedPow.aox]])
    poc1 = sedlay[SedSolid.sso12, 0] + bot_flx['prorca'] / psol1
    solrat = (sedlay[SedSolid.sso12] * p.ro2ut * disso
              / (1. + disso * undsa) * umfa)
    solrat[0] = poc1 * p.ro2ut * disso / (1. + disso * undsa[0]) * umfa[0]
    sediso = powadi(solrat, sedb1, bolay, omask, dt)
    set_bot(T.oxygen, sediso[0])
    sedlay[SedSolid.sso12, 0] = (sedlay[SedSolid.sso12, 0]
                                 + bot_flx['prorca'] / psol1)
    solrat2 = sedlay[SedSolid.sso12] * disso / (1. + disso * sediso[1:])
    posol = sediso[1:] * solrat2
    aerob = posol * umfa
    sedlay[SedSolid.sso12] = sedlay[SedSolid.sso12] - posol
    powtra[SedPow.aph] = powtra[SedPow.aph] + posol * umfa
    powtra[SedPow.no3] = powtra[SedPow.no3] + posol * p.rnit * umfa
    powtra[SedPow.aox] = sediso[1:]

    # ---------------- denitrification (:265-300) ---------------------
    hypox = powtra[SedPow.aox] < SED_O2THRESH_HYPOXIC
    posol = torch.where(
        hypox,
        SED_DENIT * dt * torch.minimum(
            .25 * powtra[SedPow.no3] / p.rdnit2,
            sedlay[SedSolid.sso12]), 0.)
    anaerob = posol * umfa
    sedlay[SedSolid.sso12] = sedlay[SedSolid.sso12] - posol
    powtra[SedPow.aph] = powtra[SedPow.aph] + posol * umfa
    powtra[SedPow.no3] = powtra[SedPow.no3] + -p.rdnit1 * posol * umfa
    powtra[SedPow.n2] = powtra[SedPow.n2] + p.rdnit2 * posol * umfa

    # ---------------- sulfate reduction (:305-330) -------------------
    sul = hypox & (powtra[SedPow.no3] < SED_NO3THRESH_SULF) \
        & (powtra[SedPow.aox] < SED_O2THRESH_SULF)
    posol = torch.where(sul, SED_SULF * dt * sedlay[SedSolid.sso12], 0.)
    sulf = posol * umfa
    sedlay[SedSolid.sso12] = sedlay[SedSolid.sso12] - posol
    powtra[SedPow.aph] = powtra[SedPow.aph] + posol * umfa
    powtra[SedPow.no3] = powtra[SedPow.no3] + posol * umfa * p.rnit

    # ---------------- CaCO3 and carbonate chemistry (:340-450) -------
    alk = (powtra[SedPow.aal] - (sulf + aerob) * (p.rnit + 1.)
           + anaerob * (p.rdnit1 - 1.)) / rrho_bot
    c = (powtra[SedPow.aic] + (anaerob + aerob + sulf) * p.rcar) \
        / rrho_bot
    sit = powtra[SedPow.asi] / rrho_bot
    pt = powtra[SedPow.aph] / rrho_bot
    ah1 = torch.clamp(sed.sedhpl, 1.e-11, 1.e-4)
    kb = chem.Kequi(*[k[None] for k in keq])  # broadcast over ks
    ah1, ac = chem.solve_h(saln_bot[None], c, alk, sit, pt, kb, ah1,
                           p.niter, 1.e-20, 1.)
    cu = (2. * c - ac) / (2. + kb.K1 / ah1)
    cc = kb.K2 * kb.K1 * cu / (ah1 * ah1)
    sedhpl = torch.clamp_min(ah1, 1.e-20)
    powcar = cc * rrho_bot

    disso = DISSO_CACO3 * dt
    satlev = keq.Kspc / chem.CALCON
    co3_bot = bot_c03(oc, kbo_onehot, keq, saln_bot, rrho_bot, p)
    undsa = torch.clamp_min(satlev[None] - powcar, 0.)
    # the surface sediment layer uses the slightly raised saturation
    # level satlev + 2e-5 (mo_powach.F90:372-380)
    undsa0 = torch.clamp_min(satlev + 2.e-5 - powcar[0], 0.)
    sedb1 = torch.cat(
        [(bolay * (satlev + 2.e-5 - co3_bot))[None], seddw_w * undsa])
    cal1 = sedlay[SedSolid.ssc12, 0] + bot_flx['prcaca'] / psol1
    solrat = (sedlay[SedSolid.ssc12] * disso / (1. + disso * undsa)
              * umfa)
    solrat[0] = cal1 * disso / (1. + disso * undsa0) * umfa[0]
    solrat = torch.where(undsa <= 0., 0., solrat)
    sediso = powadi(solrat, sedb1, bolay, omask, dt)
    sedlay[SedSolid.ssc12, 0] = (sedlay[SedSolid.ssc12, 0]
                                 + bot_flx['prcaca'] / psol1)
    solrat2 = sedlay[SedSolid.ssc12] * disso / (1. + disso * sediso[1:])
    posol = torch.where(undsa > 0., sediso[1:] * solrat2, 0.)
    sedlay[SedSolid.ssc12] = sedlay[SedSolid.ssc12] - posol
    powtra[SedPow.aic] = powtra[SedPow.aic] + (
        posol * umfa + (aerob + anaerob + sulf) * p.rcar)
    powtra[SedPow.aal] = powtra[SedPow.aal] + (
        2. * posol * umfa - (p.rnit + 1.) * (aerob + sulf)
        + (p.rdnit1 - 1.) * anaerob)

    # ---------------- clay input (dipowa's caller, powach :440) ------
    sedlay[SedSolid.sster, 0] = (sedlay[SedSolid.sster, 0]
                                 + bot_flx['produs'] / psol1)

    sed = dataclasses.replace(sed, sedlay=sedlay, powtra=powtra,
                              sedhpl=sedhpl)

    # ---------------- pore-water diffusion (dipowa) ------------------
    return dipowa(sed, oc, bolay, kbo_onehot, omask, dt)


def bot_c03(oc, kbo_onehot, keq, saln_bot, rrho_bot, p: BgcParams):
    """Carbonate-ion concentration of the bottom water (the co3 field
    carchm saves, which powach's CaCO3 boundary term reads)."""
    tc = (oc[T.sco212] * kbo_onehot).sum(0) / rrho_bot
    ta = (oc[T.alkali] * kbo_onehot).sum(0) / rrho_bot
    sit = (oc[T.silica] * kbo_onehot).sum(0) / rrho_bot
    pt = (oc[T.phosph] * kbo_onehot).sum(0) / rrho_bot
    ah1, ac = chem.solve_h(saln_bot, tc, ta, sit, pt, keq,
                           torch.full_like(tc, 1.e-8), p.niter)
    cu = (2. * tc - ac) / (2. + keq.K1 / ah1)
    return keq.K2 * keq.K1 * cu / (ah1 * ah1) * rrho_bot


def dipowa(sed: SedState, oc, bolay, kbo_onehot, omask, dt):
    """Implicit vertical diffusion of every pore-water tracer, coupled to
    the bottom water (dipowa, mo_dipowa.F90:30-140).  Returns (sed, oc),
    new objects."""
    powtra = sed.powtra
    seddw_w = layer_tensor(SEDDW * PORWAT, bolay)

    zero_solrat = torch.zeros((KS,) + tuple(bolay.shape), dtype=bolay.dtype,
                              device=bolay.device)
    new_pow = []
    new_oc = oc.clone()
    for iv in range(NPOWTRA):
        bot_v = (oc[POW2OC[iv]] * kbo_onehot).sum(0)
        sedb1 = torch.cat([(bolay * bot_v)[None], seddw_w * powtra[iv]])
        sediso = powadi(zero_solrat, sedb1, bolay, omask, dt)
        new_pow.append(sediso[1:])
        new_oc[POW2OC[iv]] = torch.where(kbo_onehot > 0., sediso[0][None],
                                         new_oc[POW2OC[iv]])
    return dataclasses.replace(sed, powtra=torch.stack(new_pow)), new_oc


def sedshi(sed: SedState, omask):
    """Burial shifting (sedshi, mo_sedshi.F90:28-200): shift the solids'
    overfill downward layer by layer, push the deepest layer's overfill
    into the burial pool, top the deepest layer up from burial when it is
    undersaturated, then shift deficits upward.  Returns a new SedState."""
    sedlay = sed.sedlay.clone()
    burial = sed.burial

    volfac = layer_tensor([ORGFA * 122., CALFA, OPLFA, CLAFA], sedlay)

    def solid_volume(lay_k):
        return ksum(volfac * lay_k, axis=0)

    def overfill(k):
        sedlo = solid_volume(sedlay[:, k])
        wsed = torch.clamp_min((sedlo - 1.) / (torch.abs(sedlo) + 1e-10),
                               0.)
        return sedlo, wsed[None] * sedlay[:, k]

    # downward shifts (:40-75)
    for k in range(KS - 1):
        _, uebers = overfill(k)
        frac = (SEDDW[k] * PORSOL[k]) / (SEDDW[k + 1] * PORSOL[k + 1])
        sedlay[:, k] = sedlay[:, k] - uebers
        sedlay[:, k + 1] = sedlay[:, k + 1] + uebers * frac

    # the deepest layer into burial (:78-105)
    sedlo, uebers = overfill(KS - 1)
    sedlay[:, KS - 1] = sedlay[:, KS - 1] - uebers
    burial = burial + uebers * SEDDW[KS - 1] * PORSOL[KS - 1]

    # refill the deepest layer from burial (:108-165)
    fulsed = torch.zeros_like(sedlo)
    for k in range(KS):
        fulsed = fulsed + PORSOL[k] * SEDDW[k] \
            * solid_volume(sedlay[:, k])
    seddef = SOLFU - fulsed
    spresent = solid_volume(burial)
    burial[SedSolid.sster] = burial[SedSolid.sster] + torch.clamp_min(
        seddef - spresent, 0.) / CLAFA
    buried = solid_volume(burial)
    refill = seddef / (buried + 1e-10)
    frac = PORSOL[KS - 1] * SEDDW[KS - 1]
    sedlay[:, KS - 1] = sedlay[:, KS - 1] + refill[None] * burial / frac
    burial = burial * (1. - refill[None])

    # upward shifts (:170-196)
    for k in range(KS - 1, 0, -1):
        _, uebers = overfill(k)
        frac = (PORSOL[k] * SEDDW[k]) / (PORSOL[k - 1] * SEDDW[k - 1])
        sedlay[:, k] = sedlay[:, k] - uebers
        sedlay[:, k - 1] = sedlay[:, k - 1] + uebers * frac

    msk = omask > .5
    sedlay = torch.where(msk[None, None], sedlay, sed.sedlay)
    burial = torch.where(msk[None], burial, sed.burial)
    return dataclasses.replace(sed, sedlay=sedlay, burial=burial)
