"""Bulk surface mixed layer: Oberhuber (1993) TKE balance.

Counterpart of `blom_tpu/dynamics/mxlayr.py` (BLOM's
mod_mxlayr.F90:130-1431).  The mixed layer is layers 1-2 (layer 1 a
thktop = 10 m skin); a TKE budget of wind work, buoyancy flux with the
penetrating-shortwave correction and the Fox-Kemper restratification
decides between entrainment deepening and detrainment toward the depth
of TKE balance.  Detrainment solves tkew(pmxl) = 0 by the reference's
damped Newton iteration over all columns (maxitr sweeps with
convergence masks); entrainment walks the layers below the mixed layer,
absorbing each while the TKE stays positive and solving for pmxl inside
the last one with the same Newton step.  Then penetrating shortwave and
the surface fluxes are applied, and kfpla is re-derived.

Every expression is blom_tpu's, in its order: its optimization barriers
only pin XLA's fusion, and eager PyTorch keeps the written order.  A
Python scalar divided by a tensor is written as a tensor division
(`_rdiv`), since PyTorch computes ``c / x`` as ``c * (1 / x)``.  The
near-inertial-wave source is niwgf * niwbf * idkedt, the inertial
kinetic-energy tendency of `phys/niw.py`, when idkedt is given, and
zero otherwise."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import (alpha0, epsilp, grav, onecm, onem, onemm,
                              spcifh)
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..ops.reduce import ksum
from ..phys.forcing import Forcing

mltmin = 5.      # minimum ML thickness [m] (mod_mxlayr.F90:73)
thktop = 10.     # skin layer thickness [m] (mod_mxlayr.F90:75)
tencm = 10. * onecm
onemu = .009806

# Oberhuber closure parameters (mod_mxlayr.F90:168-172)
kappa = .4
mu = 2.
ustmin = .001
mldjmp = 1.e-3
maxitr = 20

# Fox-Kemper restratification constants (mod_mxlayr.F90:178-181)
cori20 = 4.9745e-5
ci = 44. / 63.
slbg0 = 0.


class MxlayrParams(NamedTuple):
    rm0: float = 1.2        # wind TKE efficiency (deck RM0)
    rm5: float = 0.         # momentum-entrainment TKE efficiency (RM5)
    mlrttp: str = 'variable'   # restratification time-scale type
    ce: float = .06         # MLE efficiency (mod_eddtra.F90:58)
    tau_mlr: float = 86400.    # restrat. timescale (mod_eddtra.F90:64)
    lfmin: float = 5.e3     # min front length scale (mod_eddtra.F90:80)
    niwgf: float = 0.       # NIW energy factor (mod_niw)
    niwbf: float = .35
    swamxd: float = 200.    # max shortwave penetration depth [m]


def _rdiv(c, x):
    """c / x for a Python number c, divided elementwise as blom_tpu does."""
    return torch.full_like(x, c) / x


def _sq(x):
    return x * x


def _bg2(grid: Grid, e: eos.EosParams, s: State, n: int):
    """Squared lateral buoyancy gradient of the mixed layer
    (mod_mxlayr.F90:222-280), one-sided at land edges."""
    dp1, dp2 = s.dp[n][0], s.dp[n][1]
    q = 1. / torch.clamp(dp1 + dp2, min=epsilp)
    tmxl = (s.temp[n][0] * dp1 + s.temp[n][1] * dp2) * q
    smxl = (s.saln[n][0] * dp1 + s.saln[n][1] * dp2) * q
    b = grav * alpha0 * eos.sig0(e, tmxl, smxl)

    qx = (b - grid.im1(b)) * grid.scuxi
    u2 = qx * qx * grid.iu
    qy = (b - grid.jm1(b)) * grid.scvyi
    v2 = qy * qy * grid.iv

    u2p = grid.ip1(u2)
    nu = grid.iu + grid.ip1(grid.iu)
    gx = torch.where(nu > 1.5, .5 * (u2 + u2p), u2 + u2p)
    v2p = grid.jp1(v2, 'v', True)
    nv = grid.iv + grid.jp1(grid.iv, 'v', True)
    gy = torch.where(nv > 1.5, .5 * (v2 + v2p), v2 + v2p)
    return (gx + gy + slbg0) * grid.ip


def entrain_energy(p_top, prk, pmxl, tk, sk, tm0, sm0, dpe0, dke0,
                   uk, vk, um, vm, delt1, rm5):
    """Potential/kinetic-energy terms of the entrainment TKE budget
    (mod_mxlayr.F90:877-916, :975-1010): the PE cost of mixing layer
    k's slab into the mixed layer through the double integral
    p_p_alpha, floored by the mldjmp minimum stratification, and the
    rm5-weighted mean-shear KE source.  Returns (tmx, smx, dpe, dke)."""
    denom = torch.clamp(pmxl - p_top, min=epsilp)
    tmx = (tm0 * (prk - p_top) + tk * (pmxl - prk)) / denom
    smx = (sm0 * (prk - p_top) + sk * (pmxl - prk)) / denom
    dpe = dpe0 + torch.maximum(
        .5 * alpha0 * alpha0 * mldjmp
        * (prk - p_top) * (pmxl - prk),
        eos.p_p_alpha(pmxl, p_top, tmx, smx)
        - eos.p_p_alpha(pmxl, prk, tk, sk)
        - eos.p_p_alpha(prk, p_top, tm0, sm0)
        - (p_top - prk) * eos.p_alpha(pmxl, prk, tk, sk)) \
        * alpha0 / (delt1 * grav)
    dke = dke0 + .5 * rm5 * (prk - p_top) * (pmxl - prk) \
        * (_sq(uk - um) + _sq(vk - vm)) * alpha0 \
        / (denom * delt1 * grav)
    return tmx, smx, dpe, dke


def _newton_step(tkew, tkeo, pmxl, dpmxl, lo, hi, span, flat_up):
    """The damped Newton increment of mod_mxlayr.F90:385-454, kept
    between lo - pmxl and hi - pmxl; where the TKE is flat over `span`,
    half the way up to lo where tkew < 0 and `flat_up` elsewhere."""
    def nz(x):
        return torch.where(torch.abs(x) < 1e-30, 1e-30, x)
    dtke = (tkew - tkeo) / nz(dpmxl)
    flat = torch.abs(dtke) < (torch.abs(tkew) + 1e-22) \
        / torch.clamp(span, min=epsilp)
    return torch.where(
        flat, torch.where(tkew < 0., .5 * (lo - pmxl), flat_up),
        torch.maximum(lo - pmxl, torch.minimum(hi - pmxl, -tkew / nz(dtke))))


def mxlayr(grid: Grid, e: eos.EosParams, s: State, forcing: Forcing,
           par: MxlayrParams, m: int, n: int, delt1, swabs=None,
           idkedt=None, dfl=None):
    """The bulk mixed layer of time level n, in place.  Returns the
    state, or (state, dfl) with the TKE budget terms in dfl.mtke when
    `dfl` is given."""
    kk = grid.kk
    ip = grid.ip
    H = grid.shape
    dtype = s.dp.dtype
    dev = ip.device
    kidx = torch.arange(kk, dtype=torch.int32, device=dev).reshape(
        (kk,) + (1,) * len(H))

    ttem = s.temp[n]
    ssal = s.saln[n]
    delp = s.dp[n]
    densr = s.sigmar
    kfpl = s.kfpla[n].to(torch.int32)

    pres = cumulative_p(delp) * ip
    cpi = 1.0 / spcifh
    dtg = delt1 * grav
    qag = alpha0 / grav

    # shortwave penetration profile (swfc2/swal2 of mod_swabs)
    if swabs is not None:
        swfc2 = swabs.swfc2
        swal2 = torch.clamp(swabs.swal2, min=1e-3)
    else:
        swfc2 = torch.zeros(H, dtype=dtype, device=dev)
        swal2 = torch.full(H, 20., dtype=dtype, device=dev)

    # ---- TKE budget coefficients (mod_mxlayr.F90:330-386)
    q12 = 1. / torch.clamp(delp[0] + delp[1], min=epsilp)
    tmxl = (ttem[0] * delp[0] + ttem[1] * delp[1]) * q12
    smxl = (ssal[0] * delp[0] + ssal[1] * delp[1]) * q12
    alfa = -alpha0 * eos.dsigdt0(e, tmxl, smxl)
    beta = alpha0 * eos.dsigds0(e, tmxl, smxl)
    bfltot = grav * alpha0 * (alfa * forcing.surflx * cpi
                              - beta * (forcing.salflx - forcing.brnflx))
    bflpsw = grav * alpha0 * alfa * swfc2 * forcing.sswflx * cpi

    taux_p = .5 * (forcing.taux + grid.ip1(forcing.taux))
    tauy_p = .5 * (forcing.tauy + grid.jp1(forcing.tauy, 'v', True))
    ustar = torch.sqrt(torch.sqrt(_sq(taux_p) + _sq(tauy_p)) / 1000.)
    ustar3 = ustar * _sq(ustar)

    lui = torch.abs(grid.coriop) * qag / (kappa
                                          * torch.clamp(ustar, min=ustmin))
    lei = 1.0 / (onem * swal2)
    cus = par.rm0 * ustar3
    cni = (par.niwgf * par.niwbf * idkedt if idkedt is not None
           else torch.zeros(H, dtype=dtype, device=dev))
    cbftot = .5 * bfltot * qag
    cbfpsw = .5 * bflpsw * qag

    bg2 = _bg2(grid, e, s, n)
    rtau = 1. / par.tau_mlr
    rlf = 1. / par.lfmin
    f2 = grid.coriop * grid.coriop
    if par.mlrttp == 'variable':
        crs = (ci * par.ce * bg2 * qag ** 3
               * torch.sqrt(grid.scp2 / (f2 + rtau * rtau)) * rlf)
    elif par.mlrttp == 'constant':
        crs = ci * par.ce * bg2 * qag ** 3 * torch.sqrt(grid.scp2) \
            * rlf / cori20
    else:   # 'limited'
        crs = (ci * par.ce * bg2 * rlf * qag ** 3
               * torch.sqrt(grid.scp2 / torch.clamp(
                   f2 + rtau * rtau, max=cori20 * cori20)))

    def tke_terms(pmxl, floor_pm=False):
        """(tkew, lbi, (us, ni, bf, rs)): the pmxl-dependent sources
        (mod_mxlayr.F90:366-386)."""
        rm1 = torch.exp(-lui * pmxl)
        qv = lei * (torch.clamp(pmxl, min=tencm) if floor_pm else pmxl)
        rm3 = torch.exp(-qv)
        rm4 = _rdiv(2., qv)
        qb = cbftot - cbfpsw * (rm4 * (1. - rm3) - rm3)
        stab = qb >= 0.
        lbi = torch.where(stab, lui * kappa / mu, lui)
        rm2 = torch.where(stab, torch.exp(-lbi * pmxl), rm1)
        us = cus * rm1
        ni = cni * rm1
        bf = qb * rm2 * pmxl
        rs = -crs * pmxl * pmxl * pmxl
        return us + ni + bf + rs, lbi, (us, ni, bf, rs)

    pmxl0 = pres[2]
    tkew0, lbi0, _ = tke_terms(pmxl0)

    detrain = (tkew0 < 0.) & (pmxl0 > mltmin * onem)
    shallow = (tkew0 < 0.) & ~detrain
    entrain = tkew0 >= 0.

    # ================== detrainment (mod_mxlayr.F90:388-454) =========
    use_lbi = pres[2] * lbi0 > 1.
    pm_g = 1. / torch.clamp(lbi0, min=1e-30)
    dpm_g = torch.clamp(torch.minimum(pm_g - pres[0], pres[2] - pm_g),
                        max=tencm)
    pmxl = torch.where(use_lbi, pm_g - .5 * dpm_g, pres[2] - tencm)
    dpmxl = torch.where(use_lbi, dpm_g,
                        torch.full(H, -tencm, dtype=dtype, device=dev))
    tkeo = tkew0
    done = torch.zeros(H, dtype=torch.bool, device=dev)
    for it in range(maxitr):
        tkew, _, _ = tke_terms(pmxl, floor_pm=True)
        dp_new = _newton_step(tkew, tkeo, pmxl, dpmxl, pres[0], pres[2],
                              pres[2] - pres[0], .5 * (pres[2] - pmxl))
        if it == 0:
            dp_new = torch.where(use_lbi, dpmxl, dp_new)
        pmxl = torch.where(done, pmxl, pmxl + dp_new)
        done = done | (torch.abs(dp_new) < onemm)
        dpmxl, tkeo = dp_new, tkew
    pmxl_det = torch.clamp(pmxl, min=mltmin * onem)

    # ================== shallow branch (:802-824) ====================
    pmxl_sh = torch.full(H, mltmin * onem, dtype=dtype, device=dev)

    # ================== entrainment (:826-1019) ======================
    # mean velocities at p-points (:833-848)
    def uv_sums(k):
        uu, vv = s.u[n][k], s.v[n][k]
        du, dv = s.dpu[n][k], s.dpv[n][k]
        return (uu * du + grid.ip1(uu * du), du + grid.ip1(du),
                vv * dv + grid.jp1(vv * dv, 'v', True),
                dv + grid.jp1(dv, 'v', True))

    def uv_mean(un, ud, vn, vd):
        return (un / torch.clamp(ud, min=onecm),
                vn / torch.clamp(vd, min=onecm))

    sums = [uv_sums(k) for k in range(kk)]
    um, vm = uv_mean(*(a + b for a, b in zip(sums[0], sums[1])))

    def layer_tke(pmxl, prk, tk, sk, tm0, sm0, dpe0, dke0, uk, vk, um,
                  vm):
        """TKE with the PE/KE terms while entraining within a layer
        (:877-916)."""
        tmx, smx, dpe, dke = entrain_energy(
            pres[0], prk, pmxl, tk, sk, tm0, sm0, dpe0, dke0, uk, vk,
            um, vm, delt1, par.rm5)
        tkew, _, _ = tke_terms(pmxl, floor_pm=True)
        return tkew - dpe + dke, tmx, smx, dpe, dke

    # walk the layers from layer 2's base: absorb interior layers while
    # the TKE stays positive; inside the terminating layer solve for pmxl
    ntrc = s.trc.shape[1]
    trc_n = s.trc[n]                     # (ntrc, kk, H)
    pm_e = pres[2]
    tdps = ttem[1] * delp[1]
    sdps = ssal[1] * delp[1]
    trdps = trc_n[:, 1] * delp[1][None]
    has_ml = delp[0] + delp[1] > epsilp
    tm0 = torch.where(has_ml, tmxl, ttem[0])
    sm0 = torch.where(has_ml, smxl, ssal[0])
    dpe0 = torch.zeros(H, dtype=dtype, device=dev)
    dke0 = torch.zeros(H, dtype=dtype, device=dev)
    active = entrain
    takes = []
    for k in range(2, kk):
        t_k, s_k, dp_k, trc_k = ttem[k], ssal[k], delp[k], trc_n[:, k]
        uk, vk = uv_mean(*sums[k])
        in_layer = active & (kfpl <= k + 1) & (dp_k >= epsilp)

        prk = pm_e
        prk1 = prk + dp_k
        args = (t_k, s_k, tm0, sm0, dpe0, dke0, uk, vk, um, vm)
        tke_full, tmx_f, smx_f, dpe_f, dke_f = layer_tke(prk1, prk, *args)
        absorb = in_layer & (tke_full >= 0.)

        pmxl = prk + torch.clamp(.5 * dp_k, max=tencm)
        dpmxl = torch.clamp(.5 * dp_k, max=tencm)
        tkeo = torch.zeros(H, dtype=dtype, device=dev)
        done = torch.zeros(H, dtype=torch.bool, device=dev)
        for _ in range(maxitr):
            tkew = layer_tke(pmxl, prk, *args)[0]
            dp_new = _newton_step(tkew, tkeo, pmxl, dpmxl, prk, prk1, dp_k,
                                  prk1 - pmxl)
            dp_new = torch.maximum(
                torch.clamp(prk, min=mltmin * onem) - pmxl, dp_new)
            pmxl = torch.where(done, pmxl, pmxl + dp_new)
            done = done | (torch.abs(dp_new) < onemm)
            dpmxl, tkeo = dp_new, tkew
        pm_part = torch.clamp(pmxl, min=prk, max=prk1)
        partial = in_layer & ~absorb

        take = torch.where(absorb, dp_k,
                           torch.where(partial, pm_part - prk, 0.))
        pm_e = torch.where(absorb, prk1, torch.where(partial, pm_part, pm_e))
        tdps = tdps + t_k * take
        sdps = sdps + s_k * take
        trdps = trdps + trc_k * take[None]

        tm0 = torch.where(absorb, tmx_f, tm0)
        sm0 = torch.where(absorb, smx_f, sm0)
        dpe0 = torch.where(absorb, dpe_f, dpe0)
        dke0 = torch.where(absorb, dke_f, dke0)
        denom = torch.clamp(pm_e - pres[0], min=epsilp)
        um = torch.where(absorb,
                         (um * (prk - pres[0]) + uk * (pm_e - prk)) / denom,
                         um)
        vm = torch.where(absorb,
                         (vm * (prk - pres[0]) + vk * (pm_e - prk)) / denom,
                         vm)
        active = active & ~partial
        takes.append(take)
    dpe_fin, dke_fin = dpe0, dke0
    delp_ent = torch.cat([delp[:2], delp[2:] - torch.stack(takes)], 0)
    pmxl_ent = torch.minimum(pres[kk], pm_e)

    # ================== combine branches =============================
    pmxl = torch.where(detrain, pmxl_det,
                       torch.where(shallow, pmxl_sh, pmxl_ent))

    # rebuild the column: in entrainment and the shallow branch the
    # layers up to pmxl join layer 2; in detrainment the ML shrinks and
    # the fossil water goes to its density class
    dptopl = torch.clamp(.5 * (pmxl - pres[0]), max=thktop * onem)

    # detrainment: fossil layer content
    dpfsl = torch.clamp(pres[2] - pmxl_det, min=0.)
    below2 = pmxl_det < pres[1]
    qf = 1. / torch.clamp(dpfsl, min=epsilp)
    top_cut = torch.clamp(pres[1] - pmxl_det, min=0.)
    tfsl = torch.where(below2, (ttem[1] * delp[1] + ttem[0] * top_cut) * qf,
                       ttem[1])
    sfsl = torch.where(below2, (ssal[1] * delp[1] + ssal[0] * top_cut) * qf,
                       ssal[1])
    sigfsl = eos.sig(e, tfsl, sfsl)

    # density class of the fossil water: the deepest k in [2, kk-1] with
    # densr <= sigfsl (:695-800 condensed, as in blom_tpu)
    fits = (densr <= sigfsl[None]) & (kidx >= 2)
    kdet = torch.clamp(torch.where(fits, kidx, 2).amax(0), 2, kk - 1)

    # shallow branch: absorb interior mass into the ML up to mltmin
    take_sh = torch.minimum(torch.clamp(
        torch.minimum(pmxl_sh[None], pres[1:]) - pres[:-1], min=0.),
        delp) * (kidx >= 2)
    tdps_sh = ttem[1] * delp[1] + ksum(ttem * take_sh, 0)
    sdps_sh = ssal[1] * delp[1] + ksum(ssal * take_sh, 0)

    # detrainment: the interior gains the fossil water at kdet
    gets = (kidx == kdet[None]) & detrain[None] & (dpfsl[None] > 0.)
    wnew = torch.where(gets, dpfsl[None]
                       / torch.clamp(delp + dpfsl[None], min=epsilp), 0.)
    ttem_det = ttem * (1. - wnew) + tfsl[None] * wnew
    ssal_det = ssal * (1. - wnew) + sfsl[None] * wnew
    delp_det = delp + torch.where(gets, dpfsl[None], 0.)

    # entrainment/shallow: interior layers lose the entrained mass
    tdps_e = torch.where(shallow, tdps_sh, tdps)
    sdps_e = torch.where(shallow, sdps_sh, sdps)
    delp_ent = torch.where(shallow[None], delp - take_sh * (kidx >= 2),
                           delp_ent)
    # ML content after entrainment: everything between the skin and pmxl
    ml_mass = torch.clamp(delp[0] + torch.clamp(pmxl - pres[1], min=0.),
                          min=epsilp)
    t2_ent = (tdps_e + ttem[0] * delp[0]) / ml_mass
    s2_ent = (sdps_e + ssal[0] * delp[0]) / ml_mass

    ent_like = entrain | shallow
    ttem_new = torch.where(ent_like[None], ttem, ttem_det)
    ssal_new = torch.where(ent_like[None], ssal, ssal_det)
    delp_new = torch.where(ent_like[None], delp_ent, delp_det)

    ml_t = torch.where(ent_like, t2_ent, tmxl)
    ml_s = torch.where(ent_like, s2_ent, smxl)

    # skin/remainder split of the new ML
    delp_new[0] = dptopl * ip
    delp_new[1] = torch.clamp(pmxl - pres[0] - dptopl, min=0.) * ip
    ttem_new[0] = ml_t
    ttem_new[1] = ml_t
    ssal_new[0] = ml_s
    ssal_new[1] = ml_s

    # tracers take the same redistribution: entrained tracer mass joins
    # the ML, detrained fossil water carries tracer into its class
    if ntrc:
        trdps_sh = (trc_n[:, 1] * delp[1][None]
                    + ksum(trc_n * take_sh[None], 1))
        trdps_e = torch.where(shallow[None], trdps_sh, trdps)
        trml = (trdps_e + trc_n[:, 0] * delp[0][None]) / ml_mass[None]
        wnew_t = wnew[None]
        trc_det = trc_n * (1. - wnew_t) + trc_n[:, 1][:, None] * wnew_t
        trc_new = torch.where(ent_like[None, None], trc_n, trc_det)
        trc_new[:, 0] = torch.where(ent_like[None], trml, trc_n[:, 0])
        trc_new[:, 1] = torch.where(ent_like[None], trml, trc_n[:, 1])
        s.trc[n] = trc_new * ip[None, None]

    # ---- apply forcing (:1162-1196): penetrating shortwave below the
    # skin with the swfc2/swal2 exponential profile, capped at swamxd
    pradd = par.swamxd * onem
    pres_new = cumulative_p(delp_new) * ip

    def psw_at(pp):
        return swfc2 * torch.exp(-lei * torch.clamp(pp, max=pradd))

    pswbas = swfc2 * torch.exp(-lei * delp_new[0])
    dsw = torch.cat([torch.zeros((1,) + H, dtype=dtype, device=dev),
                     psw_at(pres_new[1:-1]) - psw_at(pres_new[2:])], 0)
    heat_pen = dsw * forcing.sswflx[None] * dtg * cpi \
        / torch.clamp(delp_new, min=epsilp)
    ttem_new = ttem_new - torch.where(delp_new > onemu, heat_pen, 0.)
    # top layer: total non-penetrating heat and salt
    pswtail = psw_at(pres_new[kk])
    q0 = _rdiv(dtg, torch.clamp(delp_new[0], min=epsilp))
    ttem_new[0] = ttem_new[0] - (
        forcing.surflx - (pswbas - pswtail) * forcing.sswflx
        + forcing.surrlx) * q0 * cpi
    ssal_new[0] = ssal_new[0] - (
        forcing.salflx - forcing.brnflx + forcing.salrlx) * q0
    # brine flux into layer 2 (condensed brine plume)
    ssal_new[1] = ssal_new[1] - forcing.brnflx * dtg \
        / torch.clamp(delp_new[1], min=epsilp)

    ssal_new = torch.clamp(ssal_new, min=0.)
    sigma_new = eos.sig(e, ttem_new, ssal_new) * ip

    # ---- mtke diagnostics at the final mixed-layer depth
    if dfl is not None:
        _, _, (t_us, t_ni, t_bf, t_rs) = tke_terms(pmxl, floor_pm=True)
        mtke = torch.stack([t_us, t_ni, t_bf, t_rs,
                            torch.where(entrain, -dpe_fin, 0.),
                            torch.where(entrain, dke_fin, 0.)]) * ip[None]
        dfl = dataclasses.replace(dfl, mtke=mtke)

    # ---- first physical layer (:1205-1218): first k >= 2 with mass
    haskm = (delp_new * (kidx >= 2)) > epsilp
    kfpl_new = torch.where(haskm.any(0), haskm.to(torch.uint8).argmax(0), kk)

    s.temp[n] = ttem_new * ip
    s.saln[n] = ssal_new * ip
    s.dp[n] = torch.clamp(delp_new, min=0.) * ip
    s.sigma[n] = sigma_new
    s.kfpla[n] = kfpl_new.to(s.kfpla.dtype)
    return s if dfl is None else (s, dfl)
