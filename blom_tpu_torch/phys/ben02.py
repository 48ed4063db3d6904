"""ben02 bulk forcing: atmospheric-state recovery, air-sea fluxes and the
thermodynamic sea-ice step (Bentsen & Drange 2002).

Counterpart of `blom_tpu/phys/ben02.py` (BLOM's ben02/mod_ben02.F90
asflux :1690-1830, mod_ben02func.F90's humidity functions,
mod_thermf_ben02.F90:65-703 thermf_ben02 and mod_sfcstr_ben02.F90
sfcstr_ben02), with blom_tpu's design: the prescribed atmosphere arrives
as a `Ben02Clim` of fields already interpolated to the step, the
previous day's surface state is the instantaneous model state, every
conditional is an elementwise `torch.where` over all points, and the
transfer-coefficient iterations run a fixed TCITER sweeps.  A
`torch.where` between two numbers is built from tensors of the state's
dtype, and a Python number divided by a tensor is a tensor division
(`_rdiv`), since PyTorch computes ``c / x`` as ``c * (1 / x)``."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import onem
from ..core.grid import Grid
from . import bulktf as btf
from . import seaice as si
from .bulktf import _rdiv

# physical constants (mod_constants, mod_ben02)
CPAIR = 1004.7     # specific heat of dry air [J kg-1 K-1]
RHOWAT = 1000.     # water density used by the ice thermodynamics [kg m-3]
SPCIFH = 3990.     # specific heat of sea water [J kg-1 K-1]
STEFANB = 5.67e-8  # Stefan-Boltzmann
EMISS = .97        # surface emissivity
T0DEG = 273.15
ZU, ZT, ZQ = 10., 10., 10.   # measurement heights [m]
TCITER = 5                   # transfer-coefficient iterations


def _sat_e_water(p, tl):
    return 611.21 * (1.0007 + 3.46e-8 * p) * torch.exp(
        17.502 * (tl - 273.15) / (tl - 32.19))


def _sat_e_ice(tl):
    return 611. * 10. ** (9.5 * (tl - 273.15) / (tl - 7.66))


def qsatw(t, p):
    """Saturation specific humidity over water (Buck 1981;
    mod_ben02func.F90:68-89)."""
    tl = torch.clamp(t, min=150.)
    e = _sat_e_water(p, tl)
    return 0.62197 * e / (p - (1. - 0.62197) * e)


def dqsatw(t, p):
    """d(qsatw)/dT (mod_ben02func.F90:93-117)."""
    tl = torch.clamp(t, min=150.)
    e = _sat_e_water(p, tl)
    d = tl - 32.19
    dedt = e * 17.502 * (273.15 - 32.19) / (d * d)
    dn = p - (1. - 0.62197) * e
    return dedt * 0.62197 * p / (dn * dn)


def qsati(t, p):
    """Saturation specific humidity over ice (Parkinson & Washington
    1979; mod_ben02func.F90:121-142)."""
    tl = torch.clamp(t, min=150.)
    e = _sat_e_ice(tl)
    return 0.62197 * e / (p - (1. - 0.62197) * e)


def dqsati(t, p):
    """d(qsati)/dT (mod_ben02func.F90:146-169)."""
    tl = torch.clamp(t, min=150.)
    e = _sat_e_ice(tl)
    d = tl - 7.66
    dedt = e * 9.5 * (273.15 - 7.66) * math.log(10.) / (d * d)
    dn = p - (1. - 0.62197) * e
    return dedt * 0.62197 * p / (dn * dn)


def rhoair(t, q, p):
    """Moist air density [kg m-3] (mod_ben02func.F90:173-197)."""
    return p / (287.04 * t * (1. + (1. / 0.62197 - 1.) * q))


class Ben02Clim(NamedTuple):
    """Prescribed atmospheric fields at the current step, all (jdm, idm)
    (the NCEP/ERA fields of rdatm_*, mod_ben02.F90:254-640)."""
    tau_d: torch.Tensor    # wind stress magnitude [N m-2]
    shtfl: torch.Tensor    # sensible heat flux of the dataset [W m-2]
    lhtfl: torch.Tensor    # latent heat flux of the dataset [W m-2]
    dswrf: torch.Tensor    # downward shortwave [W m-2]
    nlwrs: torch.Tensor    # net upward longwave [W m-2]
    prcp: torch.Tensor     # precipitation [kg m-2 s-1]
    slpr: torch.Tensor     # sea-level pressure [Pa]
    tsrf_d: torch.Tensor   # dataset surface temperature [K]
    rice: torch.Tensor     # dataset ice concentration []
    rnfins: torch.Tensor   # runoff input [kg m-2 s-1]
    albw: torch.Tensor     # open-water albedo []
    uwnd: torch.Tensor     # wind direction unit vector x (for the stress)
    vwnd: torch.Tensor


def neutral_clim(shape, dtype=torch.float64, dswrf=150., tsrf=288.,
                 slpr=101325., device=None) -> Ben02Clim:
    """A uniform atmosphere on `device` (CUDA unless the caller names
    one)."""
    from ..drivers.standalone import _device
    H = tuple(shape)
    dev = _device(device)

    def f(v):
        return torch.full(H, v, dtype=dtype, device=dev)
    return Ben02Clim(tau_d=f(.05), shtfl=f(0.), lhtfl=f(0.), dswrf=f(dswrf),
                     nlwrs=f(60.), prcp=f(3.e-5), slpr=f(slpr),
                     tsrf_d=f(tsrf), rice=f(0.), rnfins=f(0.), albw=f(.065),
                     uwnd=f(1.), vwnd=f(0.))


@dataclasses.dataclass
class Ben02State:
    """Persistent transfer coefficients and the surface fluxes derived
    from them, all (jdm, idm) (mod_ben02.F90 cd_d..wg2_m,
    swa/nsf/dfl/eva/lip/sop)."""
    cd_d: torch.Tensor
    ch_d: torch.Tensor
    ce_d: torch.Tensor
    wg2_d: torch.Tensor
    cd_m: torch.Tensor
    ch_m: torch.Tensor
    ce_m: torch.Tensor
    wg2_m: torch.Tensor
    rhoa: torch.Tensor
    # derived fluxes (asflux fills them)
    swa: torch.Tensor      # net shortwave into the surface [W m-2]
    nsf: torch.Tensor      # non-solar flux [W m-2]
    dfl: torch.Tensor      # d(nsf)/dT [W m-2 K-1]
    eva: torch.Tensor      # evaporation [kg m-2 s-1]
    lip: torch.Tensor      # liquid precipitation
    sop: torch.Tensor      # solid precipitation
    ustarw: torch.Tensor   # open-water friction velocity [m s-1]
    taufac: torch.Tensor   # wind stress correction factor
    abswnd: torch.Tensor   # wind speed at zu [m s-1]
    alb: torch.Tensor      # grid-cell mean albedo


def init_ben02(shape, dtype=torch.float64, device=None) -> Ben02State:
    """Initial coefficients and zero fluxes on `device` (CUDA unless the
    caller names one)."""
    from ..drivers.standalone import _device
    H = tuple(shape)
    dev = _device(device)

    def f(v):
        return torch.full(H, v, dtype=dtype, device=dev)
    return Ben02State(cd_d=f(1.e-3), ch_d=f(1.e-3), ce_d=f(1.e-3),
                      wg2_d=f(1.e-4), cd_m=f(1.e-3), ch_m=f(1.e-3),
                      ce_m=f(1.e-3), wg2_m=f(1.e-4), rhoa=f(1.3),
                      swa=f(0.), nsf=f(0.), dfl=f(-20.), eva=f(0.),
                      lip=f(0.), sop=f(0.), ustarw=f(0.), taufac=f(1.),
                      abswnd=f(5.), alb=f(.065))


def _where(cond, a, b, like):
    """torch.where(cond, a, b) of two numbers, in `like`'s dtype."""
    return torch.where(cond, torch.full_like(like, a), b)


def asflux(e: eos.EosParams, b: Ben02State, c: Ben02Clim,
           ice: si.SeaiceState, tml, sml) -> Ben02State:
    """Recover the atmospheric state from the prescribed fluxes and
    compute the heat and freshwater fluxes over the model's surface
    state (mod_ben02.F90:1690-1830); returns a new Ben02State.

    tml/sml: the model's top-layer temperature [K] and salinity."""
    tice_f = eos.tfrz(e, sml) + T0DEG
    fice = ice.ficem
    tsi = ice.ticem

    # the atmospheric state consistent with the dataset fluxes over the
    # dataset surface state
    tml_d = torch.maximum(c.tsrf_d, tice_f)
    tsi_d = torch.clamp((c.tsrf_d - (1. - c.rice) * tml_d)
                        / torch.clamp(c.rice, min=1.e-6), min=200.)
    qsrf_d = (c.rice * qsati(tsi_d, c.slpr)
              + (1. - c.rice) * qsatw(tml_d, c.slpr))
    le = (2.501 - 0.00237 * (c.tsrf_d - 273.15)) * 1.e6

    dtmax, dqmax = 30., 0.05   # mod_ben02's limits on the recovered state
    sa0 = torch.maximum(
        torch.abs(c.shtfl) / (b.rhoa * CPAIR * b.ch_d * dtmax),
        torch.abs(c.lhtfl) / (b.rhoa * le * b.ce_d * dqmax))
    tau_d = torch.maximum(c.tau_d, b.rhoa * b.cd_d * sa0 * sa0)

    cd_d, ch_d, ce_d, wg2_d = b.cd_d, b.ch_d, b.ce_d, b.wg2_d
    rhoa = b.rhoa

    def atm_state(cd_d, ch_d, ce_d, wg2_d, rhoa):
        r = tau_d / (rhoa * cd_d)
        ua = torch.sqrt(.5 * (-wg2_d + torch.sqrt(
            wg2_d * wg2_d + 4. * (r * r))))
        sa = torch.sqrt(ua * ua + wg2_d)
        ta = c.tsrf_d - .0098 * ZT - c.shtfl / (rhoa * CPAIR * ch_d * sa)
        qa = qsrf_d - c.lhtfl / (rhoa * le * ce_d * sa)
        return ua, sa, ta, qa

    ua, sa, ta, qa = atm_state(cd_d, ch_d, ce_d, wg2_d, rhoa)
    rhoa = rhoair(ta, qa, c.slpr)
    for _ in range(TCITER):
        cd_d, ch_d, ce_d, wg2_d = btf.bulktf(
            ua, ZU, ta, ZT, qa, ZQ, c.tsrf_d, qsrf_d, c.rice,
            cd_d, ch_d, ce_d, wg2_d)
        ua, sa, ta, qa = atm_state(cd_d, ch_d, ce_d, wg2_d, rhoa)
        rhoa = rhoair(ta, qa, c.slpr)

    # transfer coefficients over the model's surface state
    tsrf_m = fice * tsi + (1. - fice) * tml
    qsrf_m = (fice * qsati(tsi, c.slpr)
              + (1. - fice) * qsatw(tml, c.slpr))
    cd_m, ch_m, ce_m, wg2_m = b.cd_m, b.ch_m, b.ce_m, b.wg2_m
    for _ in range(TCITER):
        cd_m, ch_m, ce_m, wg2_m = btf.bulktf(
            ua, ZU, ta, ZT, qa, ZQ, tsrf_m, qsrf_m, fice,
            cd_m, ch_m, ce_m, wg2_m)

    sa = torch.sqrt(ua * ua + wg2_m)
    taufac = rhoa * cd_m * sa * ua / torch.clamp(tau_d, min=1.e-12)
    ustarw = torch.sqrt(cd_m * sa * ua * rhoa / RHOWAT)

    ta3 = ta * ta * ta
    swa = c.dswrf * (1. - b.alb)
    le_m = (2.501 - .00237 * (tsrf_m - 273.15)) * 1.e6
    nsf = (rhoa * CPAIR * ch_m * sa * (ta + 0.0098 * ZT - tsrf_m)
           + rhoa * ce_m * le_m * sa * (qa - qsrf_m)
           - c.nlwrs - 4. * EMISS * STEFANB * ta3
           * (tsrf_m - c.tsrf_d))
    eva = rhoa * ce_m * sa * (qa - qsrf_m)
    dqsrf_m = (fice * dqsati(tsi, c.slpr)
               + (1. - fice) * dqsatw(tml, c.slpr))
    dfl = (-rhoa * CPAIR * ch_m * sa
           - rhoa * ce_m * le_m * sa * dqsrf_m
           - 4. * EMISS * STEFANB * ta3)

    cold = ta < T0DEG
    lip = torch.where(cold, 0., c.prcp)
    sop = torch.where(cold, c.prcp, 0.)

    return dataclasses.replace(
        b, cd_d=cd_d, ch_d=ch_d, ce_d=ce_d, wg2_d=wg2_d,
        cd_m=cd_m, ch_m=ch_m, ce_m=ce_m, wg2_m=wg2_m, rhoa=rhoa,
        swa=swa, nsf=nsf, dfl=dfl, eva=eva, lip=lip, sop=sop,
        ustarw=ustarw, taufac=taufac, abswnd=sa)


def thermf_ben02(grid: Grid, e: eos.EosParams, b: Ben02State,
                 c: Ben02Clim, ice: si.SeaiceState,
                 dp1, temp1, saln1, p1, swfc2, swal2, dt,
                 nrfets: float = 10.):
    """The thermodynamic ice/snow slab step and the surface flux
    assembly (thermf_ben02, mod_thermf_ben02.F90:65-703).

    dp1/temp1/saln1: top-layer thickness [Pa], temperature [C] and
    salinity at the new time level; p1: the surface pressure interface.
    Returns (a new ice state, a dict of the fluxes surflx, sswflx,
    salflx, brnflx, ustar, alb, fmltfz and rnf, in BLOM's signs)."""
    hotl = torch.clamp(dp1, min=1.e-6) / onem
    totl = temp1 + T0DEG
    sotl = saln1

    fice0, hice0, hsnw0 = ice.ficem, ice.hicem, ice.hsnwm
    tsrf0 = ice.tsrfm

    tice_f = eos.tfrz(e, sotl, p1) + T0DEG
    hice_min = _where(grid.plat > 0., si.hice_nhmn, si.hice_shmn, fice0)

    bare = fice0 * hice0 < 1.e-5

    # ---------------- the ice-slab branch (:180-292) -----------------
    snowy = fice0 * hsnw0 > 1.e-3
    albi_h = .065 + .44 * torch.clamp(hice0, min=0.) ** .28
    albi = torch.where(
        snowy,
        _where(tsrf0 > si.tsnw_m - .1, si.albs_m, si.albs_f, fice0),
        torch.where(tsrf0 > si.tice_m - .1,
                    torch.clamp(albi_h, max=si.albi_m),
                    torch.clamp(albi_h, max=si.albi_f)))
    tsmlt = _where(snowy, si.tsnw_m, si.tice_m, fice0)

    alb = torch.where(bare, c.albw, albi * fice0 + c.albw * (1. - fice0))
    qswi = b.swa * (1. - albi) / torch.clamp(1. - alb, min=1.e-6)
    qsww_ice = b.swa * (1. - c.albw) / torch.clamp(1. - alb, min=1.e-6)

    # snowfall
    dh = b.sop * dt / si.rhosnw
    hsnw = hsnw0 + dh
    qsnwf = dh * si.fuss / dt

    fcond = _rdiv(si.rkice * si.rksnw,
                  si.rksnw * hice0 + si.rkice * hsnw + 1.e-12)
    tsi = ice.ticem
    denom = fcond - b.dfl * (2. - fice0)
    degen = torch.abs(denom) < 1.e-3
    tsrf_slab = torch.where(
        degen,
        tice_f + (qswi + b.nsf) / torch.clamp(fcond, min=1.e-9),
        (qswi + b.nsf - b.dfl * (tsi + (1. - fice0) * totl)
         + fcond * tice_f) / torch.where(degen, 1., denom))
    qnsw_slab = torch.where(
        degen, b.nsf,
        b.nsf + b.dfl * fice0 * (totl - torch.minimum(tsrf_slab, tsmlt)))
    qdamp = torch.where(
        degen, 0., b.dfl * (torch.minimum(tsrf_slab, tsmlt) - tsi))

    melting = tsrf_slab > tsmlt
    qsmlt = torch.where(
        melting,
        qswi + b.nsf + b.dfl * ((1. - fice0) * (tsmlt - totl)
                                + tsmlt - tsi)
        + fcond * (tice_f - tsmlt), 0.)
    tsrf_slab = torch.minimum(tsrf_slab, tsmlt)

    tice_slab = tice_f - fcond * (tice_f - tsrf_slab) * hice0 / si.rkice

    qo2i = (RHOWAT * SPCIFH * si.cwi
            * torch.clamp(ice.ustari, min=.2e-2)
            * torch.clamp(tice_f - totl, max=0.)
            + si.cuc * torch.clamp(tice_f - totl, min=0.))
    qbot = -fcond * (tice_f - tsrf_slab) - qo2i - qdamp + qsnwf

    # snow melt
    dh = -qsmlt * dt / si.fuss
    snow_gone = hsnw + dh < 0.
    qsmlt = torch.where(snow_gone, qsmlt - hsnw * si.fuss / dt, 0.)
    hsnw = torch.where(snow_gone, 0., hsnw + dh)

    hice = torch.clamp(hice0 - (qbot + qsmlt) * dt / si.fusi, min=0.)

    # snow aging and the Archimedes conversion
    sag_fac = math.exp(-si.sagets * dt)
    hice = hice + hsnw * (1. - sag_fac) * si.rhosnw / si.rhoice
    hsnw = hsnw * sag_fac
    dh = (hsnw * si.rhosnw - hice * (RHOWAT - si.rhoice)) / RHOWAT
    pos = dh > 0.
    hice = torch.where(pos, hice + dh, hice)
    hsnw = torch.where(pos, hsnw - dh * si.rhoice / si.rhosnw, hsnw)

    # the slab and bare branches merged
    fice = torch.where(bare, 0., fice0)
    hice = torch.where(bare, 0., hice)
    hsnw = torch.where(bare, 0., hsnw)
    tsrf = torch.where(bare, totl, tsrf_slab)
    tice = torch.where(bare, totl, tice_slab)
    qsww = torch.where(bare, b.swa, qsww_ice)
    qnsw = torch.where(bare, b.nsf, qnsw_slab)

    # -------------- the open-water fraction (:300-340) ---------------
    swfac = 1. - swfc2 * torch.exp(-hotl / torch.clamp(swal2, min=1.e-6))
    dtml = (swfac * qsww + qnsw) * 2. * dt / (SPCIFH * RHOWAT * hotl)

    freezing = totl + dtml < tice_f
    q = .5 * (tice_f - totl) * SPCIFH * RHOWAT * hotl / dt
    volice = torch.clamp(
        torch.where(freezing, -(qsww + qnsw - q) * (1. - fice) * dt
                    / si.fusi, 0.), min=0.)
    grow = volice > 1.e-11
    df = volice / hice_min
    fice_new = torch.clamp(fice + df, max=si.fice_max)
    hice = torch.where(grow, (hice * fice + volice)
                       / torch.clamp(fice_new, min=1.e-6), hice)
    hsnw = torch.where(grow, hsnw * fice / torch.clamp(fice_new, min=1.e-6),
                       hsnw)
    fice = torch.where(grow, fice_new, fice)

    warming = (~freezing) & (swfac * qsww + qnsw > 0.)
    fice_w = fice - (swfac * qsww + qnsw) * fice * dt / torch.clamp(
        hice * si.fusi + hsnw * si.fuss, min=1.e-11)
    fice = torch.where(warming, fice_w, fice)
    all_melt = fice < 0.
    fice = torch.where(all_melt, 0., fice)
    hice = torch.where(all_melt, 0., hice)
    hsnw = torch.where(all_melt, 0., hsnw)

    # ---------------- the fluxes to the ocean (:364-420) -------------
    dvi = hice * fice - hice0 * fice0
    dvs = hsnw * fice - hsnw0 * fice0

    rnf_fac = dt / (nrfets * 86400.)
    rnfres = ice.rnfres + c.rnfins * dt
    rnf = rnfres * rnf_fac / dt
    rnfres = rnfres * (1. - rnf_fac)

    fmltfz = -(dvi * si.rhoice + dvs * si.rhosnw) / dt
    fwflx = b.eva + b.lip + b.sop + rnf + fmltfz
    sfl = -si.sice * dvi * si.rhoice / dt * 1.e-3
    brnflx_dn = torch.clamp(-sotl * fmltfz * 1.e-3 + sfl, min=0.)
    vrtsfl = -sotl * fwflx * 1.e-3

    # the global virtual-salt-flux correction (:566-620): the
    # area-weighted mean over the ocean
    sref = 34.65
    util1 = -(sref * fwflx * 1.e-3 + vrtsfl) * grid.scp2 * grid.ip
    area = torch.sum(grid.scp2 * grid.ip)
    sflxc = torch.sum(util1) / area

    salflx = -(vrtsfl + sflxc + sfl) * 1.e3     # [g m-2 s-1] up
    brnflx = -brnflx_dn * 1.e3
    hmltfz = (dvi * si.fusi + dvs * si.fuss) / dt
    # the total and shortwave heat fluxes in BLOM's units, positive up
    # (:408-416)
    surflx = -(b.swa + b.nsf + hmltfz)
    sswflx = -qsww * (1. - fice0)

    iagem = torch.where(
        fice * hice < 1.e-5, 0.,
        (ice.iagem + dt / 86400.)
        * (1. - torch.clamp(dvi, min=0.)
           / torch.clamp(fice * hice, min=1.e-11)))

    ustar = (torch.clamp(ice.ustari, max=.8e-2) * fice0
             + b.ustarw * (1. - fice0))

    mask = grid.ip > 0.

    def msk(a, old):
        return torch.where(mask, a, old)

    new_ice = dataclasses.replace(
        ice, ficem=msk(fice, ice.ficem), hicem=msk(hice, ice.hicem),
        hsnwm=msk(hsnw, ice.hsnwm), tsrfm=msk(tsrf, ice.tsrfm),
        ticem=msk(tice, ice.ticem), iagem=msk(iagem, ice.iagem),
        rnfres=msk(rnfres, ice.rnfres))
    flx = {'surflx': surflx * grid.ip, 'sswflx': sswflx * grid.ip,
           'salflx': salflx * grid.ip, 'brnflx': brnflx * grid.ip,
           'ustar': ustar * grid.ip, 'alb': alb * grid.ip,
           'fmltfz': fmltfz * grid.ip, 'rnf': rnf * grid.ip}
    return new_ice, flx


def sfcstr_ben02(grid: Grid, b: Ben02State, c: Ben02Clim,
                 ice: si.SeaiceState):
    """The surface stress: wind stress and ice-ocean stress blended by
    the ice cover (sfcstr_ben02, mod_sfcstr_ben02.F90:34-71).  The
    dataset's stress magnitude, corrected by taufac, along the dataset's
    wind unit vector.  Returns (taux, tauy)."""
    wmag = torch.sqrt(c.uwnd * c.uwnd + c.vwnd * c.vwnd)
    ztx = b.taufac * c.tau_d * c.uwnd / torch.clamp(wmag, min=1.e-6)
    mty = b.taufac * c.tau_d * c.vwnd / torch.clamp(wmag, min=1.e-6)

    fice_u = (ice.ficem + grid.im1(ice.ficem)) \
        * torch.clamp(ice.hicem + grid.im1(ice.hicem), max=2.) * .25
    fice_v = (ice.ficem + grid.jm1(ice.ficem)) \
        * torch.clamp(ice.hicem + grid.jm1(ice.hicem), max=2.) * .25
    taux = ((ztx + grid.im1(ztx)) * .5 * (1. - fice_u)
            + ice.tauxice * fice_u) * grid.iu
    tauy = ((mty + grid.jm1(mty)) * .5 * (1. - fice_v)
            + ice.tauyice * fice_v) * grid.iv
    return taux, tauy
