"""Vertical mixing coefficients and surface-flux penetration (ALE path).

Counterpart of the CVMix-lite part of `blom_tpu/phys/vmix.py`
(mod_blom_step.F90:196-207): `ale_forcing` (mod_ale_forcing.F90, the
shortwave and brine penetration factors and the interface buoyancy flux)
and `difest_vertical` (mod_difest.F90 difest_vertical_hybrid): LMD94
shear instability, a constant background and convective enhancement,
with the surface fluxes collapsed into the top layer, and the
tidal-dissipation term (VmixParams.twedon, with phys/tidaldissip.py);
and `difest_vertical_kpp` (VmixParams.use_kpp, chosen by the step): the
KPP ocean boundary layer (LMD94 / CVMix_kpp) with its bulk-Richardson
depth, similarity velocity scales, cubic shape-function diffusivities,
the nonlocal transport of destabilizing surface fluxes and the Langmuir
enhancement (Forcing.lamult)."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import alpha0, epsilp, grav, onem, onemu, spcifh
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..dynamics.cmnfld import mixed_layer_depth
from .forcing import Forcing
from .swabs import SwabsFields, swamxd
from .tidaldissip import tidal_diffusivity


class VmixParams(NamedTuple):
    use_kpp: bool = False     # full KPP OBL scheme (difest_vertical_kpp)
    bdmc2: float = 1.e-5      # background diapycnal diffusivity [m2 s-1]
    nubmin: float = 1.e-6     # minimum background viscosity [m2 s-1]
    nu_shear0: float = 5.e-3  # LMD94 max shear diffusivity [m2 s-1]
    ri0: float = .7           # LMD94 critical Richardson number
    kv_conv: float = .1       # convective-instability diffusivity [m2 s-1]
    visc_bg: float = 1.e-4    # background viscosity [m2 s-1]
    brine_mlbase_frac: float = 1.0
    # tidal-dissipation mixing (tdmflg, mod_difest.F90:2929-2941):
    # twedon = tidal wave energy dissipation over bottom N [kg s-2], a
    # float or a (jdm, idm) tensor (phys.tidaldissip); None disables it
    twedon: object = None
    tdmmax: float = .1        # cap on the tidal diffusivity [m2 s-1]


@dataclasses.dataclass
class VmixFields:
    """Interface mixing coefficients and penetration factors.

    Kvisc_m/Kdiff_t/Kdiff_s: (kk, H), index k = interface above layer k
    (index 0 unused); *_nonloc: (kk+1, H) cumulative flux-penetration
    factors; buoyfl: (kk+1, H) interface buoyancy flux [m2 s-3]."""
    Kvisc_m: torch.Tensor
    Kdiff_t: torch.Tensor
    Kdiff_s: torch.Tensor
    t_sw_nonloc: torch.Tensor
    s_br_nonloc: torch.Tensor
    t_ns_nonloc: torch.Tensor
    s_nb_nonloc: torch.Tensor
    t_rs_nonloc: torch.Tensor
    s_rs_nonloc: torch.Tensor
    buoyfl: torch.Tensor
    mld: torch.Tensor          # mixed layer depth [m]


def _surface_collapsed(kk, shape, dtype, device):
    nl = torch.zeros((kk + 1,) + tuple(shape), dtype=dtype, device=device)
    nl[0] = 1.0
    return nl


def _minimum(a, b):
    """jnp.minimum for a Python float or tensor `a` and a tensor `b`."""
    if isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(b, max=a)


def _penetration_profile(p, dp, pmax, raw):
    """Penetration profile with its below-column remainder absorbed
    linearly in pressure over the column above
    (mod_ale_forcing.F90:96-117)."""
    active = p[1:] <= pmax                      # interface k+1 receives flux
    p_cap = _minimum(pmax, p[-1])
    below = torch.cat([torch.zeros_like(active[:1]), ~active], 0)
    first_below = torch.cumsum(below.to(torch.int32), 0) == 1
    nlbot = torch.where(first_below, raw, 0.).sum(0)
    has_below = first_below.any(0)
    nlbot = torch.where(has_below, nlbot, raw[-1])
    p_capc = torch.where(
        has_below,
        _minimum(pmax, torch.where(first_below, p, 0.).sum(0)), p_cap)
    pmaxi = 1.0 / torch.clamp(p_capc, min=epsilp)

    interior = torch.cat([torch.ones_like(active[:1]), active], 0)
    nl = torch.where(interior, raw - nlbot * p * pmaxi * (p > 0.), 0.)
    nl[0] = 1.0
    return nl


def ale_forcing(grid: Grid, e: eos.EosParams, s: State, forcing: Forcing,
                swabs: SwabsFields, par: VmixParams, n: int, mld) -> dict:
    """Penetration factors and buoyancy flux
    (mod_ale_forcing.F90:45-223)."""
    dp = s.dp[n]
    p = cumulative_p(dp) * grid.ip

    # shortwave penetration (:54-120)
    pmax_sw = swamxd * onem
    lei1 = 1.0 / (swabs.swal1 * onem)
    lei2 = 1.0 / (swabs.swal2 * onem)
    p_sw = torch.clamp(p, max=pmax_sw)
    raw_sw = (swabs.swfc1 * torch.exp(-lei1 * p_sw)
              + swabs.swfc2 * torch.exp(-lei2 * p_sw))
    raw_sw[0] = 1.0
    t_sw = _penetration_profile(p, dp, pmax_sw, raw_sw)

    # brine penetration (:122-176)
    cbra1 = 2.0 ** (1.0 / 3.0)
    cbra2 = cbra1 * cbra1 / 12.0
    mldp = torch.clamp(mld, min=1.0) * onem
    pmax_br = cbra1 * mldp
    q = torch.clamp(p / mldp, max=cbra1)
    q_c = q / cbra1
    q3 = q * q * q
    q_c3 = q_c * q_c * q_c
    fb = par.brine_mlbase_frac
    raw_br = (fb * (1. - cbra2 * q * q3 * (7. - 2. * q3))
              + (1. - fb) * (1. - q + q_c3 * q_c3
                             * (6. * cbra1 - 7. - (5. * cbra1 - 6.) * q_c)))
    raw_br[0] = 1.0
    s_br = _penetration_profile(p, dp, pmax_br, raw_br)

    # buoyancy flux (:178-214)
    cpi = 1.0 / spcifh
    gaa = grav * alpha0 * alpha0
    t1, s1 = s.temp[n][0], s.saln[n][0]
    dsgdt = eos.dsigdt0(e, t1, s1)
    dsgds = eos.dsigds0(e, t1, s1)
    buoyfl = -(dsgdt * t_sw * forcing.sswflx * cpi
               + dsgds * s_br * forcing.brnflx) * gaa
    buoyfl[0] = -(dsgdt * forcing.surflx * cpi
                  + dsgds * forcing.salflx) * gaa
    return dict(t_sw_nonloc=t_sw, s_br_nonloc=s_br, buoyfl=buoyfl)


def _tidal_term(grid: Grid, par: VmixParams, dp, p, n2):
    """Tidally driven diapycnal diffusivity at the interior interfaces
    (mod_difest.F90:2929-2941): the bottom-intensified structure times
    the local dissipation twedon * N_bottom, over N^2.  (kk-1, H), aligned
    with the interior-interface diffusivities."""
    # thickness-weighted mean BV frequency over the bottom dpnbav
    # (mod_difest.F90:193,2686-2706)
    dpnbav = 250. * onem
    # layer-mean N^2 from the adjacent interface values
    n2_pad = torch.cat([n2[:1], n2, n2[-1:]], 0)               # (kk+1, H)
    n2_layer = .5 * (n2_pad[:-1] + n2_pad[1:])
    bvf_layer = torch.sqrt(torch.clamp(n2_layer, min=0.))
    pbot = p[-1]
    q = torch.clamp(p[1:] - torch.maximum(pbot[None] - dpnbav, p[:-1]),
                    min=0.)
    dps = torch.sum(q, 0)
    bvfbot = torch.sum(bvf_layer * q, 0) / torch.clamp(dps, min=epsilp)
    bvfsq_layer = torch.clamp(n2_layer, min=1.e-12)
    ktid_layer = tidal_diffusivity(
        torch.as_tensor(par.twedon, dtype=dp.dtype, device=dp.device),
        bvfbot, bvfsq_layer, p, dp, grav, plat=grid.plat)       # (kk, H)
    ktid = .5 * (ktid_layer[:-1] + ktid_layer[1:])              # (kk-1, H)
    return torch.clamp(ktid, 0., par.tdmmax)


def difest_vertical(grid: Grid, e: eos.EosParams, s: State,
                    forcing: Forcing, swabs: SwabsFields,
                    par: VmixParams, n: int) -> VmixFields:
    """Interface mixing coefficients (CVMix-lite, difest_vertical_hybrid
    of mod_difest.F90): LMD94 shear instability, constant background and
    convective enhancement, plus the tidal term when par.twedon is set.
    par.use_kpp is not read here: the step chooses the estimator."""
    dp = s.dp[n]
    sig = s.sigma[n]
    p = cumulative_p(dp) * grid.ip

    mld = mixed_layer_depth(e, s.temp[n], s.saln[n], p, dp)

    # interface N^2 and shear^2 (interfaces above layers 1..kk-1)
    dp_mid = torch.clamp(.5 * (dp[:-1] + dp[1:]), min=onemu)
    n2 = grav * grav * (sig[1:] - sig[:-1]) / dp_mid

    u_p = .5 * (s.u[n] + grid.ip1(s.u[n]))
    v_p = .5 * (s.v[n] + grid.jp1(s.v[n], 'v', True))
    dz = dp_mid * alpha0 / grav
    du, dv = u_p[1:] - u_p[:-1], v_p[1:] - v_p[:-1]
    shear2 = (du * du + dv * dv) / (dz * dz)

    ri = n2 / torch.clamp(shear2, min=1e-14)
    x = torch.clamp(ri / par.ri0, 0., 1.)
    t = 1. - x * x
    nu_shear = par.nu_shear0 * (t * (t * t))
    conv = (n2 < 0.).to(n2.dtype) * par.kv_conv

    kdiff = nu_shear + conv + par.bdmc2
    kvisc = torch.clamp(nu_shear + conv + par.visc_bg, min=par.nubmin)

    if par.twedon is not None:
        # tidal-dissipation energy enters the TRACER diffusivity only
        # (difdia, mod_difest.F90:2954); momentum viscosity is untouched
        kdiff = kdiff + _tidal_term(grid, par, dp, p, n2)

    zero_top = torch.zeros_like(kdiff[:1])
    Kdiff = torch.cat([zero_top, kdiff], 0) * grid.ip
    Kvisc = torch.cat([zero_top, kvisc], 0) * grid.ip

    nl_surface = _surface_collapsed(grid.kk, grid.shape, dp.dtype,
                                    dp.device) * grid.ip
    pen = ale_forcing(grid, e, s, forcing, swabs, par, n, mld)
    return VmixFields(
        Kvisc_m=Kvisc, Kdiff_t=Kdiff, Kdiff_s=Kdiff,
        t_sw_nonloc=pen['t_sw_nonloc'], s_br_nonloc=pen['s_br_nonloc'],
        t_ns_nonloc=nl_surface, s_nb_nonloc=nl_surface,
        t_rs_nonloc=nl_surface, s_rs_nonloc=nl_surface,
        buoyfl=pen['buoyfl'], mld=mld)


# ------------------------------------------------------------------ #
# KPP ocean boundary layer (LMD94 / CVMix_kpp equivalent)
# ------------------------------------------------------------------ #

KAPPA = 0.4
# LMD94 similarity constants (CVMix defaults; cvmix_kpp)
ZETA_M, A_M, C_M = -0.2, 1.257, 8.360
ZETA_S, A_S, C_S = -1.0, -28.86, 98.96
RIC = 0.3           # critical bulk Richardson number
CV_T2 = 1.6         # turbulent-shear coefficient Cv
EPS_SL = 0.1        # surface-layer fraction epsilon
BETA_T = -0.2       # entrainment flux ratio
CS_NONLOC = 10.     # nonlocal transport coefficient C*


def turb_velocity_scales(sigma, hbl, ustar, bfsfc):
    """LMD94 turbulent velocity scales w_m, w_s (phi-function similarity;
    CVMix cvmix_kpp_compute_turbulent_scales as difest_vertical_hybrid
    uses it, mod_difest.F90:1085-1140)."""
    um = torch.clamp(ustar, min=1.e-8)
    ust3 = um * (um * um)
    sig_eff = torch.where(bfsfc < 0., torch.clamp(sigma, max=EPS_SL), sigma)
    zeta = sig_eff * hbl * KAPPA * bfsfc / ust3
    ku = KAPPA * torch.clamp(ustar, min=1.e-8)
    # stable
    w_st = ku / (1. + 5. * torch.clamp(zeta, min=0.))
    # unstable
    zm = torch.clamp(zeta, max=0.)
    wm_u = torch.where(zm > ZETA_M,
                       ku * torch.pow(1. - 16. * zm, .25),
                       ku * torch.pow(A_M - C_M * zm, 1. / 3.))
    ws_u = torch.where(zm > ZETA_S,
                       ku * torch.sqrt(1. - 16. * zm),
                       ku * torch.pow(A_S - C_S * zm, 1. / 3.))
    wm = torch.where(zeta >= 0., w_st, wm_u)
    ws = torch.where(zeta >= 0., w_st, ws_u)
    return wm, ws


def bulk_richardson_obl(grid: Grid, e: eos.EosParams, s: State, n: int,
                        ustar, bfsfc0):
    """Boundary-layer depth [m] from the bulk Richardson number criterion
    (LMD94 eq. 21; CVMix cvmix_kpp_compute_bulk_Richardson and
    OBL_depth), and the interface buoyancy frequency."""
    kk = grid.kk
    dp = s.dp[n]
    p = cumulative_p(dp) * grid.ip
    z_mid = (p[:-1] + .5 * dp) / onem                  # (kk, H) [m]

    # buoyancy of each layer relative to the surface layer
    sig0v = eos.sig0(e, s.temp[n], s.saln[n])
    b = -grav * alpha0 * sig0v
    br = b[0]

    u_p = .5 * (s.u[n] + grid.ip1(s.u[n])) + s.ub[n][None]
    v_p = .5 * (s.v[n] + grid.jp1(s.v[n], 'v', True)) + s.vb[n][None]
    du, dv = u_p[0][None] - u_p, v_p[0][None] - v_p
    dv2 = du * du + dv * dv

    # interface N (for the turbulent shear term)
    dp_mid = torch.clamp(.5 * (dp[:-1] + dp[1:]), min=onemu)
    n2 = grav * grav * (sig0v[1:] - sig0v[:-1]) / dp_mid
    n_freq = torch.sqrt(torch.clamp(n2, min=0.))
    n_lyr = torch.cat([n_freq[:1], n_freq], 0)

    # ws at sigma = 1 with h = z (LMD94's Vt2 takes the local depth)
    _, ws = turb_velocity_scales(torch.ones_like(z_mid), z_mid,
                                 ustar[None], bfsfc0[None])
    cvt2 = (CV_T2 * math.sqrt(-BETA_T / (C_S * EPS_SL))
            / (RIC * KAPPA ** 2))
    vt2 = torch.clamp(cvt2 * z_mid * n_lyr * ws, min=1.e-10)

    # deeper, denser water has lower b: br - b >= 0 where stable
    rib = z_mid * grav * alpha0 * torch.clamp(br[None] - b, min=0.) \
        / (dv2 + vt2)
    supercrit = rib > RIC
    # the first supercritical layer (argmax returns the first maximum)
    first = torch.argmax(supercrit.to(torch.int32), 0)
    any_sc = supercrit.any(0)
    zz = torch.gather(z_mid, 0, first[None])[0]
    hbl = torch.where(any_sc, zz, p[kk] / onem)
    return torch.clamp(hbl, min=1.), n_freq


def kpp_boundary_layer(grid: Grid, hbl, ustar, bfsfc0, p_i):
    """KPP diffusivity and viscosity inside the boundary layer and the
    nonlocal transport profile (LMD94 eq. 19-20, 28; CVMix
    cvmix_coeffs_kpp).  Returns (Km, Ks, nl): (kk, H), (kk, H) with the
    surface interface 0, and (kk+1, H) with 1 at the surface."""
    z_if = p_i / onem                                  # (kk+1, H)
    # interior interfaces 1..kk-1, as Kdiff[k] = interface above layer k
    z_int = z_if[1:-1]                                 # (kk-1, H)
    hbl1 = torch.clamp(hbl, min=1.)[None]
    sigma = torch.clamp(z_int / hbl1, 0., 1.)
    wm, ws = turb_velocity_scales(sigma, hbl[None], ustar[None],
                                  bfsfc0[None])
    one_m = 1. - sigma
    G = sigma * (one_m * one_m)                        # shape function
    inside = z_int < hbl[None]
    Km = torch.where(inside, hbl[None] * wm * G, 0.)
    Ks = torch.where(inside, hbl[None] * ws * G, 0.)
    ztop = torch.zeros_like(Km[:1])
    Km = torch.cat([ztop, Km], 0)                      # (kk, H)
    Ks = torch.cat([ztop, Ks], 0)

    # nonlocal transport: cumulative fraction profile (1 at the surface,
    # 0 below the OBL), active only under destabilizing forcing
    sig_all = torch.clamp(z_if[1:] / hbl1, 0., 1.)
    unstable = (bfsfc0 > 0.)[None]
    one_a = 1. - sig_all
    nl = torch.where(unstable & (z_if[1:] < hbl[None]), one_a * one_a, 0.)
    nl = torch.cat([torch.ones_like(nl[:1]), nl], 0)
    return Km, Ks, nl


def difest_vertical_kpp(grid: Grid, e: eos.EosParams, s: State,
                        forcing: Forcing, swabs: SwabsFields,
                        par: VmixParams, n: int,
                        lamult=None) -> VmixFields:
    """Full KPP vertical mixing (difest_vertical_hybrid with CVMix_kpp,
    mod_difest.F90:900-1200): the interior LMD94 shear and background,
    the boundary-layer profile on the bulk-Richardson OBL depth (mld),
    and the nonlocal redistribution of the non-shortwave surface fluxes.
    The boundary-layer coefficients are multiplied by the Langmuir
    factor `lamult`, or else by forcing.lamult."""
    base = difest_vertical(grid, e, s, forcing, swabs, par, n)

    # surface friction velocity from the wind stress
    taux_p = .5 * (forcing.taux + grid.ip1(forcing.taux))
    tauy_p = .5 * (forcing.tauy + grid.jp1(forcing.tauy, 'v', True))
    ustar = torch.sqrt(torch.sqrt(taux_p * taux_p + tauy_p * tauy_p)
                       / 1000.)

    # surface buoyancy flux; positive (a buoyancy loss) destabilizes in
    # ale_forcing's sign convention
    bfsfc0 = base.buoyfl[0]

    hbl, _ = bulk_richardson_obl(grid, e, s, n, ustar, bfsfc0)
    p_i = cumulative_p(s.dp[n]) * grid.ip
    Km_bl, Ks_bl, nl = kpp_boundary_layer(grid, hbl, ustar, bfsfc0, p_i)
    if lamult is None and getattr(forcing, 'lamult', None) is not None:
        lamult = forcing.lamult
    if lamult is not None:
        # Langmuir enhancement of the boundary-layer coefficients (the
        # wave coupler's Sw_lamult, mod_cesm.F90)
        Km_bl = Km_bl * lamult[None]
        Ks_bl = Ks_bl * lamult[None]

    Kvisc = torch.maximum(base.Kvisc_m, Km_bl * grid.ip)
    Kdiff = torch.maximum(base.Kdiff_t, Ks_bl * grid.ip)
    return dataclasses.replace(
        base, Kvisc_m=Kvisc, Kdiff_t=Kdiff, Kdiff_s=Kdiff,
        t_ns_nonloc=nl * grid.ip, s_nb_nonloc=nl * grid.ip, mld=hbl)
