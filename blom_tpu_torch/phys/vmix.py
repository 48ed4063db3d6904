"""Vertical mixing coefficients and surface-flux penetration (ALE path).

Counterpart of the CVMix-lite part of `blom_tpu/phys/vmix.py`
(mod_blom_step.F90:196-207): `ale_forcing` (mod_ale_forcing.F90, the
shortwave and brine penetration factors and the interface buoyancy flux)
and `difest_vertical` (mod_difest.F90 difest_vertical_hybrid): LMD94
shear instability, a constant background and convective enhancement,
with the surface fluxes collapsed into the top layer.  The KPP boundary
layer (VmixParams.use_kpp) and the tidal-dissipation term (twedon) are
not ported."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import alpha0, epsilp, grav, onem, onemu, spcifh
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..dynamics.cmnfld import mixed_layer_depth
from .forcing import Forcing
from .swabs import SwabsFields, swamxd


class VmixParams(NamedTuple):
    use_kpp: bool = False     # full KPP OBL scheme (not ported)
    bdmc2: float = 1.e-5      # background diapycnal diffusivity [m2 s-1]
    nubmin: float = 1.e-6     # minimum background viscosity [m2 s-1]
    nu_shear0: float = 5.e-3  # LMD94 max shear diffusivity [m2 s-1]
    ri0: float = .7           # LMD94 critical Richardson number
    kv_conv: float = .1       # convective-instability diffusivity [m2 s-1]
    visc_bg: float = 1.e-4    # background viscosity [m2 s-1]
    brine_mlbase_frac: float = 1.0
    # tidal-dissipation mixing (tdmflg); None disables it, as it must be
    # here (not ported)
    twedon: object = None
    tdmmax: float = .1


def unported_vmix(par: VmixParams) -> list:
    """The vertical-mixing options set in `par` that the port does not
    run."""
    missing = []
    if par.use_kpp:
        missing.append('KPP vertical mixing (vmix.use_kpp)')
    if par.twedon is not None:
        missing.append('tidal-dissipation mixing (vmix.twedon)')
    return missing


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


def difest_vertical(grid: Grid, e: eos.EosParams, s: State,
                    forcing: Forcing, swabs: SwabsFields,
                    par: VmixParams, n: int) -> VmixFields:
    """Interface mixing coefficients (CVMix-lite, difest_vertical_hybrid
    of mod_difest.F90): LMD94 shear instability, constant background and
    convective enhancement."""
    missing = unported_vmix(par)
    if missing:
        raise NotImplementedError('not ported to blom_tpu_torch: '
                                  + '; '.join(missing))
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
