"""Baroclinic momentum equation.

Counterpart of `blom_tpu/dynamics/momtum.py` (BLOM's
mod_momtum.F90:215-1280) with the three vorticity schemes of `mommth`:
enstrophy-conserving (enscon), energy-conserving (enecon) and
energy-conserving with upwind-selected mass fluxes (enedis).

- the prologue: bottom drag, barotropic r.h.s., wind stress and the PGF
  time blend;
- `_uv_body` (with `potvor_field` and `coriolis_terms`): the plain
  PyTorch version of the momentum stencil kernel;
- the massless-point fill loop and the time-smoothing epilogue.

`momtum_uv` dispatches the stencil core: a CUDA tensor goes through
the hand-written kernel (`momtum_cuda`), a CPU tensor through
`_uv_body`.  At promontory vorticity points dry velocities are exactly
zero, as in blom_tpu."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import grav, alpha0, epsilp, epsilpl, onem, onemm
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..phys.forcing import Forcing
from .pgforc import wpgf
from .tmsmt import wuv1, wuv2

slip = -1.0       # -1: no-slip sidewalls (mod_momtum.F90:94-96)
thkbot = 10.0     # bottom boundary layer thickness [m] (mod_momtum.F90:97)


class MomtumParams(NamedTuple):
    """Namelist viscosity/friction parameters (mod_momtum.F90:53-90)."""
    mdv2hi: float = 0.0
    mdv2lo: float = 0.0
    mdv4hi: float = 0.0
    mdv4lo: float = 0.0
    vsc2hi: float = .2
    vsc2lo: float = .2
    vsc4hi: float = 0.0
    vsc4lo: float = 0.0
    cbar: float = .05
    cb: float = .002
    mommth: str = 'enscon'


class MomtumKIn(NamedTuple):
    """Per-k (kk, jdm, idm) inputs of the stencil core."""
    u_m: torch.Tensor
    u_n: torch.Tensor
    v_m: torch.Tensor
    v_n: torch.Tensor
    dp_m: torch.Tensor
    dpu_m: torch.Tensor
    dpv_m: torch.Tensor
    p_lo: torch.Tensor     # p(k)   at p-points
    p_hi: torch.Tensor     # p(k+1)
    pu_lo: torch.Tensor    # pu(k)
    pu_hi: torch.Tensor    # pu(k+1)
    pv_lo: torch.Tensor
    pv_hi: torch.Tensor
    stress_u: torch.Tensor
    stress_v: torch.Tensor
    pgf_u: torch.Tensor
    pgf_v: torch.Tensor


class Momtum2DIn(NamedTuple):
    """(jdm, idm) inputs of the stencil core."""
    ubflxs_m: torch.Tensor
    ubflxs_n: torch.Tensor
    vbflxs_m: torch.Tensor
    vbflxs_n: torch.Tensor
    pbu_m: torch.Tensor
    pbv_m: torch.Tensor
    pbu_n: torch.Tensor
    pbv_n: torch.Tensor
    drag: torch.Tensor
    ubrhs: torch.Tensor
    vbrhs: torch.Tensor
    difwgt: torch.Tensor


def _hfharm(a, b):
    """Half harmonic mean (mod_momtum.F90:131-142)."""
    return a * b / (a + b)


def _mx(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


def _dpmx(grid: Grid, dp_m):
    """Neighbourhood thickness maxima at q points (mod_momtum.F90:355-396)."""
    im1, jm1 = grid.im1, grid.jm1
    du = grid.iu * (dp_m + im1(dp_m))
    dv = grid.iv * (dp_m + jm1(dp_m))
    return torch.clamp(_mx(du, jm1(du), dv, im1(dv)), min=8. * onem)


def potvor_field(grid: Grid, dp_m, utotm, vtotm, dpmx=None,
                 return_dpvor: bool = False):
    """Potential vorticity at q points, interior + lateral boundary
    treatment (mod_momtum.F90:473-575).  With return_dpvor, (potvor,
    dpvor): the thickness is the LYR_DPVOR diagnostic."""
    iu, iv, iq = grid.iu, grid.iv, grid.iq
    im1, ip1, jm1 = grid.im1, grid.ip1, grid.jm1
    jp1p = lambda a: grid.jp1(a, 'p')           # noqa: E731
    cutoff = onem
    if dpmx is None:
        dpmx = _dpmx(grid, dp_m)

    Vv = vtotm * grid.scvy        # zero where dry
    Uu = utotm * grid.scux
    v_e = torch.where(iv > 0, Vv, slip * im1(Vv))
    v_w = torch.where(im1(iv) > 0, im1(Vv), slip * Vv)
    u_nn = torch.where(iu > 0, Uu, slip * jm1(Uu))
    u_ss = torch.where(jm1(iu) > 0, jm1(Uu), slip * Uu)
    vort_b = (v_e - v_w - (u_nn - u_ss)) * grid.scq2i
    vort_i = (Vv - im1(Vv) - (Uu - jm1(Uu))) * grid.scq2i
    vort = torch.where(iq > 0, vort_i, vort_b)
    absvor = vort + grid.corioq

    dpvor_i = .125 * torch.maximum(
        2. * (dp_m + im1(dp_m) + jm1(dp_m) + im1(jm1(dp_m))),
        torch.maximum(torch.maximum(dpmx, im1(dpmx)),
                      torch.maximum(torch.maximum(ip1(dpmx), jm1(dpmx)),
                                    jp1p(dpmx))))
    # boundary candidates (v-section ends first, u-section ends override;
    # mod_momtum.F90:484-575 loop order)
    cand_ve = .125 * torch.maximum(4. * (dp_m + jm1(dp_m)),
                                   torch.maximum(dpmx, ip1(dpmx)))
    cand_vw = .125 * torch.maximum(4. * im1(dp_m + jm1(dp_m)),
                                   torch.maximum(im1(dpmx), dpmx))
    cand_un = .125 * torch.maximum(4. * (dp_m + im1(dp_m)),
                                   torch.maximum(dpmx, jp1p(dpmx)))
    cand_us = .125 * torch.maximum(4. * jm1(dp_m + im1(dp_m)),
                                   torch.maximum(jm1(dpmx), dpmx))
    dpvor_b = torch.full_like(dp_m, cutoff)
    dpvor_b = torch.where(iv > 0, cand_ve, dpvor_b)
    dpvor_b = torch.where(im1(iv) > 0, cand_vw, dpvor_b)
    dpvor_b = torch.where(iu > 0, cand_un, dpvor_b)
    dpvor_b = torch.where(jm1(iu) > 0, cand_us, dpvor_b)
    dpvor = torch.where(iq > 0, dpvor_i, dpvor_b)
    if return_dpvor:
        return absvor / dpvor, dpvor
    return absvor / dpvor


MOMMTHS = ('enscon', 'enecon', 'enedis')


def coriolis_terms(grid: Grid, dp_m, utotm, vtotm, uflux0, vflux0, potvor,
                   mommth: str):
    """Coriolis advection terms cau/cav of the three vorticity schemes
    (enscon/enecon/enedis, mod_momtum.F90:664-838)."""
    iu, iv = grid.iu, grid.iv
    im1, ip1, jm1 = grid.im1, grid.ip1, grid.jm1
    jp1q = lambda a: grid.jp1(a, 'q')           # noqa: E731
    jp1vv = lambda a: grid.jp1(a, 'v', True)    # noqa: E731
    if mommth == 'enscon':
        cau = .125 * (vflux0 + jp1vv(vflux0) + im1(vflux0)
                      + im1(jp1vv(vflux0))) * (potvor + jp1q(potvor)) * iu
        cav = -.125 * (uflux0 + ip1(uflux0) + jm1(uflux0)
                       + ip1(jm1(uflux0))) * (potvor + ip1(potvor)) * iv
    elif mommth == 'enecon':
        cau = .25 * ((vflux0 + im1(vflux0)) * potvor
                     + (jp1vv(vflux0) + im1(jp1vv(vflux0))) * jp1q(potvor)) \
            * iu
        cav = -.25 * ((uflux0 + jm1(uflux0)) * potvor
                      + ip1(uflux0 + jm1(uflux0)) * ip1(potvor)) * iv
    elif mommth == 'enedis':
        # the energy-conserving scheme with upwind-selected minimum and
        # maximum mass fluxes for slight dissipation
        # (mod_momtum.F90:664-712 min/max setup, :765-812 fluxes)
        uh_min, uh_max, vh_min, vh_max = enedis_fluxes(grid, dp_m, utotm,
                                                       vtotm, uflux0, vflux0)
        t1u = _upw(jp1q(potvor), utotm, jp1vv(vh_max) + im1(jp1vv(vh_max)),
                   jp1vv(vh_min) + im1(jp1vv(vh_min)), False)
        t2u = _upw(potvor, utotm, vh_max + im1(vh_max),
                   vh_min + im1(vh_min), False)
        cau = .25 * (t1u + t2u) * iu
        t1v = _upw(ip1(potvor), vtotm, ip1(uh_max) + jm1(ip1(uh_max)),
                   ip1(uh_min) + jm1(ip1(uh_min)), True)
        t2v = _upw(potvor, vtotm, uh_max + jm1(uh_max),
                   uh_min + jm1(uh_min), True)
        cav = -.25 * (t1v + t2v) * iv
    else:
        raise ValueError(f'mommth={mommth!r}: expected one of {MOMMTHS}')
    return cau, cav


def _hminmax(hc, hm):
    """The minimum and maximum of the centred mass flux hc and the
    upstream-limited one hm, hc first pulled toward hm (enedis,
    mod_momtum.F90:664-712)."""
    c1, c2, c3, slp_ = 1. - 1.5 * .5, 1. - .5, 2., .5
    hm2 = torch.where(torch.abs(hc) < .1 * torch.abs(hm), 10. * hc, hm)
    adj = torch.where(
        torch.abs(hc) < c2 * torch.abs(hm2),
        3. * hc + (1. - c2 * 3.) * hm2,
        torch.where(torch.abs(hc) <= c3 * torch.abs(hm2), hm2,
                    slp_ * hc + (1. - c3 * slp_) * hm2))
    hc2 = torch.where(torch.abs(hc) > c1 * torch.abs(hm2), adj, hc)
    return torch.minimum(hc2, hm2), torch.maximum(hc2, hm2)


def enedis_fluxes(grid: Grid, dp_m, utotm, vtotm, uflux0, vflux0):
    """(uh_min, uh_max, vh_min, vh_max): the enedis scheme's mass-flux
    bounds at u and v points."""
    im1, jm1 = grid.im1, grid.jm1
    uh_min, uh_max = _hminmax(.5 * utotm * (dp_m + im1(dp_m)), uflux0)
    vh_min, vh_max = _hminmax(.5 * vtotm * (dp_m + jm1(dp_m)), vflux0)
    return uh_min, uh_max, vh_min, vh_max


def _upw(pv, sgn, hmx, hmn, flip):
    """pv times the flux bound upstream of the advecting velocity sgn,
    the mean of both where pv*sgn is zero."""
    s_ = pv * sgn
    sel = torch.where(s_ == 0., .5 * (hmx + hmn),
                      torch.where((s_ < 0.) != flip, hmx, hmn))
    return pv * sel


def _uv_body(grid: Grid, par: MomtumParams, f: MomtumKIn, d2: Momtum2DIn,
             tsfac, delt1):
    """Plain PyTorch version of the momentum stencil kernel: total
    velocities, vorticity, deformation viscosity, momentum fluxes,
    Coriolis and bottom stress -> unfilled (u_new, v_new)
    (mod_momtum.F90:388-1152)."""
    iu, iv, iq = grid.iu, grid.iv, grid.iq
    im1, ip1, jm1, jp1 = grid.im1, grid.ip1, grid.jm1, grid.jp1
    jp1q = lambda a: grid.jp1(a, 'q')           # noqa: E731
    jp1u = lambda a: grid.jp1(a, 'u')           # noqa: E731
    jp1v = lambda a: grid.jp1(a, 'v')           # noqa: E731
    jp1uv = lambda a: grid.jp1(a, 'u', True)    # noqa: E731
    jp1vv = lambda a: grid.jp1(a, 'v', True)    # noqa: E731

    cutoff = onem
    thkbop = thkbot * onem
    u_m, u_n, v_m, v_n = f.u_m, f.u_n, f.v_m, f.v_n
    dp_m, dpu_m, dpv_m = f.dp_m, f.dpu_m, f.dpv_m
    difwgt = d2.difwgt

    def clip01(x):
        return torch.clamp(x, 0., 1.)

    def maxc(x, c):
        return torch.clamp(x, min=c)

    # ---- total velocities at mid and old levels (mod_momtum.F90:388-432)
    pbu_m_safe = maxc(d2.pbu_m * grid.scuy, epsilpl)
    pbv_m_safe = maxc(d2.pbv_m * grid.scvx, epsilpl)
    pbu_n_safe = maxc(d2.pbu_n * grid.scuy, epsilpl)
    pbv_n_safe = maxc(d2.pbv_n * grid.scvx, epsilpl)
    utotm = (u_m + d2.ubflxs_m * tsfac / pbu_m_safe) * iu
    vtotm = (v_m + d2.vbflxs_m * tsfac / pbv_m_safe) * iv
    utotn = (u_n + d2.ubflxs_n * tsfac / pbu_n_safe) * iu
    vtotn = (v_n + d2.vbflxs_n * tsfac / pbv_n_safe) * iv
    uflux0 = utotm * maxc(dpu_m, cutoff) * iu
    vflux0 = vtotm * maxc(dpv_m, cutoff) * iv

    # ---- sidewall-aware auxiliary velocities (mod_momtum.F90:434-470)
    dpu_col = f.pu_hi
    wgtja = clip01((dpu_col - jm1(d2.pbu_m))
                   / maxc(dpu_col - f.pu_lo, epsilp))
    wgtjb = clip01((dpu_col - jp1u(d2.pbu_m))
                   / maxc(dpu_col - f.pu_lo, epsilp))
    uja = (1. - wgtja) * jm1(utotn) + wgtja * slip * utotn
    ujb = (1. - wgtjb) * jp1uv(utotn) + wgtjb * slip * utotn
    dl2u = (utotn - .25 * (ip1(utotn) + im1(utotn) + uja + ujb)) * iu

    dpv_col = f.pv_hi
    wgtia = clip01((dpv_col - im1(d2.pbv_m))
                   / maxc(dpv_col - f.pv_lo, epsilp))
    wgtib = clip01((dpv_col - ip1(d2.pbv_m))
                   / maxc(dpv_col - f.pv_lo, epsilp))
    via = (1. - wgtia) * im1(vtotn) + wgtia * slip * vtotn
    vib = (1. - wgtib) * ip1(vtotn) + wgtib * slip * vtotn
    dl2v = (vtotn - .25 * (jp1vv(vtotn) + jm1(vtotn) + via + vib)) * iv

    # ---- vorticity / potential vorticity at q (mod_momtum.F90:473-575)
    potvor = potvor_field(grid, dp_m, utotm, vtotm)

    # ---- deformation fields (mod_momtum.F90:537-584)
    defor1 = ((ip1(utotn * grid.scuy) - utotn * grid.scuy)
              - (jp1vv(vtotn * grid.scvx) - vtotn * grid.scvx)) ** 2 \
        * grid.scp2i
    Vn = vtotn * grid.scvy
    Un = utotn * grid.scux
    d2_i = (im1(vib) * grid.scvy - via * im1(grid.scvy)
            + jm1(ujb) * grid.scux - uja * jm1(grid.scux)) ** 2 * grid.scq2i
    ve_n = torch.where(iv > 0, Vn, slip * im1(Vn))
    vw_n = torch.where(im1(iv) > 0, im1(Vn), slip * Vn)
    un_n = torch.where(iu > 0, Un, slip * jm1(Un))
    us_n = torch.where(jm1(iu) > 0, jm1(Un), slip * Un)
    d2_b = (ve_n - vw_n + un_n - us_n) ** 2 * grid.scq2i
    defor2 = torch.where(iq > 0, d2_i, d2_b)

    # sidewall-aware del2 neighbours (mod_momtum.F90:586-607)
    dl2uja = (1. - wgtja) * jm1(dl2u) + wgtja * slip * dl2u
    dl2ujb = (1. - wgtjb) * jp1uv(dl2u) + wgtjb * slip * dl2u
    dl2via = (1. - wgtia) * im1(dl2v) + wgtia * slip * dl2v
    dl2vib = (1. - wgtib) * ip1(dl2v) + wgtib * slip * dl2v

    # ---- Arakawa kinetic energy (mod_momtum.F90:609-663)
    ke = .25 * (grid.scu2 * utotm ** 2 + ip1(grid.scu2 * utotm ** 2)
                + grid.scv2 * vtotm ** 2 + jp1v(grid.scv2 * vtotm ** 2)) \
        * grid.scp2i

    # ---- Coriolis advection terms (mod_momtum.F90:719-784)
    cau, cav = coriolis_terms(grid, dp_m, utotm, vtotm, uflux0, vflux0,
                              potvor, par.mommth)

    # ================= u equation =================
    # deformation-dependent viscosity at u (mod_momtum.F90:790-804)
    qw = .5 * (im1(difwgt) + difwgt)
    deform_u = torch.sqrt(.5 * (defor1 + im1(defor1) + defor2
                                + jp1q(defor2)))
    vsc2u = torch.maximum(qw * par.mdv2hi + (1. - qw) * par.mdv2lo,
                          (qw * par.vsc2hi + (1. - qw) * par.vsc2lo)
                          * deform_u)
    vsc4u = torch.maximum(qw * par.mdv4hi + (1. - qw) * par.mdv4lo,
                          (qw * par.vsc4hi + (1. - qw) * par.vsc4lo)
                          * deform_u)

    # longitudinal momentum flux at p-points (mod_momtum.F90:821-836)
    vsc2u_a = torch.where(iu > 0, vsc2u, ip1(vsc2u))
    vsc2u_b = torch.where(ip1(iu) > 0, ip1(vsc2u), vsc2u)
    vsc4u_a = torch.where(iu > 0, vsc4u, ip1(vsc4u))
    vsc4u_b = torch.where(ip1(iu) > 0, ip1(vsc4u), vsc4u)
    dpxy_u = maxc(dpu_m, onemm)
    dpib_u = maxc(ip1(dpu_m), onemm)
    harm_p = _hfharm(dpxy_u, dpib_u)
    uflux1 = torch.where(
        (iu + ip1(iu)) > 0,
        torch.minimum(grid.difmxp, (vsc2u_a + vsc2u_b) * grid.scpy)
        * harm_p * (utotn - ip1(utotn))
        + torch.minimum(.125 * grid.difmxp, (vsc4u_a + vsc4u_b) * grid.scpy)
        * harm_p * (dl2u - ip1(dl2u)),
        torch.zeros_like(utotn))

    # lateral momentum flux at q-points (mod_momtum.F90:838-915)
    dpja = maxc(jm1(dpu_m), onemm)
    dpja = dpja + wgtja * (dpxy_u - dpja)
    dpjb = maxc(jp1u(dpu_m), onemm)
    dpjb = dpjb + wgtjb * (dpxy_u - dpjb)
    vsc2a = torch.where(jm1(iu) > 0, jm1(vsc2u), vsc2u)
    vsc4a = torch.where(jm1(iu) > 0, jm1(vsc4u), vsc4u)
    vsc2b = torch.where(jp1u(iu) > 0, jp1u(vsc2u), vsc2u)
    vsc4b = torch.where(jp1u(iu) > 0, jp1u(vsc4u), vsc4u)
    uflux2 = (torch.minimum(grid.difmxq, (vsc2u + vsc2a) * grid.scqx)
              * _hfharm(dpja, dpxy_u) * (uja - utotn)
              + torch.minimum(.125 * grid.difmxq,
                              (vsc4u + vsc4a) * grid.scqx)
              * _hfharm(dpja, dpxy_u) * (dl2uja - dl2u)) * iu
    uflux3 = (torch.minimum(jp1q(grid.difmxq),
                            (vsc2u + vsc2b) * jp1q(grid.scqx))
              * _hfharm(dpjb, dpxy_u) * (utotn - ujb)
              + torch.minimum(.125 * jp1q(grid.difmxq),
                              (vsc4u + vsc4b) * jp1(grid.scqx))
              * _hfharm(dpjb, dpxy_u) * (dl2u - dl2ujb)) * iu

    # bottom boundary layer stress + update (mod_momtum.F90:948-984)
    pbu_m = d2.pbu_m
    ptopl_u = .5 * (torch.minimum(pbu_m, f.p_lo)
                    + torch.minimum(pbu_m, im1(f.p_lo)))
    pbotl_u = .5 * (torch.minimum(pbu_m, f.p_hi)
                    + torch.minimum(pbu_m, im1(f.p_hi)))
    qbot = .5 * (d2.drag + im1(d2.drag)) \
        * (torch.maximum(pbu_m - thkbop, pbotl_u)
           - torch.maximum(pbu_m - thkbop,
                           torch.minimum(ptopl_u, pbotl_u - onemm))) \
        / maxc(dpu_m, onemm)
    botstr_u = -utotn * qbot / (1. + delt1 * qbot)

    u_new = (u_n + delt1 * (
        -grid.scuxi * (-f.pgf_u + f.stress_u + (ke - im1(ke)))
        + cau - d2.ubrhs + botstr_u
        - (uflux1 - im1(uflux1) + uflux3 - uflux2)
        / (grid.scu2 * maxc(dpu_m, onemm)))) * iu

    # ================= v equation =================
    qw = .5 * (jm1(difwgt) + difwgt)
    deform_v = torch.sqrt(.5 * (defor1 + jm1(defor1) + defor2 + ip1(defor2)))
    vsc2v = torch.maximum(qw * par.mdv2hi + (1. - qw) * par.mdv2lo,
                          (qw * par.vsc2hi + (1. - qw) * par.vsc2lo)
                          * deform_v)
    vsc4v = torch.maximum(qw * par.mdv4hi + (1. - qw) * par.mdv4lo,
                          (qw * par.vsc4hi + (1. - qw) * par.vsc4lo)
                          * deform_v)

    vsc2v_a = torch.where(iv > 0, vsc2v, jp1v(vsc2v))
    vsc2v_b = torch.where(jp1v(iv) > 0, jp1v(vsc2v), vsc2v)
    vsc4v_a = torch.where(iv > 0, vsc4v, jp1v(vsc4v))
    vsc4v_b = torch.where(jp1v(iv) > 0, jp1v(vsc4v), vsc4v)
    dpxy_v = maxc(dpv_m, onemm)
    dpjb_v = maxc(jp1v(dpv_m), onemm)
    harm_pv = _hfharm(dpxy_v, dpjb_v)
    vflux1 = torch.where(
        (iv + jp1v(iv)) > 0,
        torch.minimum(grid.difmxp, (vsc2v_a + vsc2v_b) * grid.scpx)
        * harm_pv * (vtotn - jp1vv(vtotn))
        + torch.minimum(.125 * grid.difmxp, (vsc4v_a + vsc4v_b) * grid.scpx)
        * harm_pv * (dl2v - jp1vv(dl2v)),
        torch.zeros_like(vtotn))

    dpia = maxc(im1(dpv_m), onemm)
    dpia = dpia + wgtia * (dpxy_v - dpia)
    dpib = maxc(ip1(dpv_m), onemm)
    dpib = dpib + wgtib * (dpxy_v - dpib)
    vsc2a = torch.where(im1(iv) > 0, im1(vsc2v), vsc2v)
    vsc4a = torch.where(im1(iv) > 0, im1(vsc4v), vsc4v)
    vsc2b = torch.where(ip1(iv) > 0, ip1(vsc2v), vsc2v)
    vsc4b = torch.where(ip1(iv) > 0, ip1(vsc4v), vsc4v)
    vflux2 = (torch.minimum(grid.difmxq, (vsc2v + vsc2a) * grid.scqy)
              * _hfharm(dpia, dpxy_v) * (via - vtotn)
              + torch.minimum(.125 * grid.difmxq,
                              (vsc4v + vsc4a) * grid.scqy)
              * _hfharm(dpia, dpxy_v) * (dl2via - dl2v)) * iv
    vflux3 = (torch.minimum(ip1(grid.difmxq),
                            (vsc2v + vsc2b) * ip1(grid.scqy))
              * _hfharm(dpib, dpxy_v) * (vtotn - vib)
              + torch.minimum(.125 * ip1(grid.difmxq),
                              (vsc4v + vsc4b) * ip1(grid.scqy))
              * _hfharm(dpib, dpxy_v) * (dl2v - dl2vib)) * iv

    pbv_m = d2.pbv_m
    ptopl_v = .5 * (torch.minimum(pbv_m, f.p_lo)
                    + torch.minimum(pbv_m, jm1(f.p_lo)))
    pbotl_v = .5 * (torch.minimum(pbv_m, f.p_hi)
                    + torch.minimum(pbv_m, jm1(f.p_hi)))
    qbot = .5 * (d2.drag + jm1(d2.drag)) \
        * (torch.maximum(pbv_m - thkbop, pbotl_v)
           - torch.maximum(pbv_m - thkbop,
                           torch.minimum(ptopl_v, pbotl_v - onemm))) \
        / maxc(dpv_m, onemm)
    botstr_v = -vtotn * qbot / (1. + delt1 * qbot)

    v_new = (v_n + delt1 * (
        -grid.scvyi * (-f.pgf_v + f.stress_v + (ke - jm1(ke)))
        + cav - d2.vbrhs + botstr_v
        - (vflux1 - jm1(vflux1) + vflux3 - vflux2)
        / (grid.scv2 * maxc(dpv_m, onemm)))) * iv

    return u_new, v_new


def momtum_uv(grid: Grid, par: MomtumParams, f: MomtumKIn, d2: Momtum2DIn,
              tsfac, delt1):
    """Stencil-core dispatch: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if par.mommth not in MOMMTHS:
        raise ValueError(f'mommth={par.mommth!r}: expected one of {MOMMTHS}')
    if f.u_m.is_cuda:
        from .momtum_cuda import momtum_uv_cuda
        return momtum_uv_cuda(grid, par, f, d2, tsfac, delt1)
    return _uv_body(grid, par, f, d2, tsfac, delt1)


def momtum(grid: Grid, s: State, forcing: Forcing, par: MomtumParams,
           difwgt, m: int, n: int, delt1, dlt, vcoord_isopyc: bool = False):
    """Advance baroclinic velocity from old level n using mid level m.
    Updates `s` in place and returns (state, utotn_out, vtotn_out): the
    depth-mean velocity tendency for the barotropic solver
    (mod_momtum.F90:1154-1269).  In the isopycnic coordinate the wind
    stress acts on the top layer over the mixed layer's upper part."""
    kk = grid.kk
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    im1, ip1, jm1 = grid.im1, grid.ip1, grid.jm1
    jp1vv = lambda a: grid.jp1(a, 'v', True)    # noqa: E731

    thkbop = thkbot * onem
    tsfac = dlt / delt1
    dt1inv = 1.0 / delt1

    dp_m = s.dp[m]
    dpu_m, dpu_n = s.dpu[m], s.dpu[n]
    dpv_m, dpv_n = s.dpv[m], s.dpv[n]
    u_m, u_n = s.u[m], s.u[n]
    v_m, v_n = s.v[m], s.v[n]

    # interface pressures from mid-level thicknesses (mod_momtum.F90:244-255)
    p = cumulative_p(dp_m) * ip
    pu = cumulative_p(dpu_m)
    pv = cumulative_p(dpv_m)

    # ---- bottom drag (mod_momtum.F90:257-294): bulk formula over the
    # bottom boundary layer, at p-points
    pbot = p[kk]
    pbotl = torch.maximum(p[1:], pbot - thkbop)
    ptopl = torch.maximum(p[:-1], pbot - thkbop)
    ubot_bl = torch.sum((u_n + ip1(u_n)) * (pbotl - ptopl), 0)
    vbot_bl = torch.sum((v_n + jp1vv(v_n)) * (pbotl - ptopl), 0)

    ubs = s.ubflxs_p[n] / torch.clamp(s.pbu[n] * grid.scuy, min=epsilpl)
    vbs = s.vbflxs_p[n] / torch.clamp(s.pbv[n] * grid.scvx, min=epsilpl)
    ubot = (ubs + ip1(ubs)) * tsfac + ubot_bl / thkbop
    vbot = (vbs + jp1vv(vbs)) * tsfac + vbot_bl / thkbop
    ubbl = .5 * torch.sqrt(ubot * ubot + vbot * vbot)
    qdrag = par.cb * (ubbl + par.cbar)
    drag = qdrag * grav / (alpha0 * thkbop) * ip
    ustarb = torch.sqrt(qdrag * ubbl) * ip

    # ---- barotropic r.h.s. (mod_momtum.F90:296-313)
    ubrhs = s.ubcors_p * tsfac * iu
    vbrhs = s.vbcors_p * tsfac * iv

    # ---- wind stress (mod_momtum.F90:917-946)
    if vcoord_isopyc:
        stress_u = torch.zeros_like(dpu_m)
        stress_u[0] = (-2. * forcing.taux * grav * grid.scux
                       / torch.clamp(p[1] + im1(p[1]), min=epsilp))
        stress_v = torch.zeros_like(dpv_m)
        stress_v[0] = (-2. * forcing.tauy * grav * grid.scvy
                       / torch.clamp(p[1] + jm1(p[1]), min=epsilp))
    else:
        stress_u = -(forcing.mu_nonloc[:-1] - forcing.mu_nonloc[1:]) \
            * forcing.taux * grav * grid.scux / torch.clamp(dpu_m, min=onemm)
        stress_v = -(forcing.mv_nonloc[:-1] - forcing.mv_nonloc[1:]) \
            * forcing.tauy * grav * grid.scvy / torch.clamp(dpv_m, min=onemm)
    stress_u = stress_u * iu
    stress_v = stress_v * iv

    # ---- PGF time blend (mod_momtum.F90:974-977)
    pgf_u = (1. - 2. * wpgf) * s.pgfx[m] + wpgf * (s.pgfx_o + s.pgfx[n])
    pgf_v = (1. - 2. * wpgf) * s.pgfy[m] + wpgf * (s.pgfy_o + s.pgfy[n])

    f = MomtumKIn(u_m=u_m, u_n=u_n, v_m=v_m, v_n=v_n, dp_m=dp_m,
                  dpu_m=dpu_m, dpv_m=dpv_m,
                  p_lo=p[:-1], p_hi=p[1:], pu_lo=pu[:-1], pu_hi=pu[1:],
                  pv_lo=pv[:-1], pv_hi=pv[1:],
                  stress_u=stress_u, stress_v=stress_v,
                  pgf_u=pgf_u, pgf_v=pgf_v)
    d2 = Momtum2DIn(ubflxs_m=s.ubflxs_p[m], ubflxs_n=s.ubflxs_p[n],
                    vbflxs_m=s.vbflxs_p[m], vbflxs_n=s.vbflxs_p[n],
                    pbu_m=s.pbu[m], pbv_m=s.pbv[m],
                    pbu_n=s.pbu[n], pbv_n=s.pbv[n],
                    drag=drag, ubrhs=ubrhs, vbrhs=vbrhs, difwgt=difwgt)

    u_new, v_new = momtum_uv(grid, par, f, d2, tsfac, delt1)

    # ---- time smoothing part 1 (mod_momtum.F90:974-977)
    u_m_s = (u_m * (wuv1 * dpu_m + onemm) + u_n * wuv2 * s.dpuold) * iu
    v_m_s = (v_m * (wuv1 * dpv_m + onemm) + v_n * wuv2 * s.dpvold) * iv

    # ---- massless-point fill + velocity clamp (mod_momtum.F90:1154-1210):
    # sequential top-down blend with the layer above; k=0 blends with
    # itself (kan = max(1,k-1) in the reference)
    ub_m, vb_m = s.ub[m], s.vb[m]
    ua, va = u_new[0], v_new[0]
    u_list, v_list = [], []
    for k in range(kk):
        qu = torch.clamp(torch.minimum(dpu_m[k], dpu_n[k]), max=onem)
        qv = torch.clamp(torch.minimum(dpv_m[k], dpv_n[k]), max=onem)
        uk = (u_new[k] * qu + ua * (onem - qu)) / onem
        vk = (v_new[k] * qv + va * (onem - qv)) / onem
        ua = (torch.clamp(uk + ub_m, -grid.umax, grid.umax) - ub_m) * iu
        va = (torch.clamp(vk + vb_m, -grid.vmax, grid.vmax) - vb_m) * iv
        u_list.append(ua)
        v_list.append(va)
    u_f = torch.stack(u_list)
    v_f = torch.stack(v_list)

    utot = torch.sum(u_f * dpu_n, 0) / torch.clamp(s.pbu_p, min=epsilp) * iu
    vtot = torch.sum(v_f * dpv_n, 0) / torch.clamp(s.pbv_p, min=epsilp) * iv

    # time smoothing part 2 (mod_momtum.F90:1212-1247)
    u_f = (u_f - utot) * iu
    v_f = (v_f - vtot) * iv
    u_m_new = (u_m_s + u_f * wuv2 * dpu_n) \
        / (wuv1 * dpu_m + onemm + wuv2 * (s.dpuold + dpu_n)) * iu
    v_m_new = (v_m_s + v_f * wuv2 * dpv_n) \
        / (wuv1 * dpv_m + onemm + wuv2 * (s.dpvold + dpv_n)) * iv

    # old-level interface pressures at u/v (mod_momtum.F90:1263-1281)
    s.pu = cumulative_p(dpu_n)
    s.pv = cumulative_p(dpv_n)
    s.u[n] = u_f
    s.u[m] = u_m_new
    s.v[n] = v_f
    s.v[m] = v_m_new
    s.ustarb = ustarb
    return s, utot * dt1inv, vtot * dt1inv
