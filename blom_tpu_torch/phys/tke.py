"""k-epsilon / GLS second-order turbulence closure.

Counterpart of `blom_tpu/phys/tke.py`: the constants and derived
coefficients of initke (mod_tke.F90:36-165) and the per-column TKE/GLS
update with the Canuto-A stability functions of the isopycnic
diffusivity estimator (mod_difest.F90:2641-2975, difest_isobml's TKE
branch).  TKE and the generic length scale psi are tracers (the
itrtke/itrgls slots of the trc block), so they ride the same advection
as the others.  Every conditional is an elementwise `torch.where` over
the columns."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import alpha0, epsilp, grav, onem

# mod_tke.F90:37-58
gls_cmu0 = .527
Pr_t = 1.
zos = .0002
gls_p = 3.
gls_m = 1.5
gls_n = -1.
gls_c1 = 1.44
gls_c2 = 1.92
gls_c3plus = 1.
gls_c3minus = -.63
_L1, _L2, _L3, _L4 = .107, .0032, .0864, .12
_L5, _L6, _L7, _L8 = 11.9, .4, .0, .48
gls_Gh0 = .0329
gls_Ghmin = -.28
gls_Ghcri = .03
vonKar = .4

tke_min = 7.6e-8
gls_psi_min = 1.e-14
Ls_unlmt_min = 1.e-8

# derived coefficients (initke, mod_tke.F90:135-160)
sqrt2 = 2. ** .5
cmu_fac1 = gls_cmu0 ** (-gls_p / gls_n)
cmu_fac2 = gls_cmu0 ** (3. + gls_p / gls_n)
cmu_fac3 = sqrt2
tke_exp1 = gls_m / gls_n
gls_exp1 = 1. / gls_n
gls_fac6 = 8. / gls_cmu0 ** 6
gls_s0 = 1.5 * _L1 * _L5 ** 2
gls_s1 = (-_L4 * (_L6 + _L7)
          + 2. * _L4 * _L5 * (_L1 - _L2 / 3. - _L3)
          + 1.5 * _L1 * _L5 * _L8)
gls_s2 = -3. / 8. * _L1 * (_L6 ** 2 - _L7 ** 2)
gls_s4 = 2. * _L5
gls_s5 = 2. * _L4
gls_s6 = (2. / 3. * _L5 * (3. * _L3 ** 2 - _L2 ** 2)
          - .5 * _L5 * _L1 * (3. * _L3 - _L2)
          + .75 * _L1 * (_L6 - _L7))
gls_b0 = 3. * _L5 ** 2
gls_b1 = _L5 * (7. * _L4 + 3. * _L8)
gls_b2 = (_L5 ** 2 * (3. * _L3 ** 2 - _L2 ** 2)
          - .75 * (_L6 ** 2 - _L7 ** 2))
gls_b3 = _L4 * (4. * _L4 + 3. * _L8)
gls_b4 = (_L4 * (_L2 * _L6 - 3. * _L3 * _L7
                 - _L5 * (_L2 ** 2 - _L3 ** 2))
          + _L5 * _L8 * (3. * _L3 ** 2 - _L2 ** 2))
gls_b5 = .25 * (_L2 ** 2 - 3. * _L3 ** 2) * (_L6 ** 2 - _L7 ** 2)


class TkeParams(NamedTuple):
    """Runtime switches of the TKE branch (mod_difest.F90:174-196)."""
    use_gls: bool = True       # prognostic psi (GLS) vs diagnostic
    nug0: float = 2.5e-1       # max gravity-current diffusivity [m2/s]
    ustmin: float = .001       # min bottom friction velocity [m/s]
    tkepf: float = 0.          # fraction of surface TKE penetrating
    tkepls: float = 20. * onem  # penetration length scale [Pa]


def init_tke_tracers(trc, itrtke: int, itrgls: int):
    """trc with its TKE and GLS slots at their minima, both time levels
    (initke, mod_tke.F90:105-117)."""
    trc = trc.clone()
    trc[:, itrtke] = tke_min
    trc[:, itrgls] = gls_psi_min
    return trc


def tke_gls_update(tke, gls, difdia, du2l, bvfsq, dp_k, p_i, ustar,
                   ustarb, kmax, delt1, par: TkeParams):
    """One quasi-implicit TKE(/GLS) source-sink update and the resulting
    diapycnal diffusivity (mod_difest.F90:2673-2930).

    Inputs, all (K, J, I) unless noted: the tke/gls tracers, the previous
    difdia [m2/s], du2l the squared velocity jump across the layer
    [m2/s2], bvfsq the squared Brunt-Vaisala frequency [s-2], dp_k the
    layer thickness [Pa], p_i (K+1, J, I) the interface pressure;
    ustar/ustarb (J, I) the surface and bottom friction velocities; kmax
    (J, I) the index of the deepest active layer.  Returns (tke, gls,
    nus, L_scale)."""
    kk = tke.shape[0]
    kidx = torch.arange(kk, device=tke.device)[:, None, None]

    # shear/buoyancy production (:2676-2686)
    thin = dp_k <= epsilp * 10.
    h = torch.clamp(dp_k, min=onem) * alpha0 / grav
    shear2 = torch.where(thin, 1.e-9,
                         torch.clamp(du2l, min=1.e-13) / (h * h))
    prod = torch.where(thin, 0., difdia * Pr_t * shear2)
    buoy = torch.where(thin, 0., -difdia * bvfsq)

    gls_c3 = torch.where(bvfsq > 0., torch.full_like(bvfsq, gls_c3minus),
                         gls_c3plus)

    if not par.use_gls:
        # diagnostic psi from local equilibrium (:2779-2781)
        gls = torch.clamp((gls_c1 * prod + gls_c3 * buoy) / gls_c2,
                          min=gls_psi_min)

    tke_eps = (cmu_fac2 * torch.pow(tke, 1.5 + gls_m / gls_n)
               * torch.pow(gls, -1. / gls_n))
    tke_Q = tke_eps / tke

    if par.use_gls:
        # prognostic psi update (:2789-2812)
        gls_prod = (gls / tke) * gls_c1 * prod
        gls_buoy = (gls / tke) * gls_c3 * buoy
        gls_diss = (gls / tke) * gls_c2 * tke_eps
        gls_Q = gls_diss / gls
        pos = gls_prod + gls_buoy >= 0.
        gls_new = torch.where(
            pos,
            (gls + delt1 * (gls_prod + gls_buoy)) / (1. + delt1 * gls_Q),
            (gls + delt1 * gls_prod)
            / (1. + delt1 * (gls_Q - gls_buoy / gls)))
        gls = torch.clamp(gls_new, min=gls_psi_min)
        # Galperin-type limit (:2806-2813)
        q = (.56 ** (.5 * gls_n) * gls_cmu0 ** gls_p
             * torch.pow(tke, gls_m + .5 * gls_n)
             * torch.pow(torch.clamp(bvfsq, min=1.e-10), -.5 * gls_n))
        gls = torch.where(bvfsq > 0., torch.maximum(gls, q), gls)

    # TKE update (:2816-2828)
    tke_eps = (cmu_fac2 * torch.pow(tke, 1.5 + gls_m / gls_n)
               * torch.pow(gls, -1. / gls_n))
    tke_Q = tke_eps / tke
    pos = prod + buoy >= 0.
    tke_new = torch.where(
        pos,
        (tke + delt1 * (prod + buoy)) / (1. + delt1 * tke_Q),
        torch.clamp((tke + delt1 * prod)
                    / (1. + delt1 * (tke_Q - buoy / tke)), min=tke_min))
    tke = torch.clamp(tke_new, min=tke_min)

    # surface TKE penetration (:2830-2841)
    if par.tkepf > 0.:
        q = torch.where(
            dp_k < epsilp,
            torch.exp(-p_i[:-1] / par.tkepls),
            par.tkepls * (torch.exp(-p_i[:-1] / par.tkepls)
                          - torch.exp(-p_i[1:] / par.tkepls))
            / torch.clamp(dp_k, min=epsilp))
        tke = tke + 67.83 * par.tkepf * q * (ustar[None] * ustar[None])

    # thin layers and the 2-layer surface mixed layer hold the minima
    # (:2843-2852)
    floor = thin | (kidx < 2)
    tke = torch.where(floor, tke_min, tke)
    gls = torch.where(floor, gls_psi_min, gls)

    # bottom boundary condition (:2854-2863)
    ust = torch.clamp(ustarb, min=par.ustmin)
    at_bot = kidx == kmax[None]
    r = ust / gls_cmu0
    tke = torch.where(at_bot, torch.clamp(r * r, min=tke_min)[None], tke)
    if par.use_gls:
        gls_bot = torch.clamp(
            gls_cmu0 ** (gls_p - 2. * gls_m) * torch.pow(ust, 2. * gls_m)
            * vonKar ** gls_n, min=gls_psi_min)
        gls = torch.where(at_bot, gls_bot[None], gls)

    # length scales (:2865-2879)
    Ls_unlmt = torch.clamp(
        cmu_fac1 * torch.pow(gls, gls_exp1) * torch.pow(tke, -tke_exp1),
        min=Ls_unlmt_min)
    Ls_lmt = torch.where(
        bvfsq > 0.,
        torch.minimum(Ls_unlmt, torch.pow(tke, -gls_m / gls_n)
                      * torch.pow(gls, gls_n)),
        Ls_unlmt)

    # Canuto-A stability functions (:2881-2910)
    Gh = torch.clamp(-bvfsq * Ls_lmt * Ls_lmt / (2. * tke), max=gls_Gh0)
    d = Gh - gls_Ghcri
    Gh = torch.minimum(Gh, (Gh - d * d) / (Gh + gls_Gh0 - 2. * gls_Ghcri))
    Gh = torch.clamp(Gh, gls_Ghmin, gls_Gh0)
    Gm = ((gls_b0 / gls_fac6 - gls_b1 * Gh
           + gls_b3 * gls_fac6 * (Gh * Gh))
          / (gls_b2 - gls_b4 * gls_fac6 * Gh))
    Gm = torch.minimum(Gm, shear2 * Ls_lmt * Ls_lmt / (2. * tke))
    cff = (gls_b0 - gls_b1 * gls_fac6 * Gh + gls_b2 * gls_fac6 * Gm
           + gls_b3 * gls_fac6 ** 2 * (Gh * Gh)
           - gls_b4 * gls_fac6 ** 2 * Gh * Gm
           + gls_b5 * gls_fac6 ** 2 * Gm * Gm)
    Sm = torch.clamp((gls_s0 - gls_s1 * gls_fac6 * Gh
                      + gls_s2 * gls_fac6 * Gm) / cff, min=0.)
    Sh = torch.clamp((gls_s4 - gls_s5 * gls_fac6 * Gh
                      + gls_s6 * gls_fac6 * Gm) / cff, min=0.)
    Sm = Sm * cmu_fac3 / gls_cmu0 ** 3
    Sh = Sh * cmu_fac3 / gls_cmu0 ** 3

    ql = sqrt2 * Ls_lmt * torch.sqrt(tke)
    nus = torch.clamp(Sh * ql, max=4.05 * par.nug0)   # (:2917)
    L_scale = torch.clamp(Ls_lmt, min=Ls_unlmt_min)

    if par.use_gls:
        # psi again from the limited length scale (:2922-2927)
        gls = torch.clamp(
            gls_cmu0 ** gls_p * torch.pow(tke, gls_m)
            * torch.pow(L_scale, gls_n), min=gls_psi_min)
        gls = torch.where(floor, gls_psi_min, gls)

    return tke, gls, nus, L_scale
