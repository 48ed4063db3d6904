"""Baroclinic pressure-gradient force.

Counterpart of `blom_tpu/dynamics/pgforc.py`: the pgforc routine
(mod_pgforc.F90:439-615) with both methods, 'dynamic enthalpy'
(pgforc_dynamic_enthalpy, :265-437; every shipped configuration's) and
'geopotential' (pgforc_geopotential, :95-260, where the per-column
search for the layer holding the interpolation pressure is a count over
the interfaces and a gather).  Column recursions are reversed cumulative
sums over k; horizontal differences are masked shifts."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import grav, onemm, epsilp
from ..core.grid import Grid
from ..core.state import State, cumsum0, cumulative_p, dpu_dpv_upstream

wpgf = .25        # PGF time-averaging weight (mod_pgforc.F90:46-48)
p0_dynh = 0.0     # dynamic-enthalpy reference pressure (mod_pgforc.F90:49)


def _revcumsum(a):
    """sum_{k'=k}^{K-1} a[k'] along the first axis."""
    return torch.flip(cumsum0(torch.flip(a, [0])), [0])


def pgforc(grid: Grid, e: eos.EosParams, s: State, m: int, n: int,
           pgfmth: str = 'dynamic enthalpy') -> State:
    """PGF fields for the new time level n by `pgfmth`; also refreshes
    p/pu/pv and dpu/dpv from dp(n).  Updates `s` in place and returns
    it."""
    iu, iv, ip = grid.iu, grid.iv, grid.ip

    # --- interface pressures and velocity-point thicknesses
    # (mod_pgforc.F90:450-478)
    p = cumulative_p(s.dp[n]) * ip
    dpu_n, dpv_n = dpu_dpv_upstream(grid, p)
    pu = cumulative_p(dpu_n)
    pv = cumulative_p(dpv_n)
    s.p, s.pu, s.pv = p, pu, pv
    s.dpu[n] = dpu_n
    s.dpv[n] = dpv_n

    # --- save old PGF fields (mod_pgforc.F90:480-525)
    for name in ('xixp', 'xixm', 'pgfxm', 'xiyp', 'xiym', 'pgfym',
                 'pgfx', 'pgfy'):
        getattr(s, name + '_o').copy_(getattr(s, name)[n])

    temp, saln, dp = s.temp[n], s.saln[n], s.dp[n]

    if pgfmth == 'geopotential':
        return _finalize(grid, s, n, *_pgforc_geopotential(
            grid, temp, saln, dp, s.phi[grid.kk], p, pu, pv, dpu_n, dpv_n))
    if pgfmth != 'dynamic enthalpy':
        raise ValueError(
            f'pgfmth={pgfmth!r} is unsupported (mod_pgforc.F90:525-535)')

    # --- potential (dynamic enthalpy + geopotential), its linearized
    # bottom-pressure response and interface geopotential
    # (mod_pgforc.F90:283-329): bottom-up recursions as reversed cumsums
    p_lo = p[1:]
    A = eos.p_alpha(p0_dynh, p_lo, temp, saln)
    alp_lo = eos.alp(p_lo, temp, saln)
    B = eos.p_alpha(p0_dynh, p_lo[:-1], temp[1:], saln[1:])
    alpB = eos.alp(p_lo[:-1], temp[1:], saln[1:])

    kk = grid.kk
    phi_bot = s.phi[kk]
    inc = A[:-1] - B
    pot_dynh = phi_bot + A[-1] + torch.cat(
        [_revcumsum(inc), torch.zeros_like(A[:1])], 0)

    pb_resp_inc = (alp_lo[:-1] - alpB) * p_lo[:-1]
    pot_dynh_pb = alp_lo[-1] * p_lo[-1] + torch.cat(
        [_revcumsum(pb_resp_inc), torch.zeros_like(A[:1])], 0)

    dphi_layer = eos.p_alpha(p[:-1], p[1:], temp, saln)
    phi = torch.cat([phi_bot[None] + _revcumsum(dphi_layer), phi_bot[None]],
                    0)

    # --- dynamic-enthalpy derivative fields (mod_pgforc.F90:331-357)
    dynh_ts_t, dynh_ts_s = eos.dynh_derivatives(
        p0_dynh, p[:-1], p[1:], temp, saln)
    dalpds_r = eos.dalpds(e.pref, temp, saln)
    dalpdt_r = eos.dalpdt(e.pref, temp, saln)
    thick = (dp >= onemm).to(dp.dtype)
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    dynh_a = torch.where(thick > 0, dynh_ts_s / dalpds_r, zero)
    dynh_t = torch.where(thick > 0, dynh_ts_t - dynh_a * dalpdt_r, zero)
    alpha_r = eos.alp(e.pref, temp, saln)

    # --- layer PGF on u/v points (mod_pgforc.F90:366-430)
    im1, jm1 = grid.im1, grid.jm1

    pgfx = -(pot_dynh - im1(pot_dynh))
    both_u = (thick * im1(thick)) > 0
    pgfx = pgfx + torch.where(
        both_u,
        .5 * ((im1(dynh_t) + dynh_t) * (temp - im1(temp))
              + (im1(dynh_a) + dynh_a) * (alpha_r - im1(alpha_r))),
        zero)
    pgfx = pgfx * iu

    pgfy = -(pot_dynh - jm1(pot_dynh))
    both_v = (thick * jm1(thick)) > 0
    pgfy = pgfy + torch.where(
        both_v,
        .5 * ((jm1(dynh_t) + dynh_t) * (temp - jm1(temp))
              + (jm1(dynh_a) + dynh_a) * (alpha_r - jm1(alpha_r))),
        zero)
    pgfy = pgfy * iv

    # thickness-weighted vertical sums
    pgfxm = torch.sum(pgfx * dpu_n, 0) * iu
    xixm = torch.sum(im1(pot_dynh_pb) * dpu_n, 0) * iu
    xixp = torch.sum(pot_dynh_pb * dpu_n, 0) * iu
    pgfym = torch.sum(pgfy * dpv_n, 0) * iv
    xiym = torch.sum(jm1(pot_dynh_pb) * dpv_n, 0) * iv
    xiyp = torch.sum(pot_dynh_pb * dpv_n, 0) * iv

    return _finalize(grid, s, n, phi, pgfx, pgfy, pgfxm, pgfym,
                     xixp, xixm, xiyp, xiym)


def _side_eval(p, temp, saln, phi, phip, prs):
    """One side (the plus or the minus column) of the geopotential PGF at
    the interpolation pressures prs (kk, J, I): the layer holding prs
    (the kup/kum/kvp/kvm while-loops of mod_pgforc.F90:172-183,215-226)
    is the count of the interfaces p[r], r < kk, at or above it, less
    one; phi/phip are extrapolated from the interface below it with
    delphi.  Returns (phi_side, base, alp_at_prs), base the xi-term part
    that does not involve the other side's specific volume
    (mod_pgforc.F90:185-208)."""
    kk = temp.shape[0]
    # largest r in [0, kk-1] with p[r] <= prs, counted interface by
    # interface (a (kk, kk, J, I) comparison would not fit at tnx1 size)
    cnt = torch.zeros(prs.shape, dtype=torch.int32, device=prs.device)
    for r in range(kk):
        cnt += p[r] <= prs
    idx = torch.clamp(cnt - 1, 0, kk - 1).long()
    p_g = torch.gather(p, 0, idx + 1)
    t_g = torch.gather(temp, 0, idx)
    s_g = torch.gather(saln, 0, idx)
    phi_g = torch.gather(phi, 0, idx + 1)
    phip_g = torch.gather(phip, 0, idx + 1)
    dphi, alp_prs, alp_g = eos.delphi(prs, p_g, t_g, s_g)
    phi_side = phi_g - dphi
    base = phip_g + p_g * alp_g
    return phi_side, base, alp_prs


def _pgforc_geopotential(grid: Grid, temp, saln, dp, phi_bot, p, pu, pv,
                         dpu_n, dpv_n):
    """PGF as the gradient of geopotential on pressure surfaces
    (pgforc_geopotential, mod_pgforc.F90:95-260).  Returns (phi, pgfx,
    pgfy, pgfxm, pgfym, xixp, xixm, xiyp, xiym) before _finalize."""
    iu, iv = grid.iu, grid.iv
    im1, jm1 = grid.im1, grid.jm1

    # --- interface geopotential phi and the bottom-pressure response
    # integral phip, bottom-up recursions (mod_pgforc.F90:111-135)
    dphi_l, alpu_l, alpl_l = eos.delphi(p[:-1], p[1:], temp, saln)
    thin = dp < epsilp
    dphi_l = torch.where(thin, 0., dphi_l)
    phip_inc = torch.where(thin, 0., p[1:] * alpl_l - p[:-1] * alpu_l)
    # phi[k] = phi[k+1] - dphi_l[k]; phip[kk] = 0, phip[k] = phip[k+1]+inc
    phi = torch.cat([phi_bot[None] - _revcumsum(dphi_l), phi_bot[None]], 0)
    phip = torch.cat([_revcumsum(phip_inc), torch.zeros_like(phip_inc[:1])],
                     0)

    def side_pair(sh, prs, dpn, mask):
        """The plus and minus sides at prs, the minus column shifted by
        `sh`; returns the layer PGF and the two xi sums."""
        phi_p, base_p, alp_p = _side_eval(p, temp, saln, phi, phip, prs)
        phi_m, base_m, alp_m = _side_eval(sh(p), sh(temp), sh(saln),
                                          sh(phi), sh(phip), prs)
        cp = .25 * (p[1:] + p[:-1])
        cm = .25 * (sh(p)[1:] + sh(p)[:-1])
        q = prs / torch.clamp(cp + cm, min=epsilp)
        cp, cm = q * cp, q * cm
        pgf = -(phi_p - phi_m) * mask
        xip = torch.sum((base_p - cp * (alp_p - alp_m)) * dpn, 0) * mask
        xim = torch.sum((base_m - cm * (alp_m - alp_p)) * dpn, 0) * mask
        return pgf, xip, xim

    # --- u-point PGF (mod_pgforc.F90:144-209)
    pgfx, xixp, xixm = side_pair(im1, (pu[1:] - .5 * dpu_n) * iu, dpu_n, iu)
    pgfxm = torch.sum(pgfx * dpu_n, 0) * iu
    # --- v-point PGF (mod_pgforc.F90:211-252)
    pgfy, xiyp, xiym = side_pair(jm1, (pv[1:] - .5 * dpv_n) * iv, dpv_n, iv)
    pgfym = torch.sum(pgfy * dpv_n, 0) * iv
    return phi, pgfx, pgfy, pgfxm, pgfym, xixp, xixm, xiyp, xiym


def _finalize(grid: Grid, s: State, n: int, phi, pgfx, pgfy, pgfxm, pgfym,
              xixp, xixm, xiyp, xiym) -> State:
    """Normalize the vertically averaged PGF fields by the predicted
    bottom pressures and split off the bottom-pressure sensitivities the
    barotropic solver uses (mod_pgforc.F90:539-594)."""
    iu, iv, ip = grid.iu, grid.iv, grid.ip
    im1, jm1 = grid.im1, grid.jm1

    qu = iu / torch.clamp(s.pbu_p, min=epsilp)
    qv = iv / torch.clamp(s.pbv_p, min=epsilp)
    pgfxm = pgfxm * qu
    xixp = xixp * qu
    xixm = xixm * qu
    pgfym = pgfym * qv
    xiyp = xiyp * qv
    xiym = xiym * qv

    pgfx = (pgfx - pgfxm) * iu
    pgfy = (pgfy - pgfym) * iv

    pb_p_safe = torch.clamp(s.pb_p, min=epsilp)
    pgfxm = (pgfxm + xixp - xixm) * iu
    xixp = xixp / pb_p_safe * iu
    xixm = xixm / torch.clamp(im1(s.pb_p), min=epsilp) * iu
    pgfym = (pgfym + xiyp - xiym) * iv
    xiyp = xiyp / pb_p_safe * iv
    xiym = xiym / torch.clamp(jm1(s.pb_p), min=epsilp) * iv

    s.phi = phi
    s.pgfx[n] = pgfx
    s.pgfy[n] = pgfy
    s.pgfxm[n] = pgfxm
    s.pgfym[n] = pgfym
    s.xixp[n] = xixp
    s.xixm[n] = xixm
    s.xiyp[n] = xiyp
    s.xiym[n] = xiym
    s.sealv = phi[0] / grav * ip
    return s
