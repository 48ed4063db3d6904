"""Diapycnal mixing between isopycnic layers.

Counterpart of `blom_tpu/dynamics/diapfl.py` (BLOM's
mod_diapfl.F90:45-1048): per column, interface mass fluxes solved
implicitly from the layer-thickness diffusion equation driven by the
diapycnal diffusivity, restoration fluxes nudging interior layer
densities toward their reference values, flux limits keeping interfaces
inside the fluid, bottom-boundary-layer mixing, and a tridiagonal solve
that carries T, S, tracers and then u, v with the resulting fluxes.

blom_tpu's k-scans are Python loops over k on (jdm, idm) tensors, with
its fixed sweep counts (N_LIMIT flux-limit sweeps, N_SOLVE alternating
backward-solve passes); its per-column integer bounds (kfpl, kmin,
kmax) gate every loop by dense masks, and its one-hot selections stay
masked sums: no gathers, no host reads."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import alpha0, epsilp, grav, onem
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..ops.reduce import ksum

# parameters (mod_diapfl.F90:90-92)
dsgmnr = .1
fcmxr = .25
dsgcr0 = .25
gbbl = .2
kappa = .4
ustmin = 1.e-4

TMIN = -3.      # massless-fill temperature floor [C] without a temmin
N_LIMIT = 6     # flux-limit sweeps (the reference loops to convergence)
N_SOLVE = 24    # alternating down/up backward-solve passes


def _shift_dn(a):
    """a[k+1] along k, 0 at the last k."""
    return torch.cat([a[1:], a[-1:] * 0.], 0)


def _shift_up(a):
    """a[k-1] along k, 0 at k = 0."""
    return torch.cat([a[:1] * 0., a[:-1]], 0)


def _pick(kidx, a, kq):
    """a at layer kq of each column (0 where kq is outside the column)."""
    return torch.where(kidx == kq, a, 0.).sum(0)


def _tridiag(delp, fpu, fpl, rows_on, fields):
    """The asymmetric tridiagonal of mod_diapfl.F90:545-572: forward
    elimination downward, then back-substitution; identity outside
    rows_on.  fields: list of (kk, ...) tensors; returns solved ones."""
    kk = delp.shape[0]
    q = 1. / torch.where(rows_on, delp + fpu + fpl, 1.)
    atd = torch.where(rows_on, -fpu * q, 0.)
    ctd_row = torch.where(rows_on, -fpl * q, 0.)
    dtd = torch.where(rows_on, delp * q, 1.)

    ctd_prev = torch.zeros_like(delp[0])
    bitd_prev = torch.ones_like(delp[0])
    prevs = [f[0] * 0. for f in fields]
    gtd, sol = [], []
    for k in range(kk):
        a_k = atd[k]
        g = torch.where(rows_on[k], ctd_prev * bitd_prev, 0.)
        bitd = 1. / (1. - a_k * g)
        # at the first active row a_k is 0, so prevs are inert
        prevs = [(dtd[k] * v[k] - a_k * pv) * bitd
                 for v, pv in zip(fields, prevs)]
        ctd_prev, bitd_prev = ctd_row[k], bitd
        gtd.append(g)
        sol.append(prevs)

    out = [[None] * kk for _ in fields]
    nxts = sol[-1]
    for k in range(kk - 1, -1, -1):
        g_k1 = gtd[k + 1] if k + 1 < kk else torch.zeros_like(gtd[0])
        nxts = [torch.where(rows_on[k], v - g_k1 * nv, v)
                for v, nv in zip(sol[k], nxts)]
        for t, v in enumerate(nxts):
            out[t][k] = v
    return [torch.stack(o) for o in out]


def _backward_core(q, r, t):
    """Root of the local flux equation and its derivative, with the
    Taylor branch for q < 0 and r/q^2 small (mod_diapfl.F90:389-404)."""
    s_ = torch.sqrt(q * q + r)
    f0_std = (q + s_) * t
    df_std = (1. + q / s_) * t
    qq = torch.where(torch.abs(q) > 0., q, -1.)
    sr = r / (qq * qq)
    rr = .00390625 * sr
    f0_tay = -qq * rr * (128. - sr * (32. - sr * (
        16. - sr * (10. - sr * 7.)))) * t
    df_tay = rr * (128. - sr * (96. - sr * (
        80. - sr * (70. - sr * 63.)))) * t
    use_tay = (q < 0.) & (sr < 1.e-3)
    return (torch.where(use_tay, f0_tay, f0_std),
            torch.where(use_tay, df_tay, df_std))


def diapfl(grid: Grid, e: eos.EosParams, s: State, difdia, m: int,
           n: int, delt1, temmin=None) -> State:
    """Diapycnal mixing of time level n, in place.  difdia: (kk, jdm,
    idm) diapycnal diffusivity [m2 s-1]; temmin: the massless fill's
    temperature floor, a number or one per layer (kk, jdm, idm)
    (`phys/temmin.py` settemmin), TMIN when None."""
    kk = grid.kk
    H = grid.shape
    ip = grid.ip
    ipb = ip > 0
    dev = ip.device
    kidx = torch.arange(kk, dtype=torch.int32, device=dev).reshape(
        (kk,) + (1,) * len(H))

    dp0 = s.dp[n]
    tt0, ss0 = s.temp[n], s.saln[n]
    dens0, sigr = s.sigma[n], s.sigmar
    ntr = s.trc.shape[1]
    trc0 = s.trc[n]

    c = grav * grav * delt1 / (alpha0 * alpha0)

    kfpl = s.kfpla[n].to(torch.int32)
    kmin = kfpl - 2
    wet = dp0 > epsilp
    kmax = torch.where(wet & (kidx >= 1), kidx, 0).amax(0)
    active = (kmin < kmax) & ipb

    def pick(a, kq):
        return _pick(kidx, a, kq)

    # restoration mask (rstdns, :150-156)
    no_rst1 = (kfpl != kmax) & (pick(dens0, kfpl) > .5 * (
        pick(sigr, kfpl) + pick(sigr, kfpl + 1)))
    rstdns = (kidx != kfpl) & ~((kidx == kfpl + 1) & no_rst1)

    # ML copy into the kmin/kmin+1 slots (:159-175)
    def ml_slots(a):
        return torch.where(kidx == kmin, a[0][None],
                           torch.where(kidx == kmin + 1, a[1][None], a))

    delp = ml_slots(dp0)
    ttem = ml_slots(tt0)
    ssal = ml_slots(ss0)
    nu = ml_slots(difdia)
    dens = ml_slots(dens0)
    ttrc = [ml_slots(trc0[nt]) for nt in range(ntr)]

    # zero thicknesses outside [kmin, kmax] for the pressure build
    in_col = (kidx >= kmin) & (kidx <= kmax)
    delp_c = torch.where(in_col, delp, 0.)
    pres = cumulative_p(delp_c)
    pbot = ksum(torch.where(in_col, delp_c, 0.), 0)

    # ---- ML fluxes (:181-198)
    d0, d1, d2 = (pick(delp_c, kmin + i) for i in range(3))
    nu_0, nu_1 = pick(nu, kmin), pick(nu, kmin + 1)
    p_k1 = d0
    fpl_kmin = torch.minimum(torch.minimum(p_k1, pbot - p_k1),
                             c * nu_0 * (d0 + d1)
                             / torch.clamp(2. * d0 * d1, min=epsilp))
    delpu = torch.clamp(d1, min=onem)
    delpl = torch.clamp(d2, min=onem)
    p_k2 = d0 + d1
    fpl_kmin1 = torch.minimum(torch.minimum(p_k2, pbot - p_k2),
                              c * nu_1 * (delpu + delpl)
                              / (2. * delpu * delpl))

    # ---- bottom boundary layer mixing (:201-211)
    in_int = (kidx >= kfpl) & (kidx <= kmax - 1)
    has_int = kfpl < kmax
    d_kmax, d_km1 = pick(delp_c, kmax), pick(delp_c, kmax - 1)
    sigr_kmax, sigr_km1 = pick(sigr, kmax), pick(sigr, kmax - 1)
    ust = s.ustarb
    nubbl = gbbl * (ust * (ust * ust)) * torch.exp(
        -(d_kmax + .5 * d_km1) * torch.abs(grid.coriop) * alpha0
        / (kappa * torch.clamp(ust, min=ustmin) * grav)) \
        / (alpha0 * grav * torch.clamp(sigr_kmax - sigr_km1, min=1e-12))
    nu = torch.where((kidx == kmax - 1) & has_int[None],
                     torch.maximum(nu, nubbl[None]), nu)

    # ---- linearized density jumps + restoration fluxes (:214-292)
    def prev(a):
        return torch.cat([a[:1], a[:-1]], 0)

    def nxt(a):
        return torch.cat([a[1:], a[-1:]], 0)

    tt_m, ss_m, sigr_m, dens_m = prev(ttem), prev(ssal), prev(sigr), \
        prev(dens)
    tt_p, ss_p, sigr_p, dens_p = nxt(ttem), nxt(ssal), nxt(sigr), nxt(dens)

    dsgdt = eos.dsigdt(e, ttem, ssal)
    dsgds = eos.dsigds(e, ttem, ssal)
    one = torch.ones_like(delp)
    use_rst = rstdns & in_int
    dsgu = torch.where(use_rst | (kidx == kmax),
                       torch.maximum(dsgmnr * (sigr - sigr_m),
                                     dsgdt * (ttem - tt_m)
                                     + dsgds * (ssal - ss_m)), one)
    dsgl = torch.where(use_rst,
                       torch.maximum(dsgmnr * (sigr_p - sigr),
                                     dsgdt * (tt_p - ttem)
                                     + dsgds * (ss_p - ssal)), one)
    dsghm = torch.where(use_rst, 2. * dsgu * dsgl / (dsgu + dsgl), one)
    dsg = torch.where(use_rst, .5 * (dsgu + dsgl), one)
    dsgui = 1. / dsgu
    dsgli = 1. / dsgl

    fcmx = .25 * (torch.sqrt(delp * delp
                             + 4. * c * nu * dsg * (dsgui + dsgli))
                  - delp) * dsghm * fcmxr
    dsgc = dens - sigr

    def cube_taper(qx):
        w = torch.clamp(1. - qx * qx, min=0.)
        return w * (w * w)

    qd = torch.clamp((dens - sigr_p)
                     / torch.where(torch.abs(sigr - sigr_p) > 0.,
                                   (sigr - sigr_p) * (1. - dsgcr0), 1.),
                     min=0.)
    qd = cube_taper(qd)
    fcu_pos = torch.where(dens_m < sigr,
                          torch.minimum(qd * dsgc * delp
                                        + (1. - qd) * fcmx, dsgc * delp),
                          0.)
    qu = torch.clamp((dens - sigr_m)
                     / torch.where(torch.abs(sigr - sigr_m) > 0.,
                                   (sigr - sigr_m) * (1. - dsgcr0), 1.),
                     min=0.)
    qu = cube_taper(qu)
    fcl_neg = torch.where(dens_p > sigr,
                          torch.maximum(qu * dsgc * delp
                                        - (1. - qu) * fcmx, dsgc * delp),
                          0.)
    fcu = torch.where(use_rst & (dsgc > 0.), fcu_pos, 0.)
    fcl = torch.where(use_rst & (dsgc <= 0.), fcl_neg, 0.)
    # row kfpl-1 carries -fpl of the lower mixed layer (:215-216)
    fcl = torch.where(kidx == kfpl - 1, -fpl_kmin1[None], fcl)

    # kmax row: upper flux from the density excess (:276-292)
    dens_kmax, dens_kmax_m = pick(dens, kmax), pick(dens, kmax - 1)
    dsgui_kmax = pick(dsgui, kmax)
    fpu_kmax = torch.where(
        (dens_kmax > sigr_kmax) & (dens_kmax_m < sigr_kmax),
        torch.minimum(d_km1, (dens_kmax - sigr_kmax) * d_kmax
                      * dsgui_kmax), 0.)
    fcu = torch.where(kidx == kmax, (fpu_kmax * 1.)[None] * dsgu, fcu)

    # ---- flux-limit iteration (:295-329), fixed sweeps
    pres_p1 = pres[1:]
    pres_k = pres[:-1]
    p_kfpl = pick(pres_k, kfpl)
    on = in_int
    is_kmax = kidx == kmax
    zero_h = delp.new_zeros(H)
    one_h = delp.new_ones(H)

    def limit_sweep(fcl_i, fcu_i, fmax_i):
        # downward recurrence, from the bottom: clamp fcl(k) by fmax(k+1)
        fcu_kmax_v = pick(fcu_i, kmax)
        fmax_k1, fcu_k1, dsgui_k1 = zero_h, zero_h, one_h
        fcl_r, fmax_r = [None] * kk, [None] * kk
        for k in range(kk - 1, -1, -1):
            on_k = on[k]
            fmax_k1 = torch.where(is_kmax[k], 0., fmax_k1)
            fcu_k1 = torch.where(is_kmax[k], fcu_kmax_v, fcu_k1)
            dsgui_k1 = torch.where(is_kmax[k], dsgui_kmax, dsgui_k1)
            q = ((fmax_k1 + fcu_k1) * dsgui_k1 + (pbot - pres_p1[k])) \
                * dsgl[k]
            fcl_new = torch.where(on_k, torch.maximum(-q, fcl_i[k]),
                                  fcl_i[k])
            fmax_new = torch.where(on_k, q + fcl_new, fmax_k1)
            fcu_k1 = torch.where(on_k, fcu_i[k], fcu_k1)
            dsgui_k1 = torch.where(on_k, dsgui[k], dsgui_k1)
            fmax_k1 = fmax_new
            fcl_r[k], fmax_r[k] = fcl_new, fmax_new
        fcl_i = torch.stack(fcl_r)
        fmax_i = torch.where(on, torch.stack(fmax_r), fmax_i * 0.)

        # upward recurrence: clamp fcu(k) by fmax(k-1); row kfpl-1 seeds
        # fmax = 0, fcl = -fpl_kmin1, dsgli = 1
        fmax_m, fcl_m, dsgli_m = zero_h, -fpl_kmin1, one_h
        fcu_n, fmax_n = [None] * kk, [None] * kk
        for k in range(kk):
            on_k = on[k]
            q = ((fmax_m - fcl_m) * dsgli_m + (pres_k[k] - p_kfpl)) * dsgu[k]
            fcu_new = torch.where(on_k, torch.minimum(fcu_i[k], q), fcu_i[k])
            clamp = on_k & (fmax_i[k] > q - fcu_new)
            fmax_new = torch.where(clamp, q - fcu_new, fmax_i[k])
            fmax_m = torch.where(on_k, fmax_new, fmax_m)
            fcl_m = torch.where(on_k, fcl_i[k], fcl_m)
            dsgli_m = torch.where(on_k, dsgli[k], dsgli_m)
            fcu_n[k], fmax_n[k] = fcu_new, fmax_new
        return (fcl_i, torch.stack(fcu_n),
                torch.where(on, torch.stack(fmax_n), fmax_i))

    fmax_ = torch.zeros_like(delp)
    for _ in range(N_LIMIT):
        fcl, fcu, fmax_ = limit_sweep(fcl, fcu, fmax_)
    # kfmaxu: the deepest k whose fmax the upward clamp set in the final
    # state, from the clamp condition
    fcl_m1 = torch.where(kidx == kfpl, -fpl_kmin1[None], _shift_up(fcl))
    dsgli_m1 = torch.where(kidx == kfpl, 1., _shift_up(dsgli))
    q_up = ((_shift_up(fmax_) - fcl_m1) * dsgli_m1
            + (pres_k - p_kfpl)) * dsgu
    clamped_up = in_int & (fmax_ >= q_up - fcu - 1e-9 * torch.abs(q_up))
    kfmaxu = torch.where(clamped_up, kidx, -1).amax(0)

    # ---- first guess + h (:333-353)
    f = torch.where(in_int, torch.minimum(torch.minimum(
        fmax_, .5 * torch.sqrt(c * nu * dsg * (dsgui + dsgli)) * dsghm),
        c * nu * dsg / torch.clamp(delp, min=epsilp)), 0.)
    fcu_p1 = _shift_dn(fcu)
    dsgui_p1 = _shift_dn(dsgui)
    h = torch.where(in_int,
                    fcu * dsgui - fcl * dsgli
                    + fcl_m1 * dsgli_m1 - fcu_p1 * dsgui_p1, 0.)

    # ---- alternating-direction backward solve (:356-533)
    r_all = 4. * c * nu * dsg * (dsgui + dsgli)
    t_all = .25 * dsghm
    false_h = torch.zeros(H, dtype=torch.bool, device=dev)

    def local_root(q, k, kstop):
        """Root and derivative at row k, clamped by fmax, and whether
        fmax was hit where kstop holds (the head of both passes'
        bodies)."""
        f0_k, dfdg = _backward_core(q, r_all[k], t_all[k])
        hit = f0_k >= fmax_[k]
        return (torch.where(hit, fmax_[k], f0_k), torch.where(hit, 0., dfdg),
                hit & kstop)

    def down_pass(f):
        f_next_old = _shift_dn(f)
        ctd, bitd, remfmx = zero_h, one_h, false_h
        f_prev, f0_prev = zero_h, zero_h
        gtd, f_new = [None] * kk, [None] * kk
        for k in range(kk):
            on_k = on[k]
            q = f0_prev * dsgli_m1[k] + f_next_old[k] * dsgui_p1[k] \
                - delp[k] - h[k]
            f0_k, dfdg, stop = local_root(q, k, k > kfmaxu)
            remfmx_new = remfmx | stop
            gtd_k = torch.where(remfmx, 0., ctd * bitd)
            atd = -dfdg * dsgli_m1[k]
            ctd_new = -dfdg * dsgui_p1[k]
            bitd_new = 1. / (1. - atd * gtd_k)
            f_k = (f0_k - atd * (f_prev - f0_prev)
                   + ctd_new * f_next_old[k]) * bitd_new
            f_k = torch.where(remfmx, fmax_[k], f_k)
            f0_k = torch.where(remfmx, fmax_[k], f0_k)
            gtd[k] = torch.where(on_k, gtd_k, 0.)
            f_new[k] = torch.where(on_k, f_k, 0.)
            ctd = torch.where(on_k, ctd_new, ctd)
            bitd = torch.where(on_k, bitd_new, bitd)
            remfmx = torch.where(on_k, remfmx_new, remfmx)
            f_prev = torch.where(on_k, f_k, f_prev)
            f0_prev = torch.where(on_k, f0_k, f0_prev)
        # back substitution upward (:434-440)
        out = [None] * kk
        f_next = zero_h
        for k in range(kk - 1, -1, -1):
            g_k1 = gtd[k + 1] if k + 1 < kk else gtd[k] * 0.
            f_out = torch.where(on[k], torch.minimum(
                fmax_[k], f_new[k] - g_k1 * f_next), f_new[k])
            f_next = torch.where(on[k], f_out, f_next)
            out[k] = f_out
        return torch.stack(out)

    def up_pass(f):
        f_below_old = torch.where(kidx == kfpl, 0., _shift_up(f))
        atd, bitd, remfmx = zero_h, one_h, false_h
        f_prev, f0_prev = zero_h, zero_h
        gtd, f_new = [None] * kk, [None] * kk
        for k in range(kk - 1, -1, -1):
            on_k = on[k]
            # f_prev/f0_prev are the k+1 values just updated; f_below_old
            # the old k-1 value
            q = f_below_old[k] * dsgli_m1[k] + f0_prev * dsgui_p1[k] \
                - delp[k] - h[k]
            f0_k, dfdg, stop = local_root(q, k, k <= kfmaxu)
            remfmx_new = remfmx | stop
            gtd_k = torch.where(remfmx, 0., atd * bitd)
            atd_new = -dfdg * dsgli_m1[k]
            ctd_new = -dfdg * dsgui_p1[k]
            bitd_new = 1. / (1. - ctd_new * gtd_k)
            f_k = (f0_k + atd_new * f_below_old[k]
                   - ctd_new * (f_prev - f0_prev)) * bitd_new
            f_k = torch.where(remfmx, fmax_[k], f_k)
            f0_k = torch.where(remfmx, fmax_[k], f0_k)
            gtd[k] = torch.where(on_k, gtd_k, 0.)
            f_new[k] = torch.where(on_k, f_k, 0.)
            atd = torch.where(on_k, atd_new, atd)
            bitd = torch.where(on_k, bitd_new, bitd)
            remfmx = torch.where(on_k, remfmx_new, remfmx)
            f_prev = torch.where(on_k, f_k, f_prev)
            f0_prev = torch.where(on_k, f0_k, f0_prev)
        # back substitution downward (:507-512)
        out = [None] * kk
        f_prev = zero_h
        for k in range(kk):
            g_m1 = gtd[k - 1] if k > 0 else gtd[0] * 0.
            f_out = torch.where(on[k], torch.minimum(
                fmax_[k], f_new[k] - g_m1 * f_prev), f_new[k])
            f_prev = torch.where(on[k], f_out, f_prev)
            out[k] = f_out
        return torch.stack(out)

    for it in range(N_SOLVE):
        f = down_pass(f) if it % 2 == 0 else up_pass(f)

    # ---- mass fluxes (:536-541)
    fpu = torch.where(in_int, (f + fcu) * dsgui, 0.)
    fpl = torch.where(in_int, (f - fcl) * dsgli, 0.)
    fpu = torch.where((kidx == kmax) & (kfpl <= kmax)[None],
                      fpu_kmax[None], fpu)
    fpu = torch.where(kidx == kfpl, fpl_kmin1[None], fpu)
    fpu = torch.where(kidx == kmin + 1, fpl_kmin[None], fpu)
    fpl = torch.where(kidx == kmin, fpl_kmin[None], fpl)
    fpl = torch.where(kidx == kmin + 1, fpl_kmin1[None], fpl)
    fpl = torch.where(kidx == kmax, 0., fpl)

    # gate everything on active columns and the fluid range
    rows_on = in_col & active[None]
    fpu = torch.where(rows_on, fpu, 0.)
    fpl = torch.where(rows_on, fpl, 0.)

    # ---- T/S/tracer tridiagonal (:545-572)
    solved = _tridiag(torch.where(rows_on, delp, 1.), fpu, fpl, rows_on,
                      [ssal, ttem] + ttrc)
    ssal_n, ttem_n = solved[0], solved[1]
    trc_n = solved[2:]
    dens_n = eos.sig(e, ttem_n, ssal_n)

    # ---- thickness update (:573-577)
    fpl_m1 = _shift_up(fpl)
    fpu_p1 = _shift_dn(fpu)
    dnew = torch.where(in_int & active[None],
                       torch.clamp(delp + fpu + fpl - fpl_m1 - fpu_p1,
                                   min=0.), delp)
    dnew = torch.where((kidx == kmax) & active[None],
                       torch.clamp(delp + fpu - fpl_m1, min=0.), dnew)

    # ---- mixed-layer copy-back (:580-600)
    def copy_back(a):
        v0, v1 = pick(a, kmin), pick(a, kmin + 1)
        a[0] = torch.where(active, v0, a[0])
        a[1] = torch.where(active, v1, a[1])

    for a in [ttem_n, ssal_n, dens_n] + trc_n:
        copy_back(a)
    # thickness bookkeeping for kmin > 0 (:587-594)
    d_kmin1 = pick(dnew, kmin + 1)
    dnew[1] = torch.where(active & (kmin >= 1),
                          torch.where(kmin == 1, d_kmin1, dnew[1]), dnew[1])
    dnew = torch.where((kidx == kmin + 1) & (kmin == 1)[None]
                       & active[None], 0., dnew)
    dnew = torch.where((kidx == kmin) & (kmin >= 2)[None] & active[None],
                       0., dnew)

    # inactive columns keep their inputs
    ttem_n = torch.where(active[None], ttem_n, tt0)
    ssal_n = torch.where(active[None], ssal_n, ss0)
    dens_n = torch.where(active[None], dens_n, dens0)
    dnew = torch.where(active[None], dnew, dp0)
    trc_n = [torch.where(active[None], trc_n[nt], trc0[nt])
             for nt in range(ntr)]

    # ---- massless fill (:604-649); a column without interior layers
    # fills them from layer 2, not colder than each layer's temmin
    no_int = kfpl > kmax
    fill_a = (kidx >= 2) & no_int[None] & ipb[None]
    fill_b = (kidx >= 2) & (kidx < kfpl) & (~no_int[None]) & ipb[None]
    fill_c = (kidx > kmax) & (~no_int[None]) & ipb[None]

    def fill(a, top):
        return torch.where(fill_a, top,
                           torch.where(fill_b, pick(a, kfpl)[None],
                                       torch.where(fill_c,
                                                   pick(a, kmax)[None], a)))

    t2 = ttem_n[1:2]
    if isinstance(temmin, torch.Tensor):
        top = torch.maximum(t2, temmin)
    else:
        top = torch.clamp(t2, min=TMIN if temmin is None else temmin)
    t_fill = fill(ttem_n, top)
    filled = fill_a | fill_b | fill_c
    ssal_n = torch.where(filled, eos.sofsig(e, sigr, t_fill), ssal_n)
    dens_n = torch.where(filled, sigr, dens_n)
    dnew = torch.where(fill_a | fill_b, 0., dnew)
    ttem_n = t_fill
    trc_n = [fill(a, a[1:2]) for a in trc_n]

    # ---- momentum-mixing flux save (:654-700)
    fpl_kmin_v = torch.where(active, pick(fpl, kmin), 0.)
    fpug = torch.where(kidx <= kmin, fpl_kmin_v[None],
                       torch.where(kidx <= kmax, fpu, 0.))
    fplg = torch.where(kidx <= kmin, fpl_kmin_v[None],
                       torch.where(kidx <= kmax, fpl, 0.))
    fpug = torch.where(active[None], fpug, 0.)
    fplg = torch.where(active[None], fplg, 0.)

    s.temp[n] = ttem_n * ip
    s.saln[n] = ssal_n * ip
    s.sigma[n] = dens_n * ip
    s.dp[n] = dnew * ip
    if ntr:
        s.trc[n] = torch.stack(trc_n, 0)

    # ---- diapycnal mixing of momentum (:707-1048)
    return _momentum_mix(grid, s, fpug, fplg, kmin, active, n)


def _momentum_mix(grid: Grid, s: State, fpug, fplg, kmin, active,
                  n: int) -> State:
    """u/v column mixing with the interpolated, bathymetry-limited
    interface fluxes (mod_diapfl.F90:707-1048)."""
    kk = grid.kk
    kidx = torch.arange(kk, dtype=torch.int32, device=grid.ip.device) \
        .reshape((kk,) + (1,) * len(grid.shape))

    p = cumulative_p(s.dp[n]) * grid.ip
    kmin_f = torch.where(active, kmin, kk).to(s.dp.dtype)

    def mix(vel, dpvel, nbr, mask, pbvel_bot):
        kmin_uv = torch.minimum(nbr(kmin_f), kmin_f).to(torch.int32)
        kmax_uv = torch.where((dpvel > 0.) & (kidx >= 1), kidx, 0).amax(0)
        act = (kmin_uv < kmax_uv) & (mask > 0)
        pb = pbvel_bot[None]

        def limited(pcol, fpug_c, fplg_c):
            fplg_m1 = _shift_up(fplg_c)
            pold = pcol[:-1] - fplg_m1 + fpug_c
            pnew = pcol[:-1]
            fpum = torch.where(
                pold <= pb, fpug_c,
                torch.where(pnew <= pb, fpug_c - pold + pb,
                            .5 * (fpug_c + fplg_m1)))
            fplm = torch.where(
                pold <= pb,
                torch.where(pnew <= pb, fplg_m1, fplg_m1 - pnew + pb),
                torch.where(pnew <= pb, fplg_m1, .5 * (fpug_c + fplg_m1)))
            return fpum, fplm

        fpum_m, fplm_m = limited(nbr(p), nbr(fpug), nbr(fplg))
        fpum_p, fplm_p = limited(p, fpug, fplg)
        fpu_v = .5 * (fpum_m + fpum_p)       # at interface k (above lyr)
        fplm1_v = .5 * (fplm_m + fplm_p)     # fpl(k-1)

        in_rng = (kidx >= kmin_uv) & (kidx <= kmax_uv) & act[None]
        fpu_row = torch.where(in_rng & (kidx > kmin_uv), fpu_v, 0.)
        fpl_row = torch.where(in_rng & (kidx < kmax_uv),
                              _shift_dn(fplm1_v), 0.)

        # the mixed layers go into the kmin/kmin+1 slots
        def ml_slots(a):
            return torch.where(kidx == kmin_uv, a[0][None],
                               torch.where(kidx == kmin_uv + 1, a[1][None],
                                           a))

        (v_new,) = _tridiag(torch.where(in_rng, ml_slots(dpvel), 1.),
                            fpu_row, fpl_row, in_rng, [ml_slots(vel)])
        out = torch.where((kidx >= kmin_uv + 2) & in_rng, v_new, vel)
        out[0] = torch.where(act, _pick(kidx, v_new, kmin_uv), vel[0])
        out[1] = torch.where(act, _pick(kidx, v_new, kmin_uv + 1), vel[1])
        # newly opened layers get the deepest velocity (:842-848)
        opened = (kidx > kmax_uv) \
            & (torch.minimum(nbr(p)[1:], p[1:]) < pb) & act[None]
        out = torch.where(opened, _pick(kidx, v_new, kmax_uv)[None], out)
        return out * mask

    s.u[n] = mix(s.u[n], s.dpu[n], grid.im1, grid.iu, s.dpu[n].sum(0))
    s.v[n] = mix(s.v[n], s.dpv[n], grid.jm1, grid.iv, s.dpv[n].sum(0))
    return s
