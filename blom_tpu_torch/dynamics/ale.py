"""ALE vertical regridding and remapping.

Counterpart of `blom_tpu/dynamics/ale.py` (BLOM's
mod_ale_regrid_remap.F90:1486-1984 ale_regrid_remap).  Per step, for the
cntiso_hybrid vertical coordinate:

1. reconstruct the T/S profiles and regrid: nudge the interface
   pressures toward the interface reference densities, keeping the
   minimum near-surface thicknesses (REGRID_METHOD 'nudge',
   regrid_cntiso_hybrid_nudge_jslice, :560-916), or place them where a
   monotone reconstruction of the density crosses the targets ('direct',
   regrid_cntiso_hybrid_direct_jslice, :286-560, in blom_tpu's form);
2. smooth weakly stratified interfaces laterally (regrid_smooth_jslice,
   :946-1020);
3. remap the tracers onto the new grid, recompute dpu/dpv and remap the
   velocities (:1022-1057, :1760-1960).

The reconstruction is RECONSTRUCTION_METHOD's (`_recon`): 'pqm',
'ppm_ih4', or explicit-edge PPM for any other name, as in blom_tpu.

Steps 1 and 3 are column-local.  A CUDA tensor goes through the two
hand-written kernels of ale_cuda (csrc/ale_regrid.cu for 1,
csrc/ale_remap.cu for 3) exactly where blom_tpu's `_ale_pallas_ok` takes
its Pallas kernels for the method: reconstruction_method 'ppm' with
regrid_method 'nudge', the two schemes the kernels compute
(`ale_kernels_ok`).  Nothing else decides it: no environment switch,
dtype test or fallback, so that path on a CUDA tensor runs the kernels
or raises.  Every other method runs the plain PyTorch functions below,
on the card as on the CPU, as blom_tpu runs them as XLA.  On CPU tensors
the nudge path is `regrid_plain` and `remap_plain`'s PyTorch code, which
copies blom_tpu's CPU path: T, S and the tracers are reconstructed once
and the reconstructions serve the regrid and the remap, and the
monotonic clamp of the regrid is the sequential scan (blom_tpu's
clamp_impl='scan'; its TPU kernel uses the cummax form, about one ULP of
the pressure apart)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import eos
from ..core.constants import epsilp, grav, onem
from ..core.grid import Grid
from ..core.state import State, cumulative_p, dpu_dpv_upstream
from ..ops import hor3map as h3


class AleParams(NamedTuple):
    plevel: tuple            # (kk,) minimum interface depths [Pa]
    dpmin_interior: float    # [Pa]
    regrid_nudge_ts: float   # [s]
    stab_fac_limit: float
    smooth_diff_max: float   # [m2 s-1]
    k_range_plevel: int
    tracer_limiting: str = h3.NON_OSCILLATORY
    velocity_limiting: str = h3.NON_OSCILLATORY
    tracer_pc_upper: bool = True
    velocity_pc_upper: bool = True
    # 'ppm' (explicit edges) | 'ppm_ih4' (implicit 4th-order edges) |
    # 'pqm' (implicit 6th/5th-order quartic): RECONSTRUCTION_METHOD and
    # the bndr_ord options (mod_ale_regrid_remap.F90:62-81)
    reconstruction_method: str = 'ppm'
    upper_bndr_ord: int = 6
    lower_bndr_ord: int = 4
    # 'nudge' | 'direct' (REGRID_METHOD, mod_ale_regrid_remap.F90:68)
    regrid_method: str = 'nudge'
    bfsq_min: float = 1.e-7   # monotonization slope floor [s-2]


def make_ale_params(kk: int, dpmin_surface_m: float = 1.5,
                    dpmin_inflation: float = 1.0,
                    dpmin_interior_m: float = .1,
                    regrid_nudge_ts: float = 86400.,
                    stab_fac_limit: float = .75,
                    smooth_diff_max: float = 50000.,
                    k_range_plevel: int = 4,
                    reconstruction_method: str = 'ppm') -> AleParams:
    """The fuk95 deck's values (tests/fuk95/limits:231-249) and the
    vcoord defaults (mod_vcoord.F90:87-88; plevel 'inflation',
    :948-955)."""
    plevel = [0.0]
    dpmin = dpmin_surface_m * onem
    for _ in range(kk - 1):
        plevel.append(plevel[-1] + dpmin)
        dpmin *= dpmin_inflation
    return AleParams(plevel=tuple(plevel),
                     dpmin_interior=dpmin_interior_m * onem,
                     regrid_nudge_ts=regrid_nudge_ts,
                     stab_fac_limit=stab_fac_limit,
                     smooth_diff_max=smooth_diff_max,
                     k_range_plevel=k_range_plevel,
                     reconstruction_method=reconstruction_method)


LIMITERS = (h3.MONOTONIC, h3.NON_OSCILLATORY, h3.NON_OSCILLATORY_POSDEF)


def check_ale(ale: AleParams):
    """Raise ValueError for a limiting that is not one of the three
    limiters."""
    for name in ('tracer_limiting', 'velocity_limiting'):
        if getattr(ale, name) not in LIMITERS:
            raise ValueError(f'ALE {name}={getattr(ale, name)!r}: expected '
                             f'one of {LIMITERS}')


def ale_kernels_ok(ale: AleParams) -> bool:
    """Whether kernels K1 and K2 compute this method: explicit-edge PPM
    with the nudge regrid, the method blom_tpu's `_ale_pallas_ok` sends
    to its Pallas kernels."""
    return (ale.reconstruction_method == 'ppm'
            and ale.regrid_method == 'nudge')


def check_kernel_method(ale: AleParams):
    """Raise ValueError unless kernels K1 and K2 (and their plain
    versions) compute this method and its limiters."""
    check_ale(ale)
    if not ale_kernels_ok(ale):
        raise ValueError(
            'ALE kernels K1 and K2 compute explicit-edge PPM with the '
            'nudge regrid, not reconstruction_method='
            f'{ale.reconstruction_method!r} with regrid_method='
            f'{ale.regrid_method!r}')


def _recon(ale: AleParams, p, tm, limiting, pc_upper=False,
           pc_lower=False):
    """Reconstruction dispatch (RECONSTRUCTION_METHOD,
    mod_ale_regrid_remap.F90:62-81): PQM with ih6/ih5 implicit edges and
    slopes, implicit-edge ih4 PPM, or explicit-edge PPM for any other
    name."""
    m = ale.reconstruction_method
    if m == 'pqm':
        return h3.pqm_reconstruct(p, tm, limiting, pc_upper, pc_lower,
                                  lb_ord=ale.upper_bndr_ord,
                                  rb_ord=ale.lower_bndr_ord)
    if m == 'ppm_ih4':
        return h3.ppm_ih4_reconstruct(p, tm, limiting, pc_upper, pc_lower,
                                      lb_ord=min(ale.upper_bndr_ord, 4),
                                      rb_ord=min(ale.lower_bndr_ord, 4))
    return h3.ppm_reconstruct(p, tm, limiting, pc_upper, pc_lower)


def _recon_multi(ale: AleParams, p, tms, limiting, pc_upper=False,
                 pc_lower=False):
    """Reconstruct several fields on the shared interfaces p; explicit-
    edge PPM computes its grid-only edge weights once."""
    if ale.reconstruction_method == 'ppm':
        return h3.ppm_reconstruct_multi(p, tms, limiting, pc_upper,
                                        pc_lower)
    return [_recon(ale, p, tm, limiting, pc_upper, pc_lower) for tm in tms]


def _sigma_at(p_src, sig_up, sig_lo, pq):
    """Density at the pressures pq, linear in the first source layer
    that contains each (regrid nudge's sig_pmin, :643-651); below the
    column, the deepest lower-interface value."""
    dp = p_src[1:] - p_src[:-1]
    dpi = 1.0 / torch.clamp(dp, min=epsilp)
    got = torch.zeros_like(pq)
    found = torch.zeros(pq.shape, dtype=torch.bool, device=pq.device)
    for k in range(dp.shape[0]):
        p_up = p_src[k]
        inl = (pq >= p_up[None]) & (pq < (p_up + dp[k])[None]) & (~found)
        w = torch.clamp((pq - p_up[None]) * dpi[k][None], 0., 1.)
        got = torch.where(inl, (1. - w) * sig_up[k][None]
                          + w * sig_lo[k][None], got)
        found = found | inl
    return torch.where(found, got, sig_lo[-1])


def regrid_nudge(kk: int, e: eos.EosParams, ale: AleParams, p_src,
                 rc_t: h3.Recon, rc_s: h3.Recon, sigmar, delt1):
    """Nudge the interface pressures toward the interface target
    densities (regrid_cntiso_hybrid_nudge_jslice, :560-916), with the
    monotonic minimum-thickness clamp as a sequential scan.  Returns
    (p_dst, smooth_fac), both (kk+1, H)."""
    H = p_src.shape[1:]
    dev = p_src.device
    p_bot = p_src[kk]

    t_up, t_lo = rc_t.eval0(), rc_t.eval1()
    s_up, s_lo = rc_s.eval0(), rc_s.eval1()
    sig_up = eos.sig(e, t_up, s_up)      # (kk, H)
    sig_lo = eos.sig(e, t_lo, s_lo)

    dp_src = p_src[1:] - p_src[:-1]
    wet_layer = dp_src > epsilp
    sig_max = torch.where(wet_layer, sig_lo, -torch.inf).amax(0)
    sig_max = torch.where(torch.isfinite(sig_max), sig_max, 0.)

    sig_trg = sigmar
    dsig_trg = torch.cat([sig_trg[1:] - sig_trg[:-1],
                          sig_trg[-1:] - sig_trg[-2:-1]], 0)
    dsig_trg = torch.clamp(dsig_trg, min=1e-12)

    kidx = h3._kidx(kk, 1 + len(H), dev)

    # kdmx (1-based): number of target densities lighter than the
    # densest reconstructed water, at least 1
    kdmx = torch.clamp((sig_trg < sig_max).sum(0), min=1)

    plevel = torch.tensor(ale.plevel, dtype=p_src.dtype, device=dev)
    pmin = torch.minimum(plevel.reshape((kk,) + (1,) * len(H)) + p_src[0],
                         p_bot)                        # (kk, H)

    nudge_fac = delt1 / ale.regrid_nudge_ts

    sig_pmin = _sigma_at(p_src, sig_up, sig_lo, pmin)

    # transition interface kt (1-based): first k > k_range_plevel with
    # sig_trg(k) > sig_pmin(k), limited to <= kdmx
    kb = ale.k_range_plevel
    cond = (kidx + 1 > kb) & (kidx + 1 <= kdmx) & (sig_trg > sig_pmin)
    kt = torch.where(cond.any(0),
                     torch.argmax(cond.to(torch.float32), 0) + 1, kdmx + 1)

    # pressure-regime candidates of interfaces k = 2..kk (1-based)
    p_int = p_src[1:-1]
    cand_press = p_int + nudge_fac * (pmin[1:] - p_int)

    # isopycnal-regime candidates (cases A/B/C)
    su = sig_lo[:-1]
    sl = sig_up[1:]
    st = sig_trg[1:]

    dsdx_up = (eos.dsigdt(e, t_lo, s_lo) * rc_t.deval1()
               + eos.dsigds(e, t_lo, s_lo) * rc_s.deval1())[:-1]
    dsdx_lo = (eos.dsigdt(e, t_up, s_up) * rc_t.deval0()
               + eos.dsigds(e, t_up, s_up) * rc_s.deval0())[1:]

    dst_km1 = dsig_trg[:-1]
    dst_k = dsig_trg[1:]

    dp_up = torch.clamp(p_src[1:-1] - p_src[:-2], min=epsilp)
    dp_lo = torch.clamp(p_src[2:] - p_src[1:-1], min=epsilp)

    lim = ale.stab_fac_limit

    def nudge_up(dsig, dsigdx_raw, dstv):
        stab = dsigdx_raw / dstv
        dsigdx = dstv * torch.clamp(stab, min=lim)
        delta = torch.clamp(dsig * nudge_fac / dsigdx, min=-.5) \
            * (p_src[1:-1] - p_src[:-2])
        return delta, stab

    def nudge_dn(dsig, dsigdx_raw, dstv):
        stab = dsigdx_raw / dstv
        dsigdx = dstv * torch.clamp(stab, min=lim)
        delta = torch.clamp(dsig * nudge_fac / dsigdx, max=.5) \
            * (p_src[2:] - p_src[1:-1])
        return delta, stab

    # case A: target lighter than both neighbours -> move up
    dA, stabA = nudge_up(st - su, dsdx_up, dst_km1)
    # case B: target denser than both -> move down
    dB, stabB = nudge_dn(st - sl, dsdx_lo, dst_k)
    # case C: in between; the interpolated density decides the direction
    sig_intrp = ((sl + .5 * dsdx_lo) * dp_up
                 + (su - .5 * dsdx_up) * dp_lo) / (dp_up + dp_lo)
    sig_intrp = torch.clamp(sig_intrp, torch.minimum(su, sl),
                            torch.maximum(su, sl))
    dsigC = st - sig_intrp
    dCu, stabCu = nudge_up(dsigC, dsdx_up + 2. * (sig_intrp - su), dst_km1)
    dCd, stabCd = nudge_dn(dsigC, dsdx_lo + 2. * (sl - sig_intrp), dst_k)
    dC = torch.where(dsigC < 0., dCu, dCd)
    stabC = torch.where(dsigC < 0., stabCu, stabCd)

    caseA = (st < su) & (st < sl)
    caseB = (st > su) & (st > sl)
    delta = torch.where(caseA, dA, torch.where(caseB, dB, dC))
    stab = torch.where(caseA, stabA, torch.where(caseB, stabB, stabC))
    cand_iso = p_src[1:-1] + delta
    sf_iso = torch.clamp((lim - stab) / lim, 0., 1.)

    # per interface: [2, kt) pressure regime, [kt, kdmx] isopycnal,
    # (kdmx, kk] bottom
    kif = kidx[1:] + 1
    press_reg = kif < kt
    iso_reg = (kif >= kt) & (kif <= kdmx)
    cand = torch.where(press_reg, cand_press,
                       torch.where(iso_reg, cand_iso, p_bot))
    sfac = torch.where(press_reg, 1.0, torch.where(iso_reg, sf_iso, 0.))

    # monotonic clamp with the minimum interior thickness, in order
    prev = p_src[0]
    mids = []
    for k in range(kk - 1):
        prev = torch.minimum(
            torch.maximum(torch.maximum(cand[k], pmin[k + 1]),
                          prev + ale.dpmin_interior), p_bot)
        mids.append(prev)
    p_dst = torch.stack([p_src[0]] + mids + [p_bot], 0)
    smooth_fac = torch.cat([torch.ones_like(sfac[:1]), sfac,
                            torch.zeros_like(sfac[:1])], 0)
    return p_dst, smooth_fac


def regrid_direct(grid: Grid, e: eos.EosParams, ale: AleParams, p_src,
                  sigma_n, sigmar):
    """Direct regrid: the interfaces where a monotone reconstruction of
    the column's potential density crosses the interface target
    densities (regrid_cntiso_hybrid_direct_jslice,
    mod_ale_regrid_remap.F90:286-560), in blom_tpu's form, not the
    reference's loops: the run-merge monotonization is a fixed-iteration
    Jacobi pairwise merge with the same dp-weighted means and beta/2
    slope floor, and the surface transition zone takes the plevel
    minimum clamp (the nudge path's pmin) in place of the quadratic
    blending of :530-556.  Returns (p_dst, smooth_fac)."""
    kk = grid.kk
    H = p_src.shape[1:]
    dev = p_src.device
    p_bot = p_src[kk]
    beta = ale.bfsq_min / (grav * grav)

    # monotonize the density with the beta/2 slope floor (:337-402):
    # Jacobi pairwise merges
    sig = sigma_n
    dp_src = torch.clamp(p_src[1:] - p_src[:-1], min=0.)
    span = p_src[2:] - p_src[:-2]                  # (kk-1, H)
    kidx = torch.arange(kk - 1, device=dev).reshape((kk - 1,)
                                                    + (1,) * len(H))
    wsum = dp_src[:-1] + dp_src[1:]
    for it in range(kk):
        # merge the violating pairs (k, k+1), k = it % 2, it % 2 + 2, ...,
        # into their dp-weighted mean with the beta/2 slope restored
        viol = (sig[1:] - sig[:-1]) < .5 * beta * span
        act = viol & ((kidx % 2) == it % 2)
        smean = (sig[:-1] * dp_src[:-1] + sig[1:] * dp_src[1:]) \
            / torch.clamp(wsum, min=epsilp)
        up = smean + .5 * beta * (p_src[1:-1] - p_src[2:])
        lo = smean + .5 * beta * (p_src[1:-1] - p_src[:-2])
        new_up = torch.where(act, up, sig[:-1])
        new_lo = torch.where(act, lo, sig[1:])
        sig = torch.cat([new_up[:1],
                         torch.where(act[1:], up[1:], new_lo[:-1]),
                         new_lo[-1:]], 0)

    # monotone reconstruction and root-finding regrid
    rc_sig = h3.ppm_reconstruct(p_src, sig, h3.MONOTONIC)
    sig_trg = torch.cat([sigmar, sigmar[-1:]], 0)
    p_cand = h3.regrid_crossings(rc_sig, sig_trg)      # (kk+1, H)

    # boundedness (:424-441): leading missing values go to the column
    # top, trailing ones to the bottom
    found = p_cand > .5 * h3.REGRID_MVAL
    lead = torch.cumsum(found.to(torch.int32), 0) == 0
    trail = torch.flip(torch.cumsum(torch.flip(found, (0,)).to(torch.int32),
                                    0), (0,)) == 0
    p_cand = torch.where(lead, p_src[:1], p_cand)
    p_cand = torch.where(trail & (~lead), p_bot[None], p_cand)

    # all missing (:445-461): the column goes into the layer whose
    # target-density bounds bracket its mean density
    none_found = ~found.any(0)
    smean_col = (sig * dp_src).sum(0) \
        / torch.clamp(p_bot - p_src[0], min=epsilp)
    kidx1 = torch.arange(1, kk + 1, device=dev).reshape((kk,)
                                                        + (1,) * len(H))
    # the first 1-based k in [2, kk] with smean < sig_trg(k); every
    # interface >= ks goes to the bottom
    cond = (smean_col[None] < sig_trg[1:]) & (kidx1 >= 2)
    ks = torch.where(cond.any(0),
                     torch.argmax(cond.to(torch.int32), 0) + 1, kk + 1)
    qidx = torch.arange(kk + 1, device=dev).reshape((kk + 1,)
                                                    + (1,) * len(H))
    fallback = torch.where(qidx >= ks[None], p_bot[None], p_src[:1])
    p_cand = torch.where(none_found[None], fallback, p_cand)

    # plevel surface minima and the minimum-thickness monotone clamp
    # (:466-556 simplified, the nudge path's machinery)
    plevel = torch.tensor(ale.plevel, dtype=p_src.dtype, device=dev)
    pmin = torch.minimum(plevel.reshape((kk,) + (1,) * len(H)) + p_src[0],
                         p_bot)
    dpmin = min(ale.plevel[1] - ale.plevel[0], ale.dpmin_interior)
    prev = p_src[0]
    mids = []
    for k in range(kk):
        prev = torch.minimum(torch.maximum(torch.maximum(p_cand[1 + k],
                                                         pmin[k]),
                                           prev + dpmin), p_bot)
        mids.append(prev)
    p_dst = torch.stack([p_src[0]] + mids[:-1] + [p_bot], 0)
    # smoothing only where the interface sits at its plevel minimum
    at_pmin = (p_dst[1:-1] - pmin[:-1]).abs() < 1e-6
    sfac = at_pmin.to(p_src.dtype)
    smooth_fac = torch.cat([torch.ones_like(sfac[:1]), sfac,
                            torch.zeros_like(sfac[:1])], 0)
    return p_dst, smooth_fac


def regrid_smooth(grid: Grid, ale: AleParams, p_dst, smooth_fac, delt1):
    """Flux-limited lateral diffusion of weakly stratified interfaces
    (regrid_smooth_jslice, :946-1020)."""
    im1, ip1, jm1, jp1 = grid.im1, grid.ip1, grid.jm1, grid.jp1
    iu, iv, ip = grid.iu, grid.iv, grid.ip

    pd = p_dst
    dlayer_up = pd[1:-1] - pd[:-2]
    dlayer_lo = pd[2:] - pd[1:-1]

    # u-direction
    cdiff = delt1 * grid.scuy * grid.scuxi
    difmx = .5 * (im1(grid.difmxp) + grid.difmxp)
    flxhi = .125 * torch.minimum(im1(dlayer_up) * im1(grid.scp2),
                                 dlayer_lo * grid.scp2)
    flxlo = -.125 * torch.minimum(dlayer_up * grid.scp2,
                                  im1(dlayer_lo) * im1(grid.scp2))
    sdiff = torch.minimum(.5 * (im1(smooth_fac[1:-1]) + smooth_fac[1:-1])
                          * ale.smooth_diff_max, difmx)
    flxu = torch.clamp(cdiff * sdiff * (im1(pd[1:-1]) - pd[1:-1]),
                       flxlo, flxhi) * iu

    # v-direction
    cdiffv = delt1 * grid.scvx * grid.scvyi
    difmxv = .5 * (jm1(grid.difmxp) + grid.difmxp)
    flxhiv = .125 * torch.minimum(jm1(dlayer_up) * jm1(grid.scp2),
                                  dlayer_lo * grid.scp2)
    flxlov = -.125 * torch.minimum(dlayer_up * grid.scp2,
                                   jm1(dlayer_lo) * jm1(grid.scp2))
    sdiffv = torch.minimum(.5 * (jm1(smooth_fac[1:-1]) + smooth_fac[1:-1])
                           * ale.smooth_diff_max, difmxv)
    flxv = torch.clamp(cdiffv * sdiffv * (jm1(pd[1:-1]) - pd[1:-1]),
                       flxlov, flxhiv) * iv

    conv = (ip1(flxu) - flxu + jp1(flxv, 'v', True) - flxv)
    p_new_mid = (pd[1:-1] - conv * grid.scp2i) * ip
    return torch.cat([pd[:1], p_new_mid, pd[-1:]], 0)


def regrid_plain(e: eos.EosParams, ale: AleParams, p_src, temp, saln,
                 sigmar, delt1):
    """What kernel K1 (csrc/ale_regrid.cu) computes, in PyTorch: the PPM
    reconstruction of T and S on p_src and the nudge regrid.  Returns
    (p_dst, smooth_fac)."""
    check_kernel_method(ale)
    rc_t, rc_s = _recon_multi(ale, p_src, [temp, saln], ale.tracer_limiting,
                              pc_upper=ale.tracer_pc_upper)
    return regrid_nudge(p_src.shape[0] - 1, e, ale, p_src, rc_t, rc_s,
                        sigmar, delt1)


def _remap_recons(ale: AleParams, rcs_p, pu_q, u, pv_q, v, p_dst, pu_new,
                  pv_new):
    rc_u = _recon(ale, pu_q, u, ale.velocity_limiting,
                  pc_upper=ale.velocity_pc_upper)
    rc_v = _recon(ale, pv_q, v, ale.velocity_limiting,
                  pc_upper=ale.velocity_pc_upper)
    means, (u_mean,), (v_mean,) = h3.remap_groups(
        [(rcs_p, p_dst), ([rc_u], pu_new), ([rc_v], pv_new)],
        bottom_only_empties=True)
    return means, u_mean, v_mean


def remap_plain(ale: AleParams, p_src, tms, pu_q, u, pv_q, v, p_dst,
                pu_new, pv_new):
    """What kernel K2 (csrc/ale_remap.cu) computes, in PyTorch: PPM
    reconstructions of the tracers tms on p_src, of u on pu_q and of v on
    pv_q, remapped onto p_dst, pu_new and pv_new.  Returns (means,
    u_mean, v_mean)."""
    check_kernel_method(ale)
    rcs_p = _recon_multi(ale, p_src, list(tms), ale.tracer_limiting,
                         pc_upper=ale.tracer_pc_upper)
    return _remap_recons(ale, rcs_p, pu_q, u, pv_q, v, p_dst, pu_new,
                         pv_new)


def ale_regrid_remap(grid: Grid, e: eos.EosParams, ale: AleParams,
                     s: State, m: int, n: int, delt1) -> State:
    """The ALE step (ale_regrid_remap, :1486-1984), in place on time
    level n.  CUDA tensors go through the two kernels of ale_cuda where
    `ale_kernels_ok`, through the plain functions otherwise; CPU tensors
    through the plain functions."""
    check_ale(ale)
    kk = grid.kk
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    im1, jm1 = grid.im1, grid.jm1

    p_src = cumulative_p(s.dp[n]) * ip
    p_bot = p_src[kk]
    ntr = s.trc.shape[1]
    tms = [s.temp[n], s.saln[n]] + [s.trc[n, t] for t in range(ntr)]
    use_kernels = p_src.is_cuda and ale_kernels_ok(ale)

    # REGRID_METHOD dispatch (mod_ale_regrid_remap.F90:68); the plain
    # paths reconstruct the tracers once for the regrid and the remap
    if use_kernels:
        from .ale_cuda import regrid_cuda
        p_dst, smooth_fac = regrid_cuda(e, ale, p_src, s.temp[n],
                                        s.saln[n], s.sigmar, delt1)
    else:
        rcs_p = _recon_multi(ale, p_src, tms, ale.tracer_limiting,
                             pc_upper=ale.tracer_pc_upper)
        p_dst, smooth_fac = (
            regrid_direct(grid, e, ale, p_src, s.sigma[n], s.sigmar)
            if ale.regrid_method == 'direct' else
            regrid_nudge(kk, e, ale, p_src, rcs_p[0], rcs_p[1], s.sigmar,
                         delt1))

    if ale.smooth_diff_max > 0.:
        p_dst = regrid_smooth(grid, ale, p_dst, smooth_fac, delt1)

    dp_new = torch.clamp(p_dst[1:] - p_dst[:-1], min=0.) * ip
    pu_old = cumulative_p(s.dpu[n])
    pv_old = cumulative_p(s.dpv[n])
    p_new = cumulative_p(dp_new) * ip
    dpu_new, dpv_new = dpu_dpv_upstream(grid, p_new)
    pu_new = cumulative_p(dpu_new)
    pv_new = cumulative_p(dpv_new)

    # old velocity-point interfaces rescaled to the new column range
    qu = torch.minimum(im1(p_bot), p_bot) \
        / torch.clamp(pu_old[kk], min=epsilp)
    qv = torch.minimum(jm1(p_bot), p_bot) \
        / torch.clamp(pv_old[kk], min=epsilp)

    if use_kernels:
        from .ale_cuda import remap_cuda
        means, u_mean, v_mean = remap_cuda(
            ale, p_src, tms, pu_old * qu, s.u[n], pv_old * qv, s.v[n],
            p_dst, pu_new, pv_new)
    else:
        means, u_mean, v_mean = _remap_recons(
            ale, rcs_p, pu_old * qu, s.u[n], pv_old * qv, s.v[n], p_dst,
            pu_new, pv_new)

    temp_new = means[0] * ip
    saln_new = means[1] * ip
    for t in range(ntr):
        s.trc[n, t] = means[2 + t] * ip
    s.dp[n] = dp_new
    s.temp[n] = temp_new
    s.saln[n] = saln_new
    s.sigma[n] = eos.sig(e, temp_new, saln_new) * ip
    s.u[n] = u_mean * iu
    s.v[n] = v_mean * iv
    s.dpu[n] = dpu_new
    s.dpv[n] = dpv_new
    s.dpuold, s.dpvold = dpu_new, dpv_new
    s.p, s.pu, s.pv = p_new, pu_new, pv_new
    return s
