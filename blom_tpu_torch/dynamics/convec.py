"""Convective adjustment (isopycnic bulk-mixed-layer regime).

Counterpart of `blom_tpu/dynamics/convec.py` (BLOM's
mod_convec.F90:43-449): remove static instabilities between the lower
mixed layer (layer 2) and the interior isopycnic layers by mixing the
mixed layer downward while the in-situ density jump across its base is
unstable, then re-assign the first physical layer index kfpla so that
the mixed water sits in its density class; the kfplo history merge
(:108-186) and the momentum redistribution (:305-449) as blom_tpu has
them.  blom_tpu's k-scans are Python loops over k on (jdm, idm)
tensors; its masked one-hot selections stay masked sums."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import epsilp
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..ops import hor3map as h3
from ..ops.reduce import ksum


def _collapse_thin(delp):
    """Collapse the leading run of thin interior layers (k >= 2, 0-based)
    into the first thick one (mod_convec.F90:91-106).  Returns
    (delp_new, kfpl) with kfpl 0-based, kk where every interior layer is
    thin (their mass then goes to layer 1)."""
    kk = delp.shape[0]
    H = delp.shape[1:]
    dps = delp.new_zeros(H)
    kf = torch.full(H, -1, dtype=torch.int32, device=delp.device)
    found = torch.zeros(H, dtype=torch.bool, device=delp.device)
    rows = []
    for k in range(kk):
        dp_k = delp[k]
        interior = k >= 2
        thin = (dp_k < epsilp) & interior
        take = ~found & thin
        dps = dps + torch.where(take, dp_k, 0.)
        add_here = ~found & ~thin & interior
        rows.append(torch.where(take, 0., dp_k)
                    + torch.where(add_here, dps, 0.))
        dps = torch.where(add_here, 0., dps)
        found = found | add_here
        kf = torch.where(add_here & (kf < 0), k, kf)
    rows[1] = rows[1] + torch.where(found, 0., dps)
    return torch.stack(rows), torch.where(found, kf, kk).to(torch.int32)


def convec(grid: Grid, e: eos.EosParams, s: State, m: int, n: int) -> State:
    """Convective adjustment of time level n, in place."""
    kk = grid.kk
    ip = grid.ip
    kidx = torch.arange(kk, dtype=torch.int32, device=ip.device).reshape(
        (kk,) + (1,) * len(grid.shape))

    ttem = s.temp[n].clone()
    ssal = s.saln[n].clone()
    densr = s.sigmar
    ntr = s.trc.shape[1]
    ttrc = s.trc[n].clone()

    delp, kfpl = _collapse_thin(s.dp[n])

    # ---- kfplo history merge (mod_convec.F90:108-186): when the first
    # physical layer moved up since the last step, merge the layers
    # between and re-place the merged water in its density class
    kfplo = s.kfpla[n].to(torch.int32)
    hist = kfpl < kfplo

    def merge(rng):
        dps = ksum(torch.where(rng, delp, 0.), 0)
        q = 1. / torch.clamp(dps, min=epsilp)
        ttmp = ksum(torch.where(rng, ttem * delp, 0.), 0) * q
        stmp = ksum(torch.where(rng, ssal * delp, 0.), 0) * q
        trmix = (ksum(torch.where(rng[None], ttrc * delp[None], 0.), 1)
                 * q[None]) if ntr else None
        return dps, ttmp, stmp, trmix

    # case A: kfplo within the column (:110-148)
    rng_a = (kidx >= kfpl) & (kidx <= kfplo)
    dps_a, tt_a, ss_a, tr_a = merge(rng_a)
    dt_a = eos.sig(e, tt_a, ss_a)
    densr_o = torch.where(kidx == kfplo, densr, 0.).sum(0)
    apply_a = hist & (kfplo <= kk - 1) & (dt_a > densr_o)
    zero_a = rng_a & (kidx < kfplo)
    at_a = kidx == kfplo

    # case B: no previous physical layer (:149-185): merge to the bottom
    # and find the fitting density class
    rng_b = (kidx >= kfpl) & (kidx <= kk - 1)
    dps_b, tt_b, ss_b, tr_b = merge(rng_b)
    dt_b = eos.sig(e, tt_b, ss_b)
    fits = (dt_b[None] >= densr) & (kidx >= 2)
    kfpl_b = torch.clamp(torch.where(fits, kidx, 2).amax(0), min=2)
    apply_b = hist & (kfplo > kk - 1)
    zero_b = rng_b
    at_b = kidx == kfpl_b

    for apply_x, zero_x, at_x, dps_x, tt_x, ss_x, tr_x, kf_x in (
            (apply_a, zero_a, at_a, dps_a, tt_a, ss_a, tr_a, kfplo),
            (apply_b, zero_b, at_b, dps_b, tt_b, ss_b, tr_b, kfpl_b)):
        put = apply_x[None] & at_x
        delp = torch.where(apply_x[None] & zero_x, 0., delp)
        delp = torch.where(put, dps_x[None], delp)
        ttem = torch.where(put, tt_x[None], ttem)
        ssal = torch.where(put, ss_x[None], ssal)
        if ntr:
            ttrc = torch.where(put[None], tr_x[:, None], ttrc)
        kfpl = torch.where(apply_x, kf_x, kfpl)

    # ---- mixing extent (mod_convec.F90:207-246): accumulate layers
    # downward from kfpl while the density jump at the accumulated mass
    # is unstable (the reference's converge loop body runs once,
    # :193-203)
    t2, s2 = ttem[1], ssal[1]
    tdps, sdps, dps = t2 * delp[1], s2 * delp[1], delp[1]
    tmix, smix = t2, s2
    mixing = torch.ones(grid.shape, dtype=torch.bool, device=ip.device)
    absorbed = []
    for k in range(kk):
        t_k, s_k, dp_k = ttem[k], ssal[k], delp[k]
        at_depth = k >= kfpl
        unstable = ((eos.rho(dps, tmix, smix) > eos.rho(dps, t_k, s_k))
                    | (dp_k < epsilp))
        absorb = mixing & at_depth & unstable
        tdps = tdps + torch.where(absorb, t_k * dp_k, 0.)
        sdps = sdps + torch.where(absorb, s_k * dp_k, 0.)
        dps = dps + torch.where(absorb, dp_k, 0.)
        q = 1.0 / torch.clamp(dps, min=epsilp)
        tmix = torch.where(absorb, tdps * q, tmix)
        smix = torch.where(absorb, sdps * q, smix)
        mixing = mixing & torch.where(at_depth, absorb, True)
        absorbed.append(absorb)
    absorbed = torch.stack(absorbed)

    any_mix = absorbed.any(0)
    kmix = torch.where(absorbed, kidx, -1).amax(0)
    dens_mix = eos.sig(e, tmix, smix)

    # new kfpl: the deepest k in [2, kmix] with densr(k) <= dens_mix, or 2
    # (mod_convec.F90:252-262)
    ok_class = (dens_mix[None] >= densr) & (kidx >= 2) & (kidx <= kmix)
    kfpl_new = torch.clamp(torch.where(ok_class, kidx, 1).amax(0), min=2)
    kfpl_new = torch.minimum(kfpl_new, torch.clamp(kmix, min=2))

    # mass absorbed from the interior
    dps_int = ksum(torch.where(absorbed & (kidx >= 2), delp, 0.), 0)

    upd = any_mix & (kmix >= kfpl)
    t2n = torch.where(upd, tmix, t2)
    s2n = torch.where(upd, smix, s2)

    zero_zone = absorbed & (kidx >= 2)
    at_kfpl = kidx == kfpl_new[None]
    between = (kidx > kfpl_new[None]) & (kidx <= kmix[None])

    if ntr:
        # mixed tracer value over the ML and the absorbed layers
        trmix = (ksum(torch.where(zero_zone[None], ttrc * delp[None], 0.), 1)
                 + ttrc[:, 1] * delp[1][None]) \
            / torch.clamp(dps, min=epsilp)[None]
        place = (at_kfpl | between)[None] & upd[None, None]
        ttrc = torch.where(place, trmix[:, None], ttrc)
        ttrc[:, 1] = torch.where(upd[None], trmix, ttrc[:, 1])

    delp = torch.where(upd[None] & zero_zone, 0., delp)
    delp = torch.where(upd[None] & at_kfpl, dps_int[None], delp)
    ttem = torch.where(upd[None] & (at_kfpl | between), t2n[None], ttem)
    # layers between kfpl and kmix take their reference density class
    # (mod_convec.F90:264-268): T from the ML, S from sofsig
    ssal_b = eos.sofsig(e, densr, t2n[None])
    ssal = torch.where(upd[None] & at_kfpl, s2n[None],
                       torch.where(upd[None] & between, ssal_b, ssal))
    ttem[1] = t2n
    ssal[1] = s2n
    kfpl = torch.where(upd, kfpl_new, kfpl)

    s.sigma[n] = eos.sig(e, ttem, ssal) * ip
    s.temp[n] = ttem * ip
    s.saln[n] = ssal * ip
    s.dp[n] = delp * ip
    s.kfpla[n] = kfpl
    if ntr:
        s.trc[n] = ttrc

    # ---- momentum redistribution (mod_convec.F90:305-449): remap u/v
    # conservatively from the old velocity-point pressure grid onto the
    # one implied by the convected thicknesses; empty new layers get 0
    p_new = cumulative_p(s.dp[n]) * ip

    def remap_vel(vel, p_old_uv, mask, nbr):
        pb_uv = p_old_uv[kk][None]
        pn = .5 * (torch.minimum(pb_uv, p_new)
                   + torch.minimum(pb_uv, nbr(p_new)))
        zero = torch.zeros_like(vel)
        means = h3.remap_means(h3.Recon(p=p_old_uv, c0=vel, c1=zero,
                                        c2=zero), pn)
        dpn = pn[1:] - pn[:-1]
        return torch.where(dpn > 0., means, 0.) * mask

    s.u[n] = remap_vel(s.u[n], s.pu, grid.iu, grid.im1)
    s.v[n] = remap_vel(s.v[n], s.pv, grid.iv, grid.jm1)
    return s
