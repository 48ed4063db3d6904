"""Eddy-induced (bolus) transport: Gent-McWilliams.

Counterpart of `blom_tpu/dynamics/eddtra.py`: `eddtra` for the ALE path
(BLOM's mod_eddtra.F90 eddtra_ale, :1001-1800), the GM interface
streamfunction -kappa * neutral slope as a mass flux, ramped linearly to
zero through the mixed layer; `eddtra_isopyc` for the isopycnic
coordinate (eddtra_gm_isopyc_bulkml, :228-1000), where the interfaces
are the neutral surfaces and the streamfunction is kappa times their
pressure slope.  Both are limited so that no cell loses more than
ffac = 1/16 of its mass in a step.

The limiter repeats alternating up/down sweeps over the layers until a
sweep changes no column (at most N_SWEEPS_MAX).  A column that a sweep
leaves unchanged stays unchanged under further sweeps, so the u and v
problems run through one loop, and whether to sweep again is read on the
host once per sweep: `host_syncs` counts those reads."""

from __future__ import annotations

import dataclasses

import torch

from ..core.constants import epsilp, grav, onem, rho0
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from .cmnfld import CmnFields
from .diffusion_fields import DiffusionFields

ffac = .0625          # max fraction of cell mass depleted (:1011)
fface = .99 * ffac
N_SWEEPS_MAX = 64

host_syncs = 0


def _limit_mfl(mfl, avail_w, avail_c, area_w, area_c):
    """Alternating up/down flux-limiting sweeps (mod_eddtra.F90:1312-1412),
    the first descending.

    mfl: (kk+1, ...) interface mass fluxes; avail_w/avail_c: (kk, ...)
    depletable thickness of the west/centre cell; area_*: the trailing
    shape.  Returns the limited fluxes with mfl[0] = 0."""
    global host_syncs
    kk = mfl.shape[0] - 1
    rows = list(mfl.unbind(0))

    # per-layer bounds, as blom_tpu forms them inside the sweep
    lim_w = ffac * torch.clamp(avail_w, min=epsilp) * area_w
    lim_c = ffac * torch.clamp(avail_c, min=epsilp) * area_c
    q_w = fface * avail_w * area_w
    q_c = fface * avail_c * area_c
    hq_w, nhq_w = .5 * q_w, -.5 * q_w
    hq_c, nhq_c = .5 * q_c, -.5 * q_c

    def limit_layer(k, changed):
        mk, mk1 = rows[k], rows[k + 1]
        d = mk1 - mk
        # depleting the west cell too much: clip the dominating flux
        big = mk1 > -mk
        up_a = mk > nhq_w[k]
        mk1_a = torch.where(up_a, mk + q_w[k], hq_w[k])
        mk_a = torch.where(up_a, mk, -mk1_a)
        dn_b = mk1 < hq_w[k]
        mk_b = torch.where(dn_b, mk1 - q_w[k], nhq_w[k])
        mk1_b = torch.where(dn_b, mk1, -mk_b)
        mk_w = torch.where(big, mk_a, mk_b)
        mk1_w = torch.where(big, mk1_a, mk1_b)
        # depleting the centre cell too much
        bigc = mk1 < -mk
        dn_c = mk < hq_c[k]
        mk1_c = torch.where(dn_c, mk - q_c[k], nhq_c[k])
        mk_c = torch.where(dn_c, mk, -mk1_c)
        up_d = mk1 > nhq_c[k]
        mk_d = torch.where(up_d, mk1 + q_c[k], hq_c[k])
        mk1_d = torch.where(up_d, mk1, -mk_d)
        mk_cc = torch.where(bigc, mk_c, mk_d)
        mk1_cc = torch.where(bigc, mk1_c, mk1_d)

        over_w = d > lim_w[k]
        over_c = d < -lim_c[k]
        rows[k] = torch.where(over_w, mk_w, torch.where(over_c, mk_cc, mk))
        rows[k + 1] = torch.where(over_w, mk1_w,
                                  torch.where(over_c, mk1_cc, mk1))
        return changed | over_w | over_c

    for it in range(N_SWEEPS_MAX):
        changed = torch.zeros(mfl.shape[1:], dtype=torch.bool,
                              device=mfl.device)
        order = range(kk - 1, -1, -1) if it % 2 == 0 else range(kk)
        for k in order:
            changed = limit_layer(k, changed)
        host_syncs += 1
        if not bool(changed.any()):
            break
    rows[0] = torch.zeros_like(rows[0])
    return torch.stack(rows, 0)


def eddtra(grid: Grid, s: State, cf: CmnFields, dfl: DiffusionFields,
           m: int, n: int, delt1) -> DiffusionFields:
    """dfl with the GM eddy-induced mass fluxes umfltd/vmfltd of mid
    level m (eddtra_ale, mod_eddtra.F90:1001-1800)."""
    kk = grid.kk
    iu, iv, ip = grid.iu, grid.iv, grid.ip
    im1, jm1 = grid.im1, grid.jm1

    dp = s.dp[n]
    p = cumulative_p(dp) * ip
    mld_p = cf.mld * onem    # [Pa]
    kidx1 = torch.arange(1, kk + 2, device=p.device).reshape(
        (kk + 1,) + (1,) * (p.ndim - 1))

    def direction(mask, nbr, slp, dpuv, pbuv, scuv):
        # interface streamfunction below the mixed layer
        kappa = .5 * (nbr(dfl.difint) + dfl.difint)    # (kk, H) layers
        kappa_i = torch.cat([kappa[:1], .5 * (kappa[:-1] + kappa[1:]),
                             kappa[-1:]], 0)
        et2mf = -grav * rho0 * delt1 * scuv
        mfl_gm = -kappa_i * slp * et2mf * mask        # (kk+1, H)

        # interfaces 1..kmax, kmax the deepest layer with mass at either
        # adjacent scalar point (:1230-1236)
        pair_wet = (nbr(dp) > epsilp) | (dp > epsilp)
        kmax = torch.where(pair_wet, kidx1[:-1], 1).amax(0)
        act = kidx1 <= kmax[None]
        mfl_gm = mfl_gm * act

        # linear ramp through the mixed layer (:1266-1275)
        puv = cumulative_p(dpuv)
        pml = torch.minimum(puv[0] + .5 * (nbr(mld_p) + mld_p), puv[kk])
        below = (puv > pml) & act
        first_below = torch.cumsum(below.to(torch.int32), 0) == 1
        mfl_base = torch.where(first_below, mfl_gm, 0.).sum(0)
        frac = (puv - puv[0]) / torch.clamp(pml - puv[0], min=epsilp)
        mfl = torch.where(below, mfl_gm,
                          mfl_base[None] * torch.clamp(frac, 0., 1.))
        mfl = torch.where(act, mfl, 0.)
        mfl[0] = 0.
        mfl[kk] = 0.

        # depletable thicknesses (:1300-1308)
        avail_n = torch.clamp(torch.minimum(nbr(p[1:]), pbuv) - nbr(p[:-1]),
                              min=0.)
        avail_c = torch.clamp(torch.minimum(p[1:], pbuv) - p[:-1], min=0.)
        return mfl * mask, avail_n, avail_c

    return _limited_layer_fluxes(
        grid, dfl, m,
        direction(iu, im1, cf.nslpx, s.dpu[n], s.pbu[n], grid.scuy),
        direction(iv, jm1, cf.nslpy, s.dpv[n], s.pbv[n], grid.scvx))


def _limited_layer_fluxes(grid: Grid, dfl: DiffusionFields, m: int,
                          u_parts, v_parts) -> DiffusionFields:
    """dfl with level m of umfltd/vmfltd from the u and v interface
    fluxes, each (mfl, avail_n, avail_c), limited side by side in one
    limiter; a layer's mass flux is the streamfunction difference
    (:1438-1449)."""
    (mu, anu, acu), (mv, anv, acv) = u_parts, v_parts
    mfl = _limit_mfl(torch.stack([mu, mv], 1), torch.stack([anu, anv], 1),
                     torch.stack([acu, acv], 1),
                     torch.stack([grid.im1(grid.scp2),
                                  grid.jm1(grid.scp2)], 0),
                     grid.scp2)
    um, vm = dfl.umfltd.clone(), dfl.vmfltd.clone()
    um[m] = (mfl[1:, 0] - mfl[:-1, 0]) * grid.iu
    vm[m] = (mfl[1:, 1] - mfl[:-1, 1]) * grid.iv
    return dataclasses.replace(dfl, umfltd=um, vmfltd=vm)


def eddtra_isopyc(grid: Grid, s: State, dfl: DiffusionFields,
                  m: int, n: int, delt1) -> DiffusionFields:
    """dfl with the GM eddy-induced mass fluxes umfltd/vmfltd of mid
    level m in the isopycnic coordinate (eddtra_gm_isopyc_bulkml,
    mod_eddtra.F90:228-1000), as blom_tpu's `eddtra_isopyc`: the
    interface streamfunction -kappa * dp/dx on the interfaces below the
    first physical layer of both adjacent columns, ramped linearly to
    zero through the mixed layer, none where the mixed layer reaches the
    bottom on both sides; then the same limiter as `eddtra`."""
    kk = grid.kk
    iu, iv, ip = grid.iu, grid.iv, grid.ip
    im1, jm1 = grid.im1, grid.jm1

    p = cumulative_p(s.dp[n]) * ip
    kfpla = s.kfpla[n]
    kidx = torch.arange(kk + 1, device=p.device).reshape(
        (kk + 1,) + (1,) * (p.ndim - 1))

    def direction(mask, nbr, dpuv, pbuv, scuv, scuvxi):
        kappa = .5 * (nbr(dfl.difint) + dfl.difint)
        kappa_i = torch.cat([kappa[:1], .5 * (kappa[:-1] + kappa[1:]),
                             kappa[-1:]], 0)
        # interface pressure slope at the velocity point [Pa m-1]
        dpdx = (p - nbr(p)) * scuvxi[None]
        et2mf = -grav * rho0 * delt1 * scuv
        mfl_gm = -kappa_i * (-dpdx / (grav * rho0)) * et2mf * mask

        # interfaces above the first physical interior layer of both
        # adjacent columns are mixed-layer interfaces; with the mixed
        # layer to the bottom on both sides there is no flux
        kintr = torch.maximum(kfpla, nbr(kfpla))
        interior = (kidx >= kintr[None]) & (kidx < kk)
        active = (kintr <= kk)[None]

        # linear ramp through the mixed layer from the value at the
        # first interior interface (:430-470)
        first_int = (torch.cumsum(interior.to(torch.int32), 0) == 1) \
            & interior
        mfl_base = torch.where(first_int, mfl_gm, 0.).sum(0)
        p_base = torch.where(first_int, p, 0.).sum(0)
        puv = cumulative_p(dpuv)
        frac = torch.clamp(puv / torch.clamp(p_base[None], min=epsilp),
                           0., 1.)
        mfl = torch.where(interior, mfl_gm, mfl_base[None] * frac)
        mfl = torch.where(active, mfl, 0.)
        mfl[0] = 0.
        mfl[kk] = 0.

        avail_n = torch.clamp(torch.minimum(nbr(p[1:]), pbuv) - nbr(p[:-1]),
                              min=0.)
        avail_c = torch.clamp(torch.minimum(p[1:], pbuv) - p[:-1], min=0.)
        return mfl * mask, avail_n, avail_c

    return _limited_layer_fluxes(
        grid, dfl, m,
        direction(iu, im1, s.dpu[n], s.pbu[n], grid.scuy, grid.scuxi),
        direction(iv, jm1, s.dpv[n], s.pbv[n], grid.scvx, grid.scvyi))
