"""Neutral diffusion of tracers (ltedtp='neutral').

Counterpart of `blom_tpu/dynamics/ndiff.py` (BLOM's mod_ndiff.F90:
ndiff_prep_jslice, ndiff_uflx_jslice:1028-1088,
ndiff_vflx_jslice:1090-1150, ndiff_update_trc_jslice:1152-1175, the pair
flux ndiff_flx:160-953) in blom_tpu's dense form: for every source layer
centre of one column, the neutrally matched position in the neighbour
column is the first sign change from the top of the linearized density
difference, drho = drhodt*(T1-T2) + drhods*(S1-S2) (mod_ndiff.F90:150-158),
found by an argmax over k and placed by linear interpolation; the layer
exchanges tracer with that position, deposited into the (at most two)
containing layers.  Above the edge-mean mixed-layer pressure the match is
in pressure instead (the surface alignment, mod_ndiff.F90:236-258).  Both
directed exchanges are computed and halved, which keeps the operator
symmetric and conservative; each exchange is clamped to a quarter of the
mass of every layer it touches.

blom_tpu's lax.scan over the source layers is a Python loop over k in
the same order: O(kk^2) elementwise work over (kk, J, I) planes.  There
is no CUDA kernel here: blom_tpu runs this as plain XLA, and it runs on
whatever device its tensors are on."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import onemm
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from .diffusion_fields import DiffusionFields

dp_eps = 1.e-5      # (mod_ndiff.F90:44 dp_eps)
rho_eps = 1.e-5     # (mod_ndiff.F90:43 rho_eps)


def _pair_exchange(C_a, T_a, S_a, h_a, pc_a, dt_a, ds_a,
                   C_b, T_b, S_b, h_b, pc_b, dt_b, ds_b,
                   q_edge, area_a, area_b, pml_edge):
    """One-directional neutral exchange: every layer of column A finds
    its neutrally matched position in column B.

    Column tensors are (kk, J, I) on the edge grid, C_* (nc, kk, J, I)
    tracer stacks, q_edge the per-layer edge exchange coefficient
    (kk, J, I).  Returns (dC_a, dC_b, uf): the concentration increments
    of both columns and the per-A-layer diagnostic tracer fluxes
    (nc, kk, J, I), positive A -> B."""
    kk = h_a.shape[0]
    valid_b = h_b > onemm
    kidx = torch.arange(h_b.shape[0], dtype=torch.int32,
                        device=h_b.device).view(-1, *(1,) * (h_b.dim() - 1))
    # the guards in the state's dtype
    like = h_b.new_tensor
    big = like(1.e30)
    w_eps = like(1e-6)
    d_eps = like(rho_eps * 1e-3)

    def take(x, idx):
        # x[idx] along the layer axis (0 for a column, 1 for a stack)
        ax = x.dim() - h_b.dim()
        return torch.gather(x, ax, idx.unsqueeze(0).expand(
            x.shape[:ax] + (1,) + idx.shape)).squeeze(ax)

    acc_b = torch.zeros_like(C_b)
    ufs = []
    for k in range(kk):
        pc_ak, h_ak, T_ak, S_ak = pc_a[k], h_a[k], T_a[k], S_a[k]
        dt_ak, ds_ak, q_edge_k, C_ak = dt_a[k], ds_a[k], q_edge[k], C_a[:, k]

        # density difference of A's layer centre against every B layer
        # centre, linearized with averaged derivatives (drho,
        # mod_ndiff.F90:150-158)
        drho = (.5 * (dt_ak[None] + dt_b) * (T_ak[None] - T_b)
                + .5 * (ds_ak[None] + ds_b) * (S_ak[None] - S_b))
        # surface-aligned layers match in pressure space instead
        aligned = pc_ak < pml_edge
        dvec = torch.where(aligned[None], pc_ak[None] - pc_b, drho)
        # massless B layers take no part in the match
        dvec = torch.where(valid_b, dvec, -big)

        # first sign change from the top: jstar and jneg bracket the
        # match (argmax of an int cast gives the first maximum)
        neg = dvec < 0.
        firstneg = torch.argmax(neg.to(torch.int32), dim=0)
        anyneg = neg.any(0)
        jneg = torch.where(anyneg, firstneg, kk - 1)
        jstar = torch.clamp(jneg - 1, min=0)
        d0 = take(dvec, jstar)
        d1 = take(dvec, jneg)
        denom = d0 - d1
        w = torch.where(denom.abs() > d_eps,
                        torch.clamp(d0 / torch.where(denom == 0., 1., denom),
                                    0., 1.),
                        1.)
        # A denser than all of B: match B's bottom; lighter than all:
        # jneg = jstar = 0, taken care of by the clip and the guard
        w = torch.where(anyneg, w, 1.)

        def matched(x):
            return (1. - w) * take(x, jstar) + w * take(x, jneg)

        h_bm = matched(h_b)
        C_bm = matched(C_b)                                 # (nc, J, I)

        # exchange mass coefficient, clamped for explicit stability
        # against every participating layer's mass
        h0 = take(h_b, jstar)
        h1 = take(h_b, jneg)
        q = q_edge_k * torch.clamp(torch.minimum(h_ak, h_bm), min=dp_eps)
        q = torch.minimum(q, .25 * area_a * h_ak)
        q = torch.minimum(q, .25 * area_b * h0 / torch.maximum(1. - w,
                                                               w_eps))
        q = torch.minimum(q, .25 * area_b * h1 / torch.maximum(w, w_eps))
        q = torch.clamp(q, min=0.)

        f = q[None] * (C_ak - C_bm)                        # (nc, J, I)

        # conservative deposit into the two containing B layers
        oh = ((kidx == jstar[None]) * (1. - w)[None]
              + (kidx == jneg[None]) * w[None])            # (kk, J, I)
        acc_b = acc_b + oh[None] * f[:, None]
        ufs.append(f)
    uf = torch.stack(ufs, 1)                               # (nc, kk, J, I)

    dC_a = -uf / (area_a * torch.clamp(h_a, min=dp_eps))[None]
    dC_b = acc_b / (area_b * torch.clamp(h_b, min=dp_eps))[None]
    return dC_a, dC_b, uf


def _direction_pass(C, T, S, h, pc, drt, drs, pml, shift_m, shift_p,
                    q_edge, area):
    """Neutral exchange across one edge family.  shift_m maps cell
    fields onto the edge's minus-side column (grid.im1, grid.jm1);
    shift_p shifts edge quantities back onto cells (grid.ip1, the
    fold-aware j+1).  Returns (dC, uf): the concentration increment per
    cell and the symmetrized diagnostic flux (nc, kk, J, I) at the
    edge."""
    area_m = shift_m(area)
    pml_edge = .5 * (shift_m(pml) + pml)

    dAm, dBm, uf_ab = _pair_exchange(
        shift_m(C), shift_m(T), shift_m(S), shift_m(h), shift_m(pc),
        shift_m(drt), shift_m(drs),
        C, T, S, h, pc, drt, drs,
        q_edge, area_m, area, pml_edge)
    dBp, dAp, uf_ba = _pair_exchange(
        C, T, S, h, pc, drt, drs,
        shift_m(C), shift_m(T), shift_m(S), shift_m(h), shift_m(pc),
        shift_m(drt), shift_m(drs),
        q_edge, area, area_m, pml_edge)

    # symmetrize the two directed exchanges
    dC_minus = .5 * (dAm + dAp)      # increments on the minus-side cell
    dC_plus = .5 * (dBm + dBp)       # increments on this cell
    dC = dC_plus + shift_p(dC_minus)
    uf = .5 * (uf_ab - uf_ba)
    return dC, uf


def ndiff(grid: Grid, e: eos.EosParams, s: State, dfl: DiffusionFields,
          m: int, n: int, delt1, mld_p) -> State:
    """Neutral diffusion of T, S and the passive tracers of level n
    (ltedtp='neutral'; BLOM's driver mod_ale_regrid_remap.F90:1643-1670
    calls the mod_ndiff.F90 jslice routines); accumulates the tracer
    fluxes of level m.  mld_p: the mixed-layer pressure (J, I) for the
    surface alignment.  Updates `s` in place; no new diffusion fields."""
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    dp = s.dp[n]
    temp, saln = s.temp[n], s.saln[n]

    p = cumulative_p(dp) * ip
    pc = p[:-1] + .5 * dp                        # layer-centre pressure
    drt = eos.drhodt(pc, temp, saln)
    drs = eos.drhods(pc, temp, saln)

    ntr = s.trc.shape[1]
    C = torch.cat([temp[None], saln[None]]
                  + ([s.trc[n]] if ntr else []), 0)   # (nc, kk, J, I)

    qu = delt1 * .5 * (grid.im1(dfl.difiso) + dfl.difiso) \
        * grid.scuy * grid.scuxi * iu
    qv = delt1 * .5 * (grid.jm1(dfl.difiso) + dfl.difiso) \
        * grid.scvx * grid.scvyi * iv

    dCx, ufx = _direction_pass(C, temp, saln, dp, pc, drt, drs, mld_p,
                               grid.im1, grid.ip1, qu, grid.scp2)
    dCy, vfy = _direction_pass(C, temp, saln, dp, pc, drt, drs, mld_p,
                               grid.jm1, lambda a: grid.jp1(a, 'p'), qv,
                               grid.scp2)

    C_new = (C + dCx + dCy) * ip
    temp_new, saln_new = C_new[0], C_new[1]
    s.temp[n] = temp_new
    s.saln[n] = saln_new
    s.sigma[n] = eos.sig(e, temp_new, saln_new) * ip
    s.utflx[m] += ufx[0]
    s.vtflx[m] += vfy[0]
    s.usflx[m] += ufx[1]
    s.vsflx[m] += vfy[1]
    if ntr:
        s.trc[n] = C_new[2:]
    return s
