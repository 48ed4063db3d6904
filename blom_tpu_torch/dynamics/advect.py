"""Layer thickness and tracer advection driver.

Counterpart of `blom_tpu/dynamics/advect.py` (BLOM's
mod_advect.F90:59-189): CFL-clamped flux areas cau/cav from the
mid-level baroclinic velocity, the predicted barotropic transport and
the eddy/submesoscale transports (mod_advect.F90:71-94), then either
incremental remapping (advmth='remap', mod_advect.F90:96-153; not on a
tripolar grid) or, for every other advmth as in blom_tpu, the
Strang-split CPPM sweeps (mod_cppm.F90:2748-2834), the j-sweep on a
tripolar grid over the fold-extended domain."""

from __future__ import annotations

import torch

from ..core.constants import onemm, epsilpl
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from .cppm import NGHOST_ARCTIC, CppmCoeffs, cppm_sweep, dpeps
from .diffusion_fields import DiffusionFields
from .remap import remap_layer


def advect(grid: Grid, s: State, dfl: DiffusionFields,
           coeffs_i: CppmCoeffs, coeffs_j: CppmCoeffs,
           m: int, n: int, delt1, dlt,
           advmth: str = 'cppm',
           cppm_compatibility: str = 'full',
           cppm_limiting: str = 'non_oscillatory') -> State:
    """Advect dp, temp, saln and passive tracers of level n; accumulate
    the mass and tracer fluxes of level m.  Updates `s` in place."""
    iu, iv, ip = grid.iu, grid.iv, grid.ip

    # ---- flux areas (mod_advect.F90:71-94)
    dtdl_u = delt1 * grid.scuy
    ca_u = (s.u[m] * dtdl_u
            + s.ubflxs_p[m] * dlt / torch.clamp(s.pbu[m], min=epsilpl)
            + (dfl.umfltd[m] + dfl.umflsm[m])
            / torch.clamp(s.dpu[n], min=onemm))
    cau = torch.clamp(ca_u, -grid.umax * dtdl_u, grid.umax * dtdl_u) * iu

    dtdl_v = delt1 * grid.scvx
    ca_v = (s.v[m] * dtdl_v
            + s.vbflxs_p[m] * dlt / torch.clamp(s.pbv[m], min=epsilpl)
            + (dfl.vmfltd[m] + dfl.vmflsm[m])
            / torch.clamp(s.dpv[n], min=onemm))
    cav = torch.clamp(ca_v, -grid.vmax * dtdl_v, grid.vmax * dtdl_v) * iv
    s.cau, s.cav = cau, cav

    if advmth == 'remap':
        if grid.arctic:
            raise NotImplementedError(
                "advmth='remap' does not support tripolar grids yet; "
                "use advmth='cppm' (fold-aware j-sweeps)")
        return _advect_remap(grid, s, m, n)

    # ---- CPPM Strang-split sweeps: i first on odd steps; with
    # m = (nstep+1) % 2, odd nstep <=> m == 0
    i_first = (m == 0)

    # interface pressures of the pre-advection state (for the
    # bottom-limited reconstruction of flux_integration)
    p = cumulative_p(s.dp[n]) * ip
    tm = torch.cat([s.temp[n][None], s.saln[n][None], s.trc[n]], 0)
    h = s.dp[n]

    def sweep_i(h, tm, second):
        div = (grid.jp1(cav, 'v', True) - cav) if second else None
        return cppm_sweep(h, tm, cau, s.pbu[n], p[:-1], p[1:], grid.scp2i,
                          coeffs_i, grid.periodic_i, div_corr=div,
                          compatibility=cppm_compatibility,
                          limiting=cppm_limiting, ax=-1)

    def sweep_j(h, tm, second):
        # on tripolar grids the sweep domain is extended by fold ghost
        # rows so the stencil reads across the bipolar seam (the
        # reference's (0,3) halo update, mod_cppm.F90:1956-1960); the
        # outputs are cut back to the grid's rows
        if grid.arctic:
            from ..parallel.arctic import fold_extend

            def ext(a, kind, vector=False):
                return fold_extend(a, kind, vector, NGHOST_ARCTIC)
        else:
            def ext(a, kind, vector=False):
                return a

        jdm = h.shape[-2]
        div = ext(grid.ip1(cau) - cau, 'p') if second else None
        out = cppm_sweep(ext(h, 'p'), ext(tm, 'p'), ext(cav, 'v', True),
                         ext(s.pbv[n], 'v'), ext(p[:-1], 'p'),
                         ext(p[1:], 'p'), ext(grid.scp2i, 'p'), coeffs_j,
                         grid.periodic_j, div_corr=div,
                         compatibility=cppm_compatibility,
                         limiting=cppm_limiting, ax=-2)
        return tuple(o[..., :jdm, :].contiguous() for o in out)

    if i_first:
        h1, tm1, hfu, htfu = sweep_i(h, tm, False)
        h1 = torch.clamp(h1 - dpeps, min=0.) * ip
        h2, tm2, hfv, htfv = sweep_j(h1, tm1, True)
    else:
        h1, tm1, hfv, htfv = sweep_j(h, tm, False)
        h1 = torch.clamp(h1 - dpeps, min=0.) * ip
        h2, tm2, hfu, htfu = sweep_i(h1, tm1, True)
    h2 = torch.clamp(h2 - dpeps, min=0.) * ip

    s.trc[n] = tm2[2:] * ip
    s.dp[n] = h2
    s.temp[n] = tm2[0] * ip
    s.saln[n] = tm2[1] * ip
    s.uflx[m] += hfu * iu
    s.vflx[m] += hfv * iv
    s.utflx[m] += htfu[0] * iu
    s.usflx[m] += htfu[1] * iu
    s.vtflx[m] += htfv[0] * iv
    s.vsflx[m] += htfv[1] * iv
    return s


def _advect_remap(grid: Grid, s: State, m: int, n: int) -> State:
    """Incremental-remapping branch (mod_advect.F90:96-153): the 9-point
    minimum bottom pressure with wet-neighbour fallbacks, then one remap
    of every layer at once, the tracer stack (temp, saln, trc) as
    (ntr, K, J, I)."""
    ip, iu, iv = grid.ip, grid.iu, grid.iv
    p_i = cumulative_p(s.dp[n])
    pbot = p_i[-1]

    # pbmin: 9-point min with land fallback to the centre
    # (mod_advect.F90:103-119)
    w_ok = iu > 0.
    e_ok = grid.ip1(iu) > 0.
    s_ok = iv > 0.
    n_ok = grid.jp1(iv, 'v') > 0.
    pbmin = pbot
    for di, dj, ok in ((-1, 0, w_ok), (1, 0, e_ok), (0, -1, s_ok),
                       (0, 1, n_ok), (-1, -1, w_ok & s_ok),
                       (1, -1, e_ok & s_ok), (-1, 1, w_ok & n_ok),
                       (1, 1, e_ok & n_ok)):
        wet = grid.shift(ip, di, dj) > 0.
        pbmin = torch.minimum(pbmin, torch.where(
            ok & wet, grid.shift(pbot, di, dj), pbot))

    tr = torch.cat([s.temp[n][None], s.saln[n][None], s.trc[n]], 0)
    dp_new, tr_new, fdu, fdv, ftru, ftrv = remap_layer(
        grid, pbmin, s.pbu[n], s.pbv[n], p_i[1:], s.cau, s.cav, s.dp[n],
        tr)

    s.trc[n] = tr_new[2:] * ip
    s.dp[n] = dp_new
    s.temp[n] = tr_new[0] * ip
    s.saln[n] = tr_new[1] * ip
    s.uflx[m] += fdu * iu
    s.vflx[m] += fdv * iv
    s.utflx[m] += ftru[0] * iu
    s.usflx[m] += ftru[1] * iu
    s.vtflx[m] += ftrv[0] * iv
    s.vsflx[m] += ftrv[1] * iv
    return s
