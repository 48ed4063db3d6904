"""Model initialization from configuration initial conditions.

Counterpart of `blom_tpu/core/init.py` (BLOM's mod_inicon.F90:932-1459
and mod_blom_init.F90:203-444).  Consumes interface geopotential and
layer sigma/temp/saln profiles and returns a fully initialized State.
The column scans of blom_tpu are Python loops over k."""

from __future__ import annotations

import torch

from . import eos
from .constants import epsilp
from .grid import Grid
from .state import State, empty_state, cumulative_p, dpu_dpv_upstream


def getpl(e_th, e_s, phiu, phil, pup, iters: int = 12):
    """Lower interface pressure from layer T/S and the geopotential at
    both interfaces (getpl, mod_inicon.F90:105-137): a fixed number of
    Newton iterations on the hydrostatic integral."""
    plo = pup - eos.rho(pup, e_th, e_s) * (phil - phiu)
    for _ in range(iters):
        dphi, _, alpl = eos.delphi(pup, plo, e_th, e_s)
        plo = plo - (phil - phiu - dphi) / alpl
    return plo


def init_state(grid: Grid, e: eos.EosParams, *, phi, temp, saln, sigmar,
               dtype=None, ntr: int = 0) -> State:
    """Build the initial State at rest (inicon,
    mod_inicon.F90:932-1459): velocities, barotropic transports and
    their Coriolis sums start at zero.

    phi: (kk+1, H) interface geopotential [m2 s-2]; temp/saln/sigmar:
    (kk, H).  Array inputs may be numpy or tensors; they are moved to the
    grid's device."""
    from ..dynamics.pgforc import pgforc

    kk = grid.kk
    dtype = dtype or grid.dtype
    dev = grid.device
    ip, iu, iv, iq = grid.ip, grid.iu, grid.iv, grid.iq
    im1, jm1 = grid.im1, grid.jm1

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    s = empty_state(grid, dtype, ntr=ntr)
    temp, saln, phi, sigmar = as_t(temp), as_t(saln), as_t(phi), as_t(sigmar)

    # freeze bound + consistent sigma (mod_inicon.F90:986-1040 default)
    temp = torch.maximum(eos.tfrz(e, saln), temp)
    sigma = eos.sig(e, temp, saln)

    # hydrostatic interface pressures (mod_inicon.F90:1046-1068)
    zero2 = torch.zeros_like(phi[0])
    plist = [getpl(temp[0], saln[0], zero2, phi[0], zero2)]
    for k in range(kk):
        plist.append(getpl(temp[k], saln[k], phi[k], phi[k + 1], plist[-1]))
    p = torch.stack(plist) * ip

    dp = (p[1:] - p[:-1]) * ip
    p = cumulative_p(dp) * ip

    # bottom pressures (mod_inicon.F90:1088-1127)
    pbot = p[kk]
    pbu1 = torch.minimum(pbot, im1(pbot)) * iu
    pbv1 = torch.minimum(pbot, jm1(pbot)) * iv

    dpu, dpv = dpu_dpv_upstream(grid, p)

    # kfpla and trace-layer collapse (mod_inicon.F90:1370-1399): gather
    # vanishing interior layers (k >= 3) into the first thick one
    if kk > 2:
        dps = torch.zeros_like(dp[0])
        kf = torch.full(grid.shape, -1, dtype=torch.int32, device=dev)
        found = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        dp_int = []
        for k in range(2, kk):
            dp_k = dp[k]
            thin = dp_k < epsilp
            take = (~found) & thin
            dps = dps + torch.where(take, dp_k, zero)
            add_here = (~found) & (~thin)
            dp_int.append(torch.where(take, zero, dp_k)
                          + torch.where(add_here, dps, zero))
            found = found | (~thin)
            dps = torch.where(add_here, zero, dps)
            kf = torch.where(add_here & (kf < 0),
                             torch.full_like(kf, k), kf)
        # leftover goes to layer 2 (1-based) if no thick interior layer
        dp2 = dp[1] + torch.where(found, zero, dps)
        kf = torch.where(found, kf, torch.full_like(kf, kk))
        dp = torch.cat([dp[:1], dp2[None], torch.stack(dp_int)], 0) * ip
        kfpla = torch.stack([kf, kf])
    else:
        kfpla = torch.full((2,) + grid.shape, 2, dtype=torch.int32,
                           device=dev)

    p = cumulative_p(dp) * ip

    # pvtrop (mod_inicon.F90:1190-1230): same dense rule as barotp
    pbp = torch.clamp(pbot, min=epsilp)
    pvt = torch.zeros_like(pbot)
    pvt = torch.where(jm1(iu) > 0,
                      grid.corioq * 2. / (jm1(pbp) + im1(jm1(pbp))), pvt)
    pvt = torch.where(iu > 0, grid.corioq * 2. / (pbp + im1(pbp)), pvt)
    pvt = torch.where(im1(iv) > 0,
                      grid.corioq * 2. / (im1(pbp) + im1(jm1(pbp))), pvt)
    pvt = torch.where(iv > 0, grid.corioq * 2. / (pbp + jm1(pbp)), pvt)
    pvt = torch.where(iq > 0,
                      grid.corioq * 4.
                      / (pbp + im1(pbp) + jm1(pbp) + im1(jm1(pbp))), pvt)

    def two(a):
        return torch.stack([a, a])

    s.dp = two(dp)
    s.dpu, s.dpv = two(dpu), two(dpv)
    s.temp, s.saln, s.sigma = two(temp * ip), two(saln * ip), two(sigma * ip)
    s.p = p
    s.pu, s.pv = cumulative_p(dpu), cumulative_p(dpv)
    s.phi = phi * ip
    s.pb, s.pb_mn = two(pbot), two(pbot)
    s.pbu, s.pbv = two(pbu1), two(pbv1)
    s.pb_p, s.pbu_p, s.pbv_p = pbot.clone(), pbu1.clone(), pbv1.clone()
    s.pvtrop = two(pvt)
    s.dpold = two(dp)
    s.dpuold, s.dpvold = dpu.clone(), dpv.clone()
    s.told, s.sold = temp * ip, saln * ip
    s.sigmar = sigmar * ip
    s.kfpla = kfpla

    # PGF fields at init (mod_inicon.F90:1336-1368): pgforc with
    # (m, n) = (1, 0), then copy level 0 -> 1
    s = pgforc(grid, e, s, m=1, n=0)
    for name in ('pgfx', 'pgfy', 'pgfxm', 'pgfym', 'xixp', 'xixm', 'xiyp',
                 'xiym'):
        a = getattr(s, name)
        a[1] = a[0]
    return s
