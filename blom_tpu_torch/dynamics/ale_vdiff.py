"""Vertical diffusion of tracers and momentum (ALE path).

Counterpart of `blom_tpu/dynamics/ale_vdiff.py` (BLOM's
mod_ale_vdiff.F90): backward-Euler tridiagonal solves per column,
batched over the horizontal; the Thomas elimination and back
substitution are loops over k (mod_ale_vdiff.F90:106-176)."""

from __future__ import annotations

import torch

from ..core import eos
from ..core.constants import alpha0, grav, onem, spcifh
from ..core.grid import Grid
from ..core.state import State
from ..phys.forcing import Forcing
from ..phys.vmix import VmixFields

dpmin_vdiff = 0.1 * onem   # (mod_ale_vdiff.F90:44)


def _thomas(dp_c, fp, rhs):
    """Solve -fp(k)*X(k-1) + (dp(k)+fp(k)+fp(k+1))*X(k) - fp(k+1)*X(k+1)
    = rhs(k) for X, with fp (kk, H) and no flux through the surface
    (fp[0]) or the bottom."""
    kk = dp_c.shape[0]
    fp_next = torch.cat([fp[1:], torch.zeros_like(fp[:1])], 0)
    bei = 1.0 / (dp_c[0] + fp_next[0])
    x = rhs[0] * bei
    xs, gams = [x], [None]
    for k in range(1, kk):
        gam = -fp[k] * bei
        bei = 1.0 / (dp_c[k] + fp[k] * (1.0 + gam) + fp_next[k])
        x = (rhs[k] + fp[k] * x) * bei
        xs.append(x)
        gams.append(gam)
    out = [None] * kk
    out[-1] = xs[-1]
    for k in range(kk - 2, -1, -1):
        out[k] = xs[k] - gams[k + 1] * out[k + 1]
    return torch.stack(out, 0)


def ale_vdifft(grid: Grid, e: eos.EosParams, s: State, forcing: Forcing,
               vf: VmixFields, m: int, n: int, delt1) -> State:
    """Implicit vertical diffusion of T, S and the tracers of time level n
    with the surface fluxes applied, in place (ale_vdifft,
    mod_ale_vdiff.F90:51-238)."""
    ip = grid.ip
    dp_c = s.dp[n]
    cpi = 1.0 / spcifh
    dtg = delt1 * grav
    c = grav * grav * delt1 / (alpha0 * alpha0)

    # a true division, as blom_tpu's: PyTorch computes `c / x` for a
    # Python scalar c as c * (1 / x), an ulp apart, and the solve of a
    # column with massless bottom layers amplifies that to ~1e-10
    fpbase = torch.cat(
        [torch.zeros_like(dp_c[:1]),
         torch.full_like(dp_c[1:], c)
         / torch.clamp(.5 * (dp_c[:-1] + dp_c[1:]), min=dpmin_vdiff)], 0)

    hfsw = forcing.sswflx
    hfns = forcing.surflx - hfsw
    hfrs = forcing.surrlx
    sfbr = forcing.brnflx
    sfnb = forcing.salflx - sfbr
    sfrs = forcing.salrlx

    def dnl(nl):
        return nl[:-1] - nl[1:]

    fp_t = vf.Kdiff_t * fpbase
    rhs_t = dp_c * s.temp[n] - (dnl(vf.t_ns_nonloc) * hfns
                                + dnl(vf.t_sw_nonloc) * hfsw
                                + dnl(vf.t_rs_nonloc) * hfrs) * dtg * cpi
    temp_new = _thomas(dp_c + 1e-30, fp_t, rhs_t) * ip

    fp_s = vf.Kdiff_s * fpbase
    rhs_s = dp_c * s.saln[n] - (dnl(vf.s_nb_nonloc) * sfnb
                                + dnl(vf.s_br_nonloc) * sfbr
                                + dnl(vf.s_rs_nonloc) * sfrs) * dtg
    saln_new = torch.clamp(_thomas(dp_c + 1e-30, fp_s, rhs_s), min=0.) * ip

    # tracers: the temperature diffusivity and no surface flux
    # (mod_ale_vdiff.F90:178-216)
    for t in range(s.trc.shape[1]):
        tr_new = _thomas(dp_c + 1e-30, fp_t, dp_c * s.trc[n, t])
        s.trc[n, t] = torch.clamp(tr_new, min=0.) * ip

    s.temp[n] = temp_new
    s.saln[n] = saln_new
    s.sigma[n] = eos.sig(e, temp_new, saln_new) * ip
    return s


def ale_vdiffm(grid: Grid, s: State, vf: VmixFields, m: int, n: int,
               delt1) -> State:
    """Implicit vertical diffusion of the baroclinic velocity of time
    level n, in place (ale_vdiffm, mod_ale_vdiff.F90:240-376)."""
    c = grav * grav * delt1 / (alpha0 * alpha0)

    def solve(dpc, nuv, vel, mask):
        fp = torch.cat(
            [torch.zeros_like(dpc[:1]),
             nuv[1:] * c / torch.clamp(.5 * (dpc[:-1] + dpc[1:]),
                                       min=dpmin_vdiff)], 0)
        return _thomas(dpc + 1e-30, fp, dpc * vel) * mask

    s.u[n] = solve(s.dpu[n], .5 * (grid.im1(vf.Kvisc_m) + vf.Kvisc_m),
                   s.u[n], grid.iu)
    s.v[n] = solve(s.dpv[n], .5 * (grid.jm1(vf.Kvisc_m) + vf.Kvisc_m),
                   s.v[n], grid.iv)
    return s
