"""Vertical-coordinate reference densities: Bezier sigma profiles and
the adaptive reference density (sigref_adapt) machinery.

Counterpart of `blom_tpu/core/vcoord.py` (BLOM's mod_vcoord.F90): the
cubic-Bezier-plus-parabolas reference-density generator (sigma_fun
:172-269, cubic_root :153-170) and the sigref adaption (sra_update
:354-405 time filters, sra_find_ml_dmax :406-470, sra_accumulate
:472-573 mixed-layer statistics, sra_cost :272-312 and the
finite-difference (sp1, zp2) descent of sra_optimize :575-800).

The generator computes in float64 on the device of its tensor arguments
(the CPU for plain floats), with the geometry (z_top, z_bot, kmax)
static; the Newton iterations for the Bezier parameter run blom_tpu's
fixed trip count, T_TOL_ITERS.  No step calls this module yet, as in
blom_tpu."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

T_TOL_ITERS = 30


class SigmaFunSpec(NamedTuple):
    """Parameters of the reference-density function
    (sigma_fun_spec_type, mod_vcoord.F90:100-140)."""
    sp1: float = 22.        # sigma at the top Bezier point
    zp2: float = .3         # z of the 2nd Bezier control point
    zp3: float = .7         # z of the 3rd Bezier control point
    sp4: float = 37.2       # sigma at the bottom Bezier point
    dsdz_bot: float = .1    # d(sigma)/dz at the bottom
    s_top: float = 20.      # surface parabola value (z_top > 0 only)
    z_top: float = 0.       # top parabola end (0 = none)
    s_bot: float = 37.25    # bottom parabola value (z_bot < 1 only)
    z_bot: float = 1.       # bottom parabola start (1 = none)


def _f64(x, device=None):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def cubic_root(a, b, c, d, x_ini):
    """Newton iteration for a root of ax^3+bx^2+cx+d
    (cubic_root, mod_vcoord.F90:153-170), fixed trip count."""
    x = x_ini * 1.
    for _ in range(T_TOL_ITERS):
        f = ((a * x + b) * x + c) * x + d
        df = (3. * a * x + 2. * b) * x + c
        df = _f64(df)
        x = x - f / torch.where(df.abs() > 1e-14, df,
                                torch.where(df >= 0., 1e-14, -1e-14))
    return x


def sigma_fun(spec: SigmaFunSpec, kmax: int):
    """Reference potential densities (sigma_fun, mod_vcoord.F90:172-269):
    cubic Bezier in (z, sigma) matched with optional top/bottom
    parabolas.  Returns (kmax,) float64."""
    z_eps = 1e-6
    ktt = int(spec.z_top * (kmax - 1)) + 1 if spec.z_top > z_eps else 0
    ktb = (int(spec.z_bot * (kmax - 1)) + 2
           if spec.z_bot < 1. - z_eps else kmax + 1)

    dev = next((v.device for v in spec if isinstance(v, torch.Tensor)),
               None)
    sp1 = _f64(spec.sp1, dev)
    zp2 = _f64(spec.zp2, dev)
    sp4 = _f64(spec.sp4, dev)
    s_bot = _f64(spec.s_bot, dev)

    zp1, zp3, zp4 = 0., spec.zp3, 1.
    sp2 = sp4 - spec.dsdz_bot * (1. - zp2)
    sp3 = sp4 - spec.dsdz_bot * (1. - zp3)

    az = -zp1 + 3. * zp2 - 3. * zp3 + zp4
    bz = 3. * zp1 - 6. * zp2 + 3. * zp3
    cz = -3. * zp1 + 3. * zp2
    as_ = -sp1 + 3. * sp2 - 3. * sp3 + sp4
    bs = 3. * sp1 - 6. * sp2 + 3. * sp3
    cs = -3. * sp1 + 3. * sp2
    ds = sp1

    zs = torch.arange(kmax, dtype=torch.float64, device=dev) / (kmax - 1)

    def bez_at(z, t0):
        t = cubic_root(az, bz, cz, zp1 - z, t0)
        return ((as_ * t + bs) * t + cs) * t + ds, t

    # the Bezier interior, each Newton solve started from the last root
    t = _f64(0., dev)
    vals = []
    for k in range(kmax):
        val, t = bez_at(zs[k], t)
        vals.append(val)
    sig = torch.stack(vals)
    kidx = torch.arange(kmax, device=dev)

    if ktt > 0:
        # top parabola matching the Bezier at z_top (:233-249)
        ft, t = bez_at(_f64(spec.z_top, dev), _f64(0., dev))
        dft = (((3. * as_ * t + 2. * bs) * t + cs)
               / ((3. * az * t + 2. * bz) * t + cz))
        f0 = spec.s_top
        q1 = 1. / spec.z_top
        q2 = (f0 - ft) * q1
        a = (dft + q2) * q1
        b = -(dft + 2. * q2)
        top = (a * zs + b) * zs + f0
        sig = torch.where(kidx < ktt, top, sig)

    if ktb <= kmax:
        # bottom parabola matching at z_bot (:251-268)
        ft, t = bez_at(_f64(spec.z_bot, dev), _f64(1., dev))
        dft = (((3. * as_ * t + 2. * bs) * t + cs)
               / ((3. * az * t + 2. * bz) * t + cz))
        f0 = s_bot
        zb = spec.z_bot
        q1 = 1. / (1. - zb) ** 2
        a = ((zb - 1.) * dft + f0 - ft) * q1
        b = (-(dft * zb + 2. * (f0 - ft)) * zb + dft) * q1
        c = (((f0 + dft) * zb - 2. * ft - dft) * zb + ft) * q1
        bot = (a * zs + b) * zs + c
        sig = torch.where(kidx >= ktb - 1, bot, sig)

    return sig


# ------------------------------------------------------------------ #
# sigref adaption (sra_*)
# ------------------------------------------------------------------ #

SRA_TLEV_NUM = 12    # monthly climatology bins


@dataclasses.dataclass
class SraState:
    """Adaption accumulators (mod_vcoord.F90:300-352 declarations)."""
    dpml_dmax: torch.Tensor     # (J, I) daily max ML thickness [Pa]
    sigmlb_dmax: torch.Tensor   # (J, I) density at ML base at daily max
    dpml_sum: torch.Tensor      # (T, J, I) per-bin sums
    sigmlb_sum: torch.Tensor
    tlev_accnum: torch.Tensor   # (T,) int
    dpml_clim: torch.Tensor     # (T, J, I) climatology
    sigmlb_clim: torch.Tensor
    has_clim: torch.Tensor      # (T, J, I) 0/1


def init_sra(shape, dtype=torch.float64, device='cuda') -> SraState:
    H = tuple(shape)
    z = torch.zeros(H, dtype=dtype, device=device)
    zt = torch.zeros((SRA_TLEV_NUM,) + H, dtype=dtype, device=device)
    return SraState(dpml_dmax=z, sigmlb_dmax=z, dpml_sum=zt,
                    sigmlb_sum=zt,
                    tlev_accnum=torch.zeros(SRA_TLEV_NUM, dtype=torch.int32,
                                            device=device),
                    dpml_clim=zt, sigmlb_clim=zt,
                    has_clim=torch.zeros((SRA_TLEV_NUM,) + H, dtype=dtype,
                                         device=device))


def sra_find_ml_dmax(sra: SraState, dpml, sigmlb) -> SraState:
    """Track the daily maximum mixed-layer thickness and the density at
    its base (sra_find_ml_dmax, mod_vcoord.F90:406-470)."""
    deeper = dpml > sra.dpml_dmax
    return dataclasses.replace(
        sra,
        dpml_dmax=torch.where(deeper, dpml, sra.dpml_dmax),
        sigmlb_dmax=torch.where(deeper, sigmlb, sra.sigmlb_dmax))


def sra_accumulate(sra: SraState, tlev: int) -> SraState:
    """End-of-day accumulation into climatology bin tlev (sra_accumulate,
    mod_vcoord.F90:472-573, mixed-layer part)."""
    dpml_sum = sra.dpml_sum.clone()
    sigmlb_sum = sra.sigmlb_sum.clone()
    accnum = sra.tlev_accnum.clone()
    dpml_sum[tlev] += sra.dpml_dmax
    sigmlb_sum[tlev] += sra.sigmlb_dmax
    accnum[tlev] += 1
    return dataclasses.replace(
        sra, dpml_sum=dpml_sum, sigmlb_sum=sigmlb_sum, tlev_accnum=accnum,
        dpml_dmax=torch.zeros_like(sra.dpml_dmax),
        sigmlb_dmax=torch.zeros_like(sra.sigmlb_dmax))


def sra_update_clim(sra: SraState, sra_clim_ts: float = 5.) -> SraState:
    """End-of-year climatology time filter (sra_optimize's first block,
    mod_vcoord.F90:600-635)."""
    wgt = 1. / (sra_clim_ts + 1.)
    q = 1. / torch.clamp(sra.tlev_accnum, min=1).to(
        sra.dpml_sum.dtype)[:, None, None]
    new_dp = sra.dpml_sum * q
    new_sg = sra.sigmlb_sum * q
    have = sra.has_clim > 0.
    dp_clim = torch.where(have, (1. - wgt) * sra.dpml_clim + wgt * new_dp,
                          new_dp)
    sg_clim = torch.where(have, (1. - wgt) * sra.sigmlb_clim
                          + wgt * new_sg, new_sg)
    return dataclasses.replace(
        sra, dpml_clim=dp_clim, sigmlb_clim=sg_clim,
        has_clim=torch.ones_like(sra.has_clim),
        dpml_sum=torch.zeros_like(sra.dpml_sum),
        sigmlb_sum=torch.zeros_like(sra.sigmlb_sum),
        tlev_accnum=torch.zeros_like(sra.tlev_accnum))


def sra_cost(plevel, sigref, sra: SraState, wgt, mask):
    """Deviation of the constant-pressure-level mixed-layer thickness from
    the observed climatological one (sra_cost, mod_vcoord.F90:272-312):
    the sum over bins of log(dpml_plev / dpml)^2 * weight."""
    kdm = sigref.shape[0]
    sgl = sra.sigmlb_clim                       # (T, J, I)
    # searchsorted's left side, as jnp.searchsorted
    idx = torch.clamp(torch.searchsorted(sigref, sgl.reshape(-1))
                      .reshape(sgl.shape), 1, kdm - 1)
    s0 = sigref[idx - 1]
    s1 = sigref[idx]
    w = torch.clamp((sgl - s0) / torch.clamp(s1 - s0, min=1e-12), 0., 1.)
    dpml_plev = (1. - w) * plevel[idx - 1] + w * plevel[idx]
    valid = (sra.dpml_clim > 0.) & (mask[None] > 0.)
    logdiff = torch.log(torch.clamp(dpml_plev, min=1e-12)
                        / torch.clamp(sra.dpml_clim, min=1e-12))
    return torch.where(valid, logdiff ** 2 * wgt[None], 0.).sum()


def sra_optimize_sp1_zp2(spec: SigmaFunSpec, plevel, sra: SraState,
                         wgt, mask, kdm: int, niter: int = 20,
                         lr=(.05, .005)) -> SigmaFunSpec:
    """Fixed-iteration descent on (sp1, zp2) with central-difference
    gradients (sra_cost_grad and the Adam loop of sra_optimize,
    mod_vcoord.F90:640-760, simplified to plain gradient descent with
    fixed step sizes)."""
    dev = plevel.device
    dx = _f64([.01, .001], dev)
    x = torch.stack([_f64(spec.sp1, dev), _f64(spec.zp2, dev)])

    def cost_at(x):
        sp = spec._replace(sp1=x[0], zp2=x[1])
        return sra_cost(plevel, sigma_fun(sp, kdm), sra, wgt, mask)

    lr = _f64(lr, dev)
    for _ in range(niter):
        g0 = (cost_at(x + torch.stack([dx[0] / 2, dx[0] * 0.]))
              - cost_at(x - torch.stack([dx[0] / 2, dx[0] * 0.]))) / dx[0]
        g1 = (cost_at(x + torch.stack([dx[1] * 0., dx[1] / 2]))
              - cost_at(x - torch.stack([dx[1] * 0., dx[1] / 2]))) / dx[1]
        g = torch.stack([g0, g1])
        x = x - lr * torch.tanh(g)
        x = torch.stack([x[0], torch.clamp(x[1], .05, .6)])
    return spec._replace(sp1=x[0], zp2=x[1])


def sra_update_filter(spec, spec_old, spec_new, frac_of_year,
                      baclin: float, nday_in_year: float = 365.,
                      ts1: float = 5., ts2: float = 10.):
    """Per-step time filter blending the adapted parameters (sra_update,
    mod_vcoord.F90:354-405).  Returns the filtered spec."""
    w0 = frac_of_year
    w1 = baclin / (86400. * nday_in_year * ts1 + baclin)
    w2 = baclin / (86400. * nday_in_year * ts2 + baclin)
    sp1_t = (1. - w0) * spec_old.sp1 + w0 * spec_new.sp1
    zp2_t = (1. - w0) * spec_old.zp2 + w0 * spec_new.zp2
    sp4_t = (1. - w0) * spec_old.sp4 + w0 * spec_new.sp4
    s_bot_t = (1. - w0) * spec_old.s_bot + w0 * spec_new.s_bot
    return spec._replace(
        sp1=(1. - w1) * spec.sp1 + w1 * sp1_t,
        zp2=(1. - w1) * spec.zp2 + w1 * zp2_t,
        sp4=(1. - w2) * spec.sp4 + w2 * sp4_t,
        s_bot=(1. - w2) * spec.s_bot + w2 * s_bot_t)
