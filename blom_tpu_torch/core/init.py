"""Model initialization from configuration initial conditions.

Counterpart of `blom_tpu/core/init.py` (BLOM's mod_inicon.F90:932-1459
and mod_blom_init.F90:203-444).  Consumes interface geopotential and
layer sigma/temp/saln profiles and returns a fully initialized State.
The column scans of blom_tpu are Python loops over k."""

from __future__ import annotations

import numpy as np
import torch

from . import eos
from .constants import epsilp
from .grid import Grid
from .state import State, empty_state, cumulative_p, dpu_dpv_upstream


# ---- getpl as blom_tpu's compiled getpl rounds it.  XLA on the CPU
# contracts a product whose one use is an add or subtract in the same
# fusion into a fused multiply-add (one rounding), and rewrites
# x / (a / b) as x * b / a.  blom_tpu runs getpl's Newton loop compiled,
# so the port computes those operations with an exactly rounded fma:
# Dekker's TwoProduct and Knuth's TwoSum give a*b + c as three exact
# parts, and a sum rounded to odd (Boldo and Melquiond, IEEE TC 57(4),
# 2008) keeps the final rounding single.  Each step is one eager IEEE
# operation, so the CPU and CUDA give the same bits.

_SPLIT = 134217729.0          # 2**27 + 1, Dekker's split of a double


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _odd_sum(a, b):
    """a + b rounded to odd: the sum, or where it is inexact and its
    last bit even, its neighbour toward the exact value."""
    s, e = _two_sum(a, b)
    fix = ((s.view(torch.int64) & 1) == 0) & (e != 0)
    return torch.where(fix, torch.nextafter(s, e * float('inf')), s)


def _fma(a, b, c):
    """a * b + c rounded once, for float64 or float32 tensors; a Python
    float operand is first rounded to the tensors' dtype."""
    like = next(x for x in (a, b, c) if torch.is_tensor(x))
    dt = like.dtype
    narrow = np.float32 if dt == torch.float32 else np.float64

    def wide(x):
        return x.double() if torch.is_tensor(x) else float(narrow(x))

    a, b, c = wide(a), wide(b), wide(c)
    if dt == torch.float32:
        # the product of two floats is exact in a double, and a double
        # sum rounded to odd then rounds to float correctly
        return _odd_sum(a * b, c).to(dt)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _odd_sum(tl, ul)


def _eos_coeffs(th, s):
    """delphi's aa1, aa2, bb1, bb2 (eos.py) with the compiled
    contractions."""
    f = _fma
    aa1 = f(f(s, eos.a16, eos.a13), s,
            f(f(s, eos.a15, f(th, eos.a14, eos.a12)), th, eos.a11))
    aa2 = f(f(s, eos.a26, eos.a23), s,
            f(f(s, eos.a25, f(th, eos.a24, eos.a22)), th, eos.a21))
    bb1 = f(s, eos.b13, f(th, eos.b12, eos.b11))
    bb2 = f(s, eos.b23, f(th, eos.b22, eos.b21))
    return aa1, aa2, bb1, bb2


def getpl(e_th, e_s, phiu, phil, pup, iters: int = 12,
          compiled_guess: bool = True, coeffs=None):
    """Lower interface pressure from layer T/S and the geopotential at
    both interfaces (getpl, mod_inicon.F90:105-137): a fixed number of
    Newton iterations on the hydrostatic integral, rounded as blom_tpu's
    compiled getpl (eos.delphi with its products contracted).  With
    `compiled_guess` False the first guess is eos.rho's plain rounding,
    as blom_tpu's init_state computes it for the top interface, outside
    any compiled loop.  `coeffs`: _eos_coeffs(e_th, e_s), if the caller
    has them.

    An iteration is a fixed function of plo, so once one returns every
    column's plo of one or of two iterations before, each column repeats
    with period 1 or 2 from there on: the loop stops and returns the
    value the last of `iters` iterations would give, bit for bit."""
    f = _fma
    aa1, aa2, bb1, bb2 = coeffs or _eos_coeffs(e_th, e_s)
    dphi0 = phil - phiu
    if compiled_guess:
        plo = f(-(f(bb1, pup, aa1) / f(bb2, pup, aa2)), dphi0, pup)
    else:
        plo = pup - eos.rho(pup, e_th, e_s) * dphi0
    c = aa2 - aa1 * bb2 / bb1
    # aa + bb * p at pm and plo, the four in one call
    bb, aa = torch.stack([bb1, bb2, bb1, bb2]), torch.stack([aa1, aa2, aa1,
                                                             aa2])
    bits = torch.int64 if plo.dtype == torch.float64 else torch.int32
    prev = None
    for it in range(iters):
        pm = (pup + plo) * .5
        d1m, d2m, d1, d2 = f(bb, torch.stack([pm, pm, plo, plo]), aa)
        r = ((plo - pup) * .5) / d1m
        q = bb1 * r
        qq = q * q
        ser = f(qq, f(qq, f(qq, 1 / 9., 1 / 7.), .2), 1 / 3.)
        # dphi0 - dphi with dphi = -2 r (aa2 + bb2 pm + c qq ser): XLA's
        # dphi0 - (-2 r) * x, exactly dphi0 + 2 r * x
        res = f(r * 2., f(c * qq, ser, d2m), dphi0)
        # res / alp(plo), alp = (aa2 + bb2 p) / (aa1 + bb1 p)
        new = plo - res * d1 / d2
        if torch.equal(new.view(bits), plo.view(bits)):
            return new              # every column at its fixed point
        if prev is not None and torch.equal(new.view(bits), prev.view(bits)):
            # every column repeats with period 1 or 2 from here on
            return new if (iters - 1 - it) % 2 == 0 else plo
        prev, plo = plo, new
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
    coeffs = _eos_coeffs(temp, saln)         # every layer's at once
    # (blom_tpu computes the top interface's first guess outside its
    # compiled loops, the rest inside its compiled column scan)
    plist = [getpl(temp[0], saln[0], zero2, phi[0], zero2,
                   compiled_guess=False, coeffs=[c[0] for c in coeffs])]
    for k in range(kk):
        plist.append(getpl(temp[k], saln[k], phi[k], phi[k + 1], plist[-1],
                           coeffs=[c[k] for c in coeffs]))
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
