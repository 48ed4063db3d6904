"""1-D vertical reconstruction, regrid and remap.

Counterpart of `blom_tpu/ops/hor3map.py` (BLOM's mod_hor3map.F90):
PPM with explicit 4th-order edges (the ALE main path), PPM with
implicit ih4 edges, PQM with implicit ih6/ih5 edges and slopes, the
monotonic, non-oscillatory and positive-definite limiters, the
root-finding regrid (`regrid_crossings`), and the remaps: the fused
multi-group `remap_groups` and the single-field `remap_means`.  Arrays
are (kk[+1], ...) with the vertical axis leading, and every operation is
the JAX package's, in its order, so that f64 results agree to rounding.
The k-scans are Python loops over the leading axis; the small per-edge
moment systems are batched `torch.linalg.solve_ex` calls, as blom_tpu's
are batched `jnp.linalg.solve` calls.  A limiting name other than the
three limiters leaves a reconstruction unlimited, as in blom_tpu.

Within layer k a reconstruction is f(x) = c0 + c1*x + c2*x^2 for the
normalized x in [0, 1], plus c3*x^3 + c4*x^4 for PQM."""

from __future__ import annotations

from typing import NamedTuple

import torch

heps = 1.e-11   # small thickness guard [Pa]

MONOTONIC = 'monotonic'
NON_OSCILLATORY = 'non_oscillatory'
NON_OSCILLATORY_POSDEF = 'non_oscillatory_posdef'


def _kidx(kk, ndim, device):
    return torch.arange(kk, device=device).reshape((kk,) + (1,) * (ndim - 1))


def _shift_clamped(a, off, n_out, hi):
    """a[clip(arange(n_out) + off, 0, hi)] along axis 0."""
    idx = (torch.arange(n_out, device=a.device) + off).clamp(0, hi)
    return a[idx]


def _prev(a):
    """a[k-1] along axis 0, with a[0] at k = 0."""
    return torch.cat([a[:1], a[:-1]], 0)


def _next(a):
    """a[k+1] along axis 0, with a[-1] at the last k."""
    return torch.cat([a[1:], a[-1:]], 0)


class Recon(NamedTuple):
    """Piecewise-polynomial reconstruction on a source grid: parabolic
    (c3 = c4 = None) or quartic (PQM)."""
    p: torch.Tensor      # (kk+1, ...) source interface positions
    c0: torch.Tensor     # (kk, ...) polynomial coefficients
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor = None
    c4: torch.Tensor = None

    def eval0(self):
        """Upper-interface values (peval0)."""
        return self.c0

    def eval1(self):
        """Lower-interface values (peval1)."""
        v = self.c0 + self.c1 + self.c2
        if self.c3 is not None:
            v = v + self.c3 + self.c4
        return v

    def deval0(self):
        """d/dx at the upper interface (dpeval0)."""
        return self.c1

    def deval1(self):
        """d/dx at the lower interface (dpeval1)."""
        v = self.c1 + 2. * self.c2
        if self.c3 is not None:
            v = v + 3. * self.c3 + 4. * self.c4
        return v


def edge4_weights(dx):
    """Per-edge weights (w1..w4) of the 4th-order nonuniform edge estimate
    between cells k-1 and k from the cells (k-2, k-1, k, k+1); one-sided
    3-cell estimates at edges 1 and kk-1, cell-mean copies at the column
    ends.  dx: (kk, ...) -> four (kk+1, ...) tensors."""
    kk = dx.shape[0]

    def pad(a, off):
        return _shift_clamped(a, off, kk + 1, kk - 1)

    x1 = pad(dx, -2)
    x2 = pad(dx, -1)
    x3 = pad(dx, 0)
    x4 = pad(dx, 1)

    c1_2, c2_3, c3_4, c1_6, c1_12 = .5, 2 / 3., .75, 1 / 6., 1 / 12.

    a12 = -x2 - c1_2 * x1
    a22 = -c1_2 * x2
    a32 = c1_2 * x3
    a42 = x3 + c1_2 * x4
    a13 = a12 * a12 + c1_12 * x1 * x1
    a23 = -c2_3 * a22 * x2
    a33 = c2_3 * a32 * x3
    a43 = a42 * a42 + c1_12 * x4 * x4
    a14 = (a13 + c1_6 * x1 * x1) * a12
    a24 = -c3_4 * a23 * x2
    a34 = c3_4 * a33 * x3
    a44 = (a43 + c1_6 * x4 * x4) * a42

    def safe(x):
        return torch.where(x.abs() < 1e-300, 1e-300, x)

    # full 4-cell elimination
    b22 = a22 - a12
    b32 = a32 - a12
    b42 = a42 - a12
    b23 = (a23 - a13) / safe(b22)
    b33 = a33 - a13 - b23 * b32
    b43 = a43 - a13 - b23 * b42
    b24 = (a24 - a14) / safe(b22)
    b34 = a34 - a14 - b24 * b32
    b44 = a44 - a14 - b24 * b42
    b34 = b34 / safe(b33)
    b44 = b44 - b34 * b43
    h2 = -a12 + 0. * a12
    h3 = -a13 - b23 * h2
    h4 = (-a14 - b24 * h2 - b34 * h3) / safe(b44)
    h3 = (h3 - b43 * h4) / safe(b33)
    h2 = (h2 - b32 * h3 - b42 * h4) / safe(b22)
    h1 = 1. - h2 - h3 - h4

    # 0111: cells (k-1, k, k+1)
    c32 = a32 - a22
    c42 = a42 - a22
    c33 = (a33 - a23) / safe(c32)
    c43 = a43 - a23 - c33 * c42
    g3 = -a22 + 0. * a22
    g4 = (-a23 - c33 * g3) / safe(c43)
    g3 = (g3 - c42 * g4) / safe(c32)
    g2 = 1. - g3 - g4
    # 1110: cells (k-2, k-1, k)
    d22 = a22 - a12
    d32 = a32 - a12
    d23 = (a23 - a13) / safe(d22)
    d33 = a33 - a13 - d23 * d32
    f2 = -a12 + 0. * a12
    f3 = (-a13 - d23 * f2) / safe(d33)
    f2 = (f2 - d32 * f3) / safe(d22)
    f1 = 1. - f2 - f3

    kidx = _kidx(kk + 1, dx.ndim, dx.device)
    zero = torch.zeros_like(h1)
    one = zero + 1.
    w1 = torch.where(kidx == 1, zero, h1)
    w2 = torch.where(kidx == 1, zero, h2)
    w3 = torch.where(kidx == 1, g3, h3)
    w4 = torch.where(kidx == 1, g4, h4)
    w2 = torch.where(kidx == 1, g2, w2)
    w1 = torch.where(kidx == kk - 1, f1, w1)
    w2 = torch.where(kidx == kk - 1, f2, w2)
    w3 = torch.where(kidx == kk - 1, f3, w3)
    w4 = torch.where(kidx == kk - 1, zero, w4)
    top = kidx == 0
    bot = kidx == kk
    w1 = torch.where(top | bot, zero, w1)
    w2 = torch.where(top, zero, torch.where(bot, one, w2))
    w3 = torch.where(top, one, torch.where(bot, zero, w3))
    w4 = torch.where(top | bot, zero, w4)
    return w1, w2, w3, w4


def _edge4(dx, tm, weights=None):
    """4th-order edge values (kk+1, ...) of the cell means tm (kk, ...)."""
    kk = tm.shape[0]
    if weights is None:
        weights = edge4_weights(dx)
    w1, w2, w3, w4 = weights
    t1 = _shift_clamped(tm, -2, kk + 1, kk - 1)
    t2 = _shift_clamped(tm, -1, kk + 1, kk - 1)
    t3 = _shift_clamped(tm, 0, kk + 1, kk - 1)
    t4 = _shift_clamped(tm, 1, kk + 1, kk - 1)
    return w1 * t1 + w2 * t2 + w3 * t3 + w4 * t4


def _interior(kk, ndim, device, lo=1):
    kidx = _kidx(kk, ndim, device)
    return (kidx >= lo) & (kidx <= kk - 2)


def _slope_clamp(tm, tel, ter, dx, apply_mask):
    """Minmod slope clamp of the edges at interior cells where
    apply_mask holds (mod_hor3map.F90:1885-1907)."""
    tm_m, tm_p = _prev(tm), _next(tm)
    dx_m, dx_p = _prev(dx), _next(dx)
    hi = 1.0 / dx
    hci = 2.0 / (dx_m + 2. * dx + dx_p)
    sl = 2. * (tm - tm_m) * hi
    sr = 2. * (tm_p - tm) * hi
    has = sl * sr > 0.
    sc0 = (tm_p - tm_m) * hci
    sc = torch.copysign(torch.minimum(torch.minimum(sl.abs(), sr.abs()),
                                      sc0.abs()), sc0)
    lim = .5 * dx * sc.abs()
    tel2 = torch.where((tm_m - tel) * (tm - tel) > 0.,
                       tm - torch.copysign(torch.minimum(lim, (tel - tm).abs()),
                                           sc), tel)
    ter2 = torch.where((tm_p - ter) * (tm - ter) > 0.,
                       tm + torch.copysign(torch.minimum(lim, (ter - tm).abs()),
                                           sc), ter)
    tel2 = torch.where(has, tel2, tm)
    ter2 = torch.where(has, ter2, tm)
    m = apply_mask & _interior(tm.shape[0], tm.ndim, tm.device)
    return torch.where(m, tel2, tel), torch.where(m, ter2, ter)


def _pair_sweep(tm, tel, ter):
    """Edge-pair consistency sweep (mod_hor3map.F90:1911-1917): where the
    jump across an interior edge opposes the cell-mean difference, both
    one-sided edge values become their average."""
    tm_m, ter_m = _prev(tm), _prev(ter)
    cond = (((tel - ter_m) * (tm - tm_m) < 0.)
            & _interior(tm.shape[0], tm.ndim, tm.device, lo=2))
    avg = .5 * (ter_m + tel)
    tel = torch.where(cond, avg, tel)
    cond_p = torch.cat([cond[1:], torch.zeros_like(cond[-1:])], 0)
    ter = torch.where(cond_p, _next(avg), ter)
    return tel, ter


def _parabola_limit(tm, tel, ter, apply_mask):
    """Overshoot limit of the parabola's interior extremum
    (mod_hor3map.F90:1919-1929), interior cells only."""
    d = ter - tel
    q = d * (2. * tm - tel - ter)
    r = d * d / 3.
    m = apply_mask & _interior(tm.shape[0], tm.ndim, tm.device)
    tel2 = torch.where(m & (q > r), 3. * tm - 2. * ter, tel)
    ter2 = torch.where(m & (-r > q), 3. * tm - 2. * tel, ter)
    return tel2, ter2


def _limit_boundary(tm, tel, ter, dx, pc_upper=False, pc_lower=False):
    """Boundary cells (limit_ppm_boundary, mod_hor3map.F90:2000-2070):
    monotonic parabolas that are not treated as extrema."""
    kk = tm.shape[0]
    kidx = _kidx(kk, tm.ndim, tm.device)

    flat0 = (tm[1] - ter[0]) * (tm[0] - ter[0]) > 0.
    s0 = 2. * (tm[2] - tm[1]) / (dx[1] + dx[2])
    cand0 = tm[0] + s0 * dx[0] / 3.
    uer0 = torch.where(s0 > 0.,
                       torch.maximum(tm[0], torch.minimum(ter[0], cand0)),
                       torch.minimum(tm[0], torch.maximum(ter[0], cand0)))
    uer0 = torch.where(flat0, tm[0], uer0)
    uel0 = torch.where(flat0, tm[0], .5 * (3. * tm[0] - uer0))
    if pc_upper:
        uel0, uer0 = tm[0], tm[0]

    flat1 = (tm[kk - 1] - tel[kk - 1]) * (tm[kk - 2] - tel[kk - 1]) > 0.
    s1 = 2. * (tm[kk - 2] - tm[kk - 3]) / (dx[kk - 3] + dx[kk - 2])
    cand1 = tm[kk - 1] - s1 * dx[kk - 1] / 3.
    uel1 = torch.where(
        s1 > 0.,
        torch.minimum(tm[kk - 1], torch.maximum(tel[kk - 1], cand1)),
        torch.maximum(tm[kk - 1], torch.minimum(tel[kk - 1], cand1)))
    uel1 = torch.where(flat1, tm[kk - 1], uel1)
    uer1 = torch.where(flat1, tm[kk - 1], .5 * (3. * tm[kk - 1] - uel1))
    if pc_lower:
        uel1, uer1 = tm[kk - 1], tm[kk - 1]

    tel = torch.where(kidx == 0, uel0[None], tel)
    ter = torch.where(kidx == 0, uer0[None], ter)
    tel = torch.where(kidx == kk - 1, uel1[None], tel)
    ter = torch.where(kidx == kk - 1, uer1[None], ter)
    return tel, ter


def _limit_posdef(tm, tel, ter):
    """Positive-definite parabolas (limit_ppm_posdef,
    mod_hor3map.F90:2072-2098), all cells."""
    min_u_0 = torch.clamp(tm, max=0.)
    tel = torch.maximum(tel, min_u_0)
    ter = torch.maximum(ter, min_u_0)
    sl = 2. * (3. * tm - 2. * tel - ter)
    a2 = 3. * (tel - 2. * tm + ter)
    sr = sl + 2. * a2
    denom = 3. * sl * sr + 4. * a2 * a2
    q = 3. * tm / torch.where(denom.abs() < 1e-300, 1e-300, denom)
    neg = (sl < 0.) & (sr > 0.) & (a2 * tel - .25 * sl * sl < a2 * min_u_0)
    tel = torch.where(neg, sl * sl * q, tel)
    ter = torch.where(neg, sr * sr * q, ter)
    return tel, ter


def _limit_mono(tm, tel, ter, dx):
    """Monotonic limiter (limit_ppm_interior_monotonic,
    mod_hor3map.F90:1872-1927), interior cells."""
    always = torch.ones(tm.shape, dtype=torch.bool, device=tm.device)
    tel, ter = _slope_clamp(tm, tel, ter, dx, always)
    tel, ter = _pair_sweep(tm, tel, ter)
    return _parabola_limit(tm, tel, ter, always)


def _limit_nosc(tm, tel, ter, dx):
    """Non-oscillatory limiter (limit_ppm_interior_non_oscillatory,
    mod_hor3map.F90:1929-1998): the slope clamp and the parabola limit
    only where the curvature changes sign against a neighbour; the pair
    sweep everywhere."""
    d2 = tel - 2. * tm + ter
    need = (_prev(d2) * d2 < 0.) | (d2 * _next(d2) < 0.)
    tel, ter = _slope_clamp(tm, tel, ter, dx, need)
    tel, ter = _pair_sweep(tm, tel, ter)
    return _parabola_limit(tm, tel, ter, need)


def _pc_mask(tm, dx, pc_upper, pc_lower):
    """Cells reconstructed piecewise constant: the top/bottom layer when
    asked, and every vanishing layer."""
    kk = tm.shape[0]
    kidx = _kidx(kk, tm.ndim, tm.device)
    pc_mask = torch.zeros_like(tm, dtype=torch.bool)
    if pc_upper:
        pc_mask = pc_mask | (kidx == 0)
    if pc_lower:
        pc_mask = pc_mask | (kidx == kk - 1)
    return pc_mask | (dx <= 2. * heps)


def _ppm_from_edges(p, tm, dx, e, limiting, pc_upper, pc_lower) -> Recon:
    """The parabolas of the cell means tm (kk, ...) from the edge values e
    (kk+1, ...): the limiter `limiting` (none for another name), then
    piecewise-constant top/bottom and vanishing layers."""
    tel, ter = e[:-1], e[1:]
    if limiting == MONOTONIC:
        tel, ter = _limit_mono(tm, tel, ter, dx)
        tel, ter = _limit_boundary(tm, tel, ter, dx, pc_upper, pc_lower)
    elif limiting in (NON_OSCILLATORY, NON_OSCILLATORY_POSDEF):
        tel, ter = _limit_nosc(tm, tel, ter, dx)
        tel, ter = _limit_boundary(tm, tel, ter, dx, pc_upper, pc_lower)
        if limiting == NON_OSCILLATORY_POSDEF:
            tel, ter = _limit_posdef(tm, tel, ter)

    pc_mask = _pc_mask(tm, dx, pc_upper, pc_lower)
    tel = torch.where(pc_mask, tm, tel)
    ter = torch.where(pc_mask, tm, ter)
    return Recon(p=p, c0=tel, c1=6. * tm - 4. * tel - 2. * ter,
                 c2=3. * (tel - 2. * tm + ter))


def ppm_reconstruct(p, tm, limiting=NON_OSCILLATORY, pc_upper=False,
                    pc_lower=False, edge_weights=None) -> Recon:
    """PPM reconstruction of the layer means tm (kk, ...) on the
    interfaces p (kk+1, ...).  pc_upper/pc_lower make the top/bottom
    layer piecewise constant; edge_weights are edge4_weights(dx) when
    several fields share the grid."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    return _ppm_from_edges(p, tm, dx, _edge4(dx, tm, edge_weights),
                           limiting, pc_upper, pc_lower)


def ppm_reconstruct_multi(p, tms, limiting=NON_OSCILLATORY,
                          pc_upper=False, pc_lower=False):
    """PPM-reconstruct several fields on the shared interfaces p, with
    the grid-only edge weights computed once."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    w = edge4_weights(dx)
    return [ppm_reconstruct(p, tm, limiting, pc_upper, pc_lower,
                            edge_weights=w) for tm in tms]


def integrate_to(rc: Recon, pq):
    """I(pq), the integral of the reconstruction from the column top to
    the positions pq (nq, ...), accumulated over the source layers in
    order."""
    dx = torch.clamp(rc.p[1:] - rc.p[:-1], min=0.)
    dxi = 1.0 / torch.clamp(dx, min=heps)
    acc = torch.zeros_like(pq)
    for k in range(dx.shape[0]):
        c0, c1, c2 = rc.c0[k][None], rc.c1[k][None], rc.c2[k][None]
        x = torch.clamp((pq - rc.p[k][None]) * dxi[k][None], 0., 1.)
        x2 = x * x
        poly = c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x
        if rc.c3 is not None:
            poly = (poly + .25 * rc.c3[k][None] * x2 * x2
                    + .2 * rc.c4[k][None] * x2 * x2 * x)
        acc = acc + dx[k][None] * poly
    return acc


def remap_groups(groups, bottom_only_empties: bool = False):
    """Remap several (reconstructions, destination grid) groups in one
    loop over the source layers (remap, mod_hor3map.F90:4723-4790).

    groups: list of (rc_list, p_dst); the Recons of one group share the
    source grid rc.p.  Returns a list of lists of destination layer
    means.  The quartic terms of a PQM reconstruction are added after the
    parabola's, in blom_tpu's order; a parabolic reconstruction adds
    none.  The integral from the column top to each destination edge
    accumulates over source layers k = 0, 1, ... in that order.
    bottom_only_empties: empty destination layers occur only at the
    column bottom (the nudge regrid's minimum-thickness clamp), where they
    take the deepest wet source layer's lower-edge value; otherwise an
    empty layer takes the reconstruction's point value at its
    position."""
    prep = []
    for rc_list, p_dst in groups:
        p = rc_list[0].p
        dx = torch.clamp(p[1:] - p[:-1], min=0.)
        prep.append((p, dx, rc_list, p_dst))

    kk = prep[0][1].shape[0]
    accs = [[torch.zeros_like(p_dst) for _ in rc_list]
            for _, _, rc_list, p_dst in prep]
    if not bottom_only_empties:
        points = [[torch.zeros_like(p_dst) for _ in rc_list]
                  for _, _, rc_list, p_dst in prep]
        found = [torch.zeros(p_dst.shape, dtype=torch.bool,
                             device=p_dst.device)
                 for _, _, _, p_dst in prep]
    for k in range(kk):
        for g, (p, dx, rc_list, pq) in enumerate(prep):
            p_up, dxk = p[k], dx[k]
            dxik = 1.0 / torch.clamp(dxk, min=heps)
            x = torch.clamp((pq - p_up[None]) * dxik[None], 0., 1.)
            x2 = x * x
            if not bottom_only_empties:
                inl = ((pq >= p_up[None]) & (pq <= (p_up + dxk)[None])
                       & (dxk[None] > heps) & (~found[g]))
            for t, rc in enumerate(rc_list):
                c0, c1, c2 = rc.c0[k][None], rc.c1[k][None], rc.c2[k][None]
                poly = c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x
                if rc.c3 is not None:
                    c3, c4 = rc.c3[k][None], rc.c4[k][None]
                    poly = poly + .25 * c3 * x2 * x2 + .2 * c4 * x2 * x2 * x
                accs[g][t] = accs[g][t] + dxk[None] * poly
                if not bottom_only_empties:
                    fval = c0 + c1 * x + c2 * x2
                    if rc.c3 is not None:
                        fval = fval + c3 * x2 * x + c4 * x2 * x2
                    points[g][t] = torch.where(inl, fval, points[g][t])
            if not bottom_only_empties:
                found[g] = found[g] | inl

    out = []
    for g, (p, dx, rc_list, p_dst) in enumerate(prep):
        dpd = p_dst[1:] - p_dst[:-1]
        dpdi = 1.0 / torch.clamp(dpd, min=heps)
        means_g = []
        if bottom_only_empties:
            # deepest wet source layer per column
            wet = dx > heps
            kidx = _kidx(kk, wet.ndim, wet.device)
            kbot = torch.where(wet, kidx, -1).amax(0)
            deepest = wet & (kidx == kbot[None])
        for t, rc in enumerate(rc_list):
            acc = accs[g][t]
            means = (acc[1:] - acc[:-1]) * dpdi
            if bottom_only_empties:
                botv = torch.where(deepest, rc.eval1(), 0.).sum(0)
                means_g.append(torch.where(dpd > heps, means, botv[None]))
            else:
                point_l = torch.where(found[g][:-1], points[g][t][:-1],
                                      means)
                means_g.append(torch.where(dpd > heps, means, point_l))
        out.append(means_g)
    return out


REGRID_MVAL = -1.e33    # missing value of the regrid search
#                         (the reference's regrid_mval sentinel)


def regrid_crossings(rc: Recon, trg):
    """Pressures where a monotone piecewise-parabolic reconstruction
    crosses each target value (the reference's root-finding regrid): for
    every target trg[q] the first non-vanishing layer whose edge values
    bracket it, the parabola's crossing solved in the stable quadratic
    form (linear where the curvature vanishes).  Targets outside the
    reconstruction's range return REGRID_MVAL.  trg: (nq, ...)
    broadcastable against the rc fields; returns (nq, ...)."""
    dx = torch.clamp(rc.p[1:] - rc.p[:-1], min=0.)
    ev0 = rc.eval0()
    ev1 = rc.eval1()
    shape = torch.broadcast_shapes(trg.shape,
                                   (trg.shape[0],) + rc.c0.shape[1:])
    got = torch.full(shape, REGRID_MVAL, dtype=rc.c0.dtype,
                     device=rc.c0.device)
    found = torch.zeros(shape, dtype=torch.bool, device=rc.c0.device)
    for k in range(dx.shape[0]):
        p_up, dxk = rc.p[k], dx[k]
        e0, e1 = ev0[k], ev1[k]
        inl = ((trg >= torch.minimum(e0, e1)[None])
               & (trg <= torch.maximum(e0, e1)[None]) & (~found)
               & (dxk[None] > heps))
        # a x^2 + b x + c = 0 on [0, 1]: r1 = q/a, r2 = c/q with
        # q = -(b + sign(b) sqrt(D)) / 2
        a_, b_, cc = rc.c2[k][None], rc.c1[k][None], rc.c0[k][None] - trg
        disc = torch.clamp(b_ * b_ - 4. * a_ * cc, min=0.)
        sq = torch.sqrt(disc)
        small_a = a_.abs() < 1e-30
        small_b = b_.abs() < 1e-30
        q_ = -.5 * (b_ + torch.sign(b_) * sq)
        r1 = q_ / torch.where(small_a, 1., a_)
        r2 = cc / torch.where(q_.abs() > 1e-300, q_, 1.)
        x_lin = -cc / torch.where(small_b, 1., b_)
        x_sym = torch.sqrt(torch.clamp(
            -cc / torch.where(small_a, 1., a_), min=0.))   # b == 0
        x = torch.where((r1 >= 0.) & (r1 <= 1.), r1, r2)
        x = torch.where(small_b & (~small_a), x_sym, x)
        x = torch.where(small_a, x_lin, x)
        x = torch.clamp(x, 0., 1.)
        got = torch.where(inl, p_up[None] + x * dxk[None], got)
        found = found | inl
    return got


def remap_means(rc: Recon, p_dst):
    """Destination layer means (I(p_dst[k+1]) - I(p_dst[k])) / dp_dst of
    one reconstruction (the reference's remap, piecewise integration),
    as blom_tpu's `remap_means`: one loop over the source layers carries
    the integral from the column top, the point value of the
    reconstruction at each destination edge and whether it was found.  A
    zero-thickness destination layer takes that point value."""
    dx = torch.clamp(rc.p[1:] - rc.p[:-1], min=0.)
    dxi = 1.0 / torch.clamp(dx, min=heps)
    pq = p_dst
    acc = torch.zeros_like(pq)
    point = torch.zeros_like(pq)
    found = torch.zeros(pq.shape, dtype=torch.bool, device=pq.device)
    for k in range(dx.shape[0]):
        p_up, dxk = rc.p[k][None], dx[k][None]
        c0, c1, c2 = rc.c0[k][None], rc.c1[k][None], rc.c2[k][None]
        x = torch.clamp((pq - p_up) * dxi[k][None], 0., 1.)
        x2 = x * x
        poly = c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x
        fval = c0 + c1 * x + c2 * x2
        if rc.c3 is not None:
            c3, c4 = rc.c3[k][None], rc.c4[k][None]
            poly = poly + .25 * c3 * x2 * x2 + .2 * c4 * x2 * x2 * x
            fval = fval + c3 * x2 * x + c4 * x2 * x2
        acc = acc + dxk * poly
        # point value at pq where it falls inside this (nonempty) layer
        inl = (pq >= p_up) & (pq <= p_up + dxk) & (dxk > heps) & ~found
        point = torch.where(inl, fval, point)
        found = found | inl
    dpd = p_dst[1:] - p_dst[:-1]
    means = (acc[1:] - acc[:-1]) / torch.clamp(dpd, min=heps)
    point_l = torch.where(found[:-1], point[:-1], means)
    return torch.where(dpd > heps, means, point_l)


# ------------------------------------------------------------------ #
# implicit high-order edge estimation (ih4 / ih6+ih5) and PQM
# (mod_hor3map.F90:631-1039 coefficient setup,
#  :1707-1870 tridiagonal reconstructions, :2119-2337 PQM limiting)
# ------------------------------------------------------------------ #

def _solve(A, b):
    """A x = b for the batched (..., n, n) A and (..., n, 1) b by LU with
    partial pivoting, as jnp.linalg.solve: a singular system gives
    inf/NaN where it must and raises nothing."""
    return torch.linalg.solve_ex(A, b)[0]


def _tridiag_dirichlet(tde1, tde2, rhs, e_first, e_last):
    """The edge tridiagonal with unit diagonal and Dirichlet boundary
    edges, by the Thomas recursion (reconstruct_ppm_edge_values,
    mod_hor3map.F90:1744-1755).  tde1/tde2/rhs: (kk+1, ...) rows, of
    which the interior edges 1..kk-1 are used; e_first/e_last: the
    boundary edges.  Returns the edges (kk+1, ...)."""
    kk1 = rhs.shape[0]
    e_prev, gam_prev = e_first, torch.zeros_like(e_first)
    es, gams = [], []
    for k in range(1, kk1 - 1):
        bei = 1.0 / (1.0 - tde1[k] * gam_prev)
        e_prev = (rhs[k] - tde1[k] * e_prev) * bei
        gam_prev = tde2[k] * bei
        es.append(e_prev)
        gams.append(gam_prev)
    out = [e_last]
    e_next = e_last
    for k in range(len(es) - 1, -1, -1):
        e_next = es[k] - gams[k] * e_next
        out.append(e_next)
    out.append(e_first)
    return torch.stack(out[::-1], 0)


def _ih4_coeffs(h):
    """Row coefficients of the ih4 edge tridiagonal at the interior
    edges (edge_ih4_coeff, mod_hor3map.F90:631-649).  h: (kk, ...);
    returns (tde1, tde2, rhs3, rhs4) at the edges (kk+1, ...)."""
    h1 = torch.cat([h[:1], h], 0)     # cell above the edge
    h2 = torch.cat([h, h[-1:]], 0)    # cell below the edge
    q = 1.0 / (h1 + h2)
    t1 = h2 * h2 * q * q
    t2 = h1 * h1 * q * q
    t3 = 2. * t1 * (h2 + 2. * h1) * q
    t4 = 2. * t2 * (h1 + 2. * h2) * q
    return t1, t2, t3, t4


def _boundary_poly(h, tm, ord_: int, side: str):
    """Boundary edge value and slope from an ord_-cell polynomial fit
    (edge_slope_lblu/rblu, mod_hor3map.F90:913-1039): the moment system
    A c = u of the polynomial in the basis xi^p / p! measured from the
    boundary edge; c[0] is the edge value, c[1] the slope."""
    kk = tm.shape[0]
    n = ord_
    if side == 'left':
        hs = [h[i] for i in range(n)]
        us = [tm[i] for i in range(n)]
        centers = []
        c = .5 * hs[0]
        centers.append(c)
        for i in range(1, n):
            c = c + .5 * (hs[i - 1] + hs[i])
            centers.append(c)
    else:
        hs = [h[kk - n + i] for i in range(n)]
        us = [tm[kk - n + i] for i in range(n)]
        c = -.5 * hs[-1]
        centers = [None] * n
        centers[n - 1] = c
        for i in range(n - 2, -1, -1):
            c = c - .5 * (hs[i + 1] + hs[i])
            centers[i] = c

    rows = []
    for i in range(n):
        a2 = centers[i]
        hh = hs[i]
        a2sq = a2 * a2
        hsq = hh * hh
        row = [torch.ones_like(a2), a2]
        if n > 2:
            row.append(.5 * (a2sq + hsq / 12.))
        if n > 3:
            row.append((1. / 6.) * a2 * (a2sq + .25 * hsq))
        if n > 4:
            row.append((1. / 24.) * (a2sq * (a2sq + .5 * hsq)
                                     + hsq * hsq / 80.))
        if n > 5:
            row.append((1. / 120.) * a2 * (a2sq + .75 * hsq)
                       * (a2sq + hsq / 12.))
        rows.append(row)

    A = torch.stack([torch.stack(r, -1) for r in rows], -2)
    u = torch.stack(us, -1)[..., None]
    c = _solve(A, u)[..., 0]
    return c[..., 0], c[..., 1]


def edges_ih4(p, tm, lb_ord: int = 4, rb_ord: int = 4):
    """Implicit 4th-order edges (prepare_ppm + reconstruct_ppm_edge_values,
    mod_hor3map.F90:1308-1497,1707-1763): a tridiagonal solve along each
    column.  p: (kk+1, ...), tm: (kk, ...); returns edges (kk+1, ...)."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    t1, t2, t3, t4 = _ih4_coeffs(dx)
    tm_up = torch.cat([tm[:1], tm], 0)
    tm_lo = torch.cat([tm, tm[-1:]], 0)
    rhs = t3 * tm_up + t4 * tm_lo
    e0, _ = _boundary_poly(dx, tm, lb_ord, 'left')
    e1, _ = _boundary_poly(dx, tm, rb_ord, 'right')
    return _tridiag_dirichlet(t1, t2, rhs, e0, e1)


def _ipow(x, n: int):
    """x**n by binary powering, the products jax's integer_pow takes
    (x**4 = x2 * x2, x**5 = x * x4), not libm's pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _ih6_matrices(dx):
    """Per-edge 6x6 moment matrices of the symmetric ih6/ih5 stencil
    (edge_ih6_slope_ih5_coeff_sym, mod_hor3map.F90:782-845), batched
    over edges and columns.  dx: (kk, ...); valid for the interior edges
    2..kk-2 (the others fall back to ih4)."""
    def at(off):
        return _shift_clamped(dx, off, dx.shape[0] + 1, dx.shape[0] - 1)

    h1, h2, h3, h4 = at(-2), at(-1), at(0), at(1)
    one = torch.ones_like(h1)

    def stack_col(rows):
        return torch.stack(rows, -1)

    # column 1: -E(j-1) coefficient moments; column 2: E(j+1) ...
    c11 = [one, -h2, h2 * h2, -_ipow(h2, 3), _ipow(h2, 4), -_ipow(h2, 5)]
    c22 = [one, h3, h3 * h3, _ipow(h3, 3), _ipow(h3, 4), _ipow(h3, 5)]

    a23 = .5 * h1 + h2
    a23sq = a23 * a23
    h1sq = h1 * h1
    col3 = [-one, a23, -a23sq - h1sq / 12.,
            a23 * (a23sq + .25 * h1sq),
            -a23sq * (a23sq + .5 * h1sq) - h1sq * h1sq / 80.,
            a23 * (a23sq + .75 * h1sq) * (a23sq + h1sq / 12.)]
    col4 = [-one, .5 * h2, -h2 * h2 / 3., .25 * _ipow(h2, 3),
            -_ipow(h2, 4) / 5., _ipow(h2, 5) / 6.]
    col5 = [-one, -.5 * h3, -h3 * h3 / 3., -.25 * _ipow(h3, 3),
            -_ipow(h3, 4) / 5., -_ipow(h3, 5) / 6.]
    a26 = -h3 - .5 * h4
    a26sq = a26 * a26
    h4sq = h4 * h4
    col6 = [-one, a26, -a26sq - h4sq / 12.,
            a26 * (a26sq + .25 * h4sq),
            -a26sq * (a26sq + .5 * h4sq) - h4sq * h4sq / 80.,
            a26 * (a26sq + .75 * h4sq) * (a26sq + h4sq / 12.)]

    return torch.stack([stack_col(c11), stack_col(c22), stack_col(col3),
                        stack_col(col4), stack_col(col5), stack_col(col6)],
                       -1)


def _moment_col_cell(c, h):
    """Negated mean moments -E[x^p] (p = 0..5) of the Taylor monomials
    over a cell of width h centred at the signed position c from the
    edge: the cell columns of the ih6 moment matrices
    (edge_ih6_slope_ih5_coeff_*, mod_hor3map.F90:716-911)."""
    one = torch.ones_like(c)
    csq = c * c
    hsq = h * h
    return [-one,
            -c,
            -(csq + hsq / 12.),
            -(c * (csq + .25 * hsq)),
            -(csq * (csq + .5 * hsq) + hsq * hsq / 80.),
            -(c * (csq + .75 * hsq) * (csq + hsq / 12.))]


def _ih6_matrices_asym(dx, side: str):
    """6x6 moment matrices of the asymmetric near-boundary stencils
    (edge_ih6_slope_ih5_coeff_asymleft/-right,
    mod_hor3map.F90:716-780,847-911), at every edge (only the
    near-boundary rows are used)."""
    def at(off):
        return _shift_clamped(dx, off, dx.shape[0] + 1, dx.shape[0] - 1)

    one_like = torch.ones_like(at(0))

    def powers(x):
        return [one_like, x, x * x, _ipow(x, 3), _ipow(x, 4), _ipow(x, 5)]

    if side == 'left':
        h1, h2, h3, h4 = at(-1), at(0), at(1), at(2)
        col1 = powers(-h1)                      # E at the edge above
        col2 = powers(h2)                       # E at the edge below
        col3 = _moment_col_cell(-.5 * h1, h1)            # cell e-1
        col4 = _moment_col_cell(.5 * h2, h2)             # cell e
        col5 = _moment_col_cell(h2 + .5 * h3, h3)        # cell e+1
        col6 = _moment_col_cell(h2 + h3 + .5 * h4, h4)   # cell e+2
    else:
        h1, h2, h3, h4 = at(-3), at(-2), at(-1), at(0)
        col1 = powers(-h3)
        col2 = powers(h4)
        col3 = _moment_col_cell(-(.5 * h1 + h2 + h3), h1)
        col4 = _moment_col_cell(-(.5 * h2 + h3), h2)
        col5 = _moment_col_cell(-.5 * h3, h3)
        col6 = _moment_col_cell(.5 * h4, h4)

    def stack_col(rows):
        return torch.stack(rows, -1)

    return torch.stack([stack_col(col1), stack_col(col2), stack_col(col3),
                        stack_col(col4), stack_col(col5), stack_col(col6)],
                       -1)


def _ih6_solve_coeffs(A):
    """The edge and slope row coefficients of the moment matrices A:
    A ce = -e0, and B cs = -e0 with the slope system B
    (edge_ih6_slope_ih5_coeff_common, mod_hor3map.F90:672-712)."""
    rhs_e = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    rhs_e[..., 0] = -1.
    ce = _solve(A, rhs_e[..., None])[..., 0]
    B = torch.zeros_like(A)
    B[..., 0:5, 2:6] = A[..., 1:6, 2:6]
    mult = torch.tensor([1., 2., 3., 4., 5.], dtype=A.dtype, device=A.device)
    B[..., 0:5, 0] = A[..., 0:5, 0] * mult
    B[..., 0:5, 1] = A[..., 0:5, 1] * mult
    B[..., 5, 2:6] = 1.
    cs = _solve(B, rhs_e[..., None])[..., 0]
    return ce, cs


def edges_slopes_ih6(p, tm, lb_ord: int = 6, rb_ord: int = 4):
    """Implicit 6th/5th-order edges and slopes
    (reconstruct_pqm_edge_slope_values, mod_hor3map.F90:1765-1870):
    per-edge 6x6 solves give the tridiagonal rows (ih4/ih3 where they
    are not diagonally dominant, prepare_pqm:1246-1266), then two Thomas
    solves along the column.  Returns (edges, slopes), (kk+1, ...) each;
    the slopes are per unit position."""
    kk = tm.shape[0]
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps

    ce, cs = _ih6_solve_coeffs(_ih6_matrices(dx))
    ce_l, cs_l = _ih6_solve_coeffs(_ih6_matrices_asym(dx, 'left'))
    ce_r, cs_r = _ih6_solve_coeffs(_ih6_matrices_asym(dx, 'right'))

    def cellv(off):
        return _shift_clamped(tm, off, kk + 1, kk - 1)

    u_m3 = cellv(-3)
    u_m2, u_m1, u_0, u_p1 = cellv(-2), cellv(-1), cellv(0), cellv(1)
    u_p2 = cellv(2)

    def rhs_of(c, us):
        return (c[..., 2] * us[0] + c[..., 3] * us[1]
                + c[..., 4] * us[2] + c[..., 5] * us[3])

    kidx = _kidx(kk + 1, tm.ndim, tm.device)
    at_l = kidx == 1
    at_r = kidx == kk - 1

    def sel(sym, lft, rgt):
        return torch.where(at_l, lft, torch.where(at_r, rgt, sym))

    te1 = sel(ce[..., 0], ce_l[..., 0], ce_r[..., 0])
    te2 = sel(ce[..., 1], ce_l[..., 1], ce_r[..., 1])
    ts1 = sel(cs[..., 0], cs_l[..., 0], cs_r[..., 0])
    ts2 = sel(cs[..., 1], cs_l[..., 1], cs_r[..., 1])
    rhs_e6 = sel(rhs_of(ce, (u_m2, u_m1, u_0, u_p1)),
                 rhs_of(ce_l, (u_m1, u_0, u_p1, u_p2)),
                 rhs_of(ce_r, (u_m3, u_m2, u_m1, u_0)))
    rhs_s6 = sel(rhs_of(cs, (u_m2, u_m1, u_0, u_p1)),
                 rhs_of(cs_l, (u_m1, u_0, u_p1, u_p2)),
                 rhs_of(cs_r, (u_m3, u_m2, u_m1, u_0)))

    # ih4/ih3 where the ih6/ih5 rows are not diagonally dominant, and at
    # the near-boundary edges (prepare_pqm:1246-1296)
    f1, f2, f3, f4 = _ih4_coeffs(dx)
    rhs_e4 = f3 * u_m1 + f4 * u_0
    # ih3 slopes (slope_ih3_coeff, mod_hor3map.F90:651-670)
    h1 = torch.cat([dx[:1], dx], 0)
    h2 = torch.cat([dx, dx[-1:]], 0)
    h11, h22, h12 = h1 * h1, h2 * h2, h1 * h2
    qs = 1.0 / ((h1 + h2) * (h11 + 3. * h12 + h22))
    s1 = h2 * (h11 + h2 * (h1 - h2)) * qs
    s2 = h1 * (h22 + h1 * (h2 - h1)) * qs
    s3 = -12. * h12 * qs
    rhs_s3 = s3 * u_m1 - s3 * u_0

    interior6 = (kidx >= 1) & (kidx <= kk - 1) & (kk > 4)
    bad = ((te1.abs() + te2.abs() > 1.) | (ts1.abs() + ts2.abs() > 1.)
           | ~interior6)
    te1 = torch.where(bad, f1, te1)
    te2 = torch.where(bad, f2, te2)
    rhs_e6 = torch.where(bad, rhs_e4, rhs_e6)
    ts1 = torch.where(bad, s1, ts1)
    ts2 = torch.where(bad, s2, ts2)
    rhs_s6 = torch.where(bad, rhs_s3, rhs_s6)

    lb = max(2, min(lb_ord, kk))
    rb = max(2, min(rb_ord, kk))
    e0, sl0 = _boundary_poly(dx, tm, lb, 'left')
    e1, sl1 = _boundary_poly(dx, tm, rb, 'right')

    edges = _tridiag_dirichlet(te1, te2, rhs_e6, e0, e1)
    slopes = _tridiag_dirichlet(ts1, ts2, rhs_s6, sl0, sl1)
    return edges, slopes


def ppm_ih4_reconstruct(p, tm, limiting=NON_OSCILLATORY, pc_upper=False,
                        pc_lower=False, lb_ord: int = 4,
                        rb_ord: int = 4) -> Recon:
    """PPM with implicit 4th-order edges (the reference's default hor3map
    PPM path, prepare_ppm + reconstruct_ppm_edge_values)."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    return _ppm_from_edges(p, tm, dx, edges_ih4(p, tm, lb_ord, rb_ord),
                           limiting, pc_upper, pc_lower)


def _limit_pqm_monotonic(tm, dx, uel, uer, usl, usr):
    """Monotonic PQM limiting (limit_pqm_monotonic,
    mod_hor3map.F90:2119-2337), dense over columns.  usl/usr are
    xi-slopes (scaled by the cell width)."""
    tm_m, tm_p = _prev(tm), _next(tm)
    dx_m, dx_p = _prev(dx), _next(dx)

    hi = 1.0 / dx
    hci = 2.0 / (dx_m + 2. * dx + dx_p)
    sl = 2. * (tm - tm_m) * hi
    sr = 2. * (tm_p - tm) * hi
    sc0 = (tm_p - tm_m) * hci
    sc = torch.sign(sc0) * torch.minimum(
        torch.minimum(sl.abs(), sr.abs()), sc0.abs())
    has = sl * sr > 0.

    uel2 = torch.where((tm_m - uel) * (tm - uel) > 0.,
                       tm - torch.sign(sc) * torch.minimum(
                           .5 * dx * sc.abs(), (uel - tm).abs()), uel)
    uer2 = torch.where((tm_p - uer) * (tm - uer) > 0.,
                       tm + torch.sign(sc) * torch.minimum(
                           .5 * dx * sc.abs(), (uer - tm).abs()), uer)
    usl2 = torch.where(usl * sc < 0., 0., usl)
    usr2 = torch.where(usr * sc < 0., 0., usr)

    uel = torch.where(has, uel2, tm)
    uer = torch.where(has, uer2, tm)
    usl = torch.where(has, usl2, 0.)
    usr = torch.where(has, usr2, 0.)

    # inconsistent edges between neighbours (:2162-2168)
    uer_m = _prev(uer)
    fixe = (uel - uer_m) * (tm - tm_m) < 0.
    mid = .5 * (uer_m + uel)
    uel = torch.where(fixe, mid, uel)
    # and the neighbour's right edge
    fixe_p = torch.cat([fixe[1:], torch.zeros_like(fixe[-1:])], 0)
    uer = torch.where(fixe_p, _next(uel), uer)

    # inconsistent inflexion points (:2172-2264): derivative
    # coefficients of the quartic
    a0 = usl
    a1 = 2. * (30. * tm - 18. * uel - 12. * uer - 4.5 * usl + 1.5 * usr)
    a2 = 3. * (-60. * tm + 32. * uel + 28. * uer + 6. * usl - 4. * usr)
    a3 = 4. * (30. * tm - 15. * (uel + uer) - 2.5 * (usl - usr))
    b0, b1, b2 = a1, 2. * a2, 3. * a3

    ueps = 1e-14
    q1 = b0 * b2
    q2 = b1 * b1 - 4. * q1

    def dq(xi):
        return a0 + xi * (a1 + xi * (a2 + xi * a3))

    s = torch.sqrt(torch.clamp(q2, min=0.))
    q3 = .5 / torch.where(b2.abs() < ueps, 1., b2)
    xi_a = -(b1 + s) * q3
    xi_b = -(b1 - s) * q3
    xi_lin = -b0 / torch.where(b1.abs() < ueps, 1., b1)

    one_inflex = b0 * (b0 + b1 + b2) < 0.
    lin_case = b2.abs() < ueps
    xi1 = torch.where((xi_a > 0.) & (xi_a < 1.), xi_a, xi_b)
    bad_one = torch.where(lin_case,
                          (b1.abs() > ueps) & (dq(xi_lin) * sc < 0.),
                          dq(xi1) * sc < 0.)
    bad_two = (dq(xi_a) * sc < 0.) | (dq(xi_b) * sc < 0.)
    incon = (q2 > 0.) & torch.where(one_inflex, bad_one,
                                    (q1 > ueps) & bad_two)

    # left-leaning fix (:2230-2246)
    l_usl1 = (10. / 3.) * tm - (8. / 3.) * uel - (2. / 3.) * uer
    l_bad1 = l_usl1 * sc < 0.
    l_usr2 = 4. * uel + 6. * uer - 10. * tm
    l_bad2 = l_usr2 * sc < 0.
    usl_L = torch.where(l_bad1, 0.,
                        torch.where(l_bad2, (10. / 3.) * (uer - tm), l_usl1))
    usr_L = torch.where(l_bad1, 20. * (tm - uel),
                        torch.where(l_bad2, 0., l_usr2))
    uel_L = torch.where(l_bad1, uel,
                        torch.where(l_bad2, 2.5 * tm - 1.5 * uer, uel))
    uer_L = torch.where(l_bad1, 5. * tm - 4. * uel, uer)

    # right-leaning fix (:2247-2263)
    r_usr1 = (8. / 3.) * uer + (2. / 3.) * uel - (10. / 3.) * tm
    r_bad1 = r_usr1 * sc < 0.
    r_usl2 = 10. * tm - 4. * uer - 6. * uel
    r_bad2 = r_usl2 * sc < 0.
    usr_R = torch.where(r_bad1, 0.,
                        torch.where(r_bad2, (10. / 3.) * (tm - uel), r_usr1))
    usl_R = torch.where(r_bad1, 20. * (uer - tm),
                        torch.where(r_bad2, 0., r_usl2))
    uer_R = torch.where(r_bad1, uer,
                        torch.where(r_bad2, 2.5 * tm - 1.5 * uel, uer))
    uel_R = torch.where(r_bad1, 5. * tm - 4. * uer, uel)

    left = sl.abs() < sr.abs()
    uel = torch.where(incon, torch.where(left, uel_L, uel_R), uel)
    uer = torch.where(incon, torch.where(left, uer_L, uer_R), uer)
    usl = torch.where(incon, torch.where(left, usl_L, usl_R), usl)
    usr = torch.where(incon, torch.where(left, usr_L, usr_R), usr)

    # boundary cells (:2266-2336): not extrema, but monotonic within
    kk = tm.shape[0]
    u2 = tm[1] if kk > 1 else tm[0]
    u3 = tm[2] if kk > 2 else tm[-1]
    pcm_top = (u2 - uer[0]) * (tm[0] - uer[0]) > 0.
    s_top = (2. * (u3 - u2) / (dx[1] + dx[2]) if kk > 2
             else torch.zeros_like(tm[0]))
    cand = tm[0] + (1. / 3.) * s_top * dx[0]
    uer0 = torch.where(s_top > 0.,
                       torch.maximum(tm[0], torch.minimum(uel[1], cand)),
                       torch.minimum(tm[0], torch.maximum(uel[1], cand)))
    uer0 = torch.where(pcm_top, tm[0], uer0)
    uel0 = torch.where(pcm_top, tm[0], .5 * (3. * tm[0] - uer0))
    usl0 = torch.where(pcm_top, 0., 6. * tm[0] - 4. * uel0 - 2. * uer0)
    usr0 = torch.where(pcm_top, 0., 2. * uel0 + 4. * uer0 - 6. * tm[0])

    um1 = tm[-2] if kk > 1 else tm[0]
    um2 = tm[-3] if kk > 2 else tm[0]
    pcm_bot = (tm[-1] - uel[-1]) * (um1 - uel[-1]) > 0.
    s_bot = (2. * (um1 - um2) / (dx[-3] + dx[-2]) if kk > 2
             else torch.zeros_like(tm[-1]))
    candb = tm[-1] - (1. / 3.) * s_bot * dx[-1]
    uelN = torch.where(s_bot > 0.,
                       torch.minimum(tm[-1], torch.maximum(uer[-2], candb)),
                       torch.maximum(tm[-1], torch.minimum(uer[-2], candb)))
    uelN = torch.where(pcm_bot, tm[-1], uelN)
    uerN = torch.where(pcm_bot, tm[-1], .5 * (3. * tm[-1] - uelN))
    uslN = torch.where(pcm_bot, 0., 6. * tm[-1] - 4. * uelN - 2. * uerN)
    usrN = torch.where(pcm_bot, 0., 2. * uelN + 4. * uerN - 6. * tm[-1])

    out = []
    for a, top, bot in ((uel, uel0, uelN), (uer, uer0, uerN),
                        (usl, usl0, uslN), (usr, usr0, usrN)):
        a = a.clone()
        a[0] = top
        a[-1] = bot
        out.append(a)
    return tuple(out)


def pqm_reconstruct(p, tm, limiting=MONOTONIC, pc_upper=False,
                    pc_lower=False, lb_ord: int = 6,
                    rb_ord: int = 4) -> Recon:
    """Piecewise Quartic Method (prepare_pqm +
    reconstruct_pqm_edge_slope_values + limit_pqm_*,
    mod_hor3map.F90:1041-1306,1765-1870,2119-2624): per cell the quartic
    in xi with f(0) = uel, f(1) = uer, f'(0) = usl, f'(1) = usr and the
    mean tm."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    edges, slopes = edges_slopes_ih6(p, tm, lb_ord, rb_ord)
    uel, uer = edges[:-1], edges[1:]
    usl = slopes[:-1] * dx     # xi-slopes
    usr = slopes[1:] * dx

    if limiting == MONOTONIC:
        uel, uer, usl, usr = _limit_pqm_monotonic(tm, dx, uel, uer, usl,
                                                  usr)
    elif limiting in (NON_OSCILLATORY, NON_OSCILLATORY_POSDEF):
        # only where the curvature changes sign
        d2 = uel - 2. * tm + uer
        need = (_prev(d2) * d2 <= 0.) | (d2 * _next(d2) <= 0.)
        uel_l, uer_l, usl_l, usr_l = _limit_pqm_monotonic(
            tm, dx, uel, uer, usl, usr)
        uel = torch.where(need, uel_l, uel)
        uer = torch.where(need, uer_l, uer)
        usl = torch.where(need, usl_l, usl)
        usr = torch.where(need, usr_l, usr)
        if limiting == NON_OSCILLATORY_POSDEF:
            uel = torch.clamp(uel, min=0.)
            uer = torch.clamp(uer, min=0.)

    pc_mask = _pc_mask(tm, dx, pc_upper, pc_lower)
    uel = torch.where(pc_mask, tm, uel)
    uer = torch.where(pc_mask, tm, uer)
    usl = torch.where(pc_mask, 0., usl)
    usr = torch.where(pc_mask, 0., usr)

    c0 = uel
    c1 = usl
    c2 = 30. * tm - 18. * uel - 12. * uer - 4.5 * usl + 1.5 * usr
    c3 = -60. * tm + 32. * uel + 28. * uer + 6. * usl - 4. * usr
    c4 = 30. * tm - 15. * (uel + uer) - 2.5 * (usl - usr)
    return Recon(p=p, c0=c0, c1=c1, c2=c2, c3=c3, c4=c4)
