"""1-D vertical reconstruction and remap: the ALE main-path subset.

Counterpart of `blom_tpu/ops/hor3map.py` (BLOM's mod_hor3map.F90) for
what the nudge regrid and the remap of the ALE step use: explicit
4th-order PPM edges, the monotonic, non-oscillatory and positive-definite
limiters, and the fused multi-group remap; and `remap_means`, the
single-field remap of convec's velocities.  Arrays are (kk[+1], ...)
with the vertical axis leading, and every operation is the JAX
package's, in its order, so that f64 results agree to rounding.  The
k-scans are Python loops over the leading axis.  The implicit-edge
reconstructions (ppm_ih4, PQM) and the root-finding regrid are not
ported.

Within layer k a reconstruction is f(x) = c0 + c1*x + c2*x^2 for the
normalized x in [0, 1]."""

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
    """Piecewise-parabolic reconstruction on a source grid."""
    p: torch.Tensor      # (kk+1, ...) source interface positions
    c0: torch.Tensor     # (kk, ...) polynomial coefficients
    c1: torch.Tensor
    c2: torch.Tensor

    def eval0(self):
        """Upper-interface values (peval0)."""
        return self.c0

    def eval1(self):
        """Lower-interface values (peval1)."""
        return self.c0 + self.c1 + self.c2

    def deval0(self):
        """d/dx at the upper interface (dpeval0)."""
        return self.c1

    def deval1(self):
        """d/dx at the lower interface (dpeval1)."""
        return self.c1 + 2. * self.c2


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


def ppm_reconstruct(p, tm, limiting=NON_OSCILLATORY, pc_upper=False,
                    pc_lower=False, edge_weights=None) -> Recon:
    """PPM reconstruction of the layer means tm (kk, ...) on the
    interfaces p (kk+1, ...).  pc_upper/pc_lower make the top/bottom
    layer piecewise constant; edge_weights are edge4_weights(dx) when
    several fields share the grid."""
    kk = tm.shape[0]
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    e = _edge4(dx, tm, edge_weights)
    tel = e[:-1]
    ter = e[1:]

    if limiting == MONOTONIC:
        tel, ter = _limit_mono(tm, tel, ter, dx)
        tel, ter = _limit_boundary(tm, tel, ter, dx, pc_upper, pc_lower)
    elif limiting in (NON_OSCILLATORY, NON_OSCILLATORY_POSDEF):
        tel, ter = _limit_nosc(tm, tel, ter, dx)
        tel, ter = _limit_boundary(tm, tel, ter, dx, pc_upper, pc_lower)
        if limiting == NON_OSCILLATORY_POSDEF:
            tel, ter = _limit_posdef(tm, tel, ter)

    kidx = _kidx(kk, tm.ndim, tm.device)
    pc_mask = torch.zeros_like(tm, dtype=torch.bool)
    if pc_upper:
        pc_mask = pc_mask | (kidx == 0)
    if pc_lower:
        pc_mask = pc_mask | (kidx == kk - 1)
    pc_mask = pc_mask | (dx <= 2. * heps)      # vanishing layers
    tel = torch.where(pc_mask, tm, tel)
    ter = torch.where(pc_mask, tm, ter)

    c0 = tel
    c1 = 6. * tm - 4. * tel - 2. * ter
    c2 = 3. * (tel - 2. * tm + ter)
    return Recon(p=p, c0=c0, c1=c1, c2=c2)


def ppm_reconstruct_multi(p, tms, limiting=NON_OSCILLATORY,
                          pc_upper=False, pc_lower=False):
    """PPM-reconstruct several fields on the shared interfaces p, with
    the grid-only edge weights computed once."""
    dx = torch.clamp(p[1:] - p[:-1], min=0.) + heps
    w = edge4_weights(dx)
    return [ppm_reconstruct(p, tm, limiting, pc_upper, pc_lower,
                            edge_weights=w) for tm in tms]


def remap_groups(groups, bottom_only_empties: bool = False):
    """Remap several (reconstructions, destination grid) groups in one
    loop over the source layers (remap, mod_hor3map.F90:4723-4790).

    groups: list of (rc_list, p_dst); the Recons of one group share the
    source grid rc.p.  Returns a list of lists of destination layer
    means.  The integral from the column top to each destination edge
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
                accs[g][t] = accs[g][t] + dxk[None] * poly
                if not bottom_only_empties:
                    fval = c0 + c1 * x + c2 * x2
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
        acc = acc + dxk * (c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x)
        # point value at pq where it falls inside this (nonempty) layer
        inl = (pq >= p_up) & (pq <= p_up + dxk) & (dxk > heps) & ~found
        point = torch.where(inl, c0 + c1 * x + c2 * x2, point)
        found = found | inl
    dpd = p_dst[1:] - p_dst[:-1]
    means = (acc[1:] - acc[:-1]) / torch.clamp(dpd, min=heps)
    point_l = torch.where(found[:-1], point[:-1], means)
    return torch.where(dpd > heps, means, point_l)
