"""Incremental-remapping advection (advmth='remap').

Counterpart of `blom_tpu/dynamics/remap.py` (BLOM's mod_remap.F90:205-1522
remap, with the polygon moment primitives triint/penint :53-199): per
edge, the fluxed mass is the integral of a slope-limited linear
reconstruction over the geometric departure region, a pentagon rooted in
the upwind cell plus corner triangles from the diagonal neighbours where
the corner velocities sweep across cell boundaries.  Both flow
directions are computed over whole planes and blended by the sign of
the edge velocity; one tracer stack (temp, saln, the passive tracers)
goes through the same moment algebra.

blom_tpu vmaps `remap_layer` over the layers.  Here every plane may carry
a leading layer axis: the thickness-like planes are (..., J, I) and the
tracer stack is (ntr, ..., J, I), so one call advects the whole state
(K, J, I) with its stack (ntr, K, J, I), or one layer (J, I) with
(ntr, J, I).  The operations are elementwise across layers, so either
form gives the same values.  blom_tpu_torch has no CUDA kernel here:
blom_tpu runs this as plain XLA, and it runs on whatever device its
tensors are on."""

from __future__ import annotations

import torch

from ..core.grid import Grid

DPEPS = 1.e-12   # small layer thickness [Pa] (mod_remap.F90:40-41)


# ------------------------------------------------------------------ #
# polygon flux-integral primitives
# ------------------------------------------------------------------ #

def triint(ac, x1, y1, x2, y2, x3, y3):
    """Integrals of {1, x, y, xx, yy, xy} over a triangle, times cell
    area (triint, mod_remap.F90:53-102).  Returns (a, ax, ay, axx, ayy,
    axy) with the moment terms pre-multiplied by the area a."""
    xx = x1 * x2 + x2 * x3 + x1 * x3
    yy = y1 * y2 + y2 * y3 + y1 * y3
    xy = x1 * y1 + x2 * y2 + x3 * y3
    a = .5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)) * ac
    ax = (x1 + x2 + x3) / 3.
    ay = (y1 + y2 + y3) / 3.
    axx = (9. * ax * ax - xx) / 6.
    ayy = (9. * ay * ay - yy) / 6.
    axy = (9. * ax * ay + xy) / 12.
    return a, ax * a, ay * a, axx * a, ayy * a, axy * a


def penint(ac, x1, y1, x2, y2, x3, y3, x4, y4, x5, y5):
    """Same moments over a pentagon, as the fan of triangles (123),
    (135), (345) (penint, mod_remap.F90:104-199)."""
    m1 = triint(ac, x1, y1, x2, y2, x3, y3)
    m2 = triint(ac, x1, y1, x3, y3, x5, y5)
    m3 = triint(ac, x3, y3, x4, y4, x5, y5)
    return tuple(p + q + r for p, q, r in zip(m1, m2, m3))


# ------------------------------------------------------------------ #
# limited linear reconstructions
# ------------------------------------------------------------------ #

def _neighbors(grid: Grid, a):
    """The 8 neighbour values with land fallback to the centre value
    (the iw/ie/js/jn/isw... index construction, mod_remap.F90:370-383),
    and the inverse centred-difference widths."""
    w_ok = grid.iu > 0.
    e_ok = grid.ip1(grid.iu) > 0.
    s_ok = grid.iv > 0.
    n_ok = grid.jp1(grid.iv) > 0.

    aw = torch.where(w_ok, grid.im1(a), a)
    ae = torch.where(e_ok, grid.ip1(a), a)
    as_ = torch.where(s_ok, grid.jm1(a), a)
    an = torch.where(n_ok, grid.jp1(a), a)

    def diag(ishift, jshift, iok, jok, a_iface, a_jface):
        # the reference builds isw from iw/js that are already
        # face-fallen-back: with one face neighbour the "diagonal" is
        # that (wet) face value; with both faces wet and the diagonal
        # dry, the centre
        cand = grid.shift(a, ishift, jshift)
        wet = grid.shift(grid.ip, ishift, jshift) > 0.
        both = iok & jok
        return torch.where(both, torch.where(wet, cand, a),
                           torch.where(iok, a_iface,
                                       torch.where(jok, a_jface, a)))

    asw = diag(-1, -1, w_ok, s_ok, aw, as_)
    ase = diag(1, -1, e_ok, s_ok, ae, as_)
    anw = diag(-1, 1, w_ok, n_ok, aw, an)
    ane = diag(1, 1, e_ok, n_ok, ae, an)
    # cast before adding: bool + bool is a logical or, and two wet
    # neighbours give the centred difference's 1/2 (the reference's
    # 1/max(1, ie-iw))
    dxi = 1. / torch.clamp(w_ok.to(a.dtype) + e_ok.to(a.dtype), min=1.)
    dyi = 1. / torch.clamp(s_ok.to(a.dtype) + n_ok.to(a.dtype), min=1.)
    return (aw, ae, as_, an, asw, ase, anw, ane), (dxi, dyi)


def _recon_dp(grid: Grid, dp, pup, pbmin):
    """Limited dp gradient and centre-of-mass offsets
    (mod_remap.F90:385-411)."""
    def clipdp(a_dp, a_pup):
        return torch.clamp(torch.minimum(pbmin - a_pup, a_dp), min=DPEPS)

    (dpw, dpe, dps, dpn, dpsw, dpse, dpnw, dpne), (dxi, dyi) = \
        _neighbors(grid, dp)
    (puw, pue, pus, pun, pusw, puse, punw, pune), _ = \
        _neighbors(grid, pup)
    vals = [clipdp(a, b) for a, b in
            [(dpsw, pusw), (dps, pus), (dpse, puse), (dpw, puw),
             (dpe, pue), (dpnw, punw), (dpn, pun), (dpne, pune)]]
    dpc = torch.clamp(torch.minimum(pbmin - pup, dp), min=DPEPS)
    stack = torch.stack(vals)
    gx = (clipdp(dpe, pue) - clipdp(dpw, puw)) * dxi
    gy = (clipdp(dpn, pun) - clipdp(dps, pus)) * dyi
    gmx = .5 * (gx.abs() + gy.abs())
    fmx = torch.clamp(stack.amax(0) - dpc, min=0.)
    fmn = torch.clamp(stack.amin(0) - dpc, max=0.)
    ok = (fmx > 0.) & (fmn < 0.)
    q = torch.minimum(fmx / torch.maximum(fmx, gmx),
                      fmn / torch.minimum(fmn, -gmx))
    q = torch.where(ok, q, 0.)
    gx = gx * q
    gy = gy * q
    xd = gx / (12. * dp)
    yd = gy / (12. * dp)
    return gx, gy, xd, yd


def _recon_tr(grid: Grid, tr, xd, yd):
    """Limited tracer gradients and offset-corrected means of the whole
    tracer stack (mod_remap.F90:413-468)."""
    (aw, ae, as_, an, asw, ase, anw, ane), (dxi, dyi) = \
        _neighbors(grid, tr)
    gx = (ae - aw) * dxi
    gy = (an - as_) * dyi
    q1 = gx * (-.5 - xd)
    q2 = gx * (.5 - xd)
    q3 = gy * (-.5 - yd)
    q4 = gy * (.5 - yd)
    stack = torch.stack([asw, as_, ase, aw, ae, anw, an, ane])
    fmx = torch.clamp(stack.amax(0) - tr, min=0.)
    fmn = torch.clamp(stack.amin(0) - tr, max=0.)
    gmx = torch.maximum(q1, q2) + torch.maximum(q3, q4)
    gmn = torch.minimum(q1, q2) + torch.minimum(q3, q4)
    ok = (fmx > 0.) & (fmn < 0.)
    q = torch.minimum(fmx / torch.maximum(fmx, gmx),
                      fmn / torch.minimum(fmn, gmn))
    q = torch.where(ok, q, 0.)
    gx = gx * q
    gy = gy * q
    d = tr - gx * xd - gy * yd
    return gx, gy, d


# ------------------------------------------------------------------ #
# corner velocities
# ------------------------------------------------------------------ #

def _corner_velocities(grid: Grid, cu, cv):
    """Non-dimensional corner velocities at q-points
    (mod_remap.F90:613-656)."""
    ip = grid.ip
    ipw = grid.im1(ip)
    ips = grid.jm1(ip)
    ipsw = grid.im1(grid.jm1(ip))
    nw = ipsw + ips + ipw + ip

    cu_s = grid.jm1(cu)
    cv_w = grid.im1(cv)

    # nw == 4: harmonic mean unless the signs differ
    hu = torch.where(cu_s * cu <= 0., 0.,
                     2. * cu_s * cu / torch.where((cu_s + cu).abs() > 0.,
                                                  cu_s + cu, 1.))
    hv = torch.where(cv_w * cv <= 0., 0.,
                     2. * cv_w * cv / torch.where((cv_w + cv).abs() > 0.,
                                                  cv_w + cv, 1.))

    # nw == 2: straight pairs
    pair_s = (ipsw + ips) == 2.
    pair_n = (ipw + ip) == 2.
    pair_w = (ipsw + ipw) == 2.
    pair_e = (ips + ip) == 2.
    cuc2 = torch.where(pair_s, cu_s, torch.where(pair_n, cu, 0.))
    cvc2 = torch.where(pair_s | pair_n, 0.,
                       torch.where(pair_w, cv_w,
                                   torch.where(pair_e, cv, 0.)))

    cuc = torch.where(nw == 4., hu, torch.where(nw == 2., cuc2, 0.))
    cvc = torch.where(nw == 4., hv, torch.where(nw == 2., cvc2, 0.))
    return cuc, cvc


# ------------------------------------------------------------------ #
# edge fluxes
# ------------------------------------------------------------------ #

def _moments_contrib(m, dl, gx, gy, trg):
    """Mass and tracer flux of one polygon contribution
    (mod_remap.F90:700-712); trg = (gxs, gys, ds), tracer stacks."""
    a, ax, ay, axx, ayy, axy = m
    fd = a * dl + ax * gx + ay * gy
    qx = ax * dl + axx * gx + axy * gy
    qy = ay * dl + axy * gx + ayy * gy
    gxs, gys, ds = trg
    ftr = fd[None] * ds + qx[None] * gxs + qy[None] * gys
    return fd, ftr


def _safe_div(a, b):
    # the two guards as tensors of b's dtype: torch.where of two Python
    # numbers would be float32
    eps = torch.full_like(b, 1.e-12)
    return a / torch.where(b.abs() > 1.e-12, b,
                           torch.where(b >= 0., eps, -eps))


def _contributions(grid: Grid, dp, pup, gx, gy, trg, pbe):
    """at(di, dj, a), the source-cell reads of the flux of one edge
    family, and contrib(cond, m, di, dj), a polygon's mass and tracer
    flux where cond holds and 0 elsewhere; pbe is the edge's bottom
    pressure."""
    def at(di, dj, a):
        return grid.shift(a, di, dj)

    def tr_at(di, dj):
        gxs, gys, ds = trg
        return at(di, dj, gxs), at(di, dj, gys), at(di, dj, ds)

    def dl_at(di, dj):
        return torch.minimum(at(di, dj, dp),
                             torch.clamp(pbe - at(di, dj, pup), min=0.))

    def polygon(m, di, dj):
        return _moments_contrib(m, dl_at(di, dj), at(di, dj, gx),
                                at(di, dj, gy), tr_at(di, dj))

    def contrib(cond, m, di, dj):
        fd, ftr = polygon(m, di, dj)
        return torch.where(cond, fd, 0.), torch.where(cond[None], ftr, 0.)

    return at, polygon, contrib


def _u_fluxes(grid: Grid, dp, pup, gx, gy, trg, cu, cuc, cvc, pbu):
    """u-edge mass and tracer fluxes (mod_remap.F90:662-1040).  Fields
    at source cells are gathered by shifts; both flow directions are
    computed and blended by sign(cu)."""
    sc = grid.scp2
    sci = grid.scp2i
    at, polygon, contrib = _contributions(grid, dp, pup, gx, gy, trg, pbu)

    cvc_n = grid.jp1(cvc)   # corner (i, j+1)
    cuc_n = grid.jp1(cuc)
    # the fluxing area's middle vertex (:667-668)
    ym = -.5 * (cvc + cvc_n)
    xm = _safe_div((ym + .5) * cuc - (ym - .5) * cuc_n - 2. * cu,
                   1. + cvc - cvc_n)

    # ---- cu > 0 (west upwind)
    s_on = cvc > 0.
    n_on = cvc_n < 0.
    xc0s = _safe_div(xm * cvc - cuc * (ym + .5), cvc + ym + .5)
    xc1s = xc0s * at(-1, 0, sc) * at(-1, -1, sci)
    m_sw = triint(at(-1, -1, sc), xc1s + .5, .5, -cuc + .5,
                  -cvc + .5, .5, .5)
    fd_sw, ftr_sw = contrib(s_on, m_sw, -1, -1)
    x4p = torch.where(s_on, xc0s + .5, -cuc + .5)
    y4p = torch.where(s_on, -.5, -cvc - .5)

    xc0n = _safe_div(xm * cvc_n - cuc_n * (ym - .5), cvc_n + ym - .5)
    xc1n = xc0n * at(-1, 0, sc) * at(-1, 1, sci)
    m_nw = triint(at(-1, 1, sc), xc1n + .5, -.5, .5, -.5,
                  -cuc_n + .5, -cvc_n - .5)
    fd_nw, ftr_nw = contrib(n_on, m_nw, -1, 1)
    x2p = torch.where(n_on, xc0n + .5, -cuc_n + .5)
    y2p = torch.where(n_on, .5, -cvc_n + .5)

    m_pw = penint(at(-1, 0, sc), .5, .5, x2p, y2p, xm + .5, ym,
                  x4p, y4p, .5, -.5)
    fd_w, ftr_w = polygon(m_pw, -1, 0)
    fd_pos = fd_sw + fd_nw + fd_w
    ftr_pos = ftr_sw + ftr_nw + ftr_w

    # ---- cu < 0 (east upwind, source cells at i, j +/- 1)
    xc1s = xc0s * sc * at(0, -1, sci)
    m_se = triint(at(0, -1, sc), xc1s - .5, .5, -cuc - .5,
                  -cvc + .5, -.5, .5)
    fd_se, ftr_se = contrib(s_on, m_se, 0, -1)
    x4m = torch.where(s_on, xc0s - .5, -cuc - .5)
    y4m = torch.where(s_on, -.5, -cvc - .5)

    xc1n = xc0n * sc * at(0, 1, sci)
    m_ne = triint(at(0, 1, sc), xc1n - .5, -.5, -.5, -.5,
                  -cuc_n - .5, -cvc_n - .5)
    fd_ne, ftr_ne = contrib(n_on, m_ne, 0, 1)
    x2m = torch.where(n_on, xc0n - .5, -cuc_n - .5)
    y2m = torch.where(n_on, .5, -cvc_n + .5)

    m_pe = penint(sc, -.5, .5, x2m, y2m, xm - .5, ym, x4m, y4m,
                  -.5, -.5)
    fd_e, ftr_e = polygon(m_pe, 0, 0)
    fd_neg = fd_se + fd_ne + fd_e
    ftr_neg = ftr_se + ftr_ne + ftr_e

    pos = cu > 0.
    fdu = torch.where(pos, fd_pos, fd_neg) * grid.iu
    ftru = torch.where(pos[None], ftr_pos, ftr_neg) * grid.iu
    return fdu, ftru


def _v_fluxes(grid: Grid, dp, pup, gx, gy, trg, cv, cuc, cvc, pbv):
    """v-edge fluxes (mod_remap.F90:1076-1448), the mirror of
    _u_fluxes."""
    sc = grid.scp2
    sci = grid.scp2i
    at, polygon, contrib = _contributions(grid, dp, pup, gx, gy, trg, pbv)

    cuc_e = grid.ip1(cuc)
    cvc_e = grid.ip1(cvc)
    xm = -.5 * (cuc + cuc_e)
    ym = _safe_div((xm + .5) * cvc - (xm - .5) * cvc_e - 2. * cv,
                   1. + cuc - cuc_e)

    w_on = cuc > 0.
    e_on = cuc_e < 0.

    # ---- cv > 0 (south upwind)
    yc0w = _safe_div(ym * cuc - cvc * (xm + .5), cuc + xm + .5)
    yc1w = yc0w * at(0, -1, sc) * at(-1, -1, sci)
    m_sw = triint(at(-1, -1, sc), .5, yc1w + .5, .5, .5,
                  -cuc + .5, -cvc + .5)
    fd_sw, ftr_sw = contrib(w_on, m_sw, -1, -1)
    x2p = torch.where(w_on, -.5, -cuc - .5)
    y2p = torch.where(w_on, yc0w + .5, -cvc + .5)

    yc0e = _safe_div(ym * cuc_e - cvc_e * (xm - .5), cuc_e + xm - .5)
    yc1e = yc0e * at(0, -1, sc) * at(1, -1, sci)
    m_se = triint(at(1, -1, sc), -.5, yc1e + .5, -cuc_e - .5,
                  -cvc_e + .5, -.5, .5)
    fd_se, ftr_se = contrib(e_on, m_se, 1, -1)
    x4p = torch.where(e_on, .5, -cuc_e + .5)
    y4p = torch.where(e_on, yc0e + .5, -cvc_e + .5)

    m_ps = penint(at(0, -1, sc), -.5, .5, x2p, y2p, xm, ym + .5,
                  x4p, y4p, .5, .5)
    fd_s, ftr_s = polygon(m_ps, 0, -1)
    fd_pos = fd_sw + fd_se + fd_s
    ftr_pos = ftr_sw + ftr_se + ftr_s

    # ---- cv < 0 (north upwind, sources at j, i +/- 1)
    yc1w = yc0w * sc * at(-1, 0, sci)
    m_nw = triint(at(-1, 0, sc), .5, yc1w - .5, .5, -.5,
                  -cuc + .5, -cvc - .5)
    fd_nw, ftr_nw = contrib(w_on, m_nw, -1, 0)
    x2m = torch.where(w_on, -.5, -cuc - .5)
    y2m = torch.where(w_on, yc0w - .5, -cvc - .5)

    yc1e = yc0e * sc * at(1, 0, sci)
    m_ne = triint(at(1, 0, sc), -.5, yc1e - .5, -cuc_e - .5,
                  -cvc_e - .5, -.5, -.5)
    fd_ne, ftr_ne = contrib(e_on, m_ne, 1, 0)
    x4m = torch.where(e_on, .5, -cuc_e + .5)
    y4m = torch.where(e_on, yc0e - .5, -cvc_e - .5)

    m_pn = penint(sc, -.5, -.5, x2m, y2m, xm, ym - .5, x4m, y4m,
                  .5, -.5)
    fd_n, ftr_n = polygon(m_pn, 0, 0)
    fd_neg = fd_nw + fd_ne + fd_n
    ftr_neg = ftr_nw + ftr_ne + ftr_n

    pos = cv > 0.
    fdv = torch.where(pos, fd_pos, fd_neg) * grid.iv
    ftrv = torch.where(pos[None], ftr_pos, ftr_neg) * grid.iv
    return fdv, ftrv


# ------------------------------------------------------------------ #
# driver
# ------------------------------------------------------------------ #

def remap_layer(grid: Grid, pbmin, pbu, pbv, plo, cau, cav, dp, tr):
    """Advect layer thickness and its tracer stack by incremental
    remapping (remap, mod_remap.F90:205-1522).

    plo, cau, cav, dp: (..., J, I), one layer or a leading layer axis;
    pbmin, pbu, pbv: (J, I); tr: (ntr, ..., J, I), the tracer stack
    (temp, saln, passive tracers).  Returns (dp_new, tr_new, fdu, fdv,
    ftru, ftrv) with fluxes in area*pressure units matching the
    uflx/utflx accumulation; tr_new, ftru and ftrv keep tr's layout."""
    dp = torch.clamp(dp, min=0.) + DPEPS
    pup = plo - dp

    gx, gy, xd, yd = _recon_dp(grid, dp, pup, pbmin)
    trg = _recon_tr(grid, tr, xd, yd)

    # non-dimensional edge velocities (:592-611)
    cu = torch.where(cau > 0., cau * grid.im1(grid.scp2i),
                     cau * grid.scp2i) * grid.iu
    cv = torch.where(cav > 0., cav * grid.jm1(grid.scp2i),
                     cav * grid.scp2i) * grid.iv

    cuc, cvc = _corner_velocities(grid, cu, cv)

    fdu, ftru = _u_fluxes(grid, dp, pup, gx, gy, trg, cu, cuc, cvc, pbu)
    fdv, ftrv = _v_fluxes(grid, dp, pup, gx, gy, trg, cv, cuc, cvc, pbv)

    # update (:1455-1517)
    div = (grid.ip1(fdu) - fdu + grid.jp1(fdv) - fdv) * grid.scp2i
    dp_new = dp - div
    trdiv = (grid.ip1(ftru) - ftru + grid.jp1(ftrv) - ftrv) * grid.scp2i
    tr_new = (dp[None] * tr - trdiv) / dp_new[None]
    dp_new = torch.clamp(dp_new - DPEPS, min=0.) * grid.ip
    tr_new = torch.where(grid.ip > 0., tr_new, tr)
    return dp_new, tr_new, fdu, fdv, ftru, ftrv
