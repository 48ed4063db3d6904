"""Compatible Piecewise Parabolic Method (CPPM) advection sweep.

Counterpart of `blom_tpu/dynamics/cppm.py` (BLOM's mod_cppm.F90) in all
four variants: full or partial compatibility of the tracer edges with
the thickness parabola, non-oscillatory or monotonic limiting.

- `init_cppm_coeffs`: host numpy port of set_stencil_coeffs
  (mod_cppm.F90:101-320), land-stencil-aware per-cell coefficients;
- `_cppm_sweep_body`: the plain PyTorch version of the sweep kernel —
  thickness edges (h_edges_nosc/_mono, :361-488), tracer edges that are
  compatible (per-cell 4x4 LU solves, parabola_coeffs_fc_*, :490-1116)
  or partially so (parabola_coeffs_pc_*, :1118-1371), upstream flux
  integration (:1373-1468) and the cell update;
- `cppm_sweep`: dispatch.  A CUDA tensor goes through the hand-written
  kernel (`cppm_cuda`), a CPU tensor through `_cppm_sweep_body`.

The sweep axis is an argument (`ax`: -1 for i, -2 for j); fields keep
their natural (k, j, i) layout for both axes."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

dpeps = 1.e-12   # small thickness (mod_cppm.F90:76)

# stencil class tags (mod_cppm.F90:60-68)
S0000, S1111, S1110, S0111, S1100, S0110, S0011, S0100, S0010 = range(9)


class CppmCoeffs(NamedTuple):
    """Per-cell sweep coefficients in natural (j, i) layout."""
    stencil: torch.Tensor   # int32
    hevc: torch.Tensor      # (4, J, I) thickness edge-value coefficients
    ssc: torch.Tensor       # one-sided slope coefficient
    scc: torch.Tensor       # centered slope coefficient
    d2m: torch.Tensor       # second-derivative mask
    tmc0: torch.Tensor      # (12, J, I) tracer matrix coefficients
    tmcl: torch.Tensor
    tmcr: torch.Tensor


def _set_stencil_coeffs_np(sm, dx):
    """set_stencil_coeffs (mod_cppm.F90:101-320) for a single cell:
    returns (stencil, hevc[4], tmc0[12], tmcl[12], tmcr[12])."""
    c1_2, c2_3, c1_4, c3_4 = .5, 2 / 3., .25, .75
    c1_5, c1_6, c1_10, c1_12, c1_15, c1_20 = \
        1 / 5., 1 / 6., 1 / 10., 1 / 12., 1 / 15., 1 / 20.

    a12 = -dx[1] - c1_2 * dx[0]
    a22 = -c1_2 * dx[1]
    a32 = c1_2 * dx[2]
    a42 = dx[2] + c1_2 * dx[3]
    a13 = a12 * a12 + c1_12 * dx[0] * dx[0]
    a23 = -c2_3 * a22 * dx[1]
    a33 = c2_3 * a32 * dx[2]
    a43 = a42 * a42 + c1_12 * dx[3] * dx[3]
    a14 = (a13 + c1_6 * dx[0] * dx[0]) * a12
    a24 = -c3_4 * a23 * dx[1]
    a34 = c3_4 * a33 * dx[2]
    a44 = (a43 + c1_6 * dx[3] * dx[3]) * a42

    tmcl = np.zeros(12)
    tmcr = np.zeros(12)
    tmc0 = np.zeros(12)
    tmcl[0] = -c1_12 * dx[0]
    tmcl[1] = (c1_10 * dx[0] + c1_6 * dx[1]) * dx[0]
    tmcl[2] = -(c1_10 * (dx[0] + 3 * dx[1]) * dx[0]
                + c1_4 * dx[1] ** 2) * dx[0]
    tmcl[3] = -c1_12 * dx[1]
    tmcl[4] = c1_10 * dx[1] ** 2
    tmcl[5] = -c1_10 * dx[1] ** 3
    tmcl[6] = -c1_12 * dx[2]
    tmcl[7] = -c1_15 * dx[2] ** 2
    tmcl[8] = -c1_20 * dx[2] ** 3
    tmcl[9] = -c1_12 * dx[3]
    tmcl[10] = -(c1_15 * dx[3] + c1_6 * dx[2]) * dx[3]
    tmcl[11] = -(c1_5 * (c1_4 * dx[3] + dx[2]) * dx[3]
                 + c1_4 * dx[2] ** 2) * dx[3]

    tmcr[0] = c1_12 * dx[0]
    tmcr[1] = -(c1_15 * dx[0] + c1_6 * dx[1]) * dx[0]
    tmcr[2] = (c1_5 * (c1_4 * dx[0] + dx[1]) * dx[0]
               + c1_4 * dx[1] ** 2) * dx[0]
    tmcr[3] = c1_12 * dx[1]
    tmcr[4] = -c1_15 * dx[1] ** 2
    tmcr[5] = c1_20 * dx[1] ** 3
    tmcr[6] = c1_12 * dx[2]
    tmcr[7] = c1_10 * dx[2] ** 2
    tmcr[8] = c1_10 * dx[2] ** 3
    tmcr[9] = c1_12 * dx[3]
    tmcr[10] = (c1_10 * dx[3] + c1_6 * dx[2]) * dx[3]
    tmcr[11] = (c1_10 * (dx[3] + 3 * dx[2]) * dx[3]
                + c1_4 * dx[2] ** 2) * dx[3]

    tmc0[0] = a12
    tmc0[1] = a13 - tmcl[1] - tmcr[1]
    tmc0[2] = a14 - tmcl[2] - tmcr[2]
    tmc0[3] = a22
    tmc0[4] = a23 - tmcl[4] - tmcr[4]
    tmc0[5] = a24 - tmcl[5] - tmcr[5]
    tmc0[6] = a32
    tmc0[7] = a33 - tmcl[7] - tmcr[7]
    tmc0[8] = a34 - tmcl[8] - tmcr[8]
    tmc0[9] = a42
    tmc0[10] = a43 - tmcl[10] - tmcr[10]
    tmc0[11] = a44 - tmcl[11] - tmcr[11]

    sm = tuple(int(x) for x in sm)
    hevc = np.zeros(4)
    if sm == (1, 1, 1, 1):
        st = S1111
        b22 = a22 - a12
        b32 = a32 - a12
        b42 = a42 - a12
        b23 = (a23 - a13) / b22
        b33 = a33 - a13 - b23 * b32
        b43 = a43 - a13 - b23 * b42
        b24 = (a24 - a14) / b22
        b34 = a34 - a14 - b24 * b32
        b44 = a44 - a14 - b24 * b42
        b34 = b34 / b33
        b44 = b44 - b34 * b43
        h2 = -a12
        h3 = -a13 - b23 * h2
        h4 = -a14 - b24 * h2 - b34 * h3
        h4 = h4 / b44
        h3 = (h3 - b43 * h4) / b33
        h2 = (h2 - b32 * h3 - b42 * h4) / b22
        hevc[:] = [1. - h2 - h3 - h4, h2, h3, h4]
    elif sm == (1, 1, 1, 0):
        st = S1110
        b22 = a22 - a12
        b32 = a32 - a12
        b23 = (a23 - a13) / b22
        b33 = a33 - a13 - b23 * b32
        h2 = -a12
        h3 = (-a13 - b23 * h2) / b33
        h2 = (h2 - b32 * h3) / b22
        hevc[:] = [1. - h2 - h3, h2, h3, 0.]
    elif sm == (0, 1, 1, 1):
        st = S0111
        b32 = a32 - a22
        b42 = a42 - a22
        b33 = (a33 - a23) / b32
        b43 = a43 - a23 - b33 * b42
        h3 = -a22
        h4 = (-a23 - b33 * h3) / b43
        h3 = (h3 - b42 * h4) / b32
        hevc[:] = [0., 1. - h3 - h4, h3, h4]
    elif sm == (0, 1, 1, 0):
        st = S0110
        b32 = a32 - a22
        h3 = -a22 / b32
        hevc[:] = [0., 1. - h3, h3, 0.]
    elif sm[0] == 1 and sm[1] == 1:
        st = S1100
        b22 = a22 - a12
        h2 = -a12 / b22
        hevc[:] = [1. - h2, h2, 0., 0.]
    elif sm[2] == 1 and sm[3] == 1:
        st = S0011
        b42 = a42 - a32
        h4 = -a32 / b42
        hevc[:] = [0., 0., 1. - h4, h4]
    elif sm[1] == 1:
        st = S0100
        hevc[:] = [0., 1., 0., 0.]
    elif sm[2] == 1:
        st = S0010
        hevc[:] = [0., 0., 1., 0.]
    else:
        st = S0000
    return st, hevc, tmc0, tmcl, tmcr


NGHOST_ARCTIC = 3   # fold ghost rows for the j-sweep (the reference's
                    # (0,3) xctilr halo width, mod_cppm.F90:1956-1960)


def init_cppm_coeffs(ip_np: np.ndarray, dx_np: np.ndarray, axis: int,
                     periodic: bool, dtype=torch.float64, device='cpu',
                     arctic: bool = False) -> CppmCoeffs:
    """Sweep coefficients for a direction (init_cppm,
    mod_cppm.F90:2504-2746).  `ip_np` and `dx_np` are (jdm, idm); `axis`
    is the sweep axis (-1: i, -2: j).  All returned arrays are in
    natural (j, i) layout.  Shifted masks zero-fill at closed ends; the
    shifted grid spacing replicates the edge value.

    With `arctic` the domain is extended by NGHOST_ARCTIC fold ghost
    rows (p-grid mirror: ghost jj+1+m = i-reversed row jj-2-m,
    mod_xc.F90:2430-2442) so the sweep sees the stencil across the
    bipolar seam: for axis=-2 the ghost rows join the sweep columns; for
    axis=-1 they are extra independent sweep rows."""
    ip_np = np.asarray(ip_np, np.float64)
    dx_np = np.asarray(dx_np, np.float64)
    if arctic:
        gh_ip = [ip_np[-3 - mm][::-1][None] for mm in range(NGHOST_ARCTIC)]
        gh_dx = [dx_np[-3 - mm][::-1][None] for mm in range(NGHOST_ARCTIC)]
        ip_np = np.concatenate([ip_np] + gh_ip, axis=0)
        dx_np = np.concatenate([dx_np] + gh_dx, axis=0)
    if axis == -2:
        ip_np = ip_np.T
        dx_np = dx_np.T
    nrow, ncell = ip_np.shape

    def cells(off):
        out = np.roll(ip_np, -off, axis=1)
        if not periodic:
            if off > 0:
                out[:, -off:] = 0
            elif off < 0:
                out[:, :-off] = 0
        return out

    def dxs(off):
        out = np.roll(dx_np, -off, axis=1)
        if not periodic:
            if off > 0:
                out[:, -off:] = dx_np[:, -1:]
            elif off < 0:
                out[:, :-off] = dx_np[:, :1]
        return out

    sm4 = np.stack([cells(o) for o in (-2, -1, 0, 1)], axis=-1)
    dx4 = np.stack([dxs(o) for o in (-2, -1, 0, 1)], axis=-1)

    # each distinct (mask, spacing) stencil once: a grid of uniform
    # spacing has a handful, and each cell takes its stencil's values
    keys = np.concatenate([sm4.reshape(-1, 4), dx4.reshape(-1, 4)], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    per = [_set_stencil_coeffs_np(k[:4], k[4:]) for k in uniq]

    def gather(i, n):
        vals = np.stack([np.asarray(o[i], np.float64).reshape(n) for o in per],
                        axis=1)
        return vals[:, inv].reshape(n, nrow, ncell)
    stencil = np.asarray([o[0] for o in per], np.int32)[inv].reshape(
        nrow, ncell)
    hevc, tmc0, tmcl, tmcr = (gather(1, 4), gather(2, 12), gather(3, 12),
                              gather(4, 12))
    # slope coefficients / d2 mask on the 3-cell stencil (i-1, i, i+1)
    # (set_slope_coeffs / set_d2_mask, mod_cppm.F90:322-359)
    sm3 = np.stack([cells(o) for o in (-1, 0, 1)], axis=-1)
    dx3 = np.stack([dxs(o) for o in (-1, 0, 1)], axis=-1)
    wet3 = np.all(sm3 == 1, axis=-1)
    ssc = np.where(wet3, 2.0, 0.0)
    scc = np.where(wet3,
                   2.0 * dx3[..., 1] / (dx3[..., 0] + 2 * dx3[..., 1]
                                        + dx3[..., 2]),
                   0.0)
    d2m = np.where(wet3, 1.0, 0.0)

    if axis == -2:
        stencil = stencil.T
        hevc = hevc.swapaxes(-1, -2)
        tmc0 = tmc0.swapaxes(-1, -2)
        tmcl = tmcl.swapaxes(-1, -2)
        tmcr = tmcr.swapaxes(-1, -2)
        ssc, scc, d2m = ssc.T, scc.T, d2m.T

    def as_t(a, dt=dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dt, device=device)

    return CppmCoeffs(stencil=as_t(stencil, torch.int32), hevc=as_t(hevc),
                      ssc=as_t(ssc), scc=as_t(scc), d2m=as_t(d2m),
                      tmc0=as_t(tmc0), tmcl=as_t(tmcl), tmcr=as_t(tmcr))


# ---------------------------------------------------------------------------
# plain PyTorch version of the sweep kernel


def _sh(a, off, periodic, ax):
    """Value at (idx + off) along the sweep axis `ax`; zeros enter at a
    closed end."""
    if off == 0:
        return a
    if periodic:
        return torch.roll(a, -off, dims=ax)
    n = a.shape[ax]
    pad_shape = list(a.shape)
    pad_shape[ax] = abs(off)
    zeros = a.new_zeros(pad_shape)
    if off > 0:
        return torch.cat([a.narrow(ax, off, n - off), zeros], ax)
    return torch.cat([zeros, a.narrow(ax, 0, n + off)], ax)


def _where(c, a, b):
    """jnp.where with Python-scalar branches."""
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=b.dtype, device=b.device)
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return torch.where(c, a, b)


def _minmod3(sl, sr, sc):
    return torch.sign(sc) * torch.minimum(
        torch.minimum(torch.abs(sl), torch.abs(sr)), torch.abs(sc))


def _edge_clamp(co: CppmCoeffs, m, el, er, sh):
    """Minmod-clamped edge values of the cell means m (the slope clamp
    that every limiter of mod_cppm.F90 starts from, e.g. :381-400).
    Returns (el2, er2, has_slope)."""
    m_m = sh(m, -1)
    m_p = sh(m, 1)
    sl = co.ssc * (m - m_m)
    sr = co.ssc * (m_p - m)
    has_slope = sl * sr > 0.
    sc = _minmod3(sl, sr, co.scc * (m_p - m_m))
    el2 = torch.where((m_m - el) * (m - el) > 0.,
                      m - torch.sign(sc) * torch.minimum(
                          .5 * torch.abs(sc), torch.abs(el - m)),
                      el)
    er2 = torch.where((m_p - er) * (m - er) > 0.,
                      m + torch.sign(sc) * torch.minimum(
                          .5 * torch.abs(sc), torch.abs(er - m)),
                      er)
    return el2, er2, has_slope


def _extremum_limit(m, el2, er2):
    """Overshoot limit of a parabola's interior extremum (PPM form,
    mod_cppm.F90:401-410)."""
    d = er2 - el2
    q = d * (2. * m - el2 - er2)
    r = d * d / 3.
    return (torch.where(q > r, 3. * m - 2. * er2, el2),
            torch.where(-r > q, 3. * m - 2. * el2, er2))


def _need(co: CppmCoeffs, d2, sh):
    """Cells whose curvature changes sign against a neighbour: where the
    non-oscillatory limiters act."""
    d2 = co.d2m * d2
    return (sh(d2, -1) * d2 <= 0.) | (d2 * sh(d2, 1) <= 0.)


def _h_edges(co: CppmCoeffs, hm, periodic, ax, mono: bool):
    """Thickness edges with non-oscillatory limiting (h_edges_nosc,
    mod_cppm.F90:361-434) or, with `mono`, unconditional monotonic
    limiting and no positivity fix (h_edges_mono, :436-488)."""
    def sh(a, off):
        return _sh(a, off, periodic, ax)

    he = (co.hevc[0] * sh(hm, -2) + co.hevc[1] * sh(hm, -1)
          + co.hevc[2] * hm + co.hevc[3] * sh(hm, 1))
    hel = he
    her = sh(he, 1)

    hel2, her2, has_slope = _edge_clamp(co, hm, hel, her, sh)
    hel3, her3 = _extremum_limit(hm, hel2, her2)
    hel_l = torch.where(has_slope, hel3, hm)
    her_l = torch.where(has_slope, her3, hm)
    if mono:
        return hel_l, her_l
    need = _need(co, hel - 2. * hm + her, sh)
    hel = torch.where(need, hel_l, hel)
    her = torch.where(need, her_l, her)

    # positivity of the parabola (mod_cppm.F90:418-430)
    hel = torch.clamp(hel, min=dpeps)
    her = torch.clamp(her, min=dpeps)
    sl = 2. * (3. * hm - 2. * hel - her)
    a2 = 3. * (hel - 2. * hm + her)
    sr = sl + 2. * a2
    cond = (sl < 0.) & (sr > 0.) & (a2 * hel - .25 * sl * sl < a2 * dpeps)
    qq = 3. * hm / (3. * sl * sr + 4. * a2 * a2)
    hel = torch.where(cond, sl * sl * qq, hel)
    her = torch.where(cond, sr * sr * qq, her)
    return hel, her


def _tracer_edge_coeffs(co: CppmCoeffs, hm, hel, her, periodic, ax):
    """Per-cell compatible tracer edge-value coefficients tevc1..4
    (parabola_coeffs_fc_nosc, mod_cppm.F90:505-729): the class-dependent
    LU solves, all classes evaluated and selected by stencil tag."""
    def row(cell_off, j0):
        h = _sh(hm, cell_off, periodic, ax)
        hl = _sh(hel, cell_off, periodic, ax)
        hr = _sh(her, cell_off, periodic, ax)
        hi = 1.0 / h
        a2 = co.tmc0[j0] + (co.tmcl[j0] * hl + co.tmcr[j0] * hr) * hi
        a3 = co.tmc0[j0 + 1] + (co.tmcl[j0 + 1] * hl
                                + co.tmcr[j0 + 1] * hr) * hi
        a4 = co.tmc0[j0 + 2] + (co.tmcl[j0 + 2] * hl
                                + co.tmcr[j0 + 2] * hr) * hi
        return a2, a3, a4

    a12, a13, a14 = row(-2, 0)
    b22, b23, b24 = row(-1, 3)
    b32, b33, b34 = row(0, 6)
    b42, b43, b44 = row(1, 9)

    def safe(x):
        return _where(x == 0., 1., x)

    # ---- 1111 (full 4x4)
    a22 = b22 - a12
    a23 = b23 - a13
    a24 = b24 - a14
    a32 = b32 - a12
    a33 = b33 - a13
    a34 = b34 - a14
    a42 = b42 - a12
    a43 = b43 - a13
    a44 = b44 - a14
    q = 1.0 / safe(a22)
    a23q = a23 * q
    c33 = a33 - a23q * a32
    c43 = a43 - a23q * a42
    a24q = a24 * q
    c34 = a34 - a24q * a32
    c44 = a44 - a24q * a42
    c34 = c34 / safe(c33)
    c44 = c44 - c34 * c43
    t2 = -a12
    t3 = -a13 - a23q * t2
    t4 = -a14 - a24q * t2 - c34 * t3
    t4 = t4 / safe(c44)
    t3 = (t3 - c43 * t4) / safe(c33)
    t2 = (t2 - a32 * t3 - a42 * t4) / safe(a22)
    z = torch.zeros_like(t2)
    one = torch.ones_like(t2)
    tev_1111 = (1. - t2 - t3 - t4, t2, t3, t4)

    # ---- 1110
    d23 = (b23 - a13) / safe(b22 - a12)
    d33 = (b33 - a13) - d23 * (b32 - a12)
    t2 = -a12
    t3 = (-a13 - d23 * t2) / safe(d33)
    t2 = (t2 - (b32 - a12) * t3) / safe(b22 - a12)
    tev_1110 = (1. - t2 - t3, t2, t3, z)

    # ---- 0111
    e32 = b32 - b22
    e42 = b42 - b22
    e33 = (b33 - b23) / safe(e32)
    e43 = (b43 - b23) - e33 * e42
    t3 = -b22
    t4 = (-b23 - e33 * t3) / safe(e43)
    t3 = (t3 - e42 * t4) / safe(e32)
    tev_0111 = (z, 1. - t3 - t4, t3, t4)

    # ---- 1100
    t2 = -a12 / safe(b22 - a12)
    tev_1100 = (1. - t2, t2, z, z)

    # ---- 0110
    t3 = -b22 / safe(b32 - b22)
    tev_0110 = (z, 1. - t3, t3, z)

    # ---- 0011
    t4 = -b32 / safe(b42 - b32)
    tev_0011 = (z, z, 1. - t4, t4)

    tev_0100 = (z, one, z, z)
    tev_0010 = (z, z, one, z)
    tev_0000 = (z, z, z, z)

    tabs = [tev_0000, tev_1111, tev_1110, tev_0111, tev_1100,
            tev_0110, tev_0011, tev_0100, tev_0010]
    st = co.stencil
    tevc = []
    for c in range(4):
        out = tabs[0][c]
        for tag in range(1, 9):
            out = torch.where(st == tag, tabs[tag][c], out)
        tevc.append(out)
    return tevc


def _positivity(tm, tel, ter, slope_curv):
    """Non-negative parabolas for salinity and the passive tracers, the
    stacked tracers of index >= 1 (mod_cppm.F90:791-805, :1239-1252).
    slope_curv(tel, ter) gives the parabola's slope at its left edge and
    its curvature term."""
    nt = tm.shape[0]
    pos = (torch.arange(nt, device=tm.device) >= 1).reshape(
        (nt,) + (1,) * (tm.ndim - 1))
    tel_p = torch.clamp(tel, min=0.)
    ter_p = torch.clamp(ter, min=0.)
    sl3, a23 = slope_curv(tel_p, ter_p)
    sr3 = sl3 + 2. * a23
    condp = (sl3 < 0.) & (sr3 > 0.) & (a23 * tel_p - .25 * sl3 * sl3 < 0.)
    qq = 3. * tm / (3. * sl3 * sr3 + 4. * a23 * a23)
    tel_p2 = torch.where(condp, sl3 * sl3 * qq, tel_p)
    ter_p2 = torch.where(condp, sr3 * sr3 * qq, ter_p)
    return torch.where(pos, tel_p2, tel), torch.where(pos, ter_p2, ter)


def _thickness_parabola(hm, hel, her):
    return hel, 6. * hm - 4. * hel - 2. * her, 3. * (hel - 2. * hm + her)


def _parabola_coeffs_fc(co: CppmCoeffs, hm, tm, hel, her, periodic, ax,
                        mono: bool):
    """Compatible tracer edges from the per-cell LU solves, then
    non-oscillatory limiting with the positivity fix
    (parabola_coeffs_fc_nosc, mod_cppm.F90:490-818) or, with `mono`,
    unconditional monotonic limiting (parabola_coeffs_fc_mono,
    :820-1116).  tm: (nt, ...) stacked tracers."""
    def sh(a, off):
        return _sh(a, off, periodic, ax)

    tevc = _tracer_edge_coeffs(co, hm, hel, her, periodic, ax)

    te = (tevc[0] * sh(tm, -2) + tevc[1] * sh(tm, -1)
          + tevc[2] * tm + tevc[3] * sh(tm, 1))
    tel = te
    ter = sh(te, 1)

    # thickness-dependent parabola factors (mod_cppm.F90:731-747)
    qh = 1.0 / (12. * hm - hel - her)
    hf1m = 60. * hm * qh
    hf1l = -(42. * hm + 4. * hel - 6. * her) * qh
    hf1r = -(18. * hm - 4. * hel + 6. * her) * qh
    hf2m = -hf1m
    hf2l = 5. * (6. * hm + hel - her) * qh
    hf2r = 5. * (6. * hm - hel + her) * qh

    tel2, ter2, has_slope = _edge_clamp(co, tm, tel, ter, sh)
    # derivative-sign fix of the compatible parabola (mod_cppm.F90:766-782)
    sl2 = hf1m * tm + hf1l * tel2 + hf1r * ter2
    a2 = hf2m * tm + hf2l * tel2 + hf2r * ter2
    sr2 = sl2 + 2. * a2
    fix = sl2 * sr2 < 0.
    left_fix = (ter2 - tel2) * a2 < 0.
    tel3 = torch.where(
        fix & left_fix,
        -((hf1m + 2. * hf2m) * tm + (hf1r + 2. * hf2r) * ter2)
        / (hf1l + 2. * hf2l),
        tel2)
    ter3 = torch.where(
        fix & ~left_fix,
        -(hf1m * tm + hf1l * tel3) / hf1r,
        ter2)

    tel_l = torch.where(has_slope, tel3, tm)
    ter_l = torch.where(has_slope, ter3, tm)
    if mono:
        tel, ter = tel_l, ter_l
    else:
        need = _need(co, hf2m * tm + hf2l * tel + hf2r * ter, sh)
        tel = torch.where(need, tel_l, tel)
        ter = torch.where(need, ter_l, ter)
        tel, ter = _positivity(
            tm, tel, ter, lambda l, r: (hf1m * tm + hf1l * l + hf1r * r,
                                        hf2m * tm + hf2l * l + hf2r * r))

    tpc0 = tel
    tpc1 = hf1m * tm + hf1l * tel + hf1r * ter
    tpc2 = hf2m * tm + hf2l * tel + hf2r * ter
    return _thickness_parabola(hm, hel, her), (tpc0, tpc1, tpc2)


def _parabola_coeffs_pc(co: CppmCoeffs, hm, tm, hel, her, periodic, ax,
                        mono: bool):
    """Tracer edges from the thickness edge coefficients, not compatible
    with the thickness parabola (mod_cppm.F90:1143-1155), limited as
    plain PPM: non-oscillatory with the positivity fix
    (parabola_coeffs_pc_nosc, :1118-1264) or, with `mono`, unconditional
    monotonic limiting (parabola_coeffs_pc_mono, :1266-1371)."""
    def sh(a, off):
        return _sh(a, off, periodic, ax)

    te = (co.hevc[0] * sh(tm, -2) + co.hevc[1] * sh(tm, -1)
          + co.hevc[2] * tm + co.hevc[3] * sh(tm, 1))
    tel = te
    ter = sh(te, 1)

    tel2, ter2, has_slope = _edge_clamp(co, tm, tel, ter, sh)
    tel3, ter3 = _extremum_limit(tm, tel2, ter2)
    tel_l = torch.where(has_slope, tel3, tm)
    ter_l = torch.where(has_slope, ter3, tm)
    if mono:
        tel, ter = tel_l, ter_l
    else:
        need = _need(co, tel - 2. * tm + ter, sh)
        tel = torch.where(need, tel_l, tel)
        ter = torch.where(need, ter_l, ter)
        tel, ter = _positivity(
            tm, tel, ter, lambda l, r: (2. * (3. * tm - 2. * l - r),
                                        3. * (l - 2. * tm + r)))

    tpc0 = tel
    tpc1 = 6. * tm - 4. * tel - 2. * ter
    tpc2 = 3. * (tel - 2. * tm + ter)
    return _thickness_parabola(hm, hel, her), (tpc0, tpc1, tpc2)


def _flux_integration(ca, ai, db, du, dl, hpc, tpc, periodic, ax):
    """Integrate upstream parabolas over the flux area (flux_integration,
    mod_cppm.F90:1373-1468).  Edge i lies between cells i-1 and i; ca > 0
    is transport from cell i-1 into cell i."""
    hpc0, hpc1, hpc2 = hpc
    tpc0, tpc1, tpc2 = tpc
    c1_2, c1_3, c1_4, c1_5 = .5, 1 / 3., .25, 1 / 5.

    def sh(a):
        return _sh(a, -1, periodic, ax)

    # ---- negative ca: upstream is cell i
    c = ca * ai
    hb_n = torch.clamp(db - du, min=0.)
    deep_n = dl > db
    hf_par_n = hpc0 - (c1_2 * hpc1 - c1_3 * hpc2 * c) * c
    p0_n = torch.where(deep_n, hb_n, hf_par_n)
    hf_n = p0_n * ca
    p1_n = torch.where(deep_n, -c1_2 * hb_n * c,
                       -(c1_2 * hpc0 - (c1_3 * hpc1 - c1_4 * hpc2 * c) * c)
                       * c)
    p2_n = torch.where(deep_n, c1_3 * hb_n * c * c,
                       (c1_3 * hpc0 - (c1_4 * hpc1 - c1_5 * hpc2 * c) * c)
                       * c * c)
    htf_n = (p0_n * tpc0 + p1_n * tpc1 + p2_n * tpc2) * ca

    # ---- positive ca: upstream is cell i-1
    aiw, duw, dlw = sh(ai), sh(du), sh(dl)
    h0w, h1w, h2w = sh(hpc0), sh(hpc1), sh(hpc2)
    t0w, t1w, t2w = sh(tpc0), sh(tpc1), sh(tpc2)

    cw = ca * aiw
    q1 = 1. - c1_2 * cw
    q2 = 1. - (1. - c1_3 * cw) * cw
    hb_p = torch.clamp(db - duw, min=0.)
    deep_p = dlw > db
    hf_par_p = h0w + q1 * h1w + q2 * h2w
    q3 = c1_4 * (1. + 3. * (1. - cw) * q2)
    q4 = c1_5 * (1. + 4. * (1. - cw) * q3)
    p0_p = torch.where(deep_p, hb_p, hf_par_p)
    hf_p = p0_p * ca
    p1_p = torch.where(deep_p, q1 * hb_p, q1 * h0w + q2 * h1w + q3 * h2w)
    p2_p = torch.where(deep_p, q2 * hb_p, q2 * h0w + q3 * h1w + q4 * h2w)
    htf_p = (p0_p * t0w + p1_p * t1w + p2_p * t2w) * ca

    neg = ca < 0.
    return torch.where(neg, hf_n, hf_p), torch.where(neg, htf_n, htf_p)


COMPATIBILITIES = ('full', 'partial')
LIMITINGS = ('non_oscillatory', 'monotonic')


def check_variant(compatibility: str, limiting: str):
    """Raise ValueError unless (compatibility, limiting) is one of the
    four sweep variants (the cppm namelist options,
    mod_cppm.F90:2748-2834)."""
    if compatibility not in COMPATIBILITIES or limiting not in LIMITINGS:
        raise ValueError(f'cppm compatibility={compatibility!r} '
                         f'limiting={limiting!r}: expected one of '
                         f'{COMPATIBILITIES} and one of {LIMITINGS}')


def _cppm_sweep_body(hm_in, tm, ca, db, du, dl, ai, co: CppmCoeffs,
                     periodic: bool, div_corr=None, ax: int = -1,
                     compatibility: str = 'full',
                     limiting: str = 'non_oscillatory'):
    """Plain PyTorch version of the sweep, for every (compatibility,
    limiting) variant.  Returns (hn, tm_new, hf, htf)."""
    check_variant(compatibility, limiting)
    ho = torch.clamp(hm_in, min=0.) + dpeps
    hm = ho
    if div_corr is not None:
        hm = hm / (1. - div_corr * ai)

    mono = limiting == 'monotonic'
    hel, her = _h_edges(co, hm, periodic, ax, mono)
    coeffs = (_parabola_coeffs_fc if compatibility == 'full'
              else _parabola_coeffs_pc)
    hpc, tpc = coeffs(co, hm, tm, hel, her, periodic, ax, mono)
    hf, htf = _flux_integration(ca, ai, db, du, dl, hpc, tpc, periodic, ax)

    hf_e = _sh(hf, 1, periodic, ax)
    htf_e = _sh(htf, 1, periodic, ax)
    hn = ho - (hf_e - hf) * ai
    hni = 1.0 / hn
    tm_new = (ho * tm - (htf_e - htf) * ai) * hni
    return hn, tm_new, hf, htf


def cppm_sweep(hm_in, tm, ca, db, du, dl, ai, co: CppmCoeffs,
               periodic: bool, div_corr=None,
               compatibility: str = 'full',
               limiting: str = 'non_oscillatory', ax: int = -1):
    """One 1-D CPPM transport sweep along axis `ax`
    (cppm_{fc,pc}_{nosc,mono}_{i,j}, mod_cppm.F90:1470-2498).

    hm_in: (k, J, I) thickness; tm: (nt, k, J, I) tracers; ca: (k, J, I)
    flux area at the left edge of each cell; db: bottom pressure at
    edges, (J, I) or (k, J, I); du/dl: cell top/bottom interface
    pressure; ai: inverse cell area, (J, I) or (k, J, I); div_corr:
    transverse flux-area divergence for the second Strang pass;
    compatibility 'full' or 'partial', limiting 'non_oscillatory' or
    'monotonic'.

    Returns (h_new_raw, tm_new, hf, htf): h_new_raw = ho - div(hf)*ai
    (before the dp clamp), updated tracers and the edge fluxes.  CUDA
    tensors go through the hand-written kernel, CPU tensors through
    `_cppm_sweep_body`."""
    check_variant(compatibility, limiting)
    if ax not in (-1, -2):
        raise ValueError(f'sweep axis {ax}')
    if hm_in.is_cuda:
        from .cppm_cuda import cppm_sweep_cuda
        return cppm_sweep_cuda(hm_in, tm, ca, db, du, dl, ai, co, periodic,
                               div_corr=div_corr, ax=ax,
                               compatibility=compatibility,
                               limiting=limiting)
    return _cppm_sweep_body(hm_in, tm, ca, db, du, dl, ai, co, periodic,
                            div_corr, ax, compatibility, limiting)
