"""Halo exchange between mesh blocks, margin-k batching and fold halos.

Counterpart of `blom_tpu/parallel/halo.py` (BLOM's xctilr,
mod_xc.F90:2342-3188: nbdy-wide ghost zones filled from the four tile
neighbours, with the distributed tripolar fold of :2518-2700; and the
barotropic solver's margin-2 exchange every second substep,
mod_barotp.F90:387-397).

Arrays are blocks (..., B, jloc, iloc) of a communicator of
parallel/mesh.py.  `halo_exchange` widens each block by `margin` ghost
cells per side with four permutes; `halo_scan` buys m local stencil
applications with one margin-m exchange.  i is periodic; j is closed,
with zero ghosts (land rows)."""

from __future__ import annotations

import numpy as np
import torch

from .mesh import ring


def halo_exchange(a, margin: int, comm, periodic_i: bool = True,
                  periodic_j: bool = False):
    """Widen blocks (..., B, jloc, iloc) by `margin` ghost cells per
    side, filled from the mesh neighbours (xctilr, mod_xc.F90:2342-3188).
    A closed edge gets zero ghosts."""
    m = margin
    if a.shape[-1] < m or a.shape[-2] < m:
        raise ValueError(
            f'halo_exchange: local block {tuple(a.shape[-2:])} smaller '
            f'than margin {m} — use a coarser mesh or a larger grid '
            f'(ghosts would need next-nearest-neighbour data)')
    comm.exchanges += 1
    ny, nx = comm.ny, comm.nx

    # east-west over the 'x' ring; permuted even when nx == 1 (the
    # identity), so the 1x1 program is the sharded one
    from_west = comm.permute(a[..., -m:], 'x', ring(nx, True))
    from_east = comm.permute(a[..., :m], 'x', ring(nx, False))
    if not periodic_i:
        xi = comm.axis_index('x', a)
        from_west = torch.where(xi == 0, 0., from_west)
        from_east = torch.where(xi == nx - 1, 0., from_east)
    a = torch.cat([from_west, a, from_east], -1)

    # north-south over the 'y' ring
    from_south = comm.permute(a[..., -m:, :], 'y', ring(ny, True))
    from_north = comm.permute(a[..., :m, :], 'y', ring(ny, False))
    if not periodic_j:
        yi = comm.axis_index('y', a)
        from_south = torch.where(yi == 0, 0., from_south)
        from_north = torch.where(yi == ny - 1, 0., from_north)
    return torch.cat([from_south, a, from_north], -2)


def _fold_meta(comm, variant, sign, src_rows, like):
    """(source-row index (N,), per-row masks of variants 0, 1, 2, 3 and
    -1 (5, N), sign (N,)) of a stack's fold metadata on `like`'s device
    and dtype, made once per comm (its `const`)."""
    variant = np.asarray(variant)
    sign = np.asarray(sign, np.float64)
    src_rows = np.asarray(src_rows, np.int64)
    key = ('fold', variant.tobytes(), sign.tobytes(), src_rows.tobytes(),
           like.dtype)

    def make(dev):
        masks = np.stack([variant == v for v in (0, 1, 2, 3)]
                         + [variant < 0])
        return (torch.as_tensor(src_rows, device=dev),
                torch.as_tensor(masks, device=dev),
                torch.as_tensor(sign, dtype=like.dtype, device=dev))
    return comm.const(key, like.device, make)


def _mirror_segments(seg, w: int, comm):
    """The mirror block's rows i-reversed (p/v alignment) and the same
    rolled one column east (u/q), whose vacated west column is the
    mirror-west neighbour's column w-1."""
    nx = comm.nx
    seg = comm.permute(seg, 'x', [(i, nx - 1 - i) for i in range(nx)])
    seg = torch.flip(seg, (-1,))
    col = comm.permute(seg[..., w - 1:w], 'x', ring(nx, True))
    return seg, torch.cat([col, seg[..., :-1]], -1)


def fold_fixup_stack(wide, margin: int, comm, variant, sign, src_rows):
    """Replace the top `margin` ghost rows of halo-widened stacked blocks
    (N, B, jw, iw) with tripolar fold ghosts on the top mesh row (the
    distributed fold of xctilr, mod_xc.F90:2518-2700).

    Per stacked row r (numpy):
      variant[r]: 0 p-kind, 1 u, 2 v, 3 q, -1 keep the zero ghosts;
      sign[r]:    +1 scalar, -1 vector component (halo_uv/halo_vv);
      src_rows[r]: the row the mirror data comes from (r itself except
        for the xixp/xixm-like swap pairs).

    Ghost row g (0 just above the stored top row) mirrors stored row
    -3-g (p/u kinds) or -2-g (q/v kinds) of the x-mirror block, i
    reversed; u and q kinds also roll one column east (the ii+2-i
    stagger, mod_xc.F90:2542-2620); vectors flip sign.  Needs a periodic
    i axis and local blocks at least margin+2 rows high."""
    M = margin
    jw = wide.shape[-2]
    w = wide.shape[-1] - 2 * M
    if jw - 2 * M - 2 < 0:
        raise ValueError(
            f'tripolar fold needs local block height >= margin+2 '
            f'(got {jw - 2 * M} rows, margin {M})')
    src_idx, masks, sgn = _fold_meta(comm, variant, sign, src_rows, wide)
    src = wide[src_idx]
    # j-flipped source rows: ghost g <- stored top row minus (2+g) for
    # p/u, minus (1+g) for q/v
    pu_rows = torch.flip(src[..., jw - 2 * M - 2:jw - M - 2, :], (-2,))
    qv_rows = torch.flip(src[..., jw - 2 * M - 1:jw - M - 1, :], (-2,))
    seg, seg_r = _mirror_segments(torch.cat([pu_rows, qv_rows], -2), w,
                                  comm)

    sel = masks.reshape(5, -1, 1, 1, 1)
    cur_top = wide[..., jw - M:, :]
    ghost = torch.where(sel[0], seg[..., :M, :], torch.zeros_like(cur_top))
    ghost = torch.where(sel[1], seg_r[..., :M, :], ghost)
    ghost = torch.where(sel[2], seg[..., M:, :], ghost)
    ghost = torch.where(sel[3], seg_r[..., M:, :], ghost)
    ghost = ghost * sgn.reshape(-1, 1, 1, 1)
    ghost = torch.where(sel[4], cur_top, ghost)
    top = torch.where(comm.axis_index('y', wide) == comm.ny - 1, ghost,
                      cur_top)
    return torch.cat([wide[..., :jw - M, :], top], -2)


def fold_sync_stack(st, comm, variant, sign, src_rows):
    """Block-local arctic_sync: rewrite the stored top row's
    fold-duplicated degrees of freedom of stacked blocks (N, B, jloc,
    iloc) — p/u rows become the mirror of the row below on the mirror
    block, q/v rows self-mirror their eastern half (mod_xc.F90:2432-2492).
    Metadata as in fold_fixup_stack."""
    w = st.shape[-1]
    src_idx, masks, sgn = _fold_meta(comm, variant, sign, src_rows, st)
    src = st[src_idx]
    seg, seg_r = _mirror_segments(
        torch.cat([src[..., -2:-1, :], src[..., -1:, :]], -2), w, comm)

    sgn = sgn.reshape(-1, 1, 1)
    gcol = comm.axis_index('x', st).reshape(-1, 1) * w \
        + torch.arange(w, device=st.device)
    east = gcol >= (w * comm.nx) // 2                   # (B, w)
    sel = masks.reshape(5, -1, 1, 1)

    cur = st[..., -1, :]
    top = torch.where(sel[0], sgn * seg[..., 0, :], cur)
    top = torch.where(sel[1], sgn * seg_r[..., 0, :], top)
    top = torch.where(sel[2] & east, sgn * seg[..., 1, :], top)
    top = torch.where(sel[3] & east, sgn * seg_r[..., 1, :], top)
    top = torch.where(comm.axis_index('y', st).reshape(-1, 1)
                      == comm.ny - 1, top, cur)
    return torch.cat([st[..., :-1, :], top[..., None, :]], -2)


def halo_scan(stencil_fn, a, nsub: int, margin: int, comm,
              periodic_i: bool = True, periodic_j: bool = False):
    """`nsub` applications of a one-cell-radius stencil update, with a
    halo exchange only every `margin` applications (the generalized
    margin-2 subcycling of mod_barotp.F90:387-397).  `stencil_fn` is
    applied to the widened blocks, whose valid interior shrinks one ring
    per application; out-of-domain ghosts on closed edges are zeroed
    after each (the reference's land-mask exterior)."""

    def exterior_mask(m):
        jj, ii = a.shape[-2] + 2 * m, a.shape[-1] + 2 * m
        msk = torch.ones((comm.nblocks, jj, ii), dtype=a.dtype,
                         device=a.device)
        if not periodic_i:
            xi = comm.axis_index('x', a)
            col = torch.arange(ii, device=a.device)[None, None, :]
            msk = torch.where((xi == 0) & (col < m), 0., msk)
            msk = torch.where((xi == comm.nx - 1) & (col >= ii - m), 0.,
                              msk)
        if not periodic_j:
            yi = comm.axis_index('y', a)
            row = torch.arange(jj, device=a.device)[None, :, None]
            msk = torch.where((yi == 0) & (row < m), 0., msk)
            msk = torch.where((yi == comm.ny - 1) & (row >= jj - m), 0.,
                              msk)
        return msk

    def do_round(a, m):
        wide = halo_exchange(a, m, comm, periodic_i, periodic_j)
        msk = exterior_mask(m)
        for _ in range(m):
            wide = stencil_fn(wide) * msk
        return wide[..., m:-m, m:-m]

    for _ in range(nsub // margin):
        a = do_round(a, margin)
    if nsub % margin:
        a = do_round(a, nsub % margin)
    return a


def sharded_stencil(comm, stencil_fn, nsub: int, margin: int,
                    periodic_i: bool = True, periodic_j: bool = False):
    """A function of a global (..., J, I) field that applies `nsub`
    stencil sweeps blockwise over `comm`'s mesh with margin-k halo
    batching, and returns the global result."""
    def fn(a):
        blocks = halo_scan(stencil_fn, comm.scatter(a), nsub, margin, comm,
                           periodic_i, periodic_j)
        return comm.gather(blocks)
    return fn
