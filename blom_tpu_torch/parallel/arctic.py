"""Tripolar (Arctic bipolar) fold topology.

Counterpart of `blom_tpu/parallel/arctic.py` (BLOM's single-tile fold,
mod_xc.F90:2405-2495).  The top model row is the bipolar fold line:
values beyond it are the i-mirrored (and, for vectors, sign-flipped)
values from below the fold, with per-grid staggering offsets:

  p: ghost(j=jj+m, i) = s * a(jj-1-m, ii+1-i)
  u: ghost(j=jj+m, i) = s * a(jj-1-m, ii+2-i mod ii)
  q: row jj self-mirrors for i > ii/2 with ii+2-i; ghosts mirror jj-m
  v: row jj self-mirrors for i > ii/2 with ii+1-i; ghosts mirror jj-m

with s = -1 for vector components, +1 for scalars (halo_ps..halo_vv,
mod_xc.F90:107-110,2420-2423).  Every function returns new tensors; no
input is written."""

from __future__ import annotations

import dataclasses

import torch


def _mirror_p(row):
    """i -> ii+1-i (1-based) == reverse (0-based)."""
    return torch.flip(row, dims=(-1,))


def _mirror_u(row):
    """i -> mod(ii+1-i, ii)+1 (1-based) == roll(reverse, 1)."""
    return torch.roll(torch.flip(row, dims=(-1,)), 1, dims=-1)


def fold_row(a, kind: str = 'p', vector: bool = False, m: int = 0):
    """The ghost row m rows above the stored top row.  a: (..., J, I);
    kind in {'p','u','q','v'}.  Sources: p/u ghost jj+1+m mirrors row
    jj-2-m, q/v ghost jj+1+m mirrors row jj-1-m."""
    s = -1. if vector else 1.
    if kind == 'p':
        mir = _mirror_p(a[..., -3 - m, :])
    elif kind == 'u':
        mir = _mirror_u(a[..., -3 - m, :])
    elif kind == 'q':
        mir = _mirror_u(a[..., -2 - m, :])
    elif kind == 'v':
        mir = _mirror_p(a[..., -2 - m, :])
    else:
        raise ValueError(kind)
    return s * mir


def fold_extend(a, kind: str = 'p', vector: bool = False, m: int = 1):
    """a with the fold's first m ghost rows appended above its top row
    (fold_row for 0..m-1): (..., J + m, I)."""
    return torch.cat([a] + [fold_row(a, kind, vector, mm)[..., None, :]
                            for mm in range(m)], dim=-2)


def _with_top(a, top):
    """a with its top row replaced by `top`, as a new tensor (a clone
    whose top row is written)."""
    out = a.clone()
    out[..., -1, :] = top
    return out


def _east(a):
    """True on the eastern half of the top row (idx >= ii // 2)."""
    ii = a.shape[-1]
    return torch.arange(ii, device=a.device) >= ii // 2


def arctic_sync(a, kind: str = 'p', vector: bool = False):
    """Enforce the fold-duplicated degrees of freedom on the top row (the
    reference's j=0 p/u ghost write and the q/v half-row self-mirror,
    mod_xc.F90:2432-2492)."""
    s = -1. if vector else 1.
    if kind == 'p':
        return _with_top(a, s * _mirror_p(a[..., -2, :]))
    if kind == 'u':
        return _with_top(a, s * _mirror_u(a[..., -2, :]))
    # q/v: the top row's eastern half is the mirror of its western half
    mir = _mirror_u(a[..., -1, :]) if kind == 'q' else \
        _mirror_p(a[..., -1, :])
    return _with_top(a, torch.where(_east(a), s * mir, a[..., -1, :]))


def jp1_arctic(a, kind: str = 'p', vector: bool = False):
    """Neighbour at j+1 on a tripolar grid: interior rows shift; the top
    row reads the fold ghost."""
    return torch.cat([a[..., 1:, :], fold_row(a, kind, vector)[..., None, :]],
                     dim=-2)


# field -> (grid kind, vector?) for the prognostic state (the itype tags
# each field gets in the reference's xctilr calls, halo_ps..halo_vv,
# mod_xc.F90:107-110)
STATE_KINDS = {
    'dp': ('p', False), 'temp': ('p', False), 'saln': ('p', False),
    'sigma': ('p', False), 'sealv': ('p', False), 'pb': ('p', False),
    'pb_p': ('p', False), 'pb_mn': ('p', False), 'trc': ('p', False),
    'dpold': ('p', False), 'told': ('p', False), 'sold': ('p', False),
    'trcold': ('p', False), 'sigmar': ('p', False),
    'ustarb': ('p', False), 'phi': ('p', False), 'p': ('p', False),
    'u': ('u', True), 'dpu': ('u', False), 'dpuold': ('u', False),
    'pbu': ('u', False), 'pbu_p': ('u', False), 'pu': ('u', False),
    'ub': ('u', True), 'ubflx': ('u', True), 'ubflx_mn': ('u', True),
    'ubflxs': ('u', True), 'ubflxs_p': ('u', True),
    'ubcors_p': ('u', True), 'uflx': ('u', True), 'utflx': ('u', True),
    'usflx': ('u', True), 'cau': ('u', True), 'pgfx': ('u', True),
    'pgfx_o': ('u', True), 'pgfxm': ('u', True),
    'pgfxm_o': ('u', True),
    'v': ('v', True), 'dpv': ('v', False), 'dpvold': ('v', False),
    'pbv': ('v', False), 'pbv_p': ('v', False), 'pv': ('v', False),
    'vb': ('v', True), 'vbflx': ('v', True), 'vbflx_mn': ('v', True),
    'vbflxs': ('v', True), 'vbflxs_p': ('v', True),
    'vbcors_p': ('v', True), 'vflx': ('v', True), 'vtflx': ('v', True),
    'vsflx': ('v', True), 'cav': ('v', True), 'pgfy': ('v', True),
    'pgfy_o': ('v', True), 'pgfym': ('v', True),
    'pgfym_o': ('v', True),
    'pvtrop': ('q', False),
}


# bottom-pressure-sensitivity pairs: the mirror SWAPS the +/- roles with
# NO sign flip (the mirrored u/v-point's east/north cell is the
# original's west/south cell): xixp(jj,i) = xixm(jj-1, Mu(i)), etc.
XI_PAIRS_U = (('xixp', 'xixm'), ('xixp_o', 'xixm_o'))
XI_PAIRS_V = (('xiyp', 'xiym'), ('xiyp_o', 'xiym_o'))


def sync_xi_pair_u(a, b):
    """Top-row sync of a (xixp-like, xixm-like) pair at u-points: a's
    duplicated top row is the u-mirror of b's row below, and vice versa
    (positive swap)."""
    return (_with_top(a, _mirror_u(b[..., -2, :])),
            _with_top(b, _mirror_u(a[..., -2, :])))


def sync_xi_pair_v(a, b):
    """Seam-row sync of a (xiyp-like, xiym-like) pair at v-points: the
    eastern half of the top row is the p-mirror of the partner's western
    half (positive swap)."""
    east = _east(a)
    return (_with_top(a, torch.where(east, _mirror_p(b[..., -1, :]),
                                     a[..., -1, :])),
            _with_top(b, torch.where(east, _mirror_p(a[..., -1, :]),
                                     b[..., -1, :])))


def sync_state(s):
    """A State whose fold-duplicated degrees of freedom are enforced on
    every field of STATE_KINDS and of the xi pairs (the role of the reference's per-phase
    xctilr calls on a tripolar grid: the top row of p/u fields and the
    eastern half of the top row of q/v fields are mirror copies,
    mod_xc.F90:2405-2700).  Called once per step.  Unlike blom_tpu's,
    which skips a field its State lacks, a missing field is an error;
    the fields of `s` are not written, the result holds new tensors for
    the synced ones."""
    updates = {name: arctic_sync(getattr(s, name), kind, vector)
               for name, (kind, vector) in STATE_KINDS.items()}
    for pairs, syncer in ((XI_PAIRS_U, sync_xi_pair_u),
                          (XI_PAIRS_V, sync_xi_pair_v)):
        for pa, pb in pairs:
            updates[pa], updates[pb] = syncer(getattr(s, pa),
                                              getattr(s, pb))
    return dataclasses.replace(s, **updates)
