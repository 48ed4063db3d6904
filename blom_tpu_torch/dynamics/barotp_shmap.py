"""Margin-k barotropic solver on mesh blocks.

Counterpart of `blom_tpu/dynamics/barotp_shmap.py`, the multi-block path
of the barotropic subcycling (BLOM's mod_barotp.F90:387-397: the halos
of pb_t, ubflx_t and vbflx_t exchanged with margin 2 every second
substep).  The per-step constant fields are widened once by `margin`
ghost rings, and the working time levels are exchanged every
`subs_per_exch` substeps.  One substep's chained pb -> u -> v updates use
up to 3 ghost rings, so margin 6 buys 2 substeps per exchange: one
widening exchange per dtype group, then 5 * ceil(half / 2) exchanges a
barotp instead of one per stencil read.

The blocks live on a communicator of parallel/mesh.py; on a tripolar
grid every exchange fills the top mesh row's north ghosts with fold rows
(halo.fold_fixup_stack, the distributed fold of mod_xc.F90:2518-2700).
Every update is an elementwise stencil and every sum a time sum per
cell, so on a grid without the fold the blocks give the unsharded
barotp's bits."""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import State
from ..parallel.fold_specs import leaf_specs, tree_flatten, tree_unflatten
from ..parallel.halo import fold_fixup_stack, fold_sync_stack, halo_exchange
from ..parallel.mesh import StackedComm
from . import barotp as bt

#: ghost rings consumed by one substep's chained pb->u->v updates
RINGS_PER_SUBSTEP = 3
#: substeps between exchanges; margin = RINGS_PER_SUBSTEP * SUBS_PER_EXCH
SUBS_PER_EXCH = 2

_VARIANT = {'p': 0, 'u': 1, 'v': 2, 'q': 3}


def _groups(leaves):
    """Indices of the (…, B, j, i) leaves, one list per dtype."""
    out = {}
    for i, leaf in enumerate(leaves):
        if torch.is_tensor(leaf) and leaf.ndim >= 3:
            out.setdefault(str(leaf.dtype), []).append(i)
    return [out[k] for k in sorted(out)]


def _stack(leaves, idxs):
    """Stack leaves (…, B, j, i) into rows (N, B, j, i); with their
    offsets in the stack and row counts."""
    rows = [leaves[i].reshape((-1,) + leaves[i].shape[-3:]) for i in idxs]
    offs, pos = {}, 0
    for i, r in zip(idxs, rows):
        offs[i] = pos
        pos += r.shape[0]
    return torch.cat(rows, 0), offs, pos


def _nrows(leaf):
    """Rows of a (…, B, j, i) leaf in a stack."""
    return int(np.prod(leaf.shape[:-3]))


def _unstack(st, leaves, idxs, offs, out):
    for i in idxs:
        leaf = leaves[i]
        blk = st[offs[i]:offs[i] + _nrows(leaf)]
        out[i] = blk.reshape(leaf.shape[:-2] + blk.shape[-2:])


def _fold_rows(fold_specs, leaves, idxs, offs, nrows):
    """Per stacked row: variant, sign and source row of fold_specs."""
    variant = np.full(nrows, -1, np.int32)
    sign = np.ones(nrows)
    srcr = np.arange(nrows)
    for i in idxs:
        spec = fold_specs[i]
        if spec is None:
            continue
        k, sg, partner = spec
        r0, nr = offs[i], _nrows(leaves[i])
        variant[r0:r0 + nr] = _VARIANT[k]
        sign[r0:r0 + nr] = sg
        if partner is not None:
            if partner not in offs:
                raise ValueError('fold partner leaf in a different dtype '
                                 'group')
            srcr[r0:r0 + nr] = np.arange(offs[partner], offs[partner] + nr)
    return variant, sign, srcr


def wide_tree(tree, margin, comm, per_i, per_j, fold_specs=None):
    """Halo-widen a whole tree of blocks with one exchange per dtype
    group: the leaves are stacked into one (N, B, j, i) tensor,
    exchanged and unstacked.  With `fold_specs` (aligned with
    tree_flatten(tree): (kind, sign, partner leaf) or None per leaf) the
    top mesh row's north ghosts are tripolar fold rows instead of
    zeros."""
    leaves = [leaf for _, leaf in tree_flatten(tree)]
    out = list(leaves)
    for idxs in _groups(leaves):
        st, offs, nrows = _stack(leaves, idxs)
        st = halo_exchange(st, margin, comm, per_i, per_j)
        if fold_specs is not None:
            variant, sign, srcr = _fold_rows(fold_specs, leaves, idxs,
                                             offs, nrows)
            if (variant >= 0).any():
                st = fold_fixup_stack(st, margin, comm, variant, sign, srcr)
        _unstack(st, leaves, idxs, offs, out)
    return tree_unflatten(tree, out)


def sync_tree(tree, comm, fold_specs):
    """Block-local arctic_sync over a tree of unwidened blocks: one
    stacked fold_sync_stack per dtype group (the block counterpart of
    parallel.arctic.sync_state)."""
    leaves = [leaf for _, leaf in tree_flatten(tree)]
    out = list(leaves)
    for idxs in _groups(leaves):
        st, offs, nrows = _stack(leaves, idxs)
        variant, sign, srcr = _fold_rows(fold_specs, leaves, idxs, offs,
                                         nrows)
        # rows of variant -1 keep their top row
        st = fold_sync_stack(st, comm, variant, sign, srcr)
        _unstack(st, leaves, idxs, offs, out)
    return tree_unflatten(tree, out)


def crop_tree(tree, margin):
    """Drop `margin` ghost rings from the trailing (j, i) axes of every
    tensor leaf."""
    m = margin
    return tree_unflatten(tree, [
        leaf[..., m:-m, m:-m] if torch.is_tensor(leaf) and leaf.ndim >= 2
        else leaf for _, leaf in tree_flatten(tree)])


def barotp_block(comm, per_i: bool, per_j: bool, fld_l, ubflxs, vbflxs,
                 ubflxs_p, vbflxs_p, m: int, n: int, lstep: int, dlt,
                 par: bt.BarotpParams, subs_per_exch: int = SUBS_PER_EXCH,
                 arctic: bool = False):
    """The block-local margin-k barotropic core.  Inputs are unwidened
    blocks (…, B, jloc, iloc) of `comm`; returns unwidened (out, sums)
    for bt.finalize.  With `arctic` every exchange fills the top mesh
    row's north ghosts with tripolar fold rows (mod_barotp.F90:387-397
    with mod_xc.F90:2518-2700)."""
    margin = RINGS_PER_SUBSTEP * subs_per_exch

    def crop(a):
        return a[..., margin:-margin, margin:-margin]

    # every per-step constant field widened once (one exchange a dtype)
    tree = (fld_l, ubflxs, vbflxs, ubflxs_p, vbflxs_p)
    fold = None
    if arctic:
        fold = leaf_specs(tree, overrides={1: ('u', -1.), 2: ('v', -1.),
                                           3: ('u', -1.), 4: ('v', -1.)})
    fld_w, ubflxs, vbflxs, ubflxs_p, vbflxs_p = wide_tree(
        tree, margin, comm, per_i, per_j, fold_specs=fold)

    def exch_carries(pb_t, ubflx_t, vbflx_t):
        """One stacked margin-M exchange of the working time levels (the
        xctilr of mod_barotp.F90:387-397)."""
        st = torch.cat([crop(pb_t), crop(ubflx_t), crop(vbflx_t)], 0)
        st = halo_exchange(st, margin, comm, per_i, per_j)
        if arctic:
            st = fold_fixup_stack(
                st, margin, comm, variant=np.array([0, 0, 1, 1, 2, 2]),
                sign=np.array([1., 1., -1., -1., -1., -1.]),
                src_rows=np.arange(6))
        return st[:2], st[2:4], st[4:6]

    def runner(nb, substep, half, carry):
        # the carry lives at the widened shape; every subs_per_exch
        # substeps it is cropped and exchanged.  The substeps past the
        # end of a last, partial group change nothing (blom_tpu computes
        # and discards them) and are not run.
        for ex in range(-(-half // subs_per_exch)):
            carry = exch_carries(*carry[:3]) + tuple(carry[3:])
            lll0 = 1 + (nb - 1) * half + ex * subs_per_exch
            for lll in range(lll0, min(lll0 + subs_per_exch,
                                       nb * half + 1)):
                carry = substep(nb, carry, lll)
        return carry

    out, sums = bt.run_blocks(
        fld_w, bt.local_shifts(), ubflxs, vbflxs, ubflxs_p, vbflxs_p,
        m, n, lstep, dlt, par, block_runner=runner)
    return ({k: crop(v) for k, v in out.items()},
            {k: crop(v) for k, v in sums.items()})


def make_barotp_shmap(mesh, subs_per_exch: int = SUBS_PER_EXCH, comm=None):
    """A drop-in for dynamics.barotp.barotp that runs the subcycle on the
    blocks of `mesh` (by default all stacked in this process; `comm` a
    parallel.mesh.DistComm runs one block per rank) with margin-k
    exchanges.  Takes and returns global fields; the function's `comm`
    attribute holds the exchange counts."""
    comm = comm or StackedComm(mesh)

    def barotp_fn(grid: Grid, s: State, utotn, vtotn, m: int, n: int,
                  lstep: int, dlt, par: bt.BarotpParams) -> State:
        fld = bt._prologue(grid, s, utotn, vtotn, m, n, par)
        args = (fld, s.ubflxs, s.vbflxs, s.ubflxs_p, s.vbflxs_p)
        blocks = tree_unflatten(args, [comm.scatter(leaf)
                                   for _, leaf in tree_flatten(args)])
        out, sums = barotp_block(
            comm, grid.periodic_i, grid.periodic_j, *blocks, m, n, lstep,
            dlt, par, subs_per_exch, arctic=grid.arctic)
        out = {k: comm.gather(v) for k, v in out.items()}
        sums = {k: comm.gather(v) for k, v in sums.items()}
        out['pvtrop_n'] = fld['pvtrop_n']
        return bt.finalize(s, m, n, out, sums)

    barotp_fn.comm = comm
    return barotp_fn
