"""The 2-D ('y', 'x') grid of blocks and the communicators between them.

Counterpart of `blom_tpu/parallel/mesh.py` (BLOM's 2-D tile
decomposition, mod_xc.F90:1332-2026 xcspmd) and of the parts of
`shard_map` that the block-local code uses: the split of the trailing
(j, i) axes into equal blocks, the join back, a permute of blocks along
one mesh axis (`lax.ppermute`) and a block's position on an axis
(`lax.axis_index`).

Block-local code sees every array as (..., B, jloc, iloc): the block axis
sits just before (j, i), so a time-level or layer index in front works
as on a global field.  Two communicators hold the blocks:

- `StackedComm`: one process holds all ny*nx blocks (B = ny*nx, row
  major in (y, x)); a permute is an index along the block axis.  Every
  block runs each substep together, so an exchange in the middle of a
  block's substeps meets its neighbours' data of the same substep.
- `DistComm`: one block per rank of `torch.distributed` (B = 1, rank =
  y*nx + x); a permute is `batch_isend_irecv`.  Tested with gloo on the
  CPU; NCCL across GPUs is untested.

Both count their halo exchanges (`exchanges`, one per
halo.halo_exchange) and their permutes (`permutes`), the counterpart of
the collective-permutes in blom_tpu's compiled program."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    ny: int
    nx: int

    @property
    def shape(self):
        return (self.ny, self.nx)

    @property
    def size(self):
        return self.ny * self.nx


def make_mesh(n: int = None, shape=None) -> Mesh:
    """A ('y', 'x') mesh of n blocks (by default the world size of an
    initialized torch.distributed, else 1).  Without a shape, n is
    factorized as close to square as it goes, ny <= nx (blom_tpu's
    make_mesh; the reference picks its tile grid the same way)."""
    if shape is not None:
        return Mesh(*map(int, shape))
    if n is None:
        dist = torch.distributed
        n = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    ny = int(n ** .5)
    while n % ny:
        ny -= 1
    return Mesh(ny, n // ny)


def split_blocks(a, mesh: Mesh):
    """(..., J, I) -> (..., ny*nx, J/ny, I/nx), block b = y*nx + x."""
    ny, nx = mesh
    jj, ii = a.shape[-2:]
    if jj % ny or ii % nx:
        raise ValueError(f'grid {jj}x{ii} does not split into {ny}x{nx} '
                         f'equal blocks')
    lead = a.shape[:-2]
    b = a.reshape(lead + (ny, jj // ny, nx, ii // nx))
    b = b.movedim(-3, -2)
    return b.reshape(lead + (ny * nx, jj // ny, ii // nx))


def join_blocks(b, mesh: Mesh):
    """The inverse of split_blocks."""
    ny, nx = mesh
    lead = b.shape[:-3]
    jl, il = b.shape[-2:]
    a = b.reshape(lead + (ny, nx, jl, il)).movedim(-3, -2)
    return a.reshape(lead + (ny * jl, nx * il))


def ring(n: int, up: bool):
    """(source, destination) pairs of a ring shift over n mesh slots."""
    if up:
        return [(i, (i + 1) % n) for i in range(n)]
    return [((i + 1) % n, i) for i in range(n)]


class _Comm:
    """What both communicators share: the mesh and the counts."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ny, self.nx = mesh
        self.exchanges = 0
        self.permutes = 0
        self._const = {}     # constant tensors by (what, device)

    def const(self, key, device, make):
        """make(device), made once per (key, device) and kept: the
        exchanges' index, mask and sign tensors reach the device once,
        not at every call (a copy from pageable host memory waits for
        the device)."""
        t = self._const.get((key, device))
        if t is None:
            t = self._const[(key, device)] = make(device)
        return t

    def _tensor(self, key, values, device):
        return self.const(key, device,
                          lambda d: torch.tensor(values, device=d))

    def _pos(self, y, x, axis):
        return x if axis == 'x' else y


class StackedComm(_Comm):
    """Every block of the mesh in this process, on the block axis."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        self.nblocks = mesh.size
        self._ys = [b // self.nx for b in range(self.nblocks)]
        self._xs = [b % self.nx for b in range(self.nblocks)]

    def axis_index(self, axis: str, like):
        """Each block's position on `axis`, shaped (B, 1, 1)."""
        pos = self._xs if axis == 'x' else self._ys
        return self._tensor(('pos', axis), pos,
                            like.device).reshape(-1, 1, 1)

    def permute(self, a, axis: str, pairs):
        """Out block at position d on `axis` is a's block at s for each
        (s, d) in pairs; a block with no source gets zeros."""
        self.permutes += 1
        src_of = {d: s for s, d in pairs}
        idx, keep = [], []
        for b in range(self.nblocks):
            y, x = self._ys[b], self._xs[b]
            s = src_of.get(self._pos(y, x, axis))
            keep.append(s is not None)
            s = 0 if s is None else s
            idx.append(y * self.nx + s if axis == 'x' else s * self.nx + x)
        key = (axis, tuple(pairs))
        out = a.index_select(-3, self._tensor(key, idx, a.device))
        if not all(keep):
            mask = self._tensor(('keep',) + key, keep,
                                a.device).reshape(-1, 1, 1)
            out = torch.where(mask, out, torch.zeros_like(out))
        return out

    def scatter(self, a):
        """A global (..., J, I) field as this process's blocks."""
        return split_blocks(a, self.mesh)

    def gather(self, b):
        """The global field from this process's blocks."""
        return join_blocks(b, self.mesh)


class DistComm(_Comm):
    """One block per rank of the default torch.distributed group."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        dist = torch.distributed
        if dist.get_world_size() != mesh.size:
            raise ValueError(f'mesh {mesh.shape} needs {mesh.size} ranks, '
                             f'the group has {dist.get_world_size()}')
        self.nblocks = 1
        self.rank = dist.get_rank()
        self.y, self.x = divmod(self.rank, self.nx)

    def axis_index(self, axis: str, like):
        pos = self.x if axis == 'x' else self.y
        return self._tensor(('pos', axis), [pos],
                            like.device).reshape(1, 1, 1)

    def _rank(self, pos, axis):
        return self.y * self.nx + pos if axis == 'x' \
            else pos * self.nx + self.x

    def permute(self, a, axis: str, pairs):
        dist = torch.distributed
        self.permutes += 1
        me = self._pos(self.y, self.x, axis)
        dst = [d for s, d in pairs if s == me]
        src = [s for s, d in pairs if d == me]
        a = a.contiguous()
        out = torch.zeros_like(a)
        if dst == [me] and src == [me]:
            return a.clone()
        ops = [dist.P2POp(dist.isend, a, self._rank(d, axis)) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, self._rank(s, axis))
                for s in src]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def scatter(self, a):
        return split_blocks(a, self.mesh)[..., self.rank:self.rank + 1, :, :]

    def gather(self, b):
        dist = torch.distributed
        parts = [torch.empty_like(b) for _ in range(self.mesh.size)]
        dist.all_gather(parts, b.contiguous())
        return join_blocks(torch.cat(parts, -3), self.mesh)
