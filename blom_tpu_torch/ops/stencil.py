"""Neighbour-shift primitives for C-grid stencils.

Counterpart of `blom_tpu/ops/stencil.py`.  Fields are dense
(..., jdm, idm) tensors; a periodic axis shifts with `torch.roll`, a
closed axis shifts in zeros (land).  `im1(a)[..., j, i] == a[..., j, i-1]`;
i is the last axis, j the second-to-last."""

from __future__ import annotations

import torch

AXIS_I = -1
AXIS_J = -2


def _shift(a: torch.Tensor, axis: int, offset: int, periodic: bool):
    """out[..., x] = a[..., x + offset] along `axis`; zeros enter at a
    closed edge."""
    if offset == 0:
        return a
    if periodic:
        return torch.roll(a, -offset, dims=axis)
    n = a.shape[axis]
    pad_shape = list(a.shape)
    pad_shape[axis] = abs(offset)
    zeros = a.new_zeros(pad_shape)
    if offset > 0:
        return torch.cat([a.narrow(axis, offset, n - offset), zeros], axis)
    return torch.cat([zeros, a.narrow(axis, 0, n + offset)], axis)


def im1(a, periodic_i: bool):
    """a at (i-1, j)."""
    return _shift(a, AXIS_I, -1, periodic_i)


def ip1(a, periodic_i: bool):
    """a at (i+1, j)."""
    return _shift(a, AXIS_I, +1, periodic_i)


def jm1(a, periodic_j: bool):
    """a at (i, j-1)."""
    return _shift(a, AXIS_J, -1, periodic_j)


def jp1(a, periodic_j: bool):
    """a at (i, j+1)."""
    return _shift(a, AXIS_J, +1, periodic_j)


def shift(a, di: int = 0, dj: int = 0, periodic_i: bool = False,
          periodic_j: bool = False):
    """a at (i+di, j+dj)."""
    out = a
    if di:
        out = _shift(out, AXIS_I, di, periodic_i)
    if dj:
        out = _shift(out, AXIS_J, dj, periodic_j)
    return out
