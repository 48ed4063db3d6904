"""Fixed-order axis reductions.

Counterpart of `blom_tpu/ops/reduce.py`: `ksum` adds the slices along an
axis one after another in ascending index order, as BLOM's Fortran loops
do.  `torch.sum` associates in an order of its own, so a k-sum that
feeds prognostic state uses `ksum` wherever blom_tpu does, to keep f64
parity at rounding."""

from __future__ import annotations


def ksum(a, axis: int = 0):
    """Sum along `axis`, chained in ascending index order."""
    out = a.select(axis, 0)
    for k in range(1, a.shape[axis]):
        out = out + a.select(axis, k)
    return out
