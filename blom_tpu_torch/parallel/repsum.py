"""Fixed-order global sums.

Counterpart of `blom_tpu/parallel/repsum.py` (BLOM's reproducible global
sum, phy/mod_xc.F90:2071-2192 xcsum: partial sums over fixed
(2*nbdy+1)-wide strips in a fixed order, then over strips, then one
ordered sum over rows).  The same hierarchy is a sequence of elementwise
adds whose order the Python loops pin, in f64, so a sum does not depend
on how a library associates its reductions.  Single device: the sharded
form comes with the decomposition.

Leading dimensions are batched: each sum runs over the last two (J, I)
or three (K, J, I) axes, elementwise over the ones before, in the same
order for each (blom_tpu maps its sums over such a batch with
`jax.vmap`).  On the card the row loop launches one small kernel per
row; these sums serve diagnostics, not the step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: strip width, BLOM's 2*nbdy+1 with nbdy=4 (mod_xc.F90:2090 mxsum strips)
STRIP = 9


def repsum_2d(a, mask=None, strip: int = STRIP):
    """Fixed-order f64 sum over the last two axes (J, I): within each
    strip (ascending i), over the strips (ascending), over the rows
    (ascending j), xcsum's hierarchy (mod_xc.F90:2112-2170)."""
    a = a.double()
    if mask is not None:
        a = a * mask.double()
    j, i = a.shape[-2], a.shape[-1]
    pad = (-i) % strip
    if pad:
        a = F.pad(a, (0, pad))
    nstrips = (i + pad) // strip
    a = a.reshape(a.shape[:-1] + (nstrips, strip))

    # within each strip, ascending i (elementwise over strips and rows)
    s = a[..., 0]
    for w in range(1, strip):
        s = s + a[..., w]
    # across the strips, ascending
    row = s[..., 0]
    for m in range(1, nstrips):
        row = row + s[..., m]
    # across the rows, ascending j
    tot = row[..., 0]
    for jj in range(1, j):
        tot = tot + row[..., jj]
    return tot


def repsum_3d(a, mask=None, strip: int = STRIP):
    """Fixed-order f64 sum over the last three axes (K, J, I): the
    k-columns collapsed first (ascending k, elementwise), then the 2-D
    hierarchy, as BLOM calls xcsum on per-layer sums accumulated over k
    (mod_budget.F90:69-200)."""
    a = a.double()
    col = a[..., 0, :, :]
    for k in range(1, a.shape[-3]):
        col = col + a[..., k, :, :]
    return repsum_2d(col, mask, strip)


def repsum(a, mask=None, strip: int = STRIP):
    """By rank: (J, I) or (K, J, I)."""
    if a.dim() == 2:
        return repsum_2d(a, mask, strip)
    if a.dim() == 3:
        return repsum_3d(a, mask, strip)
    raise ValueError(f'repsum: unsupported rank {a.dim()}')
