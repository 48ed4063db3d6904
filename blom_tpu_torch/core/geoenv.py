"""Host-side preprocessing of geographic input fields.

The port's own copy of `fill_global` from `blom_tpu/core/geoenv.py`
(BLOM's mod_fill_global.F90), which the climatology readers use; the
rest of that module (grid files and the geographic environment) is not
ported."""

from __future__ import annotations

import numpy as np


def fill_global(a: np.ndarray, missing, mask=None, cyclic_i: bool = True,
                maxiter: int = 1000) -> np.ndarray:
    """Flood-fill missing values by iterated neighbour averaging
    (mod_fill_global.F90: the reference sweeps until no missing point
    remains inside the ocean mask); points never reached become 0."""
    a = np.array(a, np.float64)
    if np.isnan(missing):
        miss = np.isnan(a)
    else:
        miss = np.abs(a - missing) < abs(missing) * 1e-6 + 1e-30
    if mask is not None:
        want = (np.asarray(mask) > 0)
    else:
        want = np.ones_like(a, bool)
    a[miss] = np.nan

    for _ in range(maxiter):
        bad = np.isnan(a) & want
        if not bad.any():
            break
        nb = []
        for (dj, di) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            sh = np.roll(a, (dj, di), axis=(0, 1))
            if dj == 1:
                sh[0, :] = np.nan
            if dj == -1:
                sh[-1, :] = np.nan
            if not cyclic_i:
                if di == 1:
                    sh[:, 0] = np.nan
                if di == -1:
                    sh[:, -1] = np.nan
            nb.append(sh)
        nb = np.stack(nb)
        cnt = np.sum(~np.isnan(nb), axis=0)
        ssum = np.nansum(np.where(np.isnan(nb), 0., nb), axis=0)
        fill = bad & (cnt > 0)
        a[fill] = ssum[fill] / cnt[fill]
    a[np.isnan(a)] = 0.
    return a
