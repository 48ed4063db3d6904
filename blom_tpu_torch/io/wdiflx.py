"""Write diagnosed heat and salt relaxation flux climatologies.

Counterpart of `blom_tpu/io/wdiflx.py` (BLOM's phy/mod_wdiflx.F90): the
48-slice annual accumulation of the ditflx/disflx options
(`phys/idarlx.diagnose_flux`) averaged by its counts and saved as an
npz archive that `phys/idarlx.load_flux_clim` reads back."""

from __future__ import annotations

import numpy as np

from .checksum import to_numpy


def wdiflx(path: str, acc, count, varname: str):
    """Average the accumulated slices by their counts and save them;
    returns the mean as a numpy array."""
    acc = to_numpy(acc)
    count = to_numpy(count).astype(np.float64)
    mean = acc / np.maximum(count[:, None, None], 1.)
    np.savez_compressed(path, **{varname: mean, varname + '_n': count})
    return mean
