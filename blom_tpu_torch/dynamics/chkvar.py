"""NaN/Inf and range guard on the prognostic fields.

Counterpart of `blom_tpu/dynamics/chkvar.py` (BLOM's per-step sanity
check, phy/mod_chkvar.F90: dp, T and S scanned for non-finite or
out-of-range values, the model aborting at the offending point).
`chkvar` leaves its flag and counts on the device, so a step loop reads
nothing back; `chkvar_host` reads them and raises with the location."""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.state import State

# field: (lowest, highest) value allowed over water
_RANGES = {'dp': (0.0 - 1e-6, 1e9), 'temp': (-3., 50.),
           'saln': (-1e-9, 100.)}


def chkvar(grid: Grid, s: State, lvl: int):
    """Device-side check: (ok, {field: count of bad wet points}), both
    tensors on the state's device."""
    mask = grid.ip > 0
    bad = {}
    ok = torch.ones((), dtype=torch.bool, device=s.dp.device)
    for name, (lo, hi) in _RANGES.items():
        a = getattr(s, name)[lvl]
        isbad = (~torch.isfinite(a) | (a < lo) | (a > hi)) & mask
        bad[name] = isbad.sum()
        ok = ok & (bad[name] == 0)
    return ok, bad


def chkvar_host(grid: Grid, s: State, lvl: int, nstep=None):
    """Host-side check that raises FloatingPointError naming the first
    bad point (k, j, i) of each failing field (mod_chkvar.F90's located
    abort)."""
    ok, bad = chkvar(grid, s, lvl)
    if bool(ok):
        return
    ip = grid.ip.detach().cpu().numpy()
    msgs = []
    for name in bad:
        a = getattr(s, name)[lvl].detach().cpu().numpy()
        m = ~np.isfinite(a)
        if name == 'temp':
            m |= (a < -3.) | (a > 50.)
        if name == 'saln':
            m |= (a < -1e-9) | (a > 100.)
        if name == 'dp':
            m |= a < -1e-6
        m &= ip[None] > 0
        if m.any():
            k, j, i = np.argwhere(m)[0]
            msgs.append(f'{name}[k={k}, j={j}, i={i}] = {a[k, j, i]!r}')
    raise FloatingPointError(
        f'chkvar: non-finite/out-of-range state at step {nstep}: '
        + '; '.join(msgs))
