"""Single-point diagnostic dump.

Counterpart of `blom_tpu/utils/pointtest.py` (BLOM's
phy/mod_pointtest.F90:20-120): the prognostic column at (jtest, itest)
formatted on the host."""

from __future__ import annotations

from ..io.checksum import to_numpy


def ptest(state, n: int, itest: int, jtest: int, grid=None) -> str:
    """Format the prognostic column at (jtest, itest) on time level n
    (ptest / ptest2, mod_pointtest.F90)."""
    out = [f'point test at (i={itest}, j={jtest}), time level {n}:']
    dp, t, s, u, v = (to_numpy(getattr(state, f)[n, :, jtest, itest])
                      for f in ('dp', 'temp', 'saln', 'u', 'v'))
    out.append(f'{"k":>3} {"dp[m]":>12} {"temp":>10} {"saln":>10}'
               f' {"u":>10} {"v":>10}')
    for k in range(dp.shape[0]):
        out.append(f'{k:3d} {dp[k] / 9806.:12.6f} {t[k]:10.5f}'
                   f' {s[k]:10.5f} {u[k]:10.6f} {v[k]:10.6f}')
    out.append(f'pb={float(state.pb[n, jtest, itest]):.6e}'
               f' ub={float(state.ub[n, jtest, itest]):.6e}'
               f' vb={float(state.vb[n, jtest, itest]):.6e}')
    if grid is not None:
        out.append(f'depth={float(grid.depths[jtest, itest]):.2f} m'
                   f' ip={int(grid.ip[jtest, itest])}')
    return '\n'.join(out)
