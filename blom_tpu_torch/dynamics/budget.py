"""Conservation budget diagnostics.

Counterpart of `blom_tpu/dynamics/budget.py` (BLOM's cnsvdi budgets,
phy/mod_budget.F90: mass-weighted global sums of dp, T and S at numbered
checkpoints of the step, through the reproducible xcsum, printed as
deltas).  The sums are f64 whatever the state's dtype: the columns in
ascending k, then `parallel/repsum.py`'s fixed strip hierarchy, so they
equal blom_tpu's bit for bit on the same state.

`budget_sums_many` finishes several checkpoints' columns in one
`repsum_2d` call over a leading batch axis: each element's additions are
the same, in the same order, so the sums are those of one call per
checkpoint, for one launch per row instead of one per row and sum."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.grid import Grid
from ..core.state import State
from ..parallel.repsum import repsum_2d

_KEYS = ('mass', 'heat', 'salt')


class BudgetSums(NamedTuple):
    mass: torch.Tensor   # sum dp*area [kg m s-2 * m2]
    heat: torch.Tensor   # sum T*dp*area
    salt: torch.Tensor   # sum S*dp*area


def budget_col_sums(grid: Grid, s: State, lvl: int):
    """Column-collapsed mass, heat and salt weights (ascending k, f64):
    pointwise in (j, i), the block-local half of budget_sums."""
    w = (grid.scp2 * grid.ip).double()
    dp = s.dp[lvl].double()

    def kchain(a):
        col = a[0]
        for k in range(1, a.shape[0]):
            col = col + a[k]
        return col

    return {'mass': kchain(dp * w),
            'heat': kchain(s.temp[lvl].double() * dp * w),
            'salt': kchain(s.saln[lvl].double() * dp * w)}


def budget_sums_from_cols(col) -> BudgetSums:
    """Finish budget sums from column-collapsed fields with the xcsum
    strip hierarchy."""
    return BudgetSums(mass=repsum_2d(col['mass']),
                      heat=repsum_2d(col['heat']),
                      salt=repsum_2d(col['salt']))


def budget_sums_many(cols) -> list:
    """budget_sums_from_cols of each dict in `cols`, in one batched
    repsum_2d; bit for bit the separate calls."""
    if not cols:
        return []
    tot = repsum_2d(torch.stack([torch.stack([c[k] for k in _KEYS])
                                 for c in cols]))
    return [BudgetSums(*t.unbind()) for t in tot.unbind()]


def budget_sums(grid: Grid, s: State, lvl: int) -> BudgetSums:
    """Global mass, heat and salt sums of time level `lvl`
    (budget_sums, mod_budget.F90:69-200)."""
    return budget_sums_from_cols(budget_col_sums(grid, s, lvl))


def budget_deltas(b0: BudgetSums, b1: BudgetSums):
    """Relative budget changes between two checkpoints (budget_output,
    mod_budget.F90:202-356 prints the same deltas)."""
    return {k: float((getattr(b1, k) - getattr(b0, k))
                     / torch.clamp_min(getattr(b0, k).abs(), 1.))
            for k in _KEYS}
