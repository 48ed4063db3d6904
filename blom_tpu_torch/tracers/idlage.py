"""Ideal-age tracer.

Counterpart of `blom_tpu/tracers/idlage.py` (BLOM's
idlage/mod_idlage.F90): zero age in the surface layer, aged by delt1
below, advected and diffused like any tracer.  Updates the State in
place."""

from __future__ import annotations

from ..core.state import State


def idlage_init(s: State, itriag: int) -> State:
    """Zero the ideal-age tracer at both time levels (idlage_init,
    mod_idlage.F90:33-54)."""
    s.trc[:, itriag] = 0.
    return s


def idlage_step(s: State, itriag: int, n: int, delt1: float,
                nday_in_year: float = 360.) -> State:
    """Age update (idlage_step, mod_idlage.F90:56-97): the surface layer
    reset to zero, the layers below aged by delt1 (in years)."""
    q = delt1 / (86400. * nday_in_year)
    age = s.trc[n, itriag]
    age[0] = 0.
    age[1:] += q
    return s
