"""One baroclinic model step: the adiabatic dynamical core.

Counterpart of `blom_tpu/dynamics/step.py` (BLOM's
mod_blom_step.F90:74-324) for the branches ported so far: tmsmt1,
advect (CPPM), pbcor1, pgforc (dynamic enthalpy), momtum (enscon),
barotp, pbcor2 and tmsmt2.  The ALE regrid/remap, the lateral
diffusivity estimate (with eddy transport and lateral diffusion) and
vertical mixing are not ported yet: `blom_step` raises
NotImplementedError naming the phase when a parameter asks for them.

The step updates the State in place; m, n are the Python-int time-level
slots and delt1 a Python float, so the step makes no host sync."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import eos
from ..core.grid import Grid
from ..core.state import State
from ..phys.forcing import Forcing
from .advect import advect
from .barotp import BarotpParams, barotp
from .cppm import CppmCoeffs
from .diffusion_fields import DiffusionFields
from .momtum import MomtumParams, momtum
from .pbcor import pbcor1, pbcor2
from .pgforc import pgforc
from .tmsmt import tmsmt1, tmsmt2


class ThermfParams(NamedTuple):
    """Surface restoring e-folding times [days]; 0 turns the restoring
    off, which makes thermf a no-op (mod_thermf.F90)."""
    trxday: float = 0.
    srxday: float = 0.


class StepParams(NamedTuple):
    """Static per-run parameters of the step function.  `ale`, `vmix` and
    `difest` hold the parameters of phases not ported yet and must be
    None."""
    baclin: float
    lstep: int
    dlt: float
    momtum: MomtumParams = MomtumParams()
    barotp: BarotpParams = BarotpParams()
    pgfmth: str = 'dynamic enthalpy'
    advmth: str = 'cppm'
    cppm_compatibility: str = 'full'
    cppm_limiting: str = 'non_oscillatory'
    vcoord_isopyc: bool = False
    ale: Optional[object] = None
    vmix: Optional[object] = None
    itriag: int = -1
    itrtke: int = -1
    itrgls: int = -1
    itrbgc: int = -1
    nday_in_year: float = 360.
    difest: Optional[object] = None
    thermf: Optional[ThermfParams] = ThermfParams()


def check_supported(grid: Grid, par: StepParams):
    """Raise NotImplementedError, naming the phase, for any option this
    port does not run yet."""
    missing = []
    if par.ale is not None:
        missing.append('ALE regrid/remap (par.ale)')
    if par.vmix is not None:
        missing.append('vertical mixing (par.vmix)')
    if par.difest is not None:
        missing.append('lateral diffusivities and eddy transport '
                       '(par.difest)')
    if par.vcoord_isopyc:
        missing.append('isopycnic coordinate (par.vcoord_isopyc)')
    if par.advmth != 'cppm':
        missing.append(f'advection advmth={par.advmth!r}')
    if par.itriag >= 0:
        missing.append('ideal-age tracer (par.itriag)')
    if par.itrbgc >= 0:
        missing.append('BGC tracers (par.itrbgc)')
    if par.itrtke >= 0 or par.itrgls >= 0:
        missing.append('TKE/GLS closure (par.itrtke/itrgls)')
    if par.thermf is not None and (par.thermf.trxday > 0.
                                   or par.thermf.srxday > 0.):
        missing.append('surface restoring (par.thermf)')
    if grid.arctic:
        missing.append('tripolar grid')
    if missing:
        raise NotImplementedError(
            'not ported to blom_tpu_torch yet: ' + '; '.join(missing))


# Per-phase device timing, off (None) by default.  A caller that sets
# `phase_marks` to a list gets from each blom_step on the card one
# (name, CUDA event) pair recorded before each phase, and ('end', event)
# after the last; a phase's time is the gap to the next mark.
phase_marks: Optional[list] = None


def _mark(name: str):
    if phase_marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        phase_marks.append((name, ev))


def init_fluxes(s: State, m: int) -> State:
    """Reset mid-level flux accumulators (init_fluxes,
    mod_state.F90:341-383)."""
    for name in ('uflx', 'vflx', 'utflx', 'vtflx', 'usflx', 'vsflx'):
        getattr(s, name)[m].zero_()
    return s


def blom_step(grid: Grid, e: eos.EosParams, par: StepParams,
              coeffs_i: CppmCoeffs, coeffs_j: CppmCoeffs,
              s: State, forcing: Forcing, dfl: DiffusionFields,
              m: int, n: int, delt1: float):
    """Advance one baroclinic time step (mod_blom_step.F90:74-324) in
    place.  Returns (state, dfl)."""
    check_supported(grid, par)
    dlt = par.dlt
    _mark('init_fluxes+tmsmt1')
    s = init_fluxes(s, m)
    s = tmsmt1(grid, s, n)
    _mark('advect')
    s = advect(grid, s, dfl, coeffs_i, coeffs_j, m, n, delt1, dlt,
               par.advmth, par.cppm_compatibility, par.cppm_limiting)
    _mark('pbcor1')
    s = pbcor1(grid, s, m, n, dlt)
    _mark('pgforc')
    s = pgforc(grid, e, s, m, n, par.pgfmth)
    _mark('momtum')
    s, utotn, vtotn = momtum(grid, s, forcing, par.momtum, dfl.difwgt,
                             m, n, delt1, dlt)
    _mark('barotp')
    s = barotp(grid, s, utotn, vtotn, m, n, par.lstep, dlt, par.barotp)
    _mark('pbcor2')
    s = pbcor2(grid, e, s, m, n, dlt)
    _mark('tmsmt2')
    s = tmsmt2(grid, s, m, n)
    _mark('end')
    return s, dfl


def two_step(grid: Grid, e: eos.EosParams, par: StepParams,
             coeffs_i: CppmCoeffs, coeffs_j: CppmCoeffs, s: State,
             forcing: Forcing, dfl: DiffusionFields, d1: float, d2: float):
    """Two steps covering both time-level parities: (m, n) = (0, 1) then
    (1, 0) — the body of blom_tpu's make_two_step scan."""
    s, dfl = blom_step(grid, e, par, coeffs_i, coeffs_j, s, forcing, dfl,
                       0, 1, d1)
    return blom_step(grid, e, par, coeffs_i, coeffs_j, s, forcing, dfl,
                     1, 0, d2)
