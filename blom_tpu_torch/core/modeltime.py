"""Model clock: baroclinic/barotropic step bookkeeping.

The port's own copy of `blom_tpu/core/modeltime.py` (BLOM's
mod_time.F90): `init_timevars` for every experiment configuration, the
delt1 schedule of the drivers and the climatologies' time interpolation
(`month_interp`, `phys/swabs.py` `updswa`).  The clock is advanced on the host once per baroclinic step; only `delt1`
enters the step, as a Python float.  The first steps from initial conditions are forward
(delt1 = baclin), later steps leap-frog (delt1 = 2*baclin)."""

from __future__ import annotations

import dataclasses
import math

from . import calendar as cal

# Calendar per experiment configuration (mod_time.F90:76-99).
_EXPCNF_CALENDAR = {
    'cesm': 'noleap',
    'ben02clim': '360_day',
    'ben02syn': 'standard',
    'noforcing': '360_day',
    'fuk95': '360_day',
    'channel': '360_day',
    'single_column': '360_day',
    'isomip1': '360_day',
    'isomip2': '360_day',
}

_EPSILT = 1.e-11


@dataclasses.dataclass(frozen=True)
class ModelTime:
    """Immutable clock state; use `step()` to advance."""

    calendar: str
    baclin: float        # Baroclinic time step [s].
    batrop: float        # Requested barotropic time step [s].
    lstep: int           # Barotropic substeps per baroclinic step (even).
    dlt: float           # Resolved barotropic time step [s].
    nstep_in_day: int
    date0: cal.Date      # Experiment start date.
    date: cal.Date       # Current date.
    nstep0: int = 0      # Step number at experiment start.
    nstep: int = 0       # Current step number.
    time0: float = 0.0   # Integration time at start [days].
    time: float = 0.0    # Current integration time [days].

    @property
    def delt1(self) -> float:
        """Forward step from IC, leap-frog afterwards (mod_time.F90:49-55)."""
        return self.baclin if self.nstep <= 1 else 2.0 * self.baclin

    @property
    def nday_in_year(self) -> int:
        return cal.days_in_year(self.calendar, self.date.year)

    @property
    def nday_of_year(self) -> int:
        return cal.day_of_year(self.calendar, self.date)

    def step(self) -> "ModelTime":
        """Advance one baroclinic step (mod_time.F90:185-218)."""
        nstep = self.nstep + 1
        time = self.time0 + nstep * self.baclin / 86400.0
        date = self.date
        if nstep % self.nstep_in_day == 0:
            date = cal.date_offset(self.calendar, date, 1)
        return dataclasses.replace(self, nstep=nstep, time=time, date=date)

    def month_interp(self):
        """Monthly-climatology interpolation weights (mod_time.F90:203-218):
        (xmi, l1, l2, l3, l4, l5), the fractional position within the
        current month slot and the five surrounding months (1-12)."""
        xmi = ((self.nday_of_year - 1
                + (self.nstep % self.nstep_in_day) / self.nstep_in_day)
               * 12.0 / self.nday_in_year)
        l3 = int(xmi) + 1
        xmi = xmi - (l3 - 1)
        l1 = (l3 + 9) % 12 + 1
        l2 = (l3 + 10) % 12 + 1
        l4 = l3 % 12 + 1
        l5 = (l3 + 1) % 12 + 1
        return xmi, l1, l2, l3, l4, l5

    def ymd_tod(self):
        """(YYYYMMDD, seconds of the day) (mod_time.F90 blom_time)."""
        return (self.date.to_ymd(),
                round((self.nstep % self.nstep_in_day) * self.baclin))


def init_timevars(expcnf: str, baclin: float, batrop: float,
                  idate: int, idate0: int,
                  nstep0: int = 0) -> ModelTime:
    """Build the initial clock (mod_time.F90:69-131 init_timevars)."""
    calendar = _EXPCNF_CALENDAR[expcnf]

    nstep_in_day = round(86400.0 / baclin)
    if abs(86400.0 / baclin - nstep_in_day) > _EPSILT:
        raise ValueError(
            'baclin must divide 86400 s into an integer number of steps')

    # lstep must be even (mod_time.F90:118-123).
    lstep = 2 * math.ceil(.5 * baclin / batrop)
    dlt = baclin / lstep

    date0 = cal.Date.from_ymd(idate0)
    date = cal.Date.from_ymd(idate)
    time0 = float(cal.daynum_diff(calendar, date0, date))

    return ModelTime(calendar=calendar, baclin=baclin, batrop=batrop,
                     lstep=lstep, dlt=dlt, nstep_in_day=nstep_in_day,
                     date0=date0, date=date, nstep0=nstep0, nstep=nstep0,
                     time0=time0, time=time0)
