"""Calendar arithmetic for the model clock.

The port's own copy of the part of `blom_tpu/core/calendar.py` that the
fuk95 and channel clocks need (BLOM's mod_calendar.F90): the '360_day'
calendar, with the day of the year that the climatologies' time
interpolation reads.  Dates map to a day number so that offsets are integer
arithmetic.  Pure Python, host side only."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Date:
    year: int
    month: int
    day: int

    @staticmethod
    def from_ymd(ymd: int) -> "Date":
        return Date(ymd // 10000, (ymd // 100) % 100, ymd % 100)

    def to_ymd(self) -> int:
        return self.year * 10000 + self.month * 100 + self.day


def _check(calendar: str):
    if calendar.strip() != '360_day':
        raise NotImplementedError(
            f'calendar {calendar!r} is not ported; only 360_day')


def date_to_daynum(calendar: str, d: Date) -> int:
    """Date -> day number (mod_calendar.F90:238-248)."""
    _check(calendar)
    return 360 * (d.year - 1) + 30 * (d.month - 1) + d.day - 1


def daynum_to_date(calendar: str, daynum: int) -> Date:
    """Day number -> date (mod_calendar.F90:336-353)."""
    _check(calendar)
    year = daynum // 360
    r = daynum - year * 360
    return Date(year + 1, r // 30 + 1, r - (r // 30) * 30 + 1)


def daynum_diff(calendar: str, d1: Date, d2: Date) -> int:
    """Days from d1 to d2."""
    return date_to_daynum(calendar, d2) - date_to_daynum(calendar, d1)


def date_offset(calendar: str, d: Date, ndays: int) -> Date:
    """Date offset by ndays."""
    return daynum_to_date(calendar, date_to_daynum(calendar, d) + ndays)


def days_in_year(calendar: str, year: int) -> int:
    """Days in `year`."""
    return daynum_diff(calendar, Date(year, 1, 1), Date(year + 1, 1, 1))


def day_of_year(calendar: str, d: Date) -> int:
    """1-based day of the year (mod_time.F90 set_day_of_year)."""
    return daynum_diff(calendar, Date(d.year, 1, 1), d) + 1
