"""Calendar arithmetic for the model clock.

The port's own copy of `blom_tpu/core/calendar.py` (BLOM's
mod_calendar.F90): 'standard'/'gregorian' (mixed Julian/Gregorian with the
1582 transition), 'proleptic_gregorian', 'julian', 'noleap'/'365_day',
'all_leap'/'366_day' and '360_day'.  Dates map to a Chronological Julian
Day Number so that day differences and offsets are integer arithmetic.
Pure Python, host side only."""

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


def _floordiv(a: int, b: int) -> int:
    # Python's // floors, as intdivfloor does (mod_calendar.F90:146-159).
    return a // b


def _date_to_daynum_julian(d: Date) -> int:
    # mod_calendar.F90:161-178
    c0 = _floordiv(d.month - 3, 12)
    return (_floordiv(1461 * (d.year + c0), 4)
            + (153 * d.month - 1836 * c0 - 457) // 5 + d.day + 1721117)


def _date_to_daynum_gregorian(d: Date) -> int:
    # mod_calendar.F90:180-199
    c0 = _floordiv(d.month - 3, 12)
    k1 = d.year + c0
    q1 = _floordiv(k1, 100)
    return (_floordiv(146097 * q1, 4) + 36525 * (k1 - q1 * 100) // 100
            + (153 * d.month - 1836 * c0 - 457) // 5 + d.day + 1721119)


def _date_to_daynum_fixedyear(d: Date, ylen: int) -> int:
    # mod_calendar.F90:201-236 (March-based month formula).
    c0 = _floordiv(d.month - 3, 12)
    return (ylen * (d.year + c0)
            + (153 * d.month - 1836 * c0 - 457) // 5 + d.day - 307)


def _date_to_daynum_360(d: Date) -> int:
    # mod_calendar.F90:238-248
    return 360 * (d.year - 1) + 30 * (d.month - 1) + d.day - 1


def _daynum_to_date_julian(daynum: int) -> Date:
    # mod_calendar.F90:250-269
    k2 = 4 * daynum - 6884469
    q2 = _floordiv(k2, 1461)
    k1 = 5 * ((k2 - q2 * 1461) // 4) + 2
    q1 = k1 // 153
    c0 = (q1 + 2) // 12
    return Date(q2 + c0, q1 - 12 * c0 + 3, (k1 - q1 * 153) // 5 + 1)


def _daynum_to_date_gregorian(daynum: int) -> Date:
    # mod_calendar.F90:271-292
    k3 = 4 * daynum - 6884477
    q3 = _floordiv(k3, 146097)
    k2 = 100 * ((k3 - q3 * 146097) // 4) + 99
    q2 = k2 // 36525
    k1 = 5 * ((k2 - q2 * 36525) // 100) + 2
    q1 = k1 // 153
    c0 = (q1 + 2) // 12
    return Date(100 * q3 + q2 + c0, q1 - 12 * c0 + 3,
                (k1 - q1 * 153) // 5 + 1)


def _daynum_to_date_fixedyear(daynum: int, ylen: int) -> Date:
    # mod_calendar.F90:294-334
    k2 = daynum + 306
    q2 = _floordiv(k2, ylen)
    k1 = 5 * (k2 - q2 * ylen) + 2
    q1 = k1 // 153
    c0 = (q1 + 2) // 12
    return Date(q2 + c0, q1 - 12 * c0 + 3, (k1 - q1 * 153) // 5 + 1)

# CJDN of the first Gregorian day (1582-10-15) in the mixed calendar.
_GREGORIAN_START_DAYNUM = _date_to_daynum_gregorian(Date(1582, 10, 15))


def date_to_daynum(calendar: str, d: Date) -> int:
    """Date -> day number (mod_calendar.F90:359-428)."""
    cal = calendar.strip()
    if cal in ('gregorian', 'standard'):
        dn = _date_to_daynum_gregorian(d)
        if dn < _GREGORIAN_START_DAYNUM:
            dn = _date_to_daynum_julian(d)
            if dn >= _GREGORIAN_START_DAYNUM:
                raise ValueError(f'invalid date {d} in mixed calendar')
        return dn
    if cal == 'proleptic_gregorian':
        return _date_to_daynum_gregorian(d)
    if cal == 'julian':
        return _date_to_daynum_julian(d)
    if cal in ('noleap', '365_day'):
        return _date_to_daynum_fixedyear(d, 365)
    if cal in ('all_leap', '366_day'):
        return _date_to_daynum_fixedyear(d, 366)
    if cal == '360_day':
        return _date_to_daynum_360(d)
    raise ValueError(f'unsupported calendar {calendar!r}')


def daynum_to_date(calendar: str, daynum: int) -> Date:
    """Day number -> date (mod_calendar.F90:430-495)."""
    cal = calendar.strip()
    if cal in ('gregorian', 'standard'):
        if daynum >= _GREGORIAN_START_DAYNUM:
            return _daynum_to_date_gregorian(daynum)
        return _daynum_to_date_julian(daynum)
    if cal == 'proleptic_gregorian':
        return _daynum_to_date_gregorian(daynum)
    if cal == 'julian':
        return _daynum_to_date_julian(daynum)
    if cal in ('noleap', '365_day'):
        return _daynum_to_date_fixedyear(daynum, 365)
    if cal in ('all_leap', '366_day'):
        return _daynum_to_date_fixedyear(daynum, 366)
    if cal == '360_day':
        # mod_calendar.F90:336-353
        year = _floordiv(daynum, 360)
        r = daynum - year * 360
        return Date(year + 1, r // 30 + 1, r - (r // 30) * 30 + 1)
    raise ValueError(f'unsupported calendar {calendar!r}')


def daynum_diff(calendar: str, d1: Date, d2: Date) -> int:
    """Days from d1 to d2 (mod_calendar.F90 daynum_diff)."""
    return date_to_daynum(calendar, d2) - date_to_daynum(calendar, d1)


def date_offset(calendar: str, d: Date, ndays: int) -> Date:
    """Date offset by ndays (mod_calendar.F90 date_offset)."""
    return daynum_to_date(calendar, date_to_daynum(calendar, d) + ndays)


def days_in_year(calendar: str, year: int) -> int:
    """Days in `year`."""
    return daynum_diff(calendar, Date(year, 1, 1), Date(year + 1, 1, 1))


def day_of_year(calendar: str, d: Date) -> int:
    """1-based day of year (mod_time.F90 set_day_of_year semantics)."""
    return daynum_diff(calendar, Date(d.year, 1, 1), d) + 1
