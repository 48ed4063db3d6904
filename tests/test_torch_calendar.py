"""The port's calendars, clock table and freezing coefficients against
blom_tpu's, exactly.

Every calendar of blom_tpu/core/calendar.py (julian, gregorian, standard,
proleptic_gregorian, noleap, 365_day, all_leap, 366_day, 360_day):
`daynum_to_date` over a span of day numbers that crosses the 1582
Julian-Gregorian transition, leap days and year ends, and
`date_to_daynum`, `daynum_diff`, `date_offset`, `days_in_year` and
`day_of_year` on those dates and on random offsets made from a seed with
numpy; `init_timevars` for every expcnf of `_EXPCNF_CALENDAR`, with the
clock stepped over a year end and its month weights; `init_eos` for
every expcnf of `_FREEZE_COEFFS`."""

import dataclasses

import numpy as np
import pytest

from blom_tpu.core import calendar as jcal
from blom_tpu.core import eos as jeos
from blom_tpu.core import modeltime as jmt
from blom_tpu_torch.core import calendar as tcal
from blom_tpu_torch.core import eos as teos
from blom_tpu_torch.core import modeltime as tmt

CALENDARS = ('julian', 'gregorian', 'standard', 'proleptic_gregorian',
             'noleap', '365_day', 'all_leap', '366_day', '360_day')


def _t(d):
    return (d.year, d.month, d.day)


@pytest.mark.parametrize('calendar', CALENDARS)
def test_calendar_matches_blom_tpu(calendar):
    # day numbers of 1581-03-01 .. 1584-03-01 (the transition) and of
    # 1999-11-01 .. 2001-03-01 (leap days, year ends) in either calendar
    spans = []
    for d0, d1 in ((jcal.Date(1581, 3, 1), jcal.Date(1584, 3, 1)),
                   (jcal.Date(1999, 11, 1), jcal.Date(2001, 3, 1))):
        a = jcal.date_to_daynum(calendar, d0)
        spans.append(range(a, jcal.date_to_daynum(calendar, d1)))
    rng = np.random.default_rng(20)
    offsets = rng.integers(-800_000, 800_000, 64).tolist()
    ndays = 0
    for span in spans:
        for dn in span:
            jd = jcal.daynum_to_date(calendar, dn)
            td = tcal.daynum_to_date(calendar, dn)
            assert _t(td) == _t(jd), dn
            assert tcal.date_to_daynum(calendar, td) == dn
            assert tcal.day_of_year(calendar, td) \
                == jcal.day_of_year(calendar, jd)
            ndays += 1
        for off in offsets:
            jd0 = jcal.daynum_to_date(calendar, span[0])
            td0 = tcal.daynum_to_date(calendar, span[0])
            jd1 = jcal.date_offset(calendar, jd0, off)
            td1 = tcal.date_offset(calendar, td0, off)
            assert _t(td1) == _t(jd1), off
            assert tcal.daynum_diff(calendar, td0, td1) \
                == jcal.daynum_diff(calendar, jd0, jd1) == off
    assert ndays > 1500
    for year in range(1580, 1590):
        assert tcal.days_in_year(calendar, year) \
            == jcal.days_in_year(calendar, year)
    for year in (1900, 2000, 2001, 2004, 2100):
        assert tcal.days_in_year(calendar, year) \
            == jcal.days_in_year(calendar, year)


def test_calendar_refuses_as_blom_tpu_does():
    with pytest.raises(ValueError):
        jcal.date_to_daynum('standard', jcal.Date(1582, 10, 10))
    with pytest.raises(ValueError):
        tcal.date_to_daynum('standard', tcal.Date(1582, 10, 10))
    for mod in (jcal, tcal):
        with pytest.raises(ValueError, match='unsupported calendar'):
            mod.daynum_to_date('lunar', 0)


@pytest.mark.parametrize('expcnf', sorted(jmt._EXPCNF_CALENDAR))
def test_init_timevars_matches_blom_tpu(expcnf):
    assert tmt._EXPCNF_CALENDAR == jmt._EXPCNF_CALENDAR
    kw = dict(baclin=1800., batrop=60., idate=20001230, idate0=19990101)
    jc = jmt.init_timevars(expcnf, **kw)
    tc = tmt.init_timevars(expcnf, **kw)
    for _ in range(3 * 48 + 5):       # across the year end
        ja = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
        ta = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
        ja['date0'], ja['date'] = _t(ja['date0']), _t(ja['date'])
        ta['date0'], ta['date'] = _t(ta['date0']), _t(ta['date'])
        assert ta == ja
        assert (tc.delt1, tc.nday_in_year, tc.nday_of_year,
                tc.month_interp(), tc.ymd_tod()) \
            == (jc.delt1, jc.nday_in_year, jc.nday_of_year,
                jc.month_interp(), jc.ymd_tod())
        jc, tc = jc.step(), tc.step()


@pytest.mark.parametrize('expcnf', sorted(jeos._FREEZE_COEFFS))
def test_init_eos_matches_blom_tpu(expcnf):
    j = jeos.init_eos(pref=2000.e4, expcnf=expcnf)
    t = teos.init_eos(pref=2000.e4, expcnf=expcnf)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
