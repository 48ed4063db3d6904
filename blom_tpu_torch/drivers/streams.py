"""Forcing data streams for the coupled cap.

Counterpart of `blom_tpu/drivers/streams.py`: BLOM's dshr-based stream
readers (drivers/nuopc/ocn_stream_sst.F90, ocn_stream_sss.F90,
ocn_stream_dust.F90: each positions a time series of monthly records,
aligns a data year range to the model calendar and interpolates
linearly between the bracketing records) and mod_swtfrz.F90 (the CESM
shared freezing temperature, so that the ocean and the sea ice agree).

Records stay host numpy; `interp` returns a tensor on the device it is
given.  Missing and land points are flood-filled at load (fill_global,
as ocn_stream_sst.F90:252-266 does after its interpolation)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Stream:
    """One data stream: (T, J, I) records at mid-month times.

    year_first/year_last select the data years used; year_align maps
    model year `year_align` onto data year year_first, and the data
    range repeats cyclically outside it (dshr stream semantics)."""
    data: np.ndarray          # (T, J, I)
    day_of_year: np.ndarray   # (T,) mid-record day within the year
    year: np.ndarray          # (T,) data year of each record
    year_first: int
    year_last: int
    year_align: int
    nday_in_year: float = 365.

    def _data_year(self, model_year: int) -> int:
        nyr = self.year_last - self.year_first + 1
        return self.year_first + (model_year - self.year_align) % nyr

    def interp(self, model_year: int, day: float, device='cpu',
               dtype=torch.float64):
        """Linear time interpolation at `day` (fractional day of the
        year) of model year `model_year`: a (J, I) tensor on `device`,
        interpolated in f64 on the host and copied once."""
        dy = self._data_year(model_year)
        sel = self.year == dy
        days = self.day_of_year[sel]
        recs = self.data[sel]
        if len(days) == 0:
            raise ValueError(f'stream has no records for data year {dy}')
        # cyclic bracketing within the year (December -> January wrap)
        if day <= days[0]:
            t0, t1 = len(days) - 1, 0
            span = days[0] + self.nday_in_year - days[-1]
            w1 = (day + self.nday_in_year - days[-1]) / span
        elif day >= days[-1]:
            t0, t1 = len(days) - 1, 0
            span = days[0] + self.nday_in_year - days[-1]
            w1 = (day - days[-1]) / span
        else:
            t1 = int(np.searchsorted(days, day))
            t0 = t1 - 1
            w1 = (day - days[t0]) / (days[t1] - days[t0])
        out = (1. - w1) * recs[t0] + w1 * recs[t1]
        return torch.as_tensor(out, dtype=dtype).to(device)


def monthly_stream(fields, year_first: int, year_last: int,
                   year_align: int, nday_in_year: float = 365.,
                   fill_mask=None) -> Stream:
    """A stream from per-year monthly fields.

    fields: (nyears, 12, J, I) or (12, J, I) (a climatology, repeated);
    fill_mask: a (J, I) 0/1 wet mask; masked-out points are flood-filled
    (fill_global, mod_fill_global.F90) so that the interpolation next to
    coasts never mixes in fill values."""
    f = np.asarray(fields, np.float64)
    if f.ndim == 3:
        f = f[None]
    nyears = f.shape[0]
    if fill_mask is not None:
        from ..core.geoenv import fill_global
        mask = np.asarray(fill_mask) > 0
        f = np.stack([np.stack([fill_global(np.where(mask, rec, np.nan),
                                            np.nan) for rec in yr])
                      for yr in f])
    # mid-month days of a uniform 12-month split
    dpm = nday_in_year / 12.
    dmid = np.asarray([(i + .5) * dpm for i in range(12)])
    years = np.arange(year_first, year_first + max(
        nyears, year_last - year_first + 1))
    day = np.tile(dmid, len(years))
    yr = np.repeat(years, 12)
    data = np.concatenate([f[min(i, nyears - 1)] for i in
                           range(len(years))], axis=0)
    return Stream(data=data, day_of_year=day, year=yr,
                  year_first=year_first,
                  year_last=max(year_last, year_first + nyears - 1),
                  year_align=year_align, nday_in_year=nday_in_year)


def stream_from_netcdf(path: str, varname: str, year_first: int,
                       year_last: int, year_align: int,
                       fill_mask=None) -> Stream:
    """Read a monthly stream file (the data_filename list of
    &stream_sst/&stream_sss/&stream_dust, ocn_stream_*.F90:60-130)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, 'r', mmap=False) as nc:
        var = nc.variables[varname]
        data = np.array(var[:], np.float64)
        if hasattr(var, 'scale_factor'):
            data = data * float(var.scale_factor)
    return monthly_stream(data, year_first, year_last, year_align,
                          fill_mask=fill_mask)


# ------------------------------------------------------------------ #
# freezing temperature (mod_swtfrz.F90 -> shr_frz_freezetemp)
# ------------------------------------------------------------------ #

TFREEZE_OPTIONS = ('minus1p8', 'linear_salt', 'mushy')


def swtfrz(s, option: str = 'minus1p8'):
    """Freezing temperature of sea water [deg C] by the CESM shared
    function (shr_frz_mod options; mod_swtfrz.F90 delegates to it so
    that the ocean and the sea ice agree on the freezing point)."""
    s = torch.as_tensor(s)
    if option == 'minus1p8':
        return torch.full_like(s, -1.8)
    if option == 'linear_salt':
        return -0.0544 * s
    if option == 'mushy':
        # shr_frz mushy-layer liquidus fit
        return s / (-18.48 + 0.01848 * s)
    raise ValueError(option)
