"""Quadratic 5-point time interpolation of climatological fields.

Counterpart of `blom_tpu/phys/intp1d.py` (BLOM's mod_intp1d.F90:20-60):
a quadratic fitted through five consecutive climatology slices,
evaluated at the fractional position x in [0, 1) between the 2nd and
4th slice.  Elementwise on tensors or numbers."""

from __future__ import annotations

_A1, _A2, _A3 = -3. / 7., -15. / 7., 3. / 2.
_B1, _B2, _B3, _B4, _B5 = 4. / 7., -16. / 7., 15. / 7., -5. / 7., 2. / 7.
_C1, _C2 = -1. / 7., 9. / 14.


def intp1d(d1, d2, d3, d4, d5, x):
    a = _A1 * (d1 + d5) + _A2 * d3 + _A3 * (d2 + d4)
    b = _B1 * d1 + _B2 * d2 + _B3 * d3 + _B4 * d4 + _B5 * d5
    c = _C1 * (d1 + d4) + _C2 * (d2 + d3)
    return (a * x + b) * x + c


def clim_indices(nday_of_year, frac_of_day, nslices: int = 48,
                 nday_in_year: float = 365.):
    """Slice indices and weight for an nslices-per-year climatology (the
    m1..m5/y bookkeeping of mod_thermf_ben02.F90:103-112): (i1, i2, i3,
    i4, i5, x), the indices 0-based."""
    y = (nday_of_year - 1 + frac_of_day) * nslices / nday_in_year
    m3 = int(y) + 1
    x = y - (m3 - 1)
    m1 = (m3 + nslices - 3) % nslices
    m2 = (m3 + nslices - 2) % nslices
    m4 = m3 % nslices
    m5 = (m3 + 1) % nslices
    return m1, m2, m3 - 1, m4, m5, x
