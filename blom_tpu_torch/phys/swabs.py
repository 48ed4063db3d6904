"""Shortwave absorption profiles.

Counterpart of `blom_tpu/phys/swabs.py` (BLOM's mod_swabs.F90), every
method: 'jerlov', the Paulson & Simpson (1977) double-exponential fit to
the Jerlov (1968) water types (ps77 tables, mod_swabs.F90:95-107);
'top-layer'; 'chlorophyll_ma94', the modified Morel & Antoine (1994)
chlorophyll-dependent transmission (polynomials in log10 chl,
mod_swabs.F90:109-128, updswa :653-686); 'chlorophyll_ohl03', the
Ohlmann (2003) two-band fit through a 401-entry lookup table
interpolated from its Table 1a (mod_swabs.F90:130-178, iniswa :405-435,
updswa :688-710); and 'spatial_frac_attlen', per-point fractions and
attenuation lengths that the caller supplies (mod_swabs.F90:451-608)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .intp1d import intp1d

swamxd = 200.       # max shortwave penetration depth [m] (mod_swabs.F90:183)

# Jerlov water types I, IA, IB, II, III (mod_swabs.F90:104-107)
ps77_irfc = (.58, .62, .67, .77, .78)
ps77_al1 = (.35, .60, 1.00, 1.50, 1.40)
ps77_al2 = (23.00, 20.00, 17.00, 14.00, 7.90)

# Modified Morel & Antoine (1994) coefficients (mod_swabs.F90:120-128):
# the infrared surface-absorbed fraction (Sweeney et al. 2005) and the
# degree-5 polynomials in log10(chl) of the short-band fraction (v2) and
# of the two attenuation lengths (z1, z2).
ma94_irfc = .43
ma94_v2 = (.679, -.008, -.132, -.038, .017, .007)
ma94_z1 = (1.540, -.197, .166, -.252, -.055, .042)
ma94_z2 = (7.925, -6.644, 3.662, -1.815, -.218, .502)

# Ohlmann (2003) Table 1a: E(z)/E(0) = A1 exp(-B1 z) + A2 exp(-B2 z)
# against chlorophyll concentration (mod_swabs.F90:131-178).
chl_tab1a = np.array([
    .001, .005, .01, .02, .03, .05, .10, .15, .20, .25, .30, .35, .40,
    .45, .50, .60, .70, .80, .90, 1.00, 1.50, 2.00, 2.50, 3.00, 4.00,
    5.00, 6.00, 7.00, 8.00, 9.00, 10.00])
a1_tab1a = np.array([
    0.4421, 0.4451, 0.4488, 0.4563, 0.4622, 0.4715, 0.4877, 0.4993,
    0.5084, 0.5159, 0.5223, 0.5278, 0.5326, 0.5369, 0.5408, 0.5474,
    0.5529, 0.5576, 0.5615, 0.5649, 0.5757, 0.5802, 0.5808, 0.5788,
    0.56965, 0.55638, 0.54091, 0.52442, 0.50766, 0.49110, 0.47505])
a2_tab1a = np.array([
    0.2981, 0.2963, 0.2940, 0.2894, 0.2858, 0.2800, 0.2703, 0.2628,
    0.2571, 0.2523, 0.2481, 0.2444, 0.2411, 0.2382, 0.2356, 0.2309,
    0.2269, 0.2235, 0.2206, 0.2181, 0.2106, 0.2089, 0.2113, 0.2167,
    0.23357, 0.25504, 0.27829, 0.30274, 0.32698, 0.35056, 0.37303])
b1_tab1a = np.array([
    0.0287, 0.0301, 0.0319, 0.0355, 0.0384, 0.0434, 0.0532, 0.0612,
    0.0681, 0.0743, 0.0800, 0.0853, 0.0902, 0.0949, 0.0993, 0.1077,
    0.1154, 0.1227, 0.1294, 0.1359, 0.1640, 0.1876, 0.2082, 0.2264,
    0.25808, 0.28498, 0.30844, 0.32932, 0.34817, 0.36540, 0.38132])
b2_tab1a = np.array([
    0.3192, 0.3243, 0.3306, 0.3433, 0.3537, 0.3705, 0.4031, 0.4262,
    0.4456, 0.4621, 0.4763, 0.4889, 0.4999, 0.5100, 0.5191, 0.5347,
    0.5477, 0.5588, 0.5682, 0.5764, 0.6042, 0.6206, 0.6324, 0.6425,
    0.66172, 0.68144, 0.70086, 0.72144, 0.74178, 0.76190, 0.78155])

nval_lut = 401                      # LUT resolution (mod_swabs.F90:132-133)
chl10_min, chl10_max = -2., 1.      # log10 chl clamp (mod_swabs.F90:180-182)


def _ohl03_lut():
    """The Ohlmann (2003) tables interpolated onto a uniform log10(chl)
    grid (iniswa, mod_swabs.F90:405-435): (a1, a2, b1, b2,
    log10chl_min, dlog10chl)."""
    lmin = np.log10(chl_tab1a[0])
    lmax = np.log10(chl_tab1a[-1])
    dlog = (lmax - lmin) / (nval_lut - 1)
    chl = np.clip(10.0 ** (lmin + np.arange(nval_lut) * dlog),
                  chl_tab1a[0], chl_tab1a[-1])
    return (np.interp(chl, chl_tab1a, a1_tab1a),
            np.interp(chl, chl_tab1a, a2_tab1a),
            np.interp(chl, chl_tab1a, b1_tab1a),
            np.interp(chl, chl_tab1a, b2_tab1a),
            lmin, dlog)


_A1_LUT, _A2_LUT, _B1_LUT, _B2_LUT, _LOG10CHL_MIN, _DLOG10CHL = _ohl03_lut()


@dataclasses.dataclass
class SwabsFields:
    """Absorption profile E(z)/E(0) = swfc1*exp(-z/swal1)
    + swfc2*exp(-z/swal2) (mod_swabs.F90:27-33); all (jdm, idm)."""
    swfc1: torch.Tensor
    swfc2: torch.Tensor
    swal1: torch.Tensor    # [m]
    swal2: torch.Tensor    # [m]


def _poly5(c, q):
    return ((((c[5] * q + c[4]) * q + c[3]) * q + c[2]) * q + c[1]) * q + c[0]


def swabs_from_chl(chl10, swamth: str = 'chlorophyll_ma94') -> SwabsFields:
    """Fractions and attenuation lengths from a log10-chlorophyll field
    (updswa, mod_swabs.F90:645-711)."""
    q = torch.clamp(chl10, chl10_min, chl10_max)
    if swamth == 'chlorophyll_ma94':
        v2 = _poly5(ma94_v2, q)
        return SwabsFields(swfc1=(1. - ma94_irfc) * (1. - v2),
                           swfc2=(1. - ma94_irfc) * v2,
                           swal1=_poly5(ma94_z1, q),
                           swal2=_poly5(ma94_z2, q))
    if swamth == 'chlorophyll_ohl03':
        # the nearest table entry (rounded half to even, as blom_tpu's
        # jnp.round); the table's long band (A2, 1/B2) is (swfc1, swal1)
        # (mod_swabs.F90:690-694)
        n = torch.round((q - _LOG10CHL_MIN) / _DLOG10CHL).to(torch.int64)
        n = torch.clamp(n, 0, nval_lut - 1)

        def lut(tab):
            return torch.as_tensor(tab, dtype=q.dtype, device=q.device)[n]
        return SwabsFields(swfc1=lut(_A2_LUT), swfc2=lut(_A1_LUT),
                           swal1=1.0 / lut(_B2_LUT),
                           swal2=1.0 / lut(_B1_LUT))
    raise ValueError(f'swamth={swamth!r} is not chlorophyll-based')


def updswa(swamth: str, chl10c, month_interp) -> SwabsFields:
    """The time-dependent absorption fields from a 12-month log10-chl
    climatology chl10c (12, jdm, idm) at the clock's month_interp()
    weights (updswa, mod_swabs.F90:611-732)."""
    xmi, l1, l2, l3, l4, l5 = month_interp
    chl10 = intp1d(chl10c[l1 - 1], chl10c[l2 - 1], chl10c[l3 - 1],
                   chl10c[l4 - 1], chl10c[l5 - 1], xmi)
    return swabs_from_chl(chl10, swamth)


def init_swabs(shape, swamth: str = 'jerlov', jwtype: int = 3,
               dtype=torch.float64, device='cpu', chl10c=None,
               fields=None) -> SwabsFields:
    """Initial absorption fields (iniswa, mod_swabs.F90:219-609).

    The chlorophyll methods take chl10c (12, jdm, idm), a monthly log10
    chlorophyll climatology (read upstream, as blom_tpu's case builder
    does with the NetCDF 'chlor_a' of mod_swabs.F90:278-399);
    'spatial_frac_attlen' takes its SwabsFields as `fields` (the svfile
    of mod_swabs.F90:451-608)."""
    ones = torch.ones(tuple(shape), dtype=dtype, device=device)
    if swamth == 'jerlov':
        fc1 = ps77_irfc[jwtype - 1]
        return SwabsFields(swfc1=ones * fc1, swfc2=ones * (1. - fc1),
                           swal1=ones * ps77_al1[jwtype - 1],
                           swal2=ones * ps77_al2[jwtype - 1])
    if swamth == 'top-layer':
        # no penetration below the surface: all of it absorbed in the
        # top layer (mod_swabs.F90:236-244)
        return SwabsFields(swfc1=ones * 0., swfc2=ones * 0.,
                           swal1=ones * swamxd, swal2=ones * swamxd)
    if swamth in ('chlorophyll_ma94', 'chlorophyll_ohl03'):
        if chl10c is None:
            raise ValueError('chlorophyll methods need a chl10c '
                             'climatology (mod_swabs.F90:437-448)')
        return swabs_from_chl(torch.as_tensor(chl10c[0], dtype=dtype,
                                              device=device), swamth)
    if swamth == 'spatial_frac_attlen':
        if fields is None:
            raise ValueError('spatial_frac_attlen needs precomputed '
                             'fields (mod_swabs.F90:451-608)')
        return fields
    raise ValueError(f'swamth={swamth!r} is unsupported '
                     '(mod_swabs.F90:602-607)')
