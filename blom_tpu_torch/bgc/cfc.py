"""CFC-11, CFC-12 and SF6, the transient tracers.

Counterpart of `blom_tpu/bgc/cfc.py` (BLOM's use_CFC option: the
Schmidt numbers of hamocc/mo_carchm.F90:285-300, the Warner & Weiss 1985
and Bullister 2002 solubilities of :340-360, and the surface fluxes
against hemisphere-blended atmospheric histories of :500-530 with
mo_get_cfc.F90).  Elementwise; integer powers are products in
blom_tpu's order and a number over a tensor divides as blom_tpu does
(chemistry.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import chemistry as chem
from .chemistry import _over

XCONVXA = 6.97e-7


class CfcAtm(NamedTuple):
    """Atmospheric concentrations per hemisphere [ppt]
    (get_cfc, mo_get_cfc.F90)."""
    cfc11_nh: float = 0.
    cfc11_sh: float = 0.
    cfc12_nh: float = 0.
    cfc12_sh: float = 0.
    sf6_nh: float = 0.
    sf6_sh: float = 0.


def schmidt_cfc(t):
    """Schmidt numbers (Wanninkhof 2014; mo_carchm.F90:289-293)."""
    t2 = t * t
    t3, t4 = t * t2, t2 * t2
    sch11 = 3579.2 - 222.63 * t + 7.5749 * t2 - 0.14595 * t3 \
        + 0.0011874 * t4
    sch12 = 3828.1 - 249.86 * t + 8.7603 * t2 - 0.1716 * t3 \
        + 0.001408 * t4
    schsf = 3177.5 - 200.57 * t + 6.8865 * t2 - 0.13335 * t3 \
        + 0.0010877 * t4
    return sch11, sch12, schsf


def solubility_cfc(t, s):
    """Solubilities [kmol m-3 pptv-1] (Warner & Weiss 1985; Bullister
    et al. 2002; mo_carchm.F90:340-358)."""
    tk = t + chem.TZERO
    tk100 = tk / 100.
    tk1002 = tk100 * tk100
    a11 = torch.exp(-229.9261 + 319.6552 * _over(100., tk)
                    + 119.4471 * torch.log(tk100) - 1.39165 * tk1002
                    + s * (-0.142382 + 0.091459 * tk100
                           - 0.0157274 * tk1002))
    a12 = torch.exp(-218.0971 + 298.9702 * _over(100., tk)
                    + 113.8049 * torch.log(tk100) - 1.39165 * tk1002
                    + s * (-0.143566 + 0.091015 * tk100
                           - 0.0153924 * tk1002))
    asf = torch.exp(-80.0343 + 117.232 * _over(100., tk)
                    + 29.5817 * torch.log(tk100)
                    + s * (0.033518 - 0.0373942 * tk100
                           + 0.00774862 * tk1002))
    return a11 * 1.e-12, a12 * 1.e-12, asf * 1.e-12


def hemisphere_blend(plat, nh, sh):
    """Linear blend across 10S-10N (mo_carchm.F90:505-517)."""
    fact = torch.clamp((plat + 10.) / 20., 0., 1.)
    return fact * nh + (1. - fact) * sh


def cfc_exchange(cfc11, cfc12, sf6, t0, s0, plat, fu10, fice, slp,
                 dz0, wet0, atm: CfcAtm, dtsec):
    """Surface fluxes of the three gases, updating the surface-layer
    concentrations (mo_carchm.F90:500-530).

    cfc11/cfc12/sf6: (K, J, I) concentrations [kmol/m3]; t0/s0 the
    surface T/S.  Returns the updated tracers (new tensors) and the
    fluxes [kmol m-2/step]."""
    sch11, sch12, schsf = schmidt_cfc(torch.clamp(t0, -2., 40.))
    a11, a12, asf = solubility_cfc(torch.clamp(t0, chem.TEMP_MIN,
                                               chem.TEMP_MAX),
                                   torch.clamp(s0, chem.SALN_MIN,
                                               chem.SALN_MAX))
    opn = 1. - fice
    piston = opn * XCONVXA * (fu10 * fu10)
    kw11 = piston * torch.sqrt(_over(660., sch11))
    kw12 = piston * torch.sqrt(_over(660., sch12))
    kwsf = piston * torch.sqrt(_over(660., schsf))

    rpp0 = slp / 101325.
    at11 = hemisphere_blend(plat, atm.cfc11_nh, atm.cfc11_sh)
    at12 = hemisphere_blend(plat, atm.cfc12_nh, atm.cfc12_sh)
    atsf = hemisphere_blend(plat, atm.sf6_nh, atm.sf6_sh)

    flx11 = kw11 * dtsec * (a11 * at11 * rpp0 - cfc11[0])
    flx12 = kw12 * dtsec * (a12 * at12 * rpp0 - cfc12[0])
    flxsf = kwsf * dtsec * (asf * atsf * rpp0 - sf6[0])

    dz0s = torch.clamp_min(dz0, 1.e-12)
    out = []
    for c, flx in ((cfc11, flx11), (cfc12, flx12), (sf6, flxsf)):
        c = c.clone()
        c[0] = c[0] + torch.where(wet0, flx / dz0s, 0.)
        out.append(c)
    return (*out, {'flx11': flx11, 'flx12': flx12, 'flxsf': flxsf})
