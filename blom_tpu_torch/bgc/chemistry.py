"""Carbonate-system chemistry: equilibrium constants and pH solver.

Counterpart of `blom_tpu/bgc/chemistry.py` (BLOM's hamocc/mo_carchm.F90
carchm_kequi / carchm_solve / carchm_solve_dicsat and mo_chemcon.F90
constants).  Everything is elementwise over tensors of any shape; the
pH solve runs a fixed `niter` passes as a Python loop (BLOM exits early
on |erel| < 5e-5; the extra passes are no-ops once converged).

Integer powers are written as products in blom_tpu's order (`x * x`,
`x * (x * x)`, `(x * x) * (x * x)`: what jnp's integer powers compute),
fractional powers and powers of ten as powers, and a Python number over
a tensor as a tensor division (`_over`): PyTorch computes `c / x` as
`c * (1 / x)`, an ulp from blom_tpu's division.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# mo_chemcon.F90 constants
TZERO = 273.15
BOR1 = 0.000232
BOR2 = 1. / 10.811
SALCHL = 1. / 1.80655
CALCON = 0.01028
OXYCO = 1. / 22414.4
RGAS = 83.131  # bar cm3 / (mol K) as used in the pressure correction

# O2 solubility, Weiss 1970 (mo_chemcon.F90:79-85)
OX = (-173.4292, 249.6339, 143.3483, -21.8492, -0.033096, 0.014259,
      -0.0017)
# N2 solubility (mo_chemcon.F90:93-99)
AN = (-172.4965, 248.4262, 143.0738, -21.7120, -0.049781, 0.025018,
      -0.0034861)
# CO2 solubility Weiss 1974 (mo_chemcon.F90:121-126)
AD1, AD2, AD3 = -60.2409, 93.4517, 23.3585
BD1, BD2, BD3 = 0.023517, -0.023656, 0.0047036
# N2O solubility, Weiss & Price 1980 (mo_chemcon.F90:134-140)
AL = (-165.8806, 222.8743, 92.0792, -1.48425)
BL = (-0.056235, 0.031619, -0.0048472)

# pressure corrections, Millero 95 (mo_chemcon.F90:178-191); order:
# K1 K2 Kb Kw Ks Kf Kspc Kspa K1p K2p K3p
PA0 = (-25.5, -15.82, -29.48, -25.60, -18.03, -9.78, -48.76, -46.,
       -14.51, -23.12, -26.57)
PA1 = (0.1271, -0.0219, 0.1622, 0.2324, 0.0466, -0.0090, 0.5304,
       0.5304, 0.1211, 0.1758, 0.2020)
PA2 = (0.0, 0.0, 2.608e-3, -3.6246e-3, 0.316e-3, -0.942e-3, 0.0, 0.0,
       -0.321e-3, -2.647e-3, -3.042e-3)
PB0 = (-3.08e-3, 1.13e-3, -2.84e-3, -5.13e-3, -4.53e-3, -3.91e-3,
       -11.76e-3, -11.76e-3, -2.67e-3, -5.15e-3, -4.08e-3)
PB1 = (0.0877e-3, -0.1475e-3, 0.0, 0.0794e-3, 0.09e-3, 0.054e-3,
       0.3692e-3, 0.3692e-3, 0.0427e-3, 0.09e-3, 0.0714e-3)

TEMP_MIN, TEMP_MAX = -1.0, 40.0
SALN_MIN, SALN_MAX = 5.0, 40.0


def _over(c, x):
    """c / x for a number (or tensor) c over a tensor x, divided as
    blom_tpu divides.  A number becomes a 0-d CPU tensor, which a CUDA
    operation takes as a scalar argument, with no copy to the card."""
    return torch.as_tensor(c, dtype=x.dtype) / x


class Kequi(NamedTuple):
    Kh0: torch.Tensor
    K1: torch.Tensor
    K2: torch.Tensor
    Kb: torch.Tensor
    Kw: torch.Tensor
    Ks1: torch.Tensor
    Kf: torch.Tensor
    Ksi: torch.Tensor
    K1p: torch.Tensor
    K2p: torch.Tensor
    K3p: torch.Tensor
    Kspc: torch.Tensor
    Kspa: torch.Tensor


def kequi(temp, saln, prb) -> Kequi:
    """Equilibrium constants of the carbonate system at (T, S, p[bar])
    (carchm_kequi, mo_carchm.F90:731-865)."""
    t = torch.clamp(temp, TEMP_MIN, TEMP_MAX)
    s = torch.clamp(saln, SALN_MIN, SALN_MAX)
    tk = t + TZERO
    tk100 = tk / 100.
    invtk = _over(1., tk)
    dlogtk = torch.log(tk)
    ionst = 19.924 * s / (1000. - 1.005 * s)
    is2 = ionst * ionst
    sqrtis = torch.sqrt(ionst)
    s15 = s ** 1.5
    s2 = s * s
    sqrts = torch.sqrt(s)
    scl = s * SALCHL

    # CO2 solubility (Weiss 1974) [mol/kg/atm]
    Kh0 = torch.exp(AD1 + _over(AD2, tk100) + AD3 * torch.log(tk100)
                    + s * (BD1 + BD2 * tk100 + BD3 * (tk100 * tk100)))
    # carbonic acid, Waters et al. 2014, total scale
    pK01 = -126.34048 + 6320.813 * invtk + 19.568224 * dlogtk
    pK02 = -90.18333 + 5143.692 * invtk + 14.613358 * dlogtk
    K1 = torch.pow(10., -(pK01 + 13.568513 * sqrts + 0.031645 * s
                          - 5.3834e-5 * s2 - 539.2304 * sqrts * invtk
                          - 5.635 * s * invtk
                          - 2.0901396 * sqrts * dlogtk))
    K2 = torch.pow(10., -(pK02 + 21.389248 * sqrts + 0.12452358 * s
                          - 3.7447e-4 * s2 - 787.3736 * sqrts * invtk
                          - 19.84233 * s * invtk
                          - 3.3773006 * sqrts * dlogtk))
    # boric acid, Millero 95 / Dickson 90
    Kb = torch.exp((-8966.90 - 2890.53 * sqrts - 77.942 * s
                    + 1.728 * s15 - 0.0996 * s2) * invtk
                   + (148.0248 + 137.1942 * sqrts + 1.62142 * s)
                   + (-24.4344 - 25.085 * sqrts - 0.2474 * s) * dlogtk
                   + 0.053105 * sqrts * tk)
    # phosphoric acid, DOE 94
    K1p = torch.exp(-4576.752 * invtk + 115.525 - 18.453 * dlogtk
                    + (-106.736 * invtk + 0.69171) * sqrts
                    + (-0.65643 * invtk - 0.01844) * s)
    K2p = torch.exp(-8814.715 * invtk + 172.0883 - 27.927 * dlogtk
                    + (-160.340 * invtk + 1.3566) * sqrts
                    + (0.37335 * invtk - 0.05778) * s)
    K3p = torch.exp(-3070.75 * invtk - 18.141
                    + (17.27039 * invtk + 2.81197) * sqrts
                    + (-44.99486 * invtk - 0.09984) * s)
    # silicic acid, Millero 95
    Ksi = torch.exp(-8904.2 * invtk + 117.385 - 19.334 * dlogtk
                    + (-458.79 * invtk + 3.5913) * sqrtis
                    + (188.74 * invtk - 1.5998) * ionst
                    + (-12.1652 * invtk + 0.07871) * is2
                    + torch.log(1. - 0.001005 * s))
    # water, Millero 95
    Kw = torch.exp(-13847.26 * invtk + 148.9652 - 23.6521 * dlogtk
                   + (118.67 * invtk - 5.977 + 1.0495 * dlogtk) * sqrts
                   - 0.01615 * s)
    # bisulfate, Dickson 90
    Ks1 = torch.exp(-4276.1 * invtk + 141.328 - 23.093 * dlogtk
                    + (-13856. * invtk + 324.57 - 47.986 * dlogtk) * sqrtis
                    + (35474. * invtk - 771.54 + 114.723 * dlogtk) * ionst
                    - 2698. * invtk * ionst ** 1.5 + 1776. * invtk * is2
                    + torch.log(1. - 0.001005 * s))
    # hydrogen fluoride, Dickson & Riley 79 (total scale)
    Kf = torch.exp(1590.2 * invtk - 12.641 + 1.525 * sqrtis
                   + torch.log(1. - 0.001005 * s)
                   + torch.log(1. + (0.1400 / 96.062) * scl / Ks1))
    # calcite/aragonite solubility, Mucci 83
    log10tk = dlogtk / math.log(10.)
    Kspc = torch.pow(10., (-171.9065 - 0.077993 * tk + _over(2839.319, tk)
                           + 71.595 * log10tk
                           + (-0.77712 + 0.0028426 * tk
                              + _over(178.34, tk)) * sqrts
                           - 0.07711 * s + 0.0041249 * s15))
    Kspa = torch.pow(10., (-171.945 - 0.077993 * tk + _over(2903.293, tk)
                           + 71.595 * log10tk
                           + (-0.068393 + 0.0017276 * tk
                              + _over(88.135, tk)) * sqrts
                           - 0.10018 * s + 0.0059415 * s15))

    # pressure effect (Millero 95), valid for S=35
    ks = [K1, K2, Kb, Kw, Ks1, Kf, Kspc, Kspa, K1p, K2p, K3p]
    zprb = prb / (RGAS * tk)
    zprb2 = prb * zprb
    out = []
    for j, K in enumerate(ks):
        deltav = PA0[j] + PA1[j] * t + PA2[j] * t * t
        deltak = PB0[j] + PB1[j] * t
        out.append(K * torch.exp(-(deltav * zprb + 0.5 * deltak * zprb2)))
    K1, K2, Kb, Kw, Ks1, Kf, Kspc, Kspa, K1p, K2p, K3p = out
    return Kequi(Kh0, K1, K2, Kb, Kw, Ks1, Kf, Ksi, K1p, K2p, K3p,
                 Kspc, Kspa)


def _minor_alk(saln, sit, pt, ah1, k: Kequi):
    """Alkalinity contributions of the minor acid/base systems at [H+]
    = ah1 (shared body of carchm_solve / carchm_solve_dicsat,
    mo_carchm.F90:905-916)."""
    s = torch.clamp(saln, SALN_MIN, SALN_MAX)
    scl = s * SALCHL
    borat = BOR1 * scl * BOR2
    sti = 0.14 * scl / 96.062
    ft = 0.000067 * scl / 18.9984
    hso4 = sti / (1. + k.Ks1 / (ah1 / (1. + sti / k.Ks1)))
    hf = _over(1., 1. + k.Kf / ah1)
    hsi = _over(1., 1. + ah1 / k.Ksi)
    ah2 = ah1 * ah1
    ah3 = ah1 * ah2
    hpo4 = ((k.K1p * k.K2p * (ah1 + 2. * k.K3p) - ah3)
            / (ah3 + k.K1p * ah2 + k.K1p * k.K2p * ah1
               + k.K1p * k.K2p * k.K3p))
    ab = borat / (1. + ah1 / k.Kb)
    aw = k.Kw / ah1 - ah1 / (1. + sti / k.Ks1)
    return hso4 - sit * hsi - ab - aw + ft * hf - pt * hpo4


def solve_h(saln, tc, ta, sit, pt, k: Kequi, ah1, niter: int = 20,
            ah_min: float = 1.e-11, ah_max: float = 1.e-5):
    """Iterate [H+] and carbonate alkalinity from DIC + total
    alkalinity (carchm_solve, mo_carchm.F90:868-931).  All
    concentrations in mol/kg; returns (ah, ac)."""
    ah, ac = ah1, None
    for _ in range(niter):
        ac = ta + _minor_alk(saln, sit, pt, ah, k)
        d = tc - ac
        ah2o = torch.sqrt(d * d + 4. * (ac * k.K2 / k.K1) * (2. * tc - ac))
        ah2 = 0.5 * k.K1 / ac * ((tc - ac) + ah2o)
        ah = torch.clamp(ah2, ah_min, ah_max)
    if ac is None:
        ac = ta + _minor_alk(saln, sit, pt, ah1, k)
    return ah, ac


def solve_dicsat(saln, co2_sat, ta, sit, pt, k: Kequi, niter: int = 20,
                 ah_min: float = 1.e-11, ah_max: float = 1.e-5):
    """Saturated DIC at a prescribed dissolved-CO2 concentration
    (carchm_solve_dicsat, mo_carchm.F90:934-1004)."""
    ah1 = torch.full_like(ta, 1.e-8)
    for _ in range(niter):
        ac = ta + _minor_alk(saln, sit, pt, ah1, k)
        kc = k.K1 * co2_sat
        ah2o = torch.sqrt(kc * kc + 4. * ac * 2. * k.K1 * k.K2 * co2_sat)
        ah2 = (k.K1 * co2_sat + ah2o) / (2. * ac)
        ah1 = torch.clamp(ah2, ah_min, ah_max)
    hco3 = k.K1 * co2_sat / ah1
    co3 = k.K1 * k.K2 * co2_sat / (ah1 * ah1)
    return co2_sat + hco3 + co3


def _tk100(temp, saln):
    t = torch.clamp(temp, TEMP_MIN, TEMP_MAX)
    s = torch.clamp(saln, SALN_MIN, SALN_MAX)
    return (t + TZERO) / 100., s


def sat_oxygen(temp, saln):
    """O2 saturation [kmol/m3/atm] for moist air at 1 atm (Weiss 1970;
    mo_carchm.F90:273-276)."""
    tk100, s = _tk100(temp, saln)
    oxy = (OX[0] + _over(OX[1], tk100) + OX[2] * torch.log(tk100)
           + OX[3] * tk100
           + s * (OX[4] + OX[5] * tk100 + OX[6] * (tk100 * tk100)))
    return torch.exp(oxy) * OXYCO


def sat_nitrogen(temp, saln):
    """N2 solubility [kmol/m3/atm] (mo_carchm.F90:333-335)."""
    tk100, s = _tk100(temp, saln)
    ani = (AN[0] + _over(AN[1], tk100) + AN[2] * torch.log(tk100)
           + AN[3] * tk100
           + s * (AN[4] + AN[5] * tk100 + AN[6] * (tk100 * tk100)))
    return torch.exp(ani) * OXYCO


def sat_n2o(temp, saln):
    """N2O solubility [kmol/m3/atm] (Weiss & Price 1980;
    mo_carchm.F90:338-340)."""
    tk100, s = _tk100(temp, saln)
    t2 = tk100 * tk100
    rs = (AL[0] + _over(AL[1], tk100) + AL[2] * torch.log(tk100)
          + AL[3] * t2 + s * (BL[0] + BL[1] * tk100 + BL[2] * t2))
    return torch.exp(rs)


def schmidt_numbers(t):
    """Schmidt numbers for CO2, O2, N2, DMS, N2O (Wanninkhof 2014,
    mo_carchm.F90:282-287)."""
    t2 = t * t
    t3, t4 = t * t2, t2 * t2
    scco2 = 2116.8 - 136.25 * t + 4.7353 * t2 - 0.092307 * t3 + 0.0007555 * t4
    sco2 = 1920.4 - 135.6 * t + 5.2122 * t2 - 0.10939 * t3 + 0.00093777 * t4
    scn2 = 2304.8 - 162.75 * t + 6.2557 * t2 - 0.13129 * t3 + 0.0011255 * t4
    scdms = 2855.7 - 177.63 * t + 6.0438 * t2 - 0.11645 * t3 + 0.00094743 * t4
    scn2o = 2356.2 - 166.38 * t + 6.3952 * t2 - 0.13422 * t3 + 0.0011506 * t4
    return scco2, sco2, scn2, scdms, scn2o
