"""Inorganic carbon cycle: CO2 system solve, air-sea gas exchange,
calcite dissolution.

Counterpart of `blom_tpu/bgc/carchm.py` (BLOM's hamocc/mo_carchm.F90
carchm): CO2/O2/N2/N2O/DMS gas exchange, and with the carbon isotopes
(ti, cp) their exchange, shell dissolution and decay (ciso.carchm_ciso);
the CFCs and natDIC are in cfc.py and extensions.py.  The 3-D pH solve
is one elementwise fixed-iteration call over the whole (K, J, I) block;
the surface fluxes act on layer 0.
"""

from __future__ import annotations

import torch

from . import chemistry as chem
from .chemistry import _over
from .params import BgcParams, BgcTracers as T

SRFDIC_MIN = 1.e-5          # mo_param_bgc.F90:179 [kmol C m-3]
XCONVXA = 6.97e-7           # Wanninkhof 2014 piston-velocity factor


def carchm(oc, ptho, psao, prho, dz, ptiestu, lyr, kmle,
           strahl_unused, fu10, slp, fice, dtsec, p: BgcParams,
           ti=None, cp=None):
    """Solve the CO2 system, apply air-sea fluxes and dissolve CaCO3.

    oc: (ntr, K, J, I) concentrations [kmol/m3]; prho: in-situ density
    [g/cm3]; dz [m]; ptiestu: layer-centre depth [m]; lyr: wet-layer
    mask; kmle: (J, I) int, last mixed-layer level index (0-based,
    inclusive); fu10: 10-m wind [m/s]; slp: sea-level pressure [Pa];
    fice: sea-ice fraction; ti/cp: the extended tracer index and the
    carbon-isotope parameters, both or neither.  Returns (oc, satoxy,
    diags)."""
    oc = oc.clone()
    t = torch.clamp(ptho, chem.TEMP_MIN, chem.TEMP_MAX)
    s = torch.clamp(psao, chem.SALN_MIN, chem.SALN_MAX)
    tk = t + chem.TZERO

    prb = ptiestu * 98060. * 1.027e-6   # pressure [bar] (carchm :227)
    k = chem.kequi(t, s, prb)

    rrho = prho
    tc = oc[T.sco212] / rrho
    ta = oc[T.alkali] / rrho
    sit = oc[T.silica] / rrho
    pt = oc[T.phosph] / rrho
    ah1 = torch.clamp(oc[T.hi], p.ah_min, p.ah_max)

    ah1, ac = chem.solve_h(s, tc, ta, sit, pt, k, ah1, p.niter,
                           p.ah_min, p.ah_max)
    oc[T.hi] = torch.where(lyr, ah1, oc[T.hi])

    cu = (2. * tc - ac) / (2. + k.K1 / ah1)     # CO2* [mol/kg]
    cb = k.K1 * cu / ah1                        # HCO3-
    cc = k.K2 * cb / ah1                        # CO3--
    co3 = cc * rrho                             # [kmol/m3]

    satoxy = chem.sat_oxygen(t, s)

    # ---------------- surface gas exchange (k = 0) ------------------
    t0, s0 = t[0], s[0]
    tk0 = tk[0]
    scco2, sco2, scn2, scdms, scn2o = chem.schmidt_numbers(t0)
    opn = 1. - fice
    piston = opn * XCONVXA * (fu10 * fu10)
    kwco2 = piston * torch.sqrt(_over(660., scco2))
    kwo2 = piston * torch.sqrt(_over(660., sco2))
    kwn2 = piston * torch.sqrt(_over(660., scn2))
    kwdms = piston * torch.sqrt(_over(660., scdms))
    kwn2o = piston * torch.sqrt(_over(660., scn2o))

    rpp0 = slp / 101325.
    # CO2 fugacity correction (Weiss & Price 1980)
    tk02 = tk0 * tk0
    Bvir = (-1636.75 + 12.0408 * tk0 - 0.0327957 * tk02
            + 0.0000316528 * (tk0 * tk02))
    delta = 57.7 - 0.118 * tk0
    fc = torch.exp(rpp0 * (Bvir + 2. * delta) / (82.057 * tk0))
    pH2O = torch.exp(24.4543 - 67.4509 * _over(100., tk0)
                     - 4.8489 * torch.log(tk0 / 100.) - 0.000544 * s0)

    Kh0_0 = k.Kh0[0]
    rrho0 = rrho[0]
    dz0 = torch.clamp_min(dz[0], 1.e-12)
    cu_sat = Kh0_0 * p.atm_co2 * 1.e-6 * (rpp0 - pH2O) * fc

    fluxd = cu_sat * kwco2 * dtsec * rrho0
    fluxu = cu[0] * kwco2 * dtsec * rrho0
    fluxu = torch.minimum(
        fluxu, fluxd - (SRFDIC_MIN - oc[T.sco212, 0]) * dz0)
    wet0 = lyr[0]
    oc[T.sco212, 0] = oc[T.sco212, 0] + torch.where(
        wet0, (fluxd - fluxu) / dz0, 0.)

    # saturated DIC in the mixed layer (carchm :456-458)
    tcsat = chem.solve_dicsat(
        s0, cu_sat, ta[0], sit[0], pt[0],
        chem.Kequi(*[x[0] for x in k]), p.niter, p.ah_min, p.ah_max)
    kidx = torch.arange(oc.shape[1], device=oc.device)[:, None, None]
    in_ml = (kidx <= kmle[None]) & lyr
    oc[T.dicsat] = torch.where(in_ml, (tcsat * rrho0)[None], oc[T.dicsat])

    # O2 / N2 / N2O / DMS fluxes (carchm :489-532)
    satoxy0 = satoxy[0]
    oxflux = kwo2 * dtsec * (oc[T.oxygen, 0]
                             - satoxy0 * (p.atm_o2 / 196800.) * rpp0)
    oc[T.oxygen, 0] = oc[T.oxygen, 0] + torch.where(wet0, -oxflux / dz0, 0.)

    anisa = chem.sat_nitrogen(t0, s0)
    niflux = kwn2 * dtsec * (oc[T.gasnit, 0]
                             - anisa * (p.atm_n2 / 802000.) * rpp0)
    oc[T.gasnit, 0] = oc[T.gasnit, 0] + torch.where(wet0, -niflux / dz0, 0.)

    satn2o = chem.sat_n2o(t0, s0)
    n2oflux = kwn2o * dtsec * (oc[T.an2o, 0]
                               - satn2o * p.atm_n2o * 1.e-12 * rpp0)
    oc[T.an2o, 0] = oc[T.an2o, 0] + torch.where(wet0, -n2oflux / dz0, 0.)

    dmsflux = kwdms * dtsec * oc[T.dms, 0]
    oc[T.dms, 0] = oc[T.dms, 0] + torch.where(wet0, -dmsflux / dz0, 0.)

    # ---------------- calcite dissolution (carchm :629-666) ---------
    omega = (chem.CALCON * s / 35.) * cc
    omegaC = omega / k.Kspc
    omegaA = omega / k.Kspa
    supsat = co3 - co3 / torch.clamp_min(omegaC, 1.e-12)
    undsa = torch.clamp_min(-supsat, 0.)
    dtb = dtsec / 86400.
    dissol = torch.where(lyr, torch.minimum(undsa, p.dremcalc * dtb
                                            * oc[T.calc]), 0.)
    oc[T.calc] = oc[T.calc] - dissol
    oc[T.alkali] = oc[T.alkali] + 2. * dissol
    oc[T.sco212] = oc[T.sco212] + dissol

    # ------------- carbon isotopes (use_cisonew) ---------------------
    ciso_diags = {}
    if ti is not None and cp is not None:
        from . import ciso as ciso_mod
        oc, ciso_diags = ciso_mod.carchm_ciso(
            oc, ti, t0, tk0, s0, cu, cb, cc, Kh0_0, kwco2, rpp0, pH2O,
            fc, rrho0, dz0, wet0, dissol, lyr, dtsec, p, cp)

    fco2 = cu[0] * 1.e6 / Kh0_0
    pco2 = fco2 / fc
    diags = {'co2flux': torch.where(wet0, fluxu - fluxd, 0.),
             'oxflux': torch.where(wet0, oxflux, 0.),
             'niflux': torch.where(wet0, niflux, 0.),
             'n2oflux': torch.where(wet0, n2oflux, 0.),
             'dmsflux': torch.where(wet0, dmsflux, 0.),
             'pco2': torch.where(wet0, pco2, 0.),
             'omegaC': torch.where(lyr, omegaC, 0.),
             'omegaA': torch.where(lyr, omegaA, 0.),
             'co3': torch.where(lyr, co3, 0.)}
    diags.update(ciso_diags)
    return oc, satoxy, diags
