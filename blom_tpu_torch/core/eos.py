"""Equation of state: rational-function fit of in-situ density.

Counterpart of the functions of `blom_tpu/core/eos.py` that pgforc,
pbcor2, the initial state, the ALE regrid, cmnfld, the vertical mixing,
the isopycnic phases (convec, diapfl, mxlayr) and neutral diffusion use
(BLOM's mod_eos.F90).  In-situ density is rho(p, th, s) = P1/P2 with
P1, P2 bilinear in p and quadratic in (th, s).  Every function is
elementwise on tensors and computes in the dtype of its inputs;
coefficients live in an `EosParams` built by `init_eos(pref, expcnf)`."""

from __future__ import annotations

import dataclasses

import torch

from .constants import alpha0

# Coefficients of the functional fit of in situ density
# (mod_eos.F90:37-54).
a11 = 9.9985372432159340e+02
a12 = 1.0380621928183473e+01
a13 = 1.7073577195684715e+00
a14 = -3.6570490496333680e-02
a15 = -7.3677944503527477e-03
a16 = -3.5529175999643348e-03
b11 = 1.7083494994335439e-06
b12 = 7.1567921402953455e-09
b13 = 1.2821026080049485e-09
a21 = 1.0
a22 = 1.0316374535350838e-02
a23 = 8.9521792365142522e-04
a24 = -2.8438341552142710e-05
a25 = -1.1887778959461776e-05
a26 = -4.0163964812921489e-06
b21 = 1.1995545126831476e-09
b22 = 5.5234008384648383e-12
b23 = 8.4310335919950873e-13


@dataclasses.dataclass(frozen=True)
class EosParams:
    """Pressure-reference-dependent EOS coefficients (mod_eos.F90:85-160)."""

    pref: float
    # sigma referenced at pref
    ap11: float
    ap12: float
    ap13: float
    ap14: float
    ap15: float
    ap16: float
    ap21: float
    ap22: float
    ap23: float
    ap24: float
    ap25: float
    ap26: float
    # sigma referenced at the surface
    ap110: float
    ap120: float
    ap130: float
    ap140: float
    ap150: float
    ap160: float
    ap210: float
    ap220: float
    ap230: float
    ap240: float
    ap250: float
    ap260: float
    atf: float
    btf: float
    ctf: float


# expcnf -> freezing-temperature coefficients (atf, btf, ctf),
# mod_eos.F90:135-150
_FREEZE_COEFFS = {
    'cesm': (0.0, -1.8, 0.0),
    'ben02clim': (-0.0547, 0.0, 0.0),
    'ben02syn': (-0.0547, 0.0, 0.0),
    'noforcing': (-0.0547, 0.0, 0.0),
    'fuk95': (-0.0547, 0.0, 0.0),
    'single_column': (-0.0547, 0.0, 0.0),
    'channel': (-0.0547, 0.0, 0.0),
    'isomip1': (-5.7846e-2, 1.0307e-1, -7.7961e-9),
    'isomip2': (-5.7846e-2, 1.0307e-1, -7.7961e-9),
}


def init_eos(pref: float = 0.0, expcnf: str = 'fuk95') -> EosParams:
    """Potential-density coefficients for reference pressure `pref`
    (inieos, mod_eos.F90:85-160): pressure terms absorbed into the
    quadratic coefficients, 1/alpha0 subtracted from the numerator so
    that sig() returns sigma units."""
    ap21 = a21 + b21 * pref
    ap22 = a22 + b22 * pref
    ap23 = a23 + b23 * pref
    ap24, ap25, ap26 = a24, a25, a26
    ap11 = a11 + b11 * pref - ap21 / alpha0
    ap12 = a12 + b12 * pref - ap22 / alpha0
    ap13 = a13 + b13 * pref - ap23 / alpha0
    ap14 = a14 - ap24 / alpha0
    ap15 = a15 - ap25 / alpha0
    ap16 = a16 - ap26 / alpha0
    ap210, ap220, ap230, ap240, ap250, ap260 = a21, a22, a23, a24, a25, a26
    ap110 = a11 - ap210 / alpha0
    ap120 = a12 - ap220 / alpha0
    ap130 = a13 - ap230 / alpha0
    ap140 = a14 - ap240 / alpha0
    ap150 = a15 - ap250 / alpha0
    ap160 = a16 - ap260 / alpha0
    atf, btf, ctf = _FREEZE_COEFFS[expcnf]
    return EosParams(pref=pref, ap11=ap11, ap12=ap12, ap13=ap13, ap14=ap14,
                     ap15=ap15, ap16=ap16, ap21=ap21, ap22=ap22, ap23=ap23,
                     ap24=ap24, ap25=ap25, ap26=ap26,
                     ap110=ap110, ap120=ap120, ap130=ap130, ap140=ap140,
                     ap150=ap150, ap160=ap160, ap210=ap210, ap220=ap220,
                     ap230=ap230, ap240=ap240, ap250=ap250, ap260=ap260,
                     atf=atf, btf=btf, ctf=ctf)


def _p1(p, th, s):
    return (a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s
            + (b11 + b12 * th + b13 * s) * p)


def _p2(p, th, s):
    return (a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s
            + (b21 + b22 * th + b23 * s) * p)


def rho(p, th, s):
    """In situ density [kg m-3] (mod_eos.F90:163-178)."""
    return _p1(p, th, s) / _p2(p, th, s)


def alp(p, th, s):
    """Specific volume [m3 kg-1] (mod_eos.F90:180-196)."""
    return _p2(p, th, s) / _p1(p, th, s)


def sig(e: EosParams, th, s):
    """Potential density in sigma units at pref (mod_eos.F90:198-211)."""
    return ((e.ap11 + (e.ap12 + e.ap14 * th + e.ap15 * s) * th
             + (e.ap13 + e.ap16 * s) * s)
            / (e.ap21 + (e.ap22 + e.ap24 * th + e.ap25 * s) * th
               + (e.ap23 + e.ap26 * s) * s))


def sig0(e: EosParams, th, s):
    """Potential density at the surface reference pressure
    (mod_eos.F90:213-227)."""
    return ((e.ap110 + (e.ap120 + e.ap140 * th + e.ap150 * s) * th
             + (e.ap130 + e.ap160 * s) * s)
            / (e.ap210 + (e.ap220 + e.ap240 * th + e.ap250 * s) * th
               + (e.ap230 + e.ap260 * s) * s))


def drhodt(p, th, s):
    """d(rho)/d(th) [kg m-3 K-1] (mod_eos.F90:229-252)."""
    r1 = _p1(p, th, s)
    r2i = 1.0 / _p2(p, th, s)
    return ((a12 + 2.0 * a14 * th + a15 * s + b12 * p
             - (a22 + 2.0 * a24 * th + a25 * s + b22 * p) * r1 * r2i) * r2i)


def drhods(p, th, s):
    """d(rho)/d(s) [kg m-3] (mod_eos.F90:284-308)."""
    r1 = _p1(p, th, s)
    r2i = 1.0 / _p2(p, th, s)
    return ((a13 + a15 * th + 2.0 * a16 * s + b13 * p
             - (a23 + a25 * th + 2.0 * a26 * s + b23 * p) * r1 * r2i) * r2i)


def dsigdt(e: EosParams, th, s):
    """d(sig)/d(th) (mod_eos.F90:254-263)."""
    r1 = (e.ap11 + (e.ap12 + e.ap14 * th + e.ap15 * s) * th
          + (e.ap13 + e.ap16 * s) * s)
    r2i = 1.0 / (e.ap21 + (e.ap22 + e.ap24 * th + e.ap25 * s) * th
                 + (e.ap23 + e.ap26 * s) * s)
    return ((e.ap12 + 2.0 * e.ap14 * th + e.ap15 * s
             - (e.ap22 + 2.0 * e.ap24 * th + e.ap25 * s) * r1 * r2i) * r2i)


def dsigds(e: EosParams, th, s):
    """d(sig)/d(s) (mod_eos.F90:306-325)."""
    r1 = (e.ap11 + (e.ap12 + e.ap14 * th + e.ap15 * s) * th
          + (e.ap13 + e.ap16 * s) * s)
    r2i = 1.0 / (e.ap21 + (e.ap22 + e.ap24 * th + e.ap25 * s) * th
                 + (e.ap23 + e.ap26 * s) * s)
    return ((e.ap13 + e.ap15 * th + 2.0 * e.ap16 * s
             - (e.ap23 + e.ap25 * th + 2.0 * e.ap26 * s) * r1 * r2i) * r2i)


def dsigdt0(e: EosParams, th, s):
    """d(sig0)/d(th) (mod_eos.F90:263-282)."""
    r1 = (e.ap110 + (e.ap120 + e.ap140 * th + e.ap150 * s) * th
          + (e.ap130 + e.ap160 * s) * s)
    r2i = 1.0 / (e.ap210 + (e.ap220 + e.ap240 * th + e.ap250 * s) * th
                 + (e.ap230 + e.ap260 * s) * s)
    return ((e.ap120 + 2.0 * e.ap140 * th + e.ap150 * s
             - (e.ap220 + 2.0 * e.ap240 * th + e.ap250 * s) * r1 * r2i)
            * r2i)


def dsigds0(e: EosParams, th, s):
    """d(sig0)/d(s) (mod_eos.F90:326-345)."""
    r1 = (e.ap110 + (e.ap120 + e.ap140 * th + e.ap150 * s) * th
          + (e.ap130 + e.ap160 * s) * s)
    r2i = 1.0 / (e.ap210 + (e.ap220 + e.ap240 * th + e.ap250 * s) * th
                 + (e.ap230 + e.ap260 * s) * s)
    return ((e.ap130 + e.ap150 * th + 2.0 * e.ap160 * s
             - (e.ap230 + e.ap250 * th + 2.0 * e.ap260 * s) * r1 * r2i)
            * r2i)


def tofsig(e: EosParams, sg, s):
    """Potential temperature from (sigma, salinity) (mod_eos.F90:347-367):
    closed-form inverse of the rational fit, quadratic in th."""
    a = e.ap14 - e.ap24 * sg
    b = e.ap12 - e.ap22 * sg + (e.ap15 - e.ap25 * sg) * s
    c = e.ap11 - e.ap21 * sg + (e.ap13 - e.ap23 * sg
                                + (e.ap16 - e.ap26 * sg) * s) * s
    return (-b - torch.sqrt(b * b - 4.0 * a * c)) / (2.0 * a)


def sofsig(e: EosParams, sg, th):
    """Salinity from (sigma, temperature) [g kg-1] (mod_eos.F90:369-389)."""
    a = e.ap16 - e.ap26 * sg
    b = e.ap13 - e.ap23 * sg + (e.ap15 - e.ap25 * sg) * th
    c = e.ap11 - e.ap21 * sg + (e.ap12 - e.ap22 * sg
                                + (e.ap14 - e.ap24 * sg) * th) * th
    return (-b + torch.sqrt(b * b - 4.0 * a * c)) / (2.0 * a)


def p_alpha(p1, p2, th, s):
    """Integral of specific volume in pressure [m2 s-2]
    (mod_eos.F90:391-436): truncated odd-power series of the log form."""
    aa1 = a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s
    aa2 = a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s
    bb1 = b11 + b12 * th + b13 * s
    bb2 = b21 + b22 * th + b23 * s

    pm = .5 * (p2 + p1)
    r = .5 * (p2 - p1) / (aa1 + bb1 * pm)
    q = bb1 * r
    qq = q * q
    r1_3, r1_5, r1_7, r1_9 = 1 / 3., 1 / 5., 1 / 7., 1 / 9.
    return 2.0 * r * (aa2 + bb2 * pm
                      + (aa2 - aa1 * bb2 / bb1) * qq
                      * (r1_3 + qq * (r1_5 + qq * (r1_7 + qq * r1_9))))


def p_p_alpha(p1, p2, th, s):
    """Double integral of specific volume in pressure
    (mod_eos.F90:438-489)."""
    aa1 = a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s
    aa2 = a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s
    bb1 = b11 + b12 * th + b13 * s
    bb2 = b21 + b22 * th + b23 * s

    pm = .5 * (p2 + p1)
    dp = .5 * (p2 - p1)
    r = dp / (aa1 + bb1 * pm)
    q = bb1 * r
    r1_3, r1_5, r1_7, r1_9, r1_10 = 1 / 3., 1 / 5., 1 / 7., 1 / 9., 1 / 10.
    return 2.0 * dp * r * (
        aa2 + bb2 * pm
        + (aa2 - aa1 * bb2 / bb1) * q
        * (r1_3 + q * (r1_3
           + q * (r1_5 + q * (r1_5
              + q * (r1_7 + q * (r1_7
                 + q * (r1_9 + q * (r1_9 + q * r1_10)))))))))


def delphi(p1, p2, th, s):
    """Geopotential difference between two pressures
    (mod_eos.F90:491-548).  Returns (dphi, alp1, alp2)."""
    aa1 = a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s
    aa2 = a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s
    bb1 = b11 + b12 * th + b13 * s
    bb2 = b21 + b22 * th + b23 * s

    pm = .5 * (p2 + p1)
    r = .5 * (p2 - p1) / (aa1 + bb1 * pm)
    q = bb1 * r
    qq = q * q
    r1_3, r1_5, r1_7, r1_9 = 1 / 3., 1 / 5., 1 / 7., 1 / 9.
    dphi = -2.0 * r * (aa2 + bb2 * pm
                       + (aa2 - aa1 * bb2 / bb1) * qq
                       * (r1_3 + qq * (r1_5 + qq * (r1_7 + qq * r1_9))))
    alp1 = (aa2 + bb2 * p1) / (aa1 + bb1 * p1)
    alp2 = (aa2 + bb2 * p2) / (aa1 + bb1 * p2)
    return dphi, alp1, alp2


def dalpdt(p, th, s):
    """d(alpha)/d(th) (mod_eos.F90:550-575)."""
    r1 = _p2(p, th, s)
    r2i = 1.0 / _p1(p, th, s)
    return ((a22 + 2.0 * a24 * th + a25 * s + b22 * p
             - (a12 + 2.0 * a14 * th + a15 * s + b12 * p) * r1 * r2i) * r2i)


def dalpds(p, th, s):
    """d(alpha)/d(s) (mod_eos.F90:577-600)."""
    r1 = _p2(p, th, s)
    r2i = 1.0 / _p1(p, th, s)
    return ((a23 + a25 * th + 2.0 * a26 * s + b23 * p
             - (a13 + a15 * th + 2.0 * a16 * s + b13 * p) * r1 * r2i) * r2i)


def dynh_derivatives(p0, p1, p2, th, s):
    """Mean d/dth, d/ds of dynamic enthalpy over [p1, p2]
    (mod_eos.F90:602-719), truncated series term for term."""
    r1_2, r1_3, r1_4, r1_5, r1_6 = 1/2., 1/3., 1/4., 1/5., 1/6.
    r1_7, r1_8, r1_9, r1_10, r1_11 = 1/7., 1/8., 1/9., 1/10., 1/11.

    b1i = 1.0 / (b11 + b12 * th + b13 * s)
    aa1 = (a11 + (a12 + a14 * th + a15 * s) * th + (a13 + a16 * s) * s) * b1i
    aa2 = (a21 + (a22 + a24 * th + a25 * s) * th + (a23 + a26 * s) * s) * b1i
    bb2 = (b21 + b22 * th + b23 * s) * b1i

    a1_th = (a12 + 2.0 * a14 * th + a15 * s - aa1 * b12) * b1i
    a2_th = (a22 + 2.0 * a24 * th + a25 * s - aa2 * b12) * b1i
    b2_th = (b22 - bb2 * b12) * b1i

    a1_s = (a13 + a15 * th + 2.0 * a16 * s - aa1 * b13) * b1i
    a2_s = (a23 + a25 * th + 2.0 * a26 * s - aa2 * b13) * b1i
    b2_s = (b23 - bb2 * b13) * b1i

    pm1 = r1_2 * (p2 + p1)
    pp1 = r1_2 * (p2 - p1)
    pm0 = r1_2 * (pm1 + p0)
    pp0 = r1_2 * (pm1 - p0)

    t1 = 1.0 / (aa1 + pm1)
    t0 = 1.0 / (aa1 + pm0)
    q1 = pp1 * t1
    q0 = pp0 * t0
    qq1 = q1 * q1
    qq0 = q0 * q0

    def series(bterm, c1, c2, c3):
        return (2.0 * (pp0 * bterm
                       + ((((((r1_11 * c1 - c3) * qq0
                              + (r1_9 * c1 - c3)) * qq0
                             + (r1_7 * c1 - c3)) * qq0
                            + (r1_5 * c1 - c3)) * qq0
                           + (r1_3 * c1 - c3)) * qq0
                          + (c1 - c3)) * q0)
                - ((((r1_11 * (r1_10 * c1 - c2) * qq1
                      + r1_9 * (r1_8 * c1 - c2)) * qq1
                     + r1_7 * (r1_6 * c1 - c2)) * qq1
                    + r1_5 * (r1_4 * c1 - c2)) * qq1
                   + r1_3 * (r1_2 * c1 - c2)) * qq1)

    f = (aa2 - aa1 * bb2) * a1_th
    dynh_th = series(b2_th, a2_th - aa1 * b2_th - bb2 * a1_th, f * t1, f * t0)

    f = (aa2 - aa1 * bb2) * a1_s
    dynh_s = series(b2_s, a2_s - aa1 * b2_s - bb2 * a1_s, f * t1, f * t0)

    return dynh_th, dynh_s


def tfrz(e: EosParams, s, p=0.0):
    """Freezing temperature of sea water [deg C]."""
    return e.atf * s + e.btf + e.ctf * p
