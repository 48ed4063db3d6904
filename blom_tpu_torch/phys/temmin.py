"""Minimum physical temperature per isopycnic layer.

Counterpart of `blom_tpu/phys/temmin.py` (BLOM's mod_temmin.F90:20-138
settemmin): on the isopycnic bulk-mixed-layer coordinate a layer's lower
temperature bound is the freezing temperature on its reference density,
found by solving sig(tfrz(S), S) = sigmar for S (a quadratic in S, as
tfrz = atf*S + btf with btf = ctf = 0 in these configurations); the
other coordinates use a constant -3 C."""

from __future__ import annotations

import torch

from ..core import eos


def settemmin(e: eos.EosParams, sigmar, vcoord_isopyc: bool,
              expcnf: str = 'fuk95'):
    """temmin (K, J, I) from the layers' reference densities (settemmin,
    mod_temmin.F90:51-133).  Layer 0 (the mixed layer) keeps the constant
    bound, as the reference sets only k >= 2."""
    if (not vcoord_isopyc) or expcnf in ('cesm', 'single_column'):
        return torch.full_like(sigmar, -3.)

    # the freezing salinity on the reference density: with rho = P1/P2
    # and tfrz = atf*s, sig = sigmar is a*s^2 + b*s + c = 0
    # (mod_temmin.F90:86-96)
    a = (((e.ap14 - e.ap24 * sigmar) * e.atf
          + e.ap15 - e.ap25 * sigmar) * e.atf
         + e.ap16 - e.ap26 * sigmar)
    b = (e.ap12 - e.ap22 * sigmar) * e.atf + e.ap13 - e.ap23 * sigmar
    c = e.ap11 - e.ap21 * sigmar
    disc = torch.clamp(b * b - 4. * a * c, min=0.)
    salfrz = (-b + torch.sqrt(disc)) / (2. * a)
    temmin = e.atf * salfrz
    temmin[0] = -3.
    return temmin
