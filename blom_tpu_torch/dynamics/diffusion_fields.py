"""Lateral diffusion / eddy-transport parameter fields.

Counterpart of `blom_tpu/dynamics/diffusion_fields.py` (BLOM's
mod_diffusion.F90).  Zero-initialized (difwgt = 1); each step with
`par.difest` on, difest_lateral fills difint/difiso/difwgt, eddtra the
mid level of umfltd/vmfltd and diffus the isopycnal heat/salt fluxes
utflld..vsflld; with `par.vmix` on, the vertical diffusivities
difvho/difvso/difvmo and the boundary-layer depth bld are stored for
diagnostics.  difdia, umflsm/vmflsm and mtke belong to phases not
ported and stay zero."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DiffusionFields:
    difint: torch.Tensor   # (K, H) layer interface diffusivity [m2 s-1]
    difiso: torch.Tensor   # (K, H) isopycnal diffusivity [m2 s-1]
    difdia: torch.Tensor   # (K, H) diapycnal diffusivity [m2 s-1]
    difwgt: torch.Tensor   # (H) Rossby-radius resolution weight []
    umfltd: torch.Tensor   # (2, K, H) GM eddy-induced mass flux [kg m s-2]
    vmfltd: torch.Tensor
    umflsm: torch.Tensor   # (2, K, H) submesoscale mass flux [kg m s-2]
    vmflsm: torch.Tensor
    difvho: torch.Tensor   # (K, H) vertical heat diffusivity [m2 s-1]
    difvso: torch.Tensor   # (K, H) vertical salt diffusivity [m2 s-1]
    difvmo: torch.Tensor   # (K, H) vertical momentum viscosity [m2 s-1]
    mtke: torch.Tensor     # (6, H) bulk mixed layer TKE budget terms
    bld: torch.Tensor      # (H) boundary-layer depth [m]
    utflld: torch.Tensor   # (K, H) isopycnal-diffusion heat/salt fluxes
    usflld: torch.Tensor
    vtflld: torch.Tensor
    vsflld: torch.Tensor


def zero_diffusion_fields(kk: int, shape, dtype=torch.float64,
                          device='cpu') -> DiffusionFields:
    H = tuple(shape)

    def z(*lead):
        return torch.zeros(lead + H, dtype=dtype, device=device)

    return DiffusionFields(
        difint=z(kk), difiso=z(kk), difdia=z(kk),
        difwgt=torch.ones(H, dtype=dtype, device=device),
        umfltd=z(2, kk), vmfltd=z(2, kk), umflsm=z(2, kk), vmflsm=z(2, kk),
        difvho=z(kk), difvso=z(kk), difvmo=z(kk), mtke=z(6), bld=z(),
        utflld=z(kk), usflld=z(kk), vtflld=z(kk), vsflld=z(kk))
