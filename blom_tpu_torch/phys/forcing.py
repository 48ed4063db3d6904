"""Surface forcing fields.

Counterpart of `blom_tpu/phys/forcing.py` (BLOM's mod_forcing.F90): a
dataclass of tensors passed into the step (fuk95 uses zeros), and the
annual freshwater balancing's accumulators."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Forcing:
    """Surface forcing at p- (fluxes) and u/v- (stress) points, (jdm, idm)."""

    taux: torch.Tensor      # x wind stress at u [N m-2]
    tauy: torch.Tensor      # y wind stress at v [N m-2]
    surflx: torch.Tensor    # non-shortwave heat flux [W m-2]
    sswflx: torch.Tensor    # shortwave heat flux [W m-2]
    salflx: torch.Tensor    # virtual salt flux [g m-2 s-1]
    brnflx: torch.Tensor    # brine flux [g m-2 s-1]
    surrlx: torch.Tensor    # heat-flux relaxation [W m-2]
    salrlx: torch.Tensor    # salt-flux relaxation [g m-2 s-1]
    sstclm: torch.Tensor    # SST climatology for restoring
    sssclm: torch.Tensor    # SSS climatology for restoring
    # nonlocal momentum-flux profile at u/v points, (kk+1, jdm, idm):
    # distributes wind stress over the boundary layer
    # (mod_momtum.F90:938-945)
    mu_nonloc: torch.Tensor
    mv_nonloc: torch.Tensor
    lamult: torch.Tensor    # Langmuir enhancement factor (1 = none)


def zero_forcing(kk: int, shape, dtype=torch.float64, device='cpu') -> Forcing:
    """Zero forcing; mu_nonloc = 1 at the surface and 0 below puts all
    wind stress in the top layer."""
    H = tuple(shape)

    def z2():
        return torch.zeros(H, dtype=dtype, device=device)

    def mu():
        out = torch.zeros((kk + 1,) + H, dtype=dtype, device=device)
        out[0] = 1.0
        return out

    return Forcing(taux=z2(), tauy=z2(), surflx=z2(), sswflx=z2(),
                   salflx=z2(), brnflx=z2(), surrlx=z2(), salrlx=z2(),
                   sstclm=z2(), sssclm=z2(), mu_nonloc=mu(), mv_nonloc=mu(),
                   lamult=torch.ones(H, dtype=dtype, device=device))


def fwbbal_accumulate(eiacc, pracc, eva, fmltfz, lip, sop, rnf, rfi,
                      baclin: float):
    """Accumulate evaporation + ice melt against precipitation + runoff
    for the annual freshwater balancing (fwbbal, mod_forcing.F90:361-441,
    the accumulation part)."""
    eiacc = eiacc + (eva + fmltfz) * baclin
    pracc = pracc + (lip + sop + rnf + rfi) * baclin
    return eiacc, pracc


def fwbbal_update(prfac, eiacc, pracc, scp2, wocn_mask):
    """Year-end update of the precipitation/runoff correction factor,
    prfac = -prfac * total(E + I) / total(P + R) (fwbbal,
    mod_forcing.F90:382-410); returns (prfac, zeroed accumulators)."""
    totei = torch.sum(eiacc * scp2 * wocn_mask)
    totpr = torch.sum(pracc * scp2 * wocn_mask)
    new = -prfac * totei / torch.where(torch.abs(totpr) > 0., totpr, 1.)
    return new, torch.zeros_like(eiacc), torch.zeros_like(pracc)
