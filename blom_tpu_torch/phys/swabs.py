"""Shortwave absorption profiles.

Counterpart of `SwabsFields` and the 'jerlov' method of
`blom_tpu/phys/swabs.py` (BLOM's mod_swabs.F90): the Paulson & Simpson
(1977) double-exponential fit to the Jerlov (1968) water types
(mod_swabs.F90:95-107).  The chlorophyll-dependent and spatial methods
are not ported."""

from __future__ import annotations

import dataclasses

import torch

swamxd = 200.       # max shortwave penetration depth [m] (mod_swabs.F90:183)

# Jerlov water types I, IA, IB, II, III (mod_swabs.F90:104-107)
ps77_irfc = (.58, .62, .67, .77, .78)
ps77_al1 = (.35, .60, 1.00, 1.50, 1.40)
ps77_al2 = (23.00, 20.00, 17.00, 14.00, 7.90)


@dataclasses.dataclass
class SwabsFields:
    """Absorption profile E(z)/E(0) = swfc1*exp(-z/swal1)
    + swfc2*exp(-z/swal2) (mod_swabs.F90:27-33); all (jdm, idm)."""
    swfc1: torch.Tensor
    swfc2: torch.Tensor
    swal1: torch.Tensor    # [m]
    swal2: torch.Tensor    # [m]


def init_swabs(shape, swamth: str = 'jerlov', jwtype: int = 3,
               dtype=torch.float64, device='cpu') -> SwabsFields:
    """Initial absorption fields (iniswa, mod_swabs.F90:219-609) for the
    'jerlov' method and water type jwtype (1-5)."""
    if swamth != 'jerlov':
        raise NotImplementedError(
            f'shortwave method swamth={swamth!r} is not ported '
            "(only 'jerlov')")
    ones = torch.ones(tuple(shape), dtype=dtype, device=device)
    fc1 = ps77_irfc[jwtype - 1]
    return SwabsFields(swfc1=ones * fc1, swfc2=ones * (1. - fc1),
                       swal1=ones * ps77_al1[jwtype - 1],
                       swal2=ones * ps77_al2[jwtype - 1])
