"""Build the port's containers from dicts of numpy arrays.

The dicts are keyed by the field names the JAX package uses (they match
the port's), so a caller can carry a blom_tpu Grid, State (its tracers
included), CppmCoeffs, Forcing, BgcForcing, the sediment's SedState,
DiffusionFields, SwabsFields, CmnFields or VmixFields, and the surface
physics' SeaiceState, Ben02State, Ben02Clim and NiwState, and the
coupled cap's ImportFields, CesmForcing and ExportFields across with
``np.asarray`` on each field.  The BGC's TracerIndex and CisoParams are
plain Python and cross as they are.
Nothing here touches a JAX object."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bgc.sediment import SedState
from .bgc.step import BgcForcing
from .core.grid import TENSOR_FIELDS, Grid
from .core.state import State
from .dynamics.cmnfld import CmnFields
from .dynamics.cppm import CppmCoeffs
from .drivers.coupled import CesmForcing, ExportFields, ImportFields
from .dynamics.diffusion_fields import DiffusionFields
from .phys.ben02 import Ben02Clim, Ben02State
from .phys.forcing import Forcing
from .phys.niw import NiwState
from .phys.seaice import SeaiceState
from .phys.swabs import SwabsFields
from .phys.vmix import VmixFields


def _t(a, dtype, device):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _fields(cls, d, dtype, device):
    return {f.name: _t(d[f.name], dtype, device)
            for f in dataclasses.fields(cls)}


def grid_from_numpy(d, *, periodic_i: bool, periodic_j: bool, kk: int,
                    arctic: bool = False, dtype=torch.float64,
                    device='cpu') -> Grid:
    return Grid(periodic_i=periodic_i, periodic_j=periodic_j, arctic=arctic,
                kk=kk, **{k: _t(d[k], dtype, device) for k in TENSOR_FIELDS})


def state_from_numpy(d, dtype=torch.float64, device='cpu') -> State:
    return State(**_fields(State, d, dtype, device))


def cppm_coeffs_from_numpy(d, dtype=torch.float64,
                           device='cpu') -> CppmCoeffs:
    return CppmCoeffs(**{k: _t(d[k], dtype, device)
                         for k in CppmCoeffs._fields})


def forcing_from_numpy(d, dtype=torch.float64, device='cpu') -> Forcing:
    return Forcing(**_fields(Forcing, d, dtype, device))


def bgc_forcing_from_numpy(d, dtype=torch.float64,
                           device='cpu') -> BgcForcing:
    return BgcForcing(**{k: _t(d[k], dtype, device)
                         for k in BgcForcing._fields})


def sed_state_from_numpy(d, dtype=torch.float64, device='cpu') -> SedState:
    return SedState(**_fields(SedState, d, dtype, device))


def diffusion_fields_from_numpy(d, dtype=torch.float64,
                                device='cpu') -> DiffusionFields:
    return DiffusionFields(**_fields(DiffusionFields, d, dtype, device))


def swabs_from_numpy(d, dtype=torch.float64, device='cpu') -> SwabsFields:
    return SwabsFields(**_fields(SwabsFields, d, dtype, device))


def cmn_fields_from_numpy(d, dtype=torch.float64, device='cpu') -> CmnFields:
    return CmnFields(**{k: _t(d[k], dtype, device)
                        for k in CmnFields._fields})


def vmix_fields_from_numpy(d, dtype=torch.float64,
                           device='cpu') -> VmixFields:
    return VmixFields(**_fields(VmixFields, d, dtype, device))


def seaice_from_numpy(d, dtype=torch.float64, device='cpu') -> SeaiceState:
    return SeaiceState(**_fields(SeaiceState, d, dtype, device))


def ben02_state_from_numpy(d, dtype=torch.float64,
                           device='cpu') -> Ben02State:
    return Ben02State(**_fields(Ben02State, d, dtype, device))


def ben02_clim_from_numpy(d, dtype=torch.float64,
                          device='cpu') -> Ben02Clim:
    return Ben02Clim(**{k: _t(d[k], dtype, device)
                        for k in Ben02Clim._fields})


def niw_from_numpy(d, dtype=torch.float64, device='cpu') -> NiwState:
    return NiwState(**_fields(NiwState, d, dtype, device))


def _optional_fields(cls, d, dtype, device):
    """A NamedTuple whose fields may be None (absent or None in `d`)."""
    return cls(**{k: None if d.get(k) is None else _t(d[k], dtype, device)
                  for k in cls._fields})


def imports_from_numpy(d, dtype=torch.float64,
                       device='cpu') -> ImportFields:
    return _optional_fields(ImportFields, d, dtype, device)


def cesm_forcing_from_numpy(d, dtype=torch.float64,
                            device='cpu') -> CesmForcing:
    return CesmForcing(**_fields(CesmForcing, d, dtype, device))


def exports_from_numpy(d, dtype=torch.float64,
                       device='cpu') -> ExportFields:
    return _optional_fields(ExportFields, d, dtype, device)
