"""The 'noforcing' experiment configuration.

Counterpart of `blom_tpu/configs/noforcing.py` (BLOM's
noforcing/mod_noforcing.F90): every forcing ingest is a no-op, so the
ocean evolves freely from its initial conditions, for adjustment and
conservation experiments."""

from __future__ import annotations

import torch

from ..phys.forcing import Forcing, zero_forcing


def inifrc_noforcing(kk: int, shape, dtype=torch.float64,
                     device='cpu') -> Forcing:
    """All-zero forcing (inifrc/getfrc dispatch entries for
    expcnf='noforcing', mod_inifrc.F90:38-66)."""
    return zero_forcing(kk, shape, dtype, device)


def getfrc_noforcing(forcing: Forcing) -> Forcing:
    """Per-step forcing ingest: the identity (getfrc_noforcing)."""
    return forcing


def sfcstr_noforcing(forcing: Forcing) -> Forcing:
    """Zero wind stress (sfcstr dispatch, mod_sfcstr.F90:34-63)."""
    return forcing
