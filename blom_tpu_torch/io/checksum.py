"""Deterministic field checksums for regression and equivalence tests.

Counterpart of `blom_tpu/io/checksum.py` (BLOM's csdiag CRC32 of masked
fields, phy/mod_checksum.F90 and mod_crc32.F90): each field hashes to
the CRC32 of its exact little-endian f64 bytes on the host, so equal
values give blom_tpu's CRC whatever device or dtype holds them."""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..core.state import State


def to_numpy(a):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def field_crc(a) -> int:
    arr = np.ascontiguousarray(to_numpy(a).astype('<f8'))
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def state_checksums(s: State, fields=None) -> dict:
    """Per-field CRC dictionary (chksum calls, e.g. mod_advect.F90:174-187)."""
    names = fields or [f.name for f in dataclasses.fields(s)]
    return {name: field_crc(getattr(s, name)) for name in names}


def print_checksums(tag: str, s: State, fields=('dp', 'temp', 'saln',
                                                'u', 'v', 'pb')):
    print(f'{tag}:')
    for name, crc in state_checksums(s, fields).items():
        print(f'  chksum {name}: {crc:08x}')
