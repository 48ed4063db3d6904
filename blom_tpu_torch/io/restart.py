"""Checkpoint and restart.

Counterpart of `blom_tpu/io/restart.py` (BLOM's phy/mod_restart.F90:
restart_write :1143, restart_read :1463, the rotating file names and the
rstdate.txt log).  The State is the registry: every field is saved as it
is, with the clock, in blom_tpu's single-host format (a compressed
`.npz` with the clock as JSON under `__meta__`, written to a temporary
file and renamed into place), so a file either package writes reads in
the other.  The step is a function of the State and the clock alone, so
continuing from a restart repeats the straight run bit for bit.  The
sharded pair (orbax in blom_tpu) comes with the decomposition."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core import calendar as cal
from ..core import modeltime
from ..core.state import State
from .checksum import to_numpy

_CLOCK_KEYS = ('calendar', 'baclin', 'batrop', 'lstep', 'dlt',
               'nstep_in_day', 'nstep0', 'nstep', 'time0', 'time')


def write_restart(path: str, state: State, clock: modeltime.ModelTime):
    """Dump the full state and the clock (restart_write,
    mod_restart.F90:1143)."""
    arrays = {f.name: to_numpy(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    meta = dict(
        calendar=clock.calendar, baclin=clock.baclin, batrop=clock.batrop,
        lstep=clock.lstep, dlt=clock.dlt, nstep_in_day=clock.nstep_in_day,
        date0=clock.date0.to_ymd(), date=clock.date.to_ymd(),
        nstep0=clock.nstep0, nstep=clock.nstep,
        time0=clock.time0, time=clock.time)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def read_restart(path: str, dtype=None, device=None):
    """Load (state, clock) (restart_read, mod_restart.F90:1463).  Float
    fields take `dtype` when given, else the file's; the state goes to
    `device`, CUDA unless the caller names another (without CUDA that
    raises)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to read a '
                'restart onto the CPU')
        device = 'cuda'
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z['__meta__']))
        kwargs = {}
        for f in dataclasses.fields(State):
            t = torch.from_numpy(np.ascontiguousarray(z[f.name]))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            kwargs[f.name] = t.to(device)
    state = State(**kwargs)
    clock = modeltime.ModelTime(
        date0=cal.Date.from_ymd(meta['date0']),
        date=cal.Date.from_ymd(meta['date']),
        **{k: meta[k] for k in _CLOCK_KEYS})
    return state, clock


def restart_filename(runid: str, clock: modeltime.ModelTime,
                     rstfrq: float = 1., rstmon: bool = False,
                     annual: bool = False) -> str:
    """Rotating restart file name (restart_write naming,
    mod_restart.F90:1158-1200): annual restarts get a dated name;
    otherwise a 3-slot rotation keyed by month or restart count."""
    y, mo, d = clock.date.year, clock.date.month, clock.date.day
    if annual:
        return (f'{runid}_restphy_{y:04d}.{mo:02d}.{d:02d}'
                f'_{int(round(clock.time)):06d}.npz')
    if rstmon:
        slot = (mo + 10) % 3 + 1
    else:
        slot = (int(round(min(clock.nstep / max(rstfrq, 1.),
                              clock.time))) - 1) % 3 + 1
    return f'{runid}_restphy_{slot}.npz'


def update_rstdate(dirpath: str, runid: str, fname: str,
                   clock: modeltime.ModelTime):
    """Append the written restart's date to rstdate.txt, keeping the
    last 100 lines (mod_restart.F90:1178-1212)."""
    y, mo, d = clock.date.year, clock.date.month, clock.date.day
    line = (f'{fname}: date {y:04d}.{mo:02d}.{d:02d},'
            f' integration day {int(round(clock.time))}')
    path = os.path.join(dirpath, 'rstdate.txt')
    lines = []
    if os.path.exists(path):
        with open(path) as f:
            lines = [ln.rstrip('\n') for ln in f if ln.strip()]
    lines.append(line)
    with open(path, 'w') as f:
        f.write('\n'.join(lines[-100:]) + '\n')


def restart_write_rotating(dirpath: str, runid: str, state: State,
                           clock: modeltime.ModelTime,
                           rstfrq: float = 1., rstmon: bool = False,
                           annual: bool = False) -> str:
    """Write a restart under its rotating name and log it in rstdate.txt
    (restart_write, mod_restart.F90:1143-1260); returns its path."""
    fname = restart_filename(runid, clock, rstfrq, rstmon, annual)
    path = os.path.join(dirpath, fname)
    write_restart(path, state, clock)
    update_rstdate(dirpath, runid, fname, clock)
    return path
