"""Named wall-clock timers.

Counterpart of `blom_tpu/utils/timing.py` (BLOM's phy/mod_timing.F90:
39-494): named timers with accumulated totals and per-interval
statistics on the host clock.  Work on the card is asynchronous, so
`stop` can first wait for the devices of the tensors it is given, to
charge their work to the right phase (where blom_tpu calls
`block_until_ready`)."""

from __future__ import annotations

import time
from typing import Dict

import torch


def _synchronize(tree):
    """torch.cuda.synchronize on each CUDA device holding a tensor of
    `tree` (a tensor, or a dataclass, mapping or sequence of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, '__dataclass_fields__'):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)


class Timers:
    """timer_init/start/stop/statistics (mod_timing.F90:107-326)."""

    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.min: Dict[str, float] = {}
        self.max: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def start(self, name: str):
        self._t0[name] = time.perf_counter()

    def stop(self, name: str, block_on=None) -> float:
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - self._t0.pop(name)
        self.total[name] = self.total.get(name, 0.) + dt
        self.count[name] = self.count.get(name, 0) + 1
        self.min[name] = min(self.min.get(name, dt), dt)
        self.max[name] = max(self.max.get(name, dt), dt)
        return dt

    def statistics(self) -> str:
        """Per-timer total/mean/min/max report
        (timer_statistics, mod_timing.F90:329-494)."""
        lines = [f'{"timer":<24}{"count":>8}{"total[s]":>12}'
                 f'{"mean[s]":>12}{"min[s]":>12}{"max[s]":>12}']
        for name in sorted(self.total):
            n = self.count[name]
            tot = self.total[name]
            lines.append(f'{name:<24}{n:>8}{tot:>12.4f}'
                         f'{tot / n:>12.4f}{self.min[name]:>12.4f}'
                         f'{self.max[name]:>12.4f}')
        return '\n'.join(lines)

    def step_line(self, nstep: int, name: str = 'step') -> str:
        """The per-step wall-time print (mod_blom_step.F90:311-313)."""
        return (f' {self.total.get(name, 0.) / max(self.count.get(name, 1), 1):9.4f}'
                f' sec for step {nstep}')
