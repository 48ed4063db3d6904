#!/usr/bin/env python3
"""Salinity drift of the f32 ALE step per REGRID_METHOD, in blom_tpu and
in the port, side by side.

    JAX_PLATFORMS=cpu python3 ale_drift_reference.py [itdm jtdm kdm]

Runs fuk95 with bench.py's physics at 96x64x53 unless sizes are given,
in f32 on the CPU, under the nudge regrid and under the direct regrid,
from the initial state for 2, 3, 4, 5 and 6 steps: the JAX reference
package (blom_tpu) with 64-bit types off, as a TPU runs it, and the
port (blom_tpu_torch) on CPU tensors.  Prints one JSON line per run
with the largest deviation of salinity from its uniform 35 over water
at the newest time level, the thinnest layer there that is not empty,
and whether every field is finite.  The steps chip_smoke's `highorder`
phase gates (4, from the initial state) are among them: its SALN_REF is
blom_tpu's direct-regrid reading after 4 steps here, and its
direct-regrid salinity bound SALN_DEV_DIRECT twice that.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ['JAX_PLATFORMS'] = 'cpu'

METHODS = {'nudge': {}, 'direct': dict(regrid_method='direct')}
STEPS = (2, 3, 4, 5, 6)
FIELDS = ('dp', 'temp', 'saln', 'u', 'v', 'pb')
DIFEST = dict(egc=.85, egmndf=100.)


def _record(package, method, size, nsteps, saln, dp, ip, fields, t0):
    import numpy as np
    dev = np.abs(np.asarray(saln, np.float64) - 35.)[:, ip]
    dp = np.asarray(dp, np.float64)[:, ip]
    return dict(package=package, method=method,
                shape=[size['kdm'], size['jtdm'], size['itdm']],
                dtype='float32', steps=nsteps,
                finite=all(bool(np.isfinite(np.asarray(f)).all())
                           for f in fields),
                max_saln_dev=float(np.nanmax(dev)) if np.isfinite(dev).any()
                else float('nan'),
                min_wet_dp=float(dp[dp > 0.].min()) if (dp > 0.).any()
                else float('nan'),
                seconds=time.perf_counter() - t0)


def run_blom_tpu(size, method, nsteps):
    import jax.numpy as jnp
    import numpy as np
    from blom_tpu.drivers import standalone
    from blom_tpu.dynamics.difest import DifestParams
    t0 = time.perf_counter()
    model = standalone.build_fuk95(dtype=jnp.float32, **size)
    model.par = model.par._replace(
        difest=DifestParams(**DIFEST),
        ale=model.par.ale._replace(**METHODS[method]))
    s, _ = standalone.run(model, nsteps)
    new = 1 if nsteps % 2 == 0 else 0
    return _record('blom_tpu', method, size, nsteps, s.saln[new], s.dp[new],
                   np.asarray(model.grid.ip) > 0,
                   [getattr(s, f) for f in FIELDS], t0)


def run_port(size, method, nsteps):
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    t0 = time.perf_counter()
    model = standalone.build_fuk95(dtype=torch.float32, device='cpu',
                                   **size)
    model.par = model.par._replace(
        difest=DifestParams(**DIFEST),
        ale=model.par.ale._replace(**METHODS[method]))
    s, _ = standalone.run(model, nsteps)
    new = 1 if nsteps % 2 == 0 else 0
    return _record('port', method, size, nsteps, s.saln[new].numpy(),
                   s.dp[new].numpy(),
                   model.grid.ip.numpy() > 0,
                   [getattr(s, f).numpy() for f in FIELDS], t0)


def main(argv):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', False)
    itdm, jtdm, kdm = (int(a) for a in argv[1:4]) if len(argv) > 3 \
        else (96, 64, 53)
    size = dict(itdm=itdm, jtdm=jtdm, kdm=kdm)
    for method in METHODS:
        for nsteps in STEPS:
            for run in (run_blom_tpu, run_port):
                print(json.dumps(run(size, method, nsteps)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
