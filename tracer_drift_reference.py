#!/usr/bin/env python3
"""Phosphorus drift of blom_tpu's own tracer runs in f32, on the CPU.

    JAX_PLATFORMS=cpu python3 tracer_drift_reference.py [itdm jtdm kdm]

Runs the JAX reference package (blom_tpu) as a TPU runs it, with 64-bit
types off, at 96x32x53 unless sizes are given: fuk95 with the ideal age
and the BGC base chain (bench.py's physics, the ALE coordinate) for 10
steps, the isopycnic fuk95 with the BGC (NOIIAOC) for 2 steps, and
fuk95 with the BGC and the carbon isotopes (NOINYOCISO, bench.py's
physics) for 10 steps, each from the initial state, as chip_smoke.py's
`tracers`, `tracers_isopyc` and `ciso` phases run the port.  Prints one JSON line per run with
the relative drift of the total phosphorus (phosphate, phytoplankton,
zooplankton, DOC and detritus, weighted by the layer mass and summed in
f64) from the initial state to the newest time level: the f32 rounding
of blom_tpu's own transport, against which chip_smoke gates the port's.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ['JAX_PLATFORMS'] = 'cpu'


def p_inventory(trc, dp, itrbgc):
    import numpy as np
    from blom_tpu.bgc.params import BgcTracers as T
    t = np.asarray(trc, np.float64)[itrbgc:]
    tot = t[T.phosph] + t[T.phy] + t[T.zoo] + t[T.doc] + t[T.det]
    return float((tot * np.asarray(dp, np.float64)).sum())


def drift(size, nsteps, **build):
    import jax.numpy as jnp
    from blom_tpu.drivers import standalone
    from blom_tpu.dynamics.difest import DifestParams
    t0 = time.perf_counter()
    model = standalone.build_fuk95(dtype=jnp.float32, **size, **build)
    model.par = model.par._replace(difest=DifestParams(egc=.85,
                                                       egmndf=100.))
    itrbgc = model.par.itrbgc
    p0 = p_inventory(model.state.trc[1], model.state.dp[1], itrbgc)
    s, _ = standalone.run(model, nsteps)
    new = 1 if nsteps % 2 == 0 else 0
    p1 = p_inventory(s.trc[new], s.dp[new], itrbgc)
    return dict(build=build, shape=[size['kdm'], size['jtdm'],
                                    size['itdm']],
                dtype='float32', steps=nsteps, rel_p_drift=p1 / p0 - 1.,
                seconds=time.perf_counter() - t0)


def main(argv):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', False)
    itdm, jtdm, kdm = (int(a) for a in argv[1:4]) if len(argv) > 3 \
        else (96, 32, 53)
    size = dict(itdm=itdm, jtdm=jtdm, kdm=kdm)
    for nsteps, build in ((10, dict(use_idlage=True, use_bgc=True)),
                          (2, dict(use_bgc=True, vcoord='isopyc_bulkml')),
                          (10, dict(use_bgc=True, use_ciso=True))):
        print(json.dumps(drift(size, nsteps, **build)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
