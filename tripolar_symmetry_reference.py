#!/usr/bin/env python3
"""Fold asymmetry of blom_tpu's own tripolar run in f32, on the CPU.

    JAX_PLATFORMS=cpu python3 tripolar_symmetry_reference.py [--jit] \
        [itdm jtdm kdm]

Runs the JAX reference package (blom_tpu) with 64-bit types off, at
384x64x53 unless sizes are given (the width and depth of tnx1, 64 rows):
build_tripolar in f32, then 4 steps with the end-of-step fold sync
(blom_tpu.parallel.arctic.sync_state) replaced by the identity, as
tests/test_tripolar.py does in f64 and chip_smoke.py's
`tripolar_symmetry` phase does with the port.  The steps run op by op
(`jax.disable_jit()`), so that each operation rounds once, as the port's
PyTorch operations and its kernels (nvcc -fmad=false) do; with --jit
they run compiled by XLA, whose fusions contract multiplies and adds
into single roundings that differ between a point and its mirror.
Prints one JSON line with, for every field of arctic.STATE_KINDS, the
largest deviation of its fold-duplicated degrees of freedom from their
mirrors, max |arctic_sync(a) - a| (`asymmetry`), and the field's largest
magnitude (`scale`): the f32 rounding of blom_tpu's own fold reads,
against which chip_smoke gates the port's (SYMMETRY_REF, from the run
op by op).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ['JAX_PLATFORMS'] = 'cpu'


def asymmetry(size, nsteps, eager=True):
    import contextlib
    import jax
    import jax.numpy as jnp
    import numpy as np
    from blom_tpu.drivers import standalone
    from blom_tpu.parallel import arctic
    t0 = time.perf_counter()
    model = standalone.build_tripolar(dtype=jnp.float32, **size)
    sync = arctic.sync_state
    arctic.sync_state = lambda s: s
    try:
        with jax.disable_jit() if eager else contextlib.nullcontext():
            s, _ = standalone.run(model, nsteps)
    finally:
        arctic.sync_state = sync
    err, scale = {}, {}
    for name, (kind, vector) in arctic.STATE_KINDS.items():
        a = getattr(s, name)
        err[name] = float(np.max(np.abs(np.asarray(
            arctic.arctic_sync(a, kind, vector) - a), dtype=np.float64),
            initial=0.))
        scale[name] = float(np.max(np.abs(np.asarray(a, np.float64)),
                                   initial=0.))
    return dict(shape=[size['kdm'], size['jtdm'], size['itdm']],
                dtype='float32', steps=nsteps, eager=eager,
                finite=bool(np.isfinite(np.asarray(s.dp)).all()),
                asymmetry=err, scale=scale,
                seconds=time.perf_counter() - t0)


def main(argv):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', False)
    eager = '--jit' not in argv
    sizes = [a for a in argv[1:] if a != '--jit']
    itdm, jtdm, kdm = (int(a) for a in sizes) if sizes else (384, 64, 53)
    print(json.dumps(asymmetry(dict(itdm=itdm, jtdm=jtdm, kdm=kdm), 4,
                               eager)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
