#!/usr/bin/env python3
"""Variants of the momentum kernel (blom_tpu_torch/csrc/momtum_uv.cu),
checked and timed on one NVIDIA card in one run.

    python3 momtum_variants.py '{"name": {options}, ...}' [--tree DIR]

A variant's options edit the kernel's constants before nvcc builds it
into build/momtum_variants/: "TJ" (rows of a tile), "KB" (k-levels of a
block), "minb" (the blocks per SM its __launch_bounds__ asks for, in f32
and f64, which caps the registers at 65536 / (minb * threads)) and
"stop" (each level ends after stage N, for a breakdown of the time by
stages: the outputs are then wrong and the check fails).  {} is the
kernel as it stands.
With --tree DIR the momentum kernel of the checkout in DIR (a
`git archive` of another commit, say) is timed too, through that
checkout's own wrapper, in a subprocess before and after the variants.

Each variant is held against the plain version on chip_smoke's inputs
with its tolerances (f64 and f32, closed and periodic i, every scheme)
and timed at the main path's shapes in f32 with closed i (chip_smoke's
timing), in two turns, the second in reverse order.  Prints one JSON line
per build (ptxas registers and spills), per timed or checked case, and
the card's name and power limit.  Exits nonzero without CUDA."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TSFAC, DELT1 = 6. / 360., 360.
VISC = dict(mdv2hi=2., mdv2lo=1., vsc4hi=.1, vsc4lo=.05)   # chip_smoke's


def variant_source(src, opts):
    edits = {'TJ': ('TJ = 16;', 'TJ = {};'), 'KB': ('KB = 4;', 'KB = {};'),
             'minb': ('MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;',
                      'MIN_BLOCKS = {};')}
    for key, (old, new) in edits.items():
        if key in opts:
            if old not in src:
                raise ValueError(f'{key}: {old!r} not in the source')
            src = src.replace(old, new.format(opts[key]))
    if 'stop' in opts:
        # the level loop's barriers: before stage 1, then after stages 1-4
        head, body = src.split('void run_tile', 1)
        parts = body.split('__syncthreads();\n')
        n = opts['stop'] + 1
        src = (head + 'void run_tile' + '__syncthreads();\n'.join(parts[:n])
               + '__syncthreads();\n    continue;\n'
               + '__syncthreads();\n'.join(parts[n:]))
    return src


def build(variants):
    """{name: ctypes library} of the variants, built all at once."""
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    out_dir = ROOT / 'build' / 'momtum_variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ROOT / 'blom_tpu_torch' / 'csrc' / 'momtum_uv.cu').read_text()
    procs = {}
    for name, opts in variants.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(variant_source(src, opts))
        so = out_dir / f'lib{name}.so'
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o', str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        print(json.dumps({'build': name, 'ptxas': cs.ptxas_summary(log)}),
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def cases():
    """(dtype, periodic_i, inputs) of chip_smoke's momentum checks."""
    import torch
    import chip_smoke as cs
    dev = torch.device('cuda', 0)
    for dtype in (torch.float64, torch.float32):
        for periodic_i in (False, True):
            yield dtype, periodic_i, cs.momtum_inputs(periodic_i, dtype, dev)


def run(name, turns, check=True):
    """Check and time the wrapper's kernel as it is now bound; times are
    appended to turns[(name, scheme)]."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.dynamics import momtum, momtum_cuda
    for dtype, periodic_i, (grid, f, d2) in cases():
        timed = dtype == torch.float32 and not periodic_i
        if not (check or timed):
            continue
        for mommth in momtum.MOMMTHS:
            par = momtum.MomtumParams(mommth=mommth, **VISC)

            def call():
                return momtum_cuda.momtum_uv_cuda(grid, par, f, d2, TSFAC,
                                                  DELT1)
            rec = {'variant': name, 'mommth': mommth,
                   'dtype': str(dtype)[6:], 'periodic_i': periodic_i}
            if check:
                ref = momtum._uv_body(grid, par, f, d2, TSFAC, DELT1)
                out = call()
                torch.cuda.synchronize()
                rec['ok'], rec['max_abs_err'], _ = cs.compare(out, ref,
                                                              dtype)
            if timed:
                rec['ms'] = cs.time_ms(call)
                turns.setdefault((name, mommth), []).append(rec['ms'])
            print(json.dumps(rec), flush=True)


def run_tree(tree):
    """Times the kernel of the checkout in `tree` in a subprocess."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          '--own'], cwd=tree, text=True, capture_output=True,
                         check=True).stdout
    print(out, end='', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('momtum_variants: CUDA is not available', file=sys.stderr)
        return 2
    if argv[:1] == ['--own']:       # the kernel of the checkout it runs in
        sys.path.insert(0, os.getcwd())
        run('tree', {}, check=False)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from blom_tpu_torch.dynamics import momtum_cuda
    tree = argv[argv.index('--tree') + 1] if '--tree' in argv else None
    args = [a for a in argv if a != '--tree' and a != tree]
    variants = json.loads(args[0]) if args else {'now': {}}
    print(cs.card_line(), flush=True)
    if tree:
        run_tree(tree)
    libs = build(variants)
    turns = {}
    for names, check in ((list(libs), True), (list(libs)[::-1], False)):
        for name in names:
            momtum_cuda._lib = lambda lib=libs[name]: lib
            run(name, turns, check)
    if tree:
        run_tree(tree)
    print(json.dumps({'ms_per_turn': {f'{n}/{m}': t
                                      for (n, m), t in turns.items()}}))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
