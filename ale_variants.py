#!/usr/bin/env python3
"""Variants of the ALE remap kernel K2 (blom_tpu_torch/csrc/ale_remap.cu),
checked and timed on one NVIDIA card in one run.

    python3 ale_variants.py '{"name": {options}, ...}' [--tree DIR]

A variant's options edit the kernel's constants before nvcc builds it
into build/ale_variants/: "TC_F32", "TC_F64" (columns per tile),
"NF_F32", "NF_F64" (fields per chunk), "MINB_F32", "MINB_F64" (the
blocks per SM its __launch_bounds__ asks for, which caps the registers
at 65536 / (MINB * THREADS)), "THREADS" (threads per block), "edit"
(a list of [old, new] text replacements, for trying a change of the
code beside the kernel as it stands) and "stop" (each group ends after its N-th __syncthreads(), for a
breakdown of the time by stages: the outputs are then wrong, so such a
variant is not checked and is timed in the main path's limiter pair
only).  {} is the kernel as it stands.
With --tree DIR the K2 of the checkout in DIR (a `git archive` of
another commit, say) is timed too, through that checkout's own wrapper
and its own chip_smoke.ale_inputs, in a subprocess before and after the
variants.

Each variant is held against the plain version ale.remap_plain on
chip_smoke's inputs with chip_smoke's tolerances (f64 and f32; ntr 0 and
5 with each limiter for both groups and deck B's pair, ntr 37 with the
main path's pair) and timed at the main path's shapes (f32, ntr 0) in
every (tracer, velocity) limiter pair, in two turns, the second in
reverse order; in the main path's pair also the kernel's own device
time from torch.profiler.  Prints one JSON line per build (ptxas
registers, stack, spills; dynamic shared memory per block at kk = 53),
per timed or checked case, and the card's name and power limit.  Exits
nonzero without CUDA."""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OPTIONS = ('TC_F32', 'TC_F64', 'NF_F32', 'NF_F64', 'MINB_F32', 'MINB_F64',
           'THREADS', 'edit', 'stop')
LIMS = ('monotonic', 'non_oscillatory', 'non_oscillatory_posdef')
MAIN = ('non_oscillatory', 'non_oscillatory')


def variant_source(src, opts):
    for key, val in opts.items():
        if key == 'edit':
            for old, new in val:
                if old not in src:
                    raise ValueError(f'edit: {old!r} not in the source')
                src = src.replace(old, new)
            continue
        if key == 'stop':
            head, rest = src.split('void remap_group(', 1)
            body, tail = rest.split('__global__', 1)
            parts = body.split('__syncthreads();')
            n = int(val)
            if not 1 <= n < len(parts):
                raise ValueError(f'stop={n}: the group has '
                                 f'{len(parts) - 1} barriers')
            body = ('__syncthreads();'.join(parts[:n])
                    + '__syncthreads();\n  return;'
                    + '__syncthreads();'.join(parts[n:]))
            src = head + 'void remap_group(' + body + '__global__' + tail
            continue
        if key not in OPTIONS:
            raise ValueError(f'unknown option {key!r}')
        pat = rf'constexpr int {key} = \d+;'
        if not re.search(pat, src):
            raise ValueError(f'{key}: {pat!r} not in the source')
        src = re.sub(pat, f'constexpr int {key} = {int(val)};', src)
    return src


def build(variants):
    """{name: ctypes library} of the variants, built all at once."""
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    out_dir = ROOT / 'build' / 'ale_variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / 'blom_tpu_torch' / 'csrc'
    src = (csrc / 'ale_remap.cu').read_text()
    procs = {}
    for name, opts in variants.items():
        cu = out_dir / f'{name}.cu'
        cu.write_text(variant_source(src, opts))
        so = out_dir / f'lib{name}.so'
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-I', str(csrc),
             '-o', str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        lib = ctypes.CDLL(str(so))
        fn = lib.ale_remap_shared_bytes
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
        print(json.dumps({'build': name, 'options': variants[name],
                          'ptxas': cs.ptxas_summary(log),
                          'dynamic_smem': {'f32': fn(cs.KK, 0),
                                           'f64': fn(cs.KK, 1)}}),
              flush=True)
        libs[name] = lib
    return libs


def cases():
    """(dtype, ntr, (tlim, vlim), inputs, reference) of chip_smoke's K2
    checks, each reference computed once."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.dynamics import ale
    dev = torch.device('cuda', 0)
    e = eos.init_eos(pref=0., expcnf='fuk95')
    pairs = [(lim, lim) for lim in LIMS] + [tuple(cs.DECKS['B'][3:])]
    out = []
    for dtype in (torch.float64, torch.float32):
        for ntr in cs.NTR_CHECK:
            x = cs.ale_inputs(dtype, dev, ntr)
            for tlim, vlim in (pairs if ntr != cs.NTR_MANY
                               else [('non_oscillatory',) * 2]):
                args = margs(x, tlim, vlim, e)
                ref = ale.remap_plain(*args)
                out.append((dtype, ntr, (tlim, vlim), args, ref))
    return out


def margs(x, tlim, vlim, e):
    """remap_cuda's arguments on chip_smoke's inputs x, as chip_smoke's
    check builds them."""
    from blom_tpu_torch.dynamics import ale
    import chip_smoke as cs
    par = ale.make_ale_params(cs.KK)._replace(tracer_limiting=tlim,
                                              velocity_limiting=vlim)
    p_dst = ale.regrid_plain(e, par, x['p'], x['temp'], x['saln'],
                             x['sigmar'], 360.)[0]
    return (par, x['p'], [x['temp'], x['saln']] + x['trc'], x['pu'],
            x['u'], x['pv'], x['v'], p_dst, p_dst * .98, p_dst * .97)


def timed_cases():
    """(tlim, vlim, args) of every limiter pair at the main path's shapes
    (f32, ntr 0)."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.core import eos
    x = cs.ale_inputs(torch.float32, torch.device('cuda', 0), 0)
    e = eos.init_eos(pref=0., expcnf='fuk95')
    return [(t, v, margs(x, t, v, e)) for t in LIMS for v in LIMS]


def check(name, checked):
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.dynamics import ale_cuda
    ok = True
    for dtype, ntr, (tlim, vlim), args, ref in checked:
        out = ale_cuda.remap_cuda(*args)
        torch.cuda.synchronize()
        good, eabs, _ = cs.compare(list(out[0]) + [out[1], out[2]],
                                   list(ref[0]) + [ref[1], ref[2]], dtype)
        ok &= good
        print(json.dumps({'variant': name, 'dtype': str(dtype)[6:],
                          'ntr': ntr, 'lims': f'{tlim}/{vlim}', 'ok': good,
                          'max_abs_err': eabs}), flush=True)
    return ok


def time_all(name, timed, turns, main_only=False):
    import chip_smoke as cs
    from blom_tpu_torch.dynamics import ale_cuda
    for tlim, vlim, args in timed:
        if main_only and (tlim, vlim) != MAIN:
            continue

        def call():
            return ale_cuda.remap_cuda(*args)
        rec = {'variant': name, 'lims': f'{tlim}/{vlim}',
               'ms': cs.time_ms(call)}
        if (tlim, vlim) == MAIN:
            rec['profiler_ms'] = cs.profiler_ms(call, 'ale_remap_kernel')
        turns.setdefault(f'{name}/{tlim}/{vlim}', []).append(rec['ms'])
        print(json.dumps(rec), flush=True)


def run_tree(tree):
    """Times the K2 of the checkout in `tree` in a subprocess."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          '--own'], cwd=tree, text=True, capture_output=True,
                         check=True).stdout
    print(out, end='', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('ale_variants: CUDA is not available', file=sys.stderr)
        return 2
    if argv[:1] == ['--own']:       # the kernel of the checkout it runs in
        sys.path.insert(0, os.getcwd())
        time_all('tree', timed_cases(), {})
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    tree = argv[argv.index('--tree') + 1] if '--tree' in argv else None
    args = [a for a in argv if a != '--tree' and a != tree]
    variants = json.loads(args[0]) if args else {'now': {}}
    print(cs.card_line(), flush=True)
    if tree:
        run_tree(tree)
    libs = build(variants)
    cut = {name for name, opts in variants.items() if 'stop' in opts}
    checked = cases() if cut != set(variants) else []
    timed = timed_cases()
    turns, ok = {}, True
    for names, first in ((list(libs), True), (list(libs)[::-1], False)):
        for name in names:
            cuda_build._loaded['ale_remap'] = libs[name]
            if first and name not in cut:
                ok &= check(name, checked)
            time_all(name, timed, turns, main_only=name in cut)
    if tree:
        run_tree(tree)
    print(json.dumps({'ms_per_turn': turns, 'ok': ok}))
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
