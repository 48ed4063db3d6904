#!/usr/bin/env python3
"""Variants of the CPPM sweep kernel (blom_tpu_torch/csrc/cppm_sweep.cu),
checked and timed on one NVIDIA card in one run.

    python3 cppm_variants.py '{"name": {options}, ...}' [--tree DIR]

A variant's options edit the kernel's source before nvcc builds it into
build/cppm_variants/: a constant of the source (`constexpr int NAME =
N;`: "THREADS_I", "THREADS_J_F32", "THREADS_J_F64" (threads per block
of each axis), "NW_F32", "NW_F64" (lines per block of the j-sweep),
"MINB" (the blocks per SM its __launch_bounds__ asks for), whichever
the source has),
"edit" (a list of [old, new] text replacements, for trying a change of
the code beside the kernel as it stands) and "stop" (the kernel ends
after its N-th __syncthreads() in the order of the source, for a
breakdown of the time by stages: the outputs are then wrong, so such a
variant is not checked and is timed in the main path's variant only).
{} is the kernel as it stands.  With --tree DIR the kernel of the
checkout in DIR (a `git archive` of another commit, say) is timed too,
through that checkout's own wrapper and its own chip_smoke.cppm_inputs,
in a subprocess before and after the variants.

Each variant is held against the plain version cppm._cppm_sweep_body on
chip_smoke's inputs with chip_smoke's tolerances, as chip_smoke's
check_cppm does: every (compatibility, limiting) variant, f64 and f32,
both axes, closed and periodic, with and without div_corr.  Each is
timed at the main path's shapes (53x360x384 f32, nt = 2, no div_corr;
the i-sweep closed, the j-sweep periodic, as fuk95's) in every variant,
from CUDA events, in two turns, the second in reverse order; in the main
path's variant (full / non-oscillatory) also the kernel's own device
time from torch.profiler.  Prints one JSON line per build (ptxas
registers, stack, spills; dynamic shared memory per block on each axis
and dtype), per timed or checked case, and the card's name and power
limit.  Exits nonzero without CUDA."""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LIB = 'cppm_sweep'
CUT = ('cppm_sweep_kernel(Args<T> a) {',
       '\ntemplate <typename T, bool FULL, bool MONO>\nint launch_variant')
VARIANTS = (('full', 'non_oscillatory'), ('full', 'monotonic'),
            ('partial', 'non_oscillatory'), ('partial', 'monotonic'))
MAIN = ('full', 'non_oscillatory')
# the main path's sweeps: fuk95 is closed in i and periodic in j
AXES = ((-1, False), (-2, True))


def variant_source(src, opts):
    for key, val in opts.items():
        if key == 'edit':
            for old, new in val:
                if old not in src:
                    raise ValueError(f'edit: {old!r} not in the source')
                src = src.replace(old, new)
            continue
        if key == 'stop':
            head, rest = src.split(CUT[0], 1)
            body, tail = rest.split(CUT[1], 1)
            parts = body.split('__syncthreads();')
            n = int(val)
            if not 1 <= n < len(parts):
                raise ValueError(f'stop={n}: the kernel has '
                                 f'{len(parts) - 1} barriers')
            body = ('__syncthreads();'.join(parts[:n])
                    + '__syncthreads();\n  return;'
                    + '__syncthreads();'.join(parts[n:]))
            src = head + CUT[0] + body + CUT[1] + tail
            continue
        pat = rf'constexpr int {key} = \d+;'
        if not re.search(pat, src):
            raise ValueError(f'{key}: {pat!r} not in the source')
        src = re.sub(pat, f'constexpr int {key} = {int(val)};', src)
    return src


def shared_bytes(lib):
    """{axis/dtype: dynamic shared memory per block} at the main path's
    line lengths."""
    import chip_smoke as cs
    fn = lib.cppm_sweep_shared_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return {f'{a}/{t}': fn(n, ax, f64) for a, ax, n in
            (('i', -1, cs.II), ('j', -2, cs.JJ))
            for t, f64 in (('f32', 0), ('f64', 1))}


def build(variants):
    """{name: ctypes library} of the variants, built all at once."""
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    out_dir = ROOT / 'build' / 'cppm_variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / 'blom_tpu_torch' / 'csrc'
    src = (csrc / f'{LIB}.cu').read_text()
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
        print(json.dumps({'build': name, 'options': variants[name],
                          'ptxas': cs.ptxas_summary(log),
                          'dynamic_smem': shared_bytes(lib)}), flush=True)
        libs[name] = lib
    return libs


def cases():
    """(label, arguments, reference) of chip_smoke's checks of the
    kernel, each reference computed once."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.dynamics import cppm
    dev = torch.device('cuda', 0)
    out = []
    for dtype in (torch.float64, torch.float32):
        for ax in (-1, -2):
            for periodic in (False, True):
                co, args, div = cs.cppm_inputs(ax, periodic, dtype, dev)
                for compat, lim in VARIANTS:
                    for d in (None, div):
                        kw = dict(div_corr=d, ax=ax, compatibility=compat,
                                  limiting=lim)
                        a = (*args, co, periodic)
                        label = dict(variant=f'{compat}/{lim}',
                                     dtype=str(dtype)[6:], ax=ax,
                                     periodic=periodic,
                                     div_corr=d is not None)
                        out.append((label, a, kw,
                                    cppm._cppm_sweep_body(*a, **kw)))
    return out


def timed_cases():
    """(name, args, kwargs) of every variant on both axes at the main
    path's shapes (f32, nt = 2, no div_corr)."""
    import torch
    import chip_smoke as cs
    dev = torch.device('cuda', 0)
    out = []
    for ax, periodic in AXES:
        co, args, _ = cs.cppm_inputs(ax, periodic, torch.float32, dev)
        for compat, lim in VARIANTS:
            out.append((f"{compat}/{lim}/{'i' if ax == -1 else 'j'}",
                        (*args, co, periodic),
                        dict(div_corr=None, ax=ax, compatibility=compat,
                             limiting=lim)))
    return out


def call(args, kw):
    from blom_tpu_torch.dynamics import cppm_cuda
    return cppm_cuda.cppm_sweep_cuda(*args, **kw)


def check(name, checked):
    import torch
    import chip_smoke as cs
    ok = True
    for label, args, kw, ref in checked:
        out = call(args, kw)
        torch.cuda.synchronize()
        good, eabs, _ = cs.compare(out, ref, getattr(torch, label['dtype']))
        ok &= good
        print(json.dumps({'variant': name, **label, 'ok': good,
                          'max_abs_err': eabs}), flush=True)
    return ok


def time_all(name, timed, turns, main_only=False):
    import chip_smoke as cs
    main = '/'.join(MAIN)
    for case, args, kw in timed:
        if main_only and not case.startswith(main + '/'):
            continue

        def run():
            return call(args, kw)
        rec = {'variant': name, 'case': case, 'ms': cs.time_ms(run)}
        if case.startswith(main + '/'):
            rec['profiler_ms'] = cs.profiler_ms(run, 'cppm_sweep_kernel')
        turns.setdefault(f'{name}/{case}', []).append(
            [rec['ms'], rec.get('profiler_ms')])
        print(json.dumps(rec), flush=True)


def run_tree(tree):
    """Times the kernel of the checkout in `tree` in a subprocess."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          '--own'], cwd=tree, text=True,
                         capture_output=True, check=True).stdout
    print(out, end='', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('cppm_variants: CUDA is not available', file=sys.stderr)
        return 2
    if argv[:1] == ['--own']:       # the kernel of the checkout it runs in
        sys.path.insert(0, os.getcwd())
        time_all('tree', timed_cases(), {})
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    tree = None
    if '--tree' in argv:
        i = argv.index('--tree')
        tree = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    variants = json.loads(argv[0]) if argv else {'now': {}}
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
            cuda_build._loaded[LIB] = libs[name]
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
