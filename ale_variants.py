#!/usr/bin/env python3
"""Variants of the ALE kernels K1 (blom_tpu_torch/csrc/ale_regrid.cu) and
K2 (ale_remap.cu), checked and timed on one NVIDIA card in one run.

    python3 ale_variants.py '{"name": {options}, ...}' [--kernel regrid]
                            [--tree DIR]

--kernel picks the kernel: remap (K2, the default) or regrid (K1).  A
variant's options edit the kernel's constants before nvcc builds it
into build/ale_variants/: "TC_F32", "TC_F64" (columns per tile),
"NF_F32", "NF_F64" (K2: fields per chunk), "MINB_F32", "MINB_F64" (the
blocks per SM its __launch_bounds__ asks for, which caps the registers
at 65536 / (MINB * THREADS)), "THREADS" (threads per block), "edit"
(a list of [old, new] text replacements, for trying a change of the
code beside the kernel as it stands) and "stop" (each group of K2, or
K1's tile, ends after its N-th __syncthreads(), for a breakdown of the
time by stages: the outputs are then wrong, so such a variant is not
checked and is timed in the main path's limiters only).  {} is the
kernel as it stands.  With --tree DIR the kernel of the checkout in DIR
(a `git archive` of another commit, say) is timed too, through that
checkout's own wrapper and its own chip_smoke.ale_inputs, in a
subprocess before and after the variants.

Each variant of K2 is held against the plain version ale.remap_plain on
chip_smoke's inputs with chip_smoke's tolerances (f64 and f32; ntr 0 and
5 with each limiter for both groups and deck B's pair, ntr 37 with the
main path's pair) and timed at the main path's shapes (f32, ntr 0) in
every (tracer, velocity) limiter pair; each variant of K1 against
ale.regrid_plain on the same inputs in each limiter, f64 and f32, and
timed at the main path's shapes (f32) in each limiter.  Timed in two
turns, the second in reverse order; in the main path's limiters also
the kernel's own device time from torch.profiler.  Prints one JSON line
per build (ptxas registers, stack, spills; dynamic shared memory per
block at kk = 53), per timed or checked case, and the card's name and
power limit.  Exits nonzero without CUDA."""

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
# per kernel: its library, the device function whose barriers `stop`
# counts, and the main path's limiters
KERNELS = {
    'remap': dict(lib='ale_remap', cut='void remap_group(',
                  main=('non_oscillatory', 'non_oscillatory')),
    'regrid': dict(lib='ale_regrid', cut='void regrid_tile(',
                   main=('non_oscillatory',)),
}
KERNEL = KERNELS['remap']


def variant_source(src, opts):
    for key, val in opts.items():
        if key == 'edit':
            for old, new in val:
                if old not in src:
                    raise ValueError(f'edit: {old!r} not in the source')
                src = src.replace(old, new)
            continue
        if key == 'stop':
            head, rest = src.split(KERNEL['cut'], 1)
            body, tail = rest.split('__global__', 1)
            parts = body.split('__syncthreads();')
            n = int(val)
            if not 1 <= n < len(parts):
                raise ValueError(f'stop={n}: the group has '
                                 f'{len(parts) - 1} barriers')
            body = ('__syncthreads();'.join(parts[:n])
                    + '__syncthreads();\n  return;'
                    + '__syncthreads();'.join(parts[n:]))
            src = head + KERNEL['cut'] + body + '__global__' + tail
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
    src = (csrc / f"{KERNEL['lib']}.cu").read_text()
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
        fn = getattr(lib, f"{KERNEL['lib']}_shared_bytes")
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
    """(dtype, ntr, limiters, arguments, reference) of chip_smoke's checks
    of the kernel, each reference computed once."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.dynamics import ale
    dev = torch.device('cuda', 0)
    e = eos.init_eos(pref=0., expcnf='fuk95')
    out = []
    if KERNEL['lib'] == 'ale_regrid':
        for dtype in (torch.float64, torch.float32):
            x = cs.ale_inputs(dtype, dev, 0)
            for lim in LIMS:
                args = rargs(x, lim, e)
                out.append((dtype, 0, (lim,), args, ale.regrid_plain(*args)))
        return out
    pairs = [(lim, lim) for lim in LIMS] + [tuple(cs.DECKS['B'][3:])]
    for dtype in (torch.float64, torch.float32):
        for ntr in cs.NTR_CHECK:
            x = cs.ale_inputs(dtype, dev, ntr)
            for tlim, vlim in (pairs if ntr != cs.NTR_MANY
                               else [('non_oscillatory',) * 2]):
                args = margs(x, tlim, vlim, e)
                ref = ale.remap_plain(*args)
                out.append((dtype, ntr, (tlim, vlim), args, ref))
    return out


def rargs(x, lim, e):
    """regrid_cuda's arguments on chip_smoke's inputs x, as chip_smoke's
    check builds them."""
    from blom_tpu_torch.dynamics import ale
    import chip_smoke as cs
    par = ale.make_ale_params(cs.KK)._replace(tracer_limiting=lim)
    return (e, par, x['p'], x['temp'], x['saln'], x['sigmar'], 360.)


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
    """(limiters, args) of every limiter (K1) or limiter pair (K2) at the
    main path's shapes (f32, ntr 0)."""
    import torch
    import chip_smoke as cs
    from blom_tpu_torch.core import eos
    x = cs.ale_inputs(torch.float32, torch.device('cuda', 0), 0)
    e = eos.init_eos(pref=0., expcnf='fuk95')
    if KERNEL['lib'] == 'ale_regrid':
        return [((t,), rargs(x, t, e)) for t in LIMS]
    return [((t, v), margs(x, t, v, e)) for t in LIMS for v in LIMS]


def call(args):
    """The kernel's wrapper on args: its outputs as one list."""
    from blom_tpu_torch.dynamics import ale_cuda
    if KERNEL['lib'] == 'ale_regrid':
        return list(ale_cuda.regrid_cuda(*args))
    out = ale_cuda.remap_cuda(*args)
    return list(out[0]) + [out[1], out[2]]


def check(name, checked):
    import torch
    import chip_smoke as cs
    ok = True
    for dtype, ntr, lims, args, ref in checked:
        out = call(args)
        torch.cuda.synchronize()
        refs = list(ref) if KERNEL['lib'] == 'ale_regrid' else \
            list(ref[0]) + [ref[1], ref[2]]
        good, eabs, _ = cs.compare(out, refs, dtype)
        ok &= good
        print(json.dumps({'variant': name, 'dtype': str(dtype)[6:],
                          'ntr': ntr, 'lims': '/'.join(lims), 'ok': good,
                          'max_abs_err': eabs}), flush=True)
    return ok


def time_all(name, timed, turns, main_only=False):
    import chip_smoke as cs
    for lims, args in timed:
        if main_only and lims != KERNEL['main']:
            continue

        def run():
            return call(args)
        rec = {'variant': name, 'lims': '/'.join(lims),
               'ms': cs.time_ms(run)}
        if lims == KERNEL['main']:
            rec['profiler_ms'] = cs.profiler_ms(
                run, f"{KERNEL['lib']}_kernel")
        turns.setdefault(f"{name}/{'/'.join(lims)}", []).append(rec['ms'])
        print(json.dumps(rec), flush=True)


def run_tree(tree, kernel):
    """Times the kernel of the checkout in `tree` in a subprocess."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          '--own', kernel], cwd=tree, text=True,
                         capture_output=True, check=True).stdout
    print(out, end='', flush=True)


def main(argv):
    global KERNEL
    import torch
    if not torch.cuda.is_available():
        print('ale_variants: CUDA is not available', file=sys.stderr)
        return 2
    if argv[:1] == ['--own']:       # the kernel of the checkout it runs in
        sys.path.insert(0, os.getcwd())
        KERNEL = KERNELS[argv[1]]
        time_all('tree', timed_cases(), {})
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from blom_tpu_torch import cuda_build
    opts = {}
    for flag in ('--tree', '--kernel'):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    tree = opts.get('--tree')
    kernel = opts.get('--kernel', 'remap')
    KERNEL = KERNELS[kernel]
    variants = json.loads(argv[0]) if argv else {'now': {}}
    print(cs.card_line(), flush=True)
    if tree:
        run_tree(tree, kernel)
    libs = build(variants)
    cut = {name for name, opts in variants.items() if 'stop' in opts}
    checked = cases() if cut != set(variants) else []
    timed = timed_cases()
    turns, ok = {}, True
    for names, first in ((list(libs), True), (list(libs)[::-1], False)):
        for name in names:
            cuda_build._loaded[KERNEL['lib']] = libs[name]
            if first and name not in cut:
                ok &= check(name, checked)
            time_all(name, timed, turns, main_only=name in cut)
    if tree:
        run_tree(tree, kernel)
    print(json.dumps({'ms_per_turn': turns, 'ok': ok}))
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
