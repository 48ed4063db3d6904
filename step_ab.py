#!/usr/bin/env python3
"""The port's main-path step timed in two checkouts on one NVIDIA card,
in one run.

    python3 step_ab.py --tree DIR [--order PCCP]

DIR is another checkout of the repository (a `git archive` of the parent
commit, say).  Each letter of --order starts one process: P runs the
port of DIR, C the port beside this script, each importing only its own
`blom_tpu_torch` and building its kernels into its own build/ (the first
process of a checkout compiles them; its warm-up steps absorb that).
A process times, as chip_smoke.py's `slice` and `deck_fuk95` phases do:
the fuk95 step at 384x360x53 f32 with bench.py's difest, 10 and 11 steps
after 2 of warm-up, then the device time of each phase over 4 steps
(the CUDA events `step.phase_marks` records), then decks A, B and C of
chip_smoke.DECKS as fuk95 at the same size, 4 steps after 1.  Prints
one JSON line per process, then the median of each number per checkout,
then the card's name and power limit.  Exits nonzero without CUDA."""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _chip_smoke():
    """chip_smoke.py beside this script, for its sizes and its decks (it
    imports blom_tpu_torch only inside its functions, so they use the
    checkout that this process put first on sys.path)."""
    spec = importlib.util.spec_from_file_location('chip_smoke_ab',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _timed(run, model, nsteps):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(model, nsteps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / nsteps


def child(tree):
    """Time the port of checkout `tree`; print one JSON line."""
    sys.path.insert(0, str(tree))
    import torch
    import blom_tpu_torch
    if Path(blom_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f'imported {blom_tpu_torch.__file__}, '
                           f'not the port of {tree}')
    from blom_tpu_torch.core.config import load_limits
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import step
    from blom_tpu_torch.dynamics.difest import DifestParams
    cs = _chip_smoke()
    dev = torch.device('cuda', 0)
    size = dict(itdm=cs.II, jtdm=cs.JJ, kdm=cs.KK)
    model = standalone.build_fuk95(dtype=torch.float32, device=dev, **size)
    model.par = model.par._replace(difest=DifestParams(**cs.BENCH_DIFEST))
    standalone.run(model, 2)
    rec = {'tree': str(tree),
           'fuk95_s_per_step': [_timed(standalone.run, model, n)
                                for n in (10, 11)]}
    step.phase_marks = marks = []
    try:
        standalone.run(model, 4)
    finally:
        step.phase_marks = None
    torch.cuda.synchronize()
    ms = {}
    for (name, e0), (_, e1) in zip(marks, marks[1:]):
        if name != 'end':
            ms[name] = ms.get(name, 0.) + e0.elapsed_time(e1) / 4
    rec['step_ms'] = marks[0][1].elapsed_time(marks[-1][1]) / 4
    rec['phase_ms'] = dict(sorted(ms.items(), key=lambda kv: -kv[1]))
    del model
    rec['decks_fuk95_s_per_step'] = {}
    for name in cs.DECKS:
        cfg = load_limits(cs.deck_path(name, 'float32', 'fuk95'))
        deck = cs.build_deck_case(cfg, dev, **size)
        standalone.run(deck, 1)
        rec['decks_fuk95_s_per_step'][name] = _timed(standalone.run, deck,
                                                     4)
        del deck
    print(json.dumps(rec), flush=True)


def _median(recs, get):
    return statistics.median(get(r) for r in recs)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('step_ab: CUDA is not available', file=sys.stderr)
        return 2
    if '--child' in argv:
        child(Path(argv[argv.index('--child') + 1]).resolve())
        return 0
    if '--tree' not in argv:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {'P': Path(argv[argv.index('--tree') + 1]).resolve(),
             'C': ROOT}
    order = argv[argv.index('--order') + 1] if '--order' in argv \
        else 'PCCP'
    runs = {k: [] for k in trees}
    for k in order:
        env = dict(os.environ, PYTHONPATH=str(trees[k]))
        out = subprocess.run([sys.executable, __file__, '--child',
                              str(trees[k])], env=env, cwd=trees[k],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec['label'] = k
        print(json.dumps(rec), flush=True)
        runs[k].append(rec)
    summary = {}
    for k, recs in runs.items():
        phases = recs[0]['phase_ms']
        summary[k] = {
            'tree': str(trees[k]), 'processes': len(recs),
            'fuk95_s_per_step': _median(
                recs, lambda r: statistics.median(r['fuk95_s_per_step'])),
            'step_ms': _median(recs, lambda r: r['step_ms']),
            'phase_ms': {p: _median(recs, lambda r: r['phase_ms'].get(p, 0.))
                         for p in phases},
            'decks_fuk95_s_per_step': {
                d: _median(recs, lambda r: r['decks_fuk95_s_per_step'][d])
                for d in recs[0]['decks_fuk95_s_per_step']}}
    print(json.dumps({'summary': summary}), flush=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
