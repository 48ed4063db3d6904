"""Compset presets and the SMS/ERS test-list runner.

The port of `tools/testsuite.py` (BLOM's cime_config: the aux_blom_noresm
matrix of SMS_D_Ld1 smoke and ERS exact-restart tests over compsets,
testlist_blom.xml:4-40, config_compsets.xml).  A compset maps to a
standalone builder configuration (experiment x vertical coordinate x
tracer set), and the two test kinds are:

  SMS: an N-step smoke test, a finite state and mass conserved to 1e-11;
  ERS: an exact restart, N+M steps straight against N steps, a restart
       written and read through the port's io/restart.py, then M steps;
       the final states bit for bit equal.

Runs on the card in f64 unless --cpu is given:

    python -m blom_tpu_torch.tools.testsuite [--list]
        [--category smoke|restart|all] [--pes 1x1] [--nsteps N] [--cpu]

Only the PE layout 1x1 runs: the decomposition is not ported yet."""

import argparse
import os
import sys
import tempfile

import torch

#: compset name -> standalone builder configuration.  NOINY* is the
#: standalone ocean on the hybrid coordinate, OC adds iHAMOCC, NOII* the
#: isopycnic bulk-ML coordinate (testlist_blom.xml, config_compsets.xml).
COMPSETS = {
    # hybrid (cntiso) vertical coordinate
    'NOINY': dict(vcoord='cntiso_hybrid'),
    'NOINYOC': dict(vcoord='cntiso_hybrid', use_bgc=True),
    'NOINYOCISO': dict(vcoord='cntiso_hybrid', use_bgc=True,
                       use_ciso=True),
    'NOINYAGE': dict(vcoord='cntiso_hybrid', use_idlage=True),
    # isopycnic bulk-ML coordinate (the MICOM heritage compsets)
    'NOIIA': dict(vcoord='isopyc_bulkml'),
    'NOIIAOC': dict(vcoord='isopyc_bulkml', use_bgc=True),
    # tripolar (bipolar fold) smoke
    'NOINYARCTIC': dict(tripolar=True),
}

DEFAULT_GRID = dict(itdm=32, jtdm=16, kdm=6)

#: the test list (the aux_blom_noresm matrix: testlist_blom.xml:4-40)
TESTLIST = [
    ('SMS_D_Ld1', 'NOINY', 'smoke'),
    ('SMS_D_Ld1', 'NOINYOC', 'smoke'),
    ('SMS_D_Ld1', 'NOINYAGE', 'smoke'),
    ('SMS_D_Ld1', 'NOIIA', 'smoke'),
    ('SMS_D_Ld1', 'NOIIAOC', 'smoke'),
    ('SMS_D_Ld1', 'NOINYARCTIC', 'smoke'),
    ('ERS_Ld3', 'NOINY', 'restart'),
    ('ERS_Ld3', 'NOINYAGE', 'restart'),
]


def _check_pes(pes):
    if pes is not None and tuple(pes) != (1, 1):
        raise NotImplementedError(
            f'PE layout {pes}: the decomposition is ROADMAP item 13, not '
            'ported yet; only 1x1 runs')


def build(compset: str, pes=None, device=None):
    """The compset's model in f64 on `device` (CUDA unless named)."""
    from ..drivers import standalone
    _check_pes(pes)
    spec = dict(COMPSETS[compset])
    if spec.pop('tripolar', False):
        return standalone.build_tripolar(itdm=32, jtdm=24, kdm=6,
                                         device=device)
    return standalone.build_fuk95(**DEFAULT_GRID, **spec, device=device)


def _mass(model, dp):
    """Mass over the physical rows: a tripolar grid's top row duplicates
    the row below the fold."""
    g = model.grid
    w = g.scp2 * g.ip
    if g.arctic:
        w = w.clone()
        w[-1, :] = 0.
    return float(torch.sum(dp.sum(0) * w))


def sms(compset: str, nsteps=6, pes=None, device=None) -> str:
    """SMS_D: an N-step debug smoke test (finite and mass conserving)."""
    from ..drivers import standalone
    model = build(compset, pes, device)
    m0 = _mass(model, model.state.dp[1])
    s, clock = standalone.run(model, nsteps)
    if not bool(torch.isfinite(s.dp).all()):
        return 'FAIL (non-finite dp)'
    m1 = _mass(model, s.dp[nsteps % 2])
    if abs(m1 - m0) / m0 > 1e-11:
        return f'FAIL (mass drift {(m1 - m0) / m0:.2e})'
    return 'PASS'


def ers(compset: str, n1=4, n2=4, pes=None, device=None) -> str:
    """ERS: exact restart, N1+N2 steps straight against a restart at
    N1."""
    from ..drivers import standalone
    from ..io import restart as rst

    ref_model = build(compset, pes, device)
    s_ref, _ = standalone.run(ref_model, n1 + n2)

    model = build(compset, pes, device)
    s1, clock1 = standalone.run(model, n1)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, 'rst.npz')
        rst.write_restart(path, s1, clock1)
        s1r, clock1r = rst.read_restart(path, device=model.grid.device)
    model2 = build(compset, pes, device)
    model2.state = s1r
    model2.clock = clock1r
    s2, _ = standalone.run(model2, n2)

    bad = [name for name in ('dp', 'temp', 'saln', 'u', 'v', 'pb', 'ub',
                             'vb')
           if not torch.equal(getattr(s_ref, name), getattr(s2, name))]
    return 'PASS' if not bad else f'FAIL (restart diverges: {bad})'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--list', action='store_true')
    ap.add_argument('--category', default='all',
                    choices=('smoke', 'restart', 'all'))
    ap.add_argument('--pes', default='1x1',
                    help='mesh shape YxX (PE layout)')
    ap.add_argument('--nsteps', type=int, default=6)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)

    if args.list:
        for name, compset, cat in TESTLIST:
            print(f'{name}.{compset}  [{cat}]')
        return 0

    pes = tuple(int(x) for x in args.pes.split('x'))
    _check_pes(pes)
    device = 'cpu' if args.cpu else None
    failed = 0
    for name, compset, cat in TESTLIST:
        if args.category != 'all' and cat != args.category:
            continue
        fn = ers if cat == 'restart' else sms
        kw = {'nsteps': args.nsteps} if cat == 'smoke' else {}
        res = fn(compset, pes=pes, device=device, **kw)
        print(f'{name}.{compset:14s} {res}', flush=True)
        failed += not res.startswith('PASS')
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
