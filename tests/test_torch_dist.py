"""The torch.distributed communicator: the same blocks, one per rank.

Four gloo ranks on the CPU (a 2x2 mesh, a FileStore under the test's
temporary directory so that parallel test workers cannot collide on a
port, one torch thread per rank) run `halo_exchange` with fold halos,
and one margin-k barotp on the tripolar grid; their bits equal the
stacked communicator's run of the same inputs in this process.  The
ranks run this file as a script, once for both cases."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SHAPE = (2, 2)
TRIPOLAR = dict(itdm=32, jtdm=24, kdm=6)
VARIANT = np.array([0, 1, 2, 3, -1, 1])
SIGN = np.array([1., -1., -1., 1., 1., 1.])
SRC = np.array([0, 1, 2, 3, 5, 4])


def _halo(a, comm):
    from blom_tpu_torch.parallel import halo
    blocks = comm.scatter(a)
    wide = halo.halo_exchange(blocks, 3, comm)
    fold = halo.fold_fixup_stack(wide, 3, comm, VARIANT, SIGN, SRC)
    closed = halo.halo_exchange(blocks, 2, comm, periodic_i=False)
    return {'wide': comm.gather(wide), 'fold': comm.gather(fold),
            'closed': comm.gather(closed), 'exchanges': comm.exchanges}


def _barotp(inputs, comm):
    from blom_tpu_torch.dynamics.barotp_shmap import make_barotp_shmap
    model, s, ut, vt = inputs
    p = model.par
    fn = make_barotp_shmap(comm.mesh, comm=comm)
    out = fn(model.grid, s.clone(), ut, vt, 0, 1, p.lstep, p.dlt, p.barotp)
    return {'state': out, 'exchanges': comm.exchanges}


def _inputs(case):
    if case == 'halo':
        rng = np.random.default_rng(5)
        return torch.as_tensor(rng.standard_normal((len(VARIANT), 24, 32)))
    from blom_tpu_torch.drivers import standalone as tst
    from blom_tpu_torch.parallel.arctic import arctic_sync
    model = tst.build_tripolar(**TRIPOLAR, device='cpu')
    s, _ = tst.run(model, 2)
    rng = np.random.default_rng(6)
    ut = torch.as_tensor(rng.standard_normal(model.grid.shape) * 1e-4)
    vt = torch.as_tensor(rng.standard_normal(model.grid.shape) * 1e-4)
    return (model, s, arctic_sync(ut * model.grid.iu, 'u', True),
            arctic_sync(vt * model.grid.iv, 'v', True))


def _run(case, inputs, comm):
    return (_halo if case == 'halo' else _barotp)(inputs, comm)


CASES = ('halo', 'barotp')


def _rank_main(rank, tmp):
    """One rank: read each case's inputs, run them on its block, and
    write rank 0's (gathered) results."""
    import torch.distributed as dist

    from blom_tpu_torch.parallel.mesh import DistComm, make_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(tmp) / 'store'), 4)
    dist.init_process_group('gloo', store=store, rank=rank, world_size=4)
    try:
        for case in CASES:
            comm = DistComm(make_mesh(shape=SHAPE))
            out = _run(case, torch.load(Path(tmp) / f'{case}_inputs.pt',
                                        weights_only=False), comm)
            if rank == 0:
                torch.save(out, Path(tmp) / f'{case}_out.pt')
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def gloo_runs(tmp_path_factory):
    """Both cases' inputs, and the results of four gloo ranks that ran
    them, in one directory."""
    tmp = tmp_path_factory.mktemp('gloo')
    inputs = {}
    for case in CASES:
        inputs[case] = _inputs(case)
        torch.save(inputs[case], tmp / f'{case}_inputs.pt')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(tmp)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(4)]
    logs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err.decode()[-3000:]
    return tmp, inputs


@pytest.mark.parametrize('case', CASES)
def test_gloo_ranks_give_the_stacked_bits(gloo_runs, case):
    from blom_tpu_torch.parallel.mesh import StackedComm, make_mesh
    torch.set_num_threads(1)
    tmp, inputs = gloo_runs
    got = torch.load(tmp / f'{case}_out.pt', weights_only=False)
    want = _run(case, inputs[case], StackedComm(make_mesh(shape=SHAPE)))
    assert got['exchanges'] == want['exchanges']
    if case == 'halo':
        for name in ('wide', 'fold', 'closed'):
            assert torch.equal(got[name], want[name]), name
        return
    import dataclasses
    for f in dataclasses.fields(want['state']):
        a, b = getattr(want['state'], f.name), getattr(got['state'], f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name


if __name__ == '__main__':
    sys.path.insert(0, str(REPO))
    _rank_main(int(sys.argv[1]), sys.argv[2])
