"""The port's margin-k barotropic solver on mesh blocks.

On the CPU in f64 (and one f32 case), with every block stacked in one
process:

- on tests/test_barotp_shmap.py's 64x32 fuk95, after two steps of the
  port and with seeded depth-mean tendencies, every output of one
  barotp equals the port's unsharded barotp bit for bit on meshes 1x1,
  1x2, 2x1, 2x2 and 2x4 (local blocks stay wider than one cell);
- it agrees with blom_tpu's `make_barotp_shmap` on blom_tpu's 8-device
  mesh within the 1e-8 of the port's barotp parity test
  (test_torch_slice.py);
- on the tripolar grid (fold-consistent inputs: the step's state and
  arctic-synced tendencies) it is bitwise across meshes 1x1, 1x2, 2x2
  and 2x4, and within tests/test_step_shmap_arctic.py's tolerances of
  the unsharded barotp; its exchanges' constant tensors are made once;
- a barotp makes one widening exchange per dtype group and
  5 * ceil(half / 2) carry exchanges, about half of what
  subs_per_exch=1 makes;
- `StepParams.barotp_fn` takes the solver into the step, which then
  equals the plain step bit for bit;
- a mesh whose blocks are narrower than the margin raises."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.configs import fuk95 as jfuk95
from blom_tpu.core import state as jstate
from blom_tpu.dynamics.barotp_shmap import make_barotp_shmap as jmake
from blom_tpu.parallel import mesh as jmesh
from blom_tpu_torch.drivers import standalone as tst
from blom_tpu_torch.dynamics import barotp as tb
from blom_tpu_torch.dynamics import step as tstep
from blom_tpu_torch.dynamics.barotp_shmap import (
    RINGS_PER_SUBSTEP, make_barotp_shmap)
from blom_tpu_torch.parallel.arctic import arctic_sync
from blom_tpu_torch.parallel.mesh import make_mesh

FUK95 = dict(itdm=64, jtdm=32, kdm=6)
TRIPOLAR = dict(itdm=32, jtdm=24, kdm=6)
OUT = ('pb', 'pbu', 'pbv', 'ub', 'vb', 'ubflx', 'vbflx', 'pb_mn',
       'ubflx_mn', 'vbflx_mn', 'ubflxs', 'vbflxs', 'ubflxs_p', 'vbflxs_p',
       'ubcors_p', 'vbcors_p', 'pb_p', 'pbu_p', 'pbv_p', 'pvtrop')
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(model, seed, arctic=False):
    """The model's state after two steps and seeded tendencies."""
    s, _ = tst.run(model, 2)
    rng = np.random.default_rng(seed)
    g = model.grid
    ut = torch.as_tensor(rng.standard_normal(g.shape) * 1e-4, dtype=g.dtype)
    vt = torch.as_tensor(rng.standard_normal(g.shape) * 1e-4, dtype=g.dtype)
    ut, vt = ut * g.iu, vt * g.iv
    if arctic:
        ut, vt = arctic_sync(ut, 'u', True), arctic_sync(vt, 'v', True)
    return s, ut, vt


def _barotp(fn, model, case):
    s, ut, vt = case
    p = model.par
    return fn(model.grid, s.clone(), ut, vt, 0, 1, p.lstep, p.dlt, p.barotp)


@pytest.fixture(scope='module')
def fuk95():
    model = tst.build_fuk95(**FUK95, device='cpu')
    case = _case(model, 0)
    return model, case, _barotp(tb.barotp, model, case)


@pytest.fixture(scope='module')
def tripolar():
    model = tst.build_tripolar(**TRIPOLAR, device='cpu')
    case = _case(model, 1, arctic=True)
    return model, case, _barotp(tb.barotp, model, case)


@pytest.mark.parametrize('shape', MESHES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_bitwise_against_unsharded(fuk95, shape):
    model, case, ref = fuk95
    out = _barotp(make_barotp_shmap(make_mesh(shape=shape)), model, case)
    bad = [f for f in OUT if not torch.equal(getattr(out, f),
                                             getattr(ref, f))]
    assert not bad, bad


def test_bitwise_against_unsharded_f32():
    model = tst.build_fuk95(**FUK95, dtype=torch.float32, device='cpu')
    case = _case(model, 2)
    ref = _barotp(tb.barotp, model, case)
    out = _barotp(make_barotp_shmap(make_mesh(shape=(2, 2))), model, case)
    assert ref.pb.dtype == torch.float32
    bad = [f for f in OUT if not torch.equal(getattr(out, f),
                                             getattr(ref, f))]
    assert not bad, bad


def test_matches_blom_tpu_make_barotp_shmap(fuk95):
    """The same state and tendencies through blom_tpu's solver under
    shard_map on its 2x4 mesh of 8 host devices."""
    model, (s, ut, vt), _ = fuk95
    p = model.par
    grid = jfuk95.make_grid(p.baclin, FUK95['itdm'], FUK95['jtdm'],
                            FUK95['kdm'])
    js = jstate.empty_state(grid, jnp.float64)
    js = dataclasses.replace(js, **{
        f.name: jnp.asarray(getattr(s, f.name).numpy())
        for f in dataclasses.fields(js)
        if torch.is_tensor(getattr(s, f.name, None))})
    mesh = jmesh.make_mesh(jax.devices()[:8])
    fn = jmake(mesh)
    ref = jax.jit(lambda g, st, u, v: fn(
        g, st, u, v, 0, 1, p.lstep, p.dlt, p.barotp))(
        jmesh.shard_pytree(grid, mesh), jmesh.shard_pytree(js, mesh),
        jnp.asarray(ut.numpy()), jnp.asarray(vt.numpy()))
    out = _barotp(make_barotp_shmap(make_mesh(shape=mesh.devices.shape)),
                  model, (s, ut, vt))
    errs = {}
    for f in OUT:
        a = np.asarray(getattr(ref, f))
        errs[f] = float(np.abs(getattr(out, f).numpy() - a).max()
                        / max(np.abs(a).max(), 1e-300))
    bad = {k: v for k, v in errs.items() if v > 1e-8}
    assert not bad, bad


def test_tripolar_bitwise_across_meshes(tripolar):
    model, case, ref = tripolar
    outs = [_barotp(make_barotp_shmap(make_mesh(shape=shape)), model, case)
            for shape in ((1, 1), (1, 2), (2, 2), (2, 4))]
    for shape, out in zip(((1, 2), (2, 2), (2, 4)), outs[1:]):
        bad = [f for f in OUT if not torch.equal(getattr(out, f),
                                                 getattr(outs[0], f))]
        assert not bad, (shape, bad)
    # tests/test_step_shmap_arctic.py's tolerances against the
    # unsharded solver
    scale = {'pb': 1e5, 'pb_p': 1e5, 'ubflxs_p': 1e6}
    for f in OUT:
        np.testing.assert_allclose(
            getattr(outs[2], f).numpy(), getattr(ref, f).numpy(), rtol=1e-7,
            atol=1e-7 * scale.get(f, 1.), err_msg=f)


def test_tripolar_constants_reach_the_device_once(tripolar):
    """The index, mask and sign tensors of the exchanges and fold halos
    are made at the first barotp and reused by the next: a second call
    makes no new one and gives the same bits."""
    model, case, _ = tripolar
    fn = make_barotp_shmap(make_mesh(shape=(2, 2)))
    first = _barotp(fn, model, case)
    made = dict(fn.comm._const)
    assert any(k[0][0] == 'fold' for k in made)
    second = _barotp(fn, model, case)
    assert fn.comm._const.keys() == made.keys()
    assert all(fn.comm._const[k] is v for k, v in made.items())
    assert all(torch.equal(getattr(first, f), getattr(second, f))
               for f in OUT)


def test_exchange_count(fuk95):
    """One widening exchange (one dtype group) and 5 * ceil(half / k)
    carry exchanges for k substeps an exchange: 41 against 76 at
    lstep 30, with the same bits."""
    model, case, ref = fuk95
    half = model.par.lstep // 2
    counts = {}
    for k in (1, 2):
        fn = make_barotp_shmap(make_mesh(shape=(2, 2)), subs_per_exch=k)
        out = _barotp(fn, model, case)
        counts[k] = fn.comm.exchanges
        assert counts[k] == 1 + 5 * -(-half // k)
        assert fn.comm.permutes == 4 * counts[k]
        assert all(torch.equal(getattr(out, f), getattr(ref, f))
                   for f in OUT)
    assert counts[2] <= counts[1] / 2 + 3


def test_step_hook_is_bitwise(fuk95):
    model, _, _ = fuk95
    s0, _ = tst.run(model, 1)
    args = (model.coeffs_i, model.coeffs_j)
    d = 2. * model.par.baclin

    def step(par):
        s, _ = tstep.blom_step(model.grid, model.e, par, *args, s0.clone(),
                               model.forcing, model.dfl, 1, 0, d,
                               model.swabs)
        return s

    ref = step(model.par)
    fn = make_barotp_shmap(make_mesh(shape=(2, 2)))
    out = step(model.par._replace(barotp_fn=fn))
    assert fn.comm.exchanges == 1 + 5 * -(-(model.par.lstep // 2) // 2)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name


def test_blocks_narrower_than_the_margin_raise(fuk95):
    model, case, _ = fuk95
    margin = 2 * RINGS_PER_SUBSTEP
    fn = make_barotp_shmap(make_mesh(shape=(2, FUK95['itdm'] // 4)))
    assert FUK95['itdm'] // fn.comm.nx < margin
    with pytest.raises(ValueError, match=f'smaller than margin {margin}'):
        _barotp(fn, model, case)
