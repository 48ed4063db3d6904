"""The port's mesh, halo exchange and fold halos against blom_tpu's.

On the stacked communicator (every block in one process) over blom_tpu's
2x4 mesh of tests/conftest.py's 8 host devices:

- tests/test_halo.py's three margin/nsub cases and its closed-boundary
  case: the blockwise stencil sweeps equal the dense global computation
  and blom_tpu's `sharded_stencil`, exactly.  The stencil rounds as XLA
  compiles blom_tpu's (w + .2 * (sum - 4 w) with both products
  contracted into fused multiply-adds, core/init.py's `_fma`), so the
  two packages agree bit for bit;
- `fold_fixup_stack` and `fold_sync_stack` on a tripolar block layout
  (every fold variant, both signs, a swapped pair) equal blom_tpu's
  inside `shard_map`;
- the margin and fold-height errors;
- `make_mesh`'s factorization, the block split and join, and
  `fold_specs.leaf_specs` on barotp's tree equal blom_tpu's;
- barotp_shmap's `sync_tree` on blocks equals parallel/arctic.py's
  global fold sync, and `crop_tree` undoes `wide_tree`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.parallel import fold_specs as jfs
from blom_tpu.parallel import halo as jhalo
from blom_tpu.parallel import mesh as jmesh
from blom_tpu_torch.core.init import _fma
from blom_tpu_torch.parallel import fold_specs, halo, mesh

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P


@pytest.fixture(scope='module')
def meshes():
    jm = jmesh.make_mesh()
    return jm, mesh.StackedComm(mesh.make_mesh(shape=jm.devices.shape))


def _jax_step(w):
    """tests/test_halo.py's local stencil."""
    lap = (jnp.roll(w, -1, -1) + jnp.roll(w, 1, -1)
           + jnp.roll(w, -1, -2) + jnp.roll(w, 1, -2) - 4. * w)
    return w + .2 * lap


def _step(w, shift):
    s = shift(w, 1, 0) + shift(w, -1, 0) + shift(w, 0, 1) + shift(w, 0, -1)
    return _fma(.2, _fma(-4., w, s), w)


def _local_step(w):
    return _step(w, lambda a, di, dj: torch.roll(a, (-dj, -di), (-2, -1)))


def _global_step(a, periodic_i=True, periodic_j=False):
    """The dense reference: the same stencil over the global domain."""
    def sh(x, di, dj):
        out = torch.roll(x, (-dj, -di), (-2, -1))
        if dj and not periodic_j:
            out[..., -1 if dj > 0 else 0, :] = 0.
        if di and not periodic_i:
            out[..., :, -1 if di > 0 else 0] = 0.
        return out
    return _step(a, sh)


@pytest.mark.parametrize('margin,nsub', [(1, 4), (2, 4), (3, 7)])
def test_margin_k_matches_dense_and_blom_tpu(meshes, margin, nsub):
    jm, comm = meshes
    ny, nx = comm.mesh
    a = np.random.RandomState(margin).randn(8 * ny, 16 * nx)
    got = halo.sharded_stencil(comm, _local_step, nsub, margin)(
        torch.as_tensor(a))
    want = torch.as_tensor(a)
    for _ in range(nsub):
        want = _global_step(want)
    assert torch.equal(got, want)
    ref = jhalo.sharded_stencil(jm, _jax_step, nsub, margin)(jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_closed_boundaries(meshes):
    jm, comm = meshes
    ny, nx = comm.mesh
    a = np.random.RandomState(7).randn(8 * ny, 16 * nx)
    got = halo.sharded_stencil(comm, _local_step, 3, 3, periodic_i=False)(
        torch.as_tensor(a))
    want = torch.as_tensor(a)
    for _ in range(3):
        want = _global_step(want, periodic_i=False)
    assert torch.equal(got, want)
    ref = jhalo.sharded_stencil(jm, _jax_step, 3, 3, periodic_i=False)(
        jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# a tripolar block layout: every fold variant, both signs, a swapped pair
VARIANT = np.array([0, 1, 2, 3, -1, 1, 1, 2])
SIGN = np.array([1., -1., -1., 1., 1., 1., 1., -1.])
SRC = np.array([0, 1, 2, 3, 4, 6, 5, 7])


def _fold_case(jm, comm, margin):
    ny, nx = comm.mesh
    a = np.random.RandomState(11).randn(len(VARIANT), 12 * ny, 8 * nx)
    spec = P(None, 'y', 'x')

    def fixup(st):
        w = jhalo.halo_exchange(st, margin, ny, nx)
        return jhalo.fold_fixup_stack(w, margin, ny, nx, VARIANT, SIGN, SRC)

    def sync(st):
        return jhalo.fold_sync_stack(st, ny, nx, VARIANT, SIGN, SRC)

    refs = [np.asarray(jax.jit(shard_map(f, mesh=jm, in_specs=(spec,),
                                         out_specs=spec))(jnp.asarray(a)))
            for f in (fixup, sync)]
    blocks = comm.scatter(torch.as_tensor(a))
    got = [comm.gather(halo.fold_fixup_stack(
               halo.halo_exchange(blocks, margin, comm), margin, comm,
               VARIANT, SIGN, SRC)),
           comm.gather(halo.fold_sync_stack(blocks, comm, VARIANT, SIGN,
                                            SRC))]
    return refs, got


@pytest.mark.parametrize('margin', [2, 6])
def test_fold_halos_match_blom_tpu(meshes, margin):
    jm, comm = meshes
    refs, got = _fold_case(jm, comm, margin)
    for name, r, g in zip(('fold_fixup_stack', 'fold_sync_stack'), refs,
                          got):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_margin_errors(meshes):
    _, comm = meshes
    blocks = comm.scatter(torch.zeros(3, 4 * comm.ny, 4 * comm.nx))
    with pytest.raises(ValueError, match='smaller than margin 6'):
        halo.halo_exchange(blocks, 6, comm)
    # blom_tpu's fold check: blocks of one row
    thin = comm.scatter(torch.zeros(3, comm.ny, 4 * comm.nx))
    wide = halo.halo_exchange(thin, 1, comm)
    with pytest.raises(ValueError, match='margin\\+2'):
        halo.fold_fixup_stack(wide, 1, comm, [0, 0, 0], [1.] * 3, [0, 1, 2])


@pytest.mark.parametrize('n', range(1, 9))
def test_make_mesh_factorizes_as_blom_tpu(n):
    assert mesh.make_mesh(n).shape \
        == jmesh.make_mesh(jax.devices()[:n]).devices.shape


def test_split_join_is_shard_map_layout(meshes):
    """Block b = y*nx + x of split_blocks is the block shard_map gives
    mesh device (y, x), and join_blocks undoes the split."""
    jm, comm = meshes
    ny, nx = comm.mesh
    a = np.random.RandomState(3).randn(2, 8 * ny, 4 * nx)
    spec = P(None, 'y', 'x')

    def tag(x):
        b = jax.lax.axis_index('y') * nx + jax.lax.axis_index('x')
        return x * 0. + b

    ref = np.asarray(jax.jit(shard_map(tag, mesh=jm, in_specs=(spec,),
                                       out_specs=spec))(jnp.asarray(a)))
    blocks = mesh.split_blocks(torch.as_tensor(a), comm.mesh)
    ids = torch.arange(ny * nx, dtype=blocks.dtype).reshape(-1, 1, 1)
    np.testing.assert_array_equal(
        mesh.join_blocks(blocks * 0. + ids, comm.mesh).numpy(), ref)
    assert torch.equal(mesh.join_blocks(blocks, comm.mesh),
                       torch.as_tensor(a))


def test_leaf_specs_match_blom_tpu():
    """barotp_shmap's tree: the prologue bundle and four transport sums,
    with their overrides."""
    names = sorted(set(jfs._TABLE) & {
        'ip', 'iu', 'iv', 'scuy', 'scvx', 'scp2i', 'pvtrop_o', 'pgfxm_o',
        'xixp_o', 'xixm_o', 'xiyp_m', 'xiym_m', 'umaxb', 'uminb', 'utotn',
        'pb_t', 'ubflx_t', 'vbflx_t'})
    over = {1: ('u', -1.), 2: ('v', -1.), 3: ('u', -1.), 4: ('v', -1.)}
    jtree = ({k: jnp.zeros((2, 2)) for k in names},) \
        + (jnp.zeros((3, 2, 2)),) * 4
    ttree = ({k: torch.zeros(2, 2) for k in names},) \
        + (torch.zeros(3, 2, 2),) * 4
    assert fold_specs.leaf_specs(ttree, over) == jfs.leaf_specs(jtree, over)
    assert fold_specs._TABLE == jfs._TABLE
    with pytest.raises(KeyError, match='no tripolar fold rule'):
        fold_specs.leaf_specs({'nonesuch': torch.zeros(2, 2)})


def test_sync_and_crop_trees_match_the_global_fold(meshes):
    """barotp_shmap's tree exchanges on blocks: sync_tree equals
    parallel/arctic.py's global sync of each field (vector sign, the xi
    pair's swap), and crop_tree undoes wide_tree."""
    from blom_tpu_torch.dynamics.barotp_shmap import (crop_tree, sync_tree,
                                                      wide_tree)
    from blom_tpu_torch.parallel import arctic
    _, comm = meshes
    rng = np.random.default_rng(13)
    shape = (2, 12 * comm.ny, 8 * comm.nx)
    tree = {k: torch.as_tensor(rng.standard_normal(shape))
            for k in ('pb', 'u', 'v', 'pvtrop', 'xixp', 'xixm')}
    blocks = {k: comm.scatter(a) for k, a in tree.items()}
    synced = sync_tree(blocks, comm, fold_specs.leaf_specs(blocks))
    want = {k: arctic.arctic_sync(a, *arctic.STATE_KINDS[k])
            for k, a in tree.items() if k in arctic.STATE_KINDS}
    want['xixp'], want['xixm'] = arctic.sync_xi_pair_u(tree['xixp'],
                                                       tree['xixm'])
    for k, a in want.items():
        assert torch.equal(comm.gather(synced[k]), a), k
    wide = wide_tree(blocks, 3, comm, True, False)
    assert wide['u'].shape[-2:] == (12 + 6, 8 + 6)
    for k, a in crop_tree(wide, 3).items():
        assert torch.equal(a, blocks[k]), k
