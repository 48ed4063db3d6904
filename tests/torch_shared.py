"""Once-per-run blom_tpu references, shared between pytest-xdist workers.

The port's parity tests compare against blom_tpu references that take
tens of seconds to build (a model run eagerly phase by phase).  Under
``-n N --dist load`` the tests of one module land on several workers, and
a ``scope='module'`` fixture is then built again on each of them.
`shared` builds such a reference once per run: the first worker to ask
builds it under a file lock and stores it in the run's common temporary
directory (``tmp_path_factory.getbasetemp().parent``, which pytest-xdist
gives every worker of one run and no other run); the others load it.
The stored form keeps the jax arrays as numpy arrays and gives them back
as jax arrays, and the worker that builds the reference returns the
loaded form too, so every worker compares against the same values.
Without xdist the reference is built in the process, as before.
`shared_build` does the same for a blom_tpu model builder, keyed by its
arguments, so that every module building the same model shares one
build.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np


class _Stored:
    """A jax array held as a numpy array."""

    def __init__(self, a):
        self.a = a


def _store(tree):
    return jax.tree_util.tree_map(
        lambda x: _Stored(np.asarray(x)) if isinstance(x, jax.Array) else x,
        tree)


def _load(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.a) if isinstance(x, _Stored) else x, tree,
        is_leaf=lambda x: isinstance(x, _Stored))


def shared(tmp_path_factory, name, build):
    """build(), once per test run across the xdist workers; `name` keys
    the reference and must be unique in the suite."""
    if not os.environ.get('PYTEST_XDIST_WORKER'):
        return build()
    from filelock import FileLock

    path = tmp_path_factory.getbasetemp().parent / f'torch_ref_{name}.pkl'
    with FileLock(f'{path}.lock'):
        if not path.is_file():
            path.write_bytes(pickle.dumps(_store(build())))
        data = path.read_bytes()
    return _load(pickle.loads(data))


def shared_build(tmp_path_factory, build, **kw):
    """build(**kw) (a blom_tpu model builder), once per test run across
    the xdist workers and the modules that ask for the same model."""
    args = '_'.join(f'{k}-{v}' for k, v in sorted(kw.items()))
    return shared(tmp_path_factory, f'{build.__module__}.{build.__name__}_'
                  f'{args}', lambda: build(**kw))
