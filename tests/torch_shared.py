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
build.  `shared_items` does it for a reference made of many items (a
phase-by-phase run), stored one item at a time as it is built, so that a
worker waits only for the item its test reads.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time

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


def _item_path(root, key):
    return root / hashlib.sha1(repr(key).encode()).hexdigest()


def _build_items(root, items):
    """Store each (key, value) of items() under root as it comes, then
    mark root done."""
    for key, value in items():
        part = root / 'part'
        part.write_bytes(pickle.dumps(_store(value)))
        part.replace(_item_path(root, key))
    (root / 'done').touch()


class _Items:
    """The items of a `shared_items` reference, each loaded when first
    read; reading one that is not stored yet waits until it is, and if
    its builder is gone (its lock free and root not done) builds them."""

    def __init__(self, root, lock, items):
        self.root, self.lock, self.items = root, lock, items
        self._got = {}

    def _build_if_orphaned(self):
        from filelock import Timeout
        try:
            self.lock.acquire(timeout=0)
        except Timeout:
            return
        try:
            if not (self.root / 'done').is_file():
                _build_items(self.root, self.items)
        finally:
            self.lock.release()

    def __getitem__(self, key):
        if key not in self._got:
            path = _item_path(self.root, key)
            while not path.is_file():
                if (self.root / 'done').is_file() and not path.is_file():
                    raise KeyError(key)
                self._build_if_orphaned()
                time.sleep(.05)
            self._got[key] = _load(pickle.loads(path.read_bytes()))
        return self._got[key]


def shared_items(tmp_path_factory, name, items):
    """A mapping of the (key, value) pairs that items() yields, built once
    per test run across the xdist workers as `shared` builds, but stored
    item by item: a worker reading a key waits only until that item is
    built.  `name` must be unique in the suite; keys need a repr that is
    the same in every worker."""
    if not os.environ.get('PYTEST_XDIST_WORKER'):
        return dict(items())
    from filelock import FileLock

    root = tmp_path_factory.getbasetemp().parent / f'torch_items_{name}'
    root.mkdir(exist_ok=True)
    out = _Items(root, FileLock(f'{root}.lock'), items)
    out._build_if_orphaned()
    return out
