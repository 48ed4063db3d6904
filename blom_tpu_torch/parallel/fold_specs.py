"""Per-field tripolar-fold halo rules for the block-local solvers.

Counterpart of `blom_tpu/parallel/fold_specs.py`.  The reference tags
every xctilr call with a halo type (halo_ps/halo_us/halo_vs/halo_qs for
scalars at p/u/v/q points, halo_uv/halo_vv for sign-flipping vector
components, mod_xc.F90:107-110); the distributed fold then mirrors,
staggers and sign-flips by it (:2518-2700).  This module is the same
tagging for the trees of tensors the block-local code exchanges: a flat
`(kind, sign, partner)` spec per leaf, found by field name.

`partner` is a leaf whose +i/-i (or max/min) role swaps with this one's
under the fold, with no sign flip: the xixp/xixm pairs
(parallel/arctic.py XI_PAIRS_U/V) and the umaxb/uminb clip bounds.

kind None keeps the zero ghosts of the plain exchange (the CPPM
coefficients, whose fold rows are not mirrors)."""

from __future__ import annotations

from .arctic import STATE_KINDS, XI_PAIRS_U, XI_PAIRS_V

# name -> (kind, sign, partner_name | None)
_TABLE = {}

# --- State fields (the tags of arctic.STATE_KINDS) ------------------
for _n, (_k, _vec) in STATE_KINDS.items():
    _TABLE[_n] = (_k, -1.0 if _vec else 1.0, None)
_TABLE['kfpla'] = ('p', 1.0, None)   # int index field at p-points
for _pairs, _k in ((XI_PAIRS_U, 'u'), (XI_PAIRS_V, 'v')):
    for _a, _b in _pairs:
        _TABLE[_a] = (_k, 1.0, _b)
        _TABLE[_b] = (_k, 1.0, _a)

# --- DiffusionFields ------------------------------------------------
for _n in ('difint', 'difiso', 'difdia', 'difwgt', 'difvho', 'difvso',
           'difvmo', 'mtke', 'bld'):
    _TABLE[_n] = ('p', 1.0, None)
for _n in ('umfltd', 'umflsm', 'utflld', 'usflld'):
    _TABLE[_n] = ('u', -1.0, None)
for _n in ('vmfltd', 'vmflsm', 'vtflld', 'vsflld'):
    _TABLE[_n] = ('v', -1.0, None)

# --- Forcing --------------------------------------------------------
_TABLE.update({
    'taux': ('u', -1.0, None), 'tauy': ('v', -1.0, None),
    'mu_nonloc': ('u', 1.0, None), 'mv_nonloc': ('v', 1.0, None),
})
for _n in ('surflx', 'sswflx', 'salflx', 'brnflx', 'surrlx', 'salrlx',
           'sstclm', 'sssclm', 'lamult',
           'swfc1', 'swfc2', 'swal1', 'swal2'):
    _TABLE[_n] = ('p', 1.0, None)

# --- Grid metrics (scalars; mod_inigeo's xctilr tags) ---------------
for _n in ('scpx', 'scpy', 'scp2', 'scp2i', 'coriop', 'betafp', 'ip',
           'difmxp', 'depths', 'plon', 'plat'):
    _TABLE[_n] = ('p', 1.0, None)
for _n in ('scux', 'scuy', 'scu2', 'scuxi', 'scuyi', 'iu', 'umax'):
    _TABLE[_n] = ('u', 1.0, None)
for _n in ('scvx', 'scvy', 'scv2', 'scvxi', 'scvyi', 'iv', 'vmax'):
    _TABLE[_n] = ('v', 1.0, None)
for _n in ('scqx', 'scqy', 'scq2', 'scq2i', 'corioq', 'iq', 'difmxq'):
    _TABLE[_n] = ('q', 1.0, None)

# --- barotp's prologue bundle (dynamics/barotp.py _prologue) --------
_TABLE.update({
    'pvtrop_o': ('q', 1.0, None), 'pvtrop_m': ('q', 1.0, None),
    'pvtrop_n': ('q', 1.0, None),
    'pgfxm_o': ('u', -1.0, None), 'pgfym_o': ('v', -1.0, None),
    'pgfxm_m': ('u', -1.0, None), 'pgfxm_n': ('u', -1.0, None),
    'pgfym_m': ('v', -1.0, None), 'pgfym_n': ('v', -1.0, None),
    'xixp_m': ('u', 1.0, 'xixm_m'), 'xixm_m': ('u', 1.0, 'xixp_m'),
    'xixp_n': ('u', 1.0, 'xixm_n'), 'xixm_n': ('u', 1.0, 'xixp_n'),
    'xiyp_m': ('v', 1.0, 'xiym_m'), 'xiym_m': ('v', 1.0, 'xiyp_m'),
    'xiyp_n': ('v', 1.0, 'xiym_n'), 'xiym_n': ('v', 1.0, 'xiyp_n'),
    'utotn': ('u', -1.0, None), 'vtotn': ('v', -1.0, None),
    'uglue': ('u', 1.0, None), 'vglue': ('v', 1.0, None),
    # velocity clip bounds: the mirror swaps max and min with no sign
    # flip (the mirrored u_max is -u_min of the source point)
    'umaxb': ('u', 1.0, 'uminb'), 'uminb': ('u', 1.0, 'umaxb'),
    'vmaxb': ('v', 1.0, 'vminb'), 'vminb': ('v', 1.0, 'vmaxb'),
    'pb_t': ('p', 1.0, None),
    'ubflx_t': ('u', -1.0, None), 'vbflx_t': ('v', -1.0, None),
})

# --- CPPM coefficients: zero ghosts here ----------------------------
for _n in ('stencil', 'hevc', 'ssc', 'scc', 'd2m', 'tmc0', 'tmcl',
           'tmcr', 'dx'):
    _TABLE[_n] = (None, 1.0, None)


def tree_flatten(tree):
    """[(path, leaf)] in jax.tree.flatten's order: tuples and lists by
    position, dicts by sorted key, NamedTuples by field; anything else
    but None is a leaf.  A path entry is an int (position) or a str (key
    or field name)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, tuple) and hasattr(node, '_fields'):
            for k in node._fields:
                walk(getattr(node, k), path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif node is not None:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_unflatten(tree, leaves):
    """`tree` with its leaves, in tree_flatten's order, replaced."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            new = {k: build(node[k]) for k in sorted(node)}
            return {k: new[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, '_fields'):
            return type(node)(*[build(getattr(node, k))
                                for k in node._fields])
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(tree)


def leaf_specs(tree, overrides=None):
    """The flat fold-spec list aligned with tree_flatten(tree).

    Each entry: (kind, sign, partner_leaf_index | None), or None to
    skip the fold fixup for that leaf.  `overrides` maps a top-level
    tuple position (for leaves without a name) to a (kind, sign) pair.

    Raises KeyError for a leaf whose field name is unknown: defaulting a
    vector to a scalar would corrupt the fold."""
    overrides = overrides or {}
    names, specs = [], []
    for path, _ in tree_flatten(tree):
        name = next((e for e in reversed(path) if isinstance(e, str)),
                    None)
        if name is None:
            idx = path[0] if path else None
            if idx in overrides:
                k, sign = overrides[idx]
                names.append(None)
                specs.append((k, sign, None))
                continue
            raise KeyError(f'unnamed leaf at {path} needs an overrides '
                           f'entry for the tripolar fold')
        if name not in _TABLE:
            raise KeyError(f'no tripolar fold rule for field {name!r}')
        names.append(name)
        specs.append(_TABLE[name])
    out = []
    for k, sign, partner in specs:
        if k is None:
            out.append(None)
        elif partner is None:
            out.append((k, sign, None))
        else:
            if partner not in names:
                raise KeyError(f'fold partner {partner!r} not present '
                               f'in the exchanged tree')
            out.append((k, sign, names.index(partner)))
    return out
