"""The port's high-order vertical reconstructions against blom_tpu's.

`blom_tpu_torch/ops/hor3map.py`'s quartic Recon and remaps,
integrate_to, the implicit-edge machinery (the Thomas solve, the ih4
rows, the boundary fits, the ih6/ih5 moment matrices and their solves),
ppm_ih4 and PQM, on random columns made from a numpy seed, through
blom_tpu's jnp functions and the port's on CPU in f64.  Every column set
mixes columns without vanishing layers (WET) with columns whose two or
one bottom layers are empty, as the ALE coordinate leaves them (BOTTOM),
and one column with an empty interior layer (INTERIOR).

Tolerances, and why:
- WET columns: every function within 1e-12 of blom_tpu, relative to the
  largest magnitude of the field compared.
- BOTTOM and INTERIOR columns: the boundary fits and the ih6/ih5 moment
  systems are nearly singular there.  Their condition numbers exceed
  1e12 for the 4-cell boundary fit and 1e21 for the 6-cell one on BOTTOM
  columns (np.linalg.cond, `test_boundary_systems`; up to ~1e33 and
  ~1e39 on other draws), against < 1e15 and < 1e25 on WET columns
  (ill-scaled there, not ill-posed: the entries run from 1 to h**5).
  LAPACK's LU under jnp.linalg.solve and under torch.linalg.solve then
  round differently, and the two packages' results differ by up to ~2e5
  of the field's largest magnitude, so no forward tolerance holds on
  these columns with the two packages' own solvers.  Next to an empty
  interior layer the Thomas recursion divides by 1 - tde1 * gam ~ 1e-15
  as well, and blom_tpu's compiled lax.scan, whose multiply-adds XLA
  contracts, and the port's loop then differ by up to ~0.3 of the field
  (the Thomas solve alone on identical rows included).  These columns
  are held two ways instead: the port's solver has a normwise backward
  error below 1e-14 on every system (`test_boundary_systems`,
  `test_ih6_solve_coeffs`), and with one common solver (`_gepp`, a
  batched numpy LU with partial pivoting, put in place of both
  packages' solve) and blom_tpu run op by op (`jax.disable_jit()`, no
  contracted multiply-adds), every function agrees within 1e-12 on every
  column (`test_common_solver`, `test_tridiag_dirichlet`; measured: bit
  for bit).  The ALE coordinate keeps interior layers at least
  dpmin_interior thick, so its columns meet only the BOTTOM case.
- The parabolic remaps are bit for bit what they were before the
  quartic terms were added (a copy of that code is kept here).
- The ih4 PPM against tests/oracles/hor3map_oracle.py in its four
  limitings at test_oracle_parity.py's 1e-9; the properties of
  tests/test_hor3map_highorder.py on the port, at its tolerances.

Each blom_tpu reference is computed once per run (in the test that uses
it, or cached in the module for the tests that share it).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blom_tpu.ops import hor3map as jh3
from blom_tpu_torch.ops import hor3map as th3
from oracles import hor3map_oracle as h3o

KK, J, I = 10, 4, 5
LIMITINGS = (th3.MONOTONIC, th3.NON_OSCILLATORY, th3.NON_OSCILLATORY_POSDEF,
             'none')

# column classes of _columns: j-rows 0 and 1 lose their two bottom layers,
# j-row 2 its bottom layer, column (3, 0) its middle layer
INTERIOR = (np.arange(J)[:, None] == 3) & (np.arange(I)[None] == 0)
BOTTOM = (np.arange(J)[:, None] <= 2) & np.ones((1, I), bool)
WET = ~(BOTTOM | INTERIOR)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _columns(seed):
    """Interfaces p (KK+1, J, I) in Pa and means t (KK, J, I)."""
    rng = np.random.default_rng(seed)
    dp = rng.uniform(.5, 3., (KK, J, I)) * 1.e4
    dp[-2:, :2] = 0.
    dp[-1, 2] = 0.
    dp[KK // 2, 3, 0] = 0.
    p = np.concatenate([np.zeros((1, J, I)), np.cumsum(dp, axis=0)])
    t = rng.uniform(2., 18., (KK, J, I))
    return p, t


def _dx(p):
    return np.maximum(np.diff(p, axis=0), 0.) + th3.heps


def _p_dst(p, seed=2):
    """Destination interfaces over the same column ranges, with an empty
    destination layer inside each column."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(.5, 3., p[1:].shape) * 1.e4
    d[3] = 0.
    q = np.concatenate([np.zeros((1,) + p.shape[1:]), np.cumsum(d, 0)])
    return np.minimum(q * (p[-1] / q[-1]), p[-1])


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, cols=None, tol=1e-12):
    """|port - ref| <= tol * max|ref| over the columns `cols` (a (J, I)
    mask; all columns when None)."""
    port = port.numpy() if hasattr(port, 'numpy') else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if cols is not None:
        port, ref = port[..., cols], ref[..., cols]
    scale = np.abs(ref).max(initial=0.)
    err = np.abs(port - ref).max(initial=0.)
    assert np.isfinite(port).all() and err <= tol * scale, (err, scale)


def _gepp(A, b):
    """Batched LU with partial pivoting in numpy: x with A x = b for
    (..., n, n) A and (..., n, 1) b; a singular system gives inf/NaN."""
    A = np.array(A, dtype=np.float64)
    b = np.array(b, dtype=np.float64)
    n = A.shape[-1]
    with np.errstate(all='ignore'):
        for k in range(n):
            piv = np.argmax(np.abs(A[..., k:, k]), axis=-1) + k
            idx = tuple(np.indices(piv.shape))
            for M in (A, b):
                rowk = M[..., k, :].copy()
                M[..., k, :] = M[idx + (piv,)]
                M[idx + (piv,)] = rowk
            f = A[..., k + 1:, k] / A[..., k:k + 1, k]
            A[..., k + 1:, :] -= f[..., None] * A[..., k:k + 1, :]
            b[..., k + 1:, :] -= f[..., None] * b[..., k:k + 1, :]
        x = np.zeros_like(b)
        for k in range(n - 1, -1, -1):
            x[..., k, :] = (b[..., k, :] - (A[..., k, k + 1:, None]
                                            * x[..., k + 1:, :]).sum(-2)) \
                / A[..., k, k:k + 1]
    return x


def use_common_solver(monkeypatch):
    """Replace both packages' batched solve by `_gepp` for the rest of
    the test."""
    monkeypatch.setattr(jnp.linalg, 'solve', lambda A, b: jnp.asarray(
        _gepp(np.asarray(A), np.asarray(b))))
    monkeypatch.setattr(th3, '_solve', lambda A, b: torch.from_numpy(
        _gepp(A.numpy(), b.numpy())))


def _backward_error(A, x, b):
    """The largest normwise backward error |A x - b| / (|A| |x| + |b|)
    (infinity norms) of the batched systems."""
    res = np.abs(A @ x - b).max((-2, -1))
    return (res / (np.abs(A).sum(-1).max(-1) * np.abs(x).max((-2, -1))
                   + np.abs(b).max((-2, -1)))).max()


# ------------------------------------------------- quartic Recon, remaps

@functools.lru_cache(maxsize=None)
def _recons(kind, seed, limiting=th3.MONOTONIC):
    """blom_tpu's and the port's reconstruction of _columns(seed)."""
    p, t = _columns(seed)
    fn = {'pqm': 'pqm_reconstruct', 'ppm': 'ppm_reconstruct',
          'ih4': 'ppm_ih4_reconstruct'}[kind]
    return (getattr(jh3, fn)(jnp.asarray(p), jnp.asarray(t), limiting),
            getattr(th3, fn)(_t(p), _t(t), limiting), p, t)


def test_recon_evaluations():
    jr, tr, _, _ = _recons('pqm', 1)
    assert tr.c3 is not None and tr.c4 is not None
    for name in ('eval0', 'eval1', 'deval0', 'deval1'):
        _close(getattr(tr, name)(), getattr(jr, name)(), WET)
    pr = th3.Recon(tr.p, tr.c0, tr.c1, tr.c2)
    assert pr.c3 is None and pr.c4 is None
    assert torch.equal(pr.eval1(), tr.c0 + tr.c1 + tr.c2)
    assert torch.equal(pr.deval1(), tr.c1 + 2. * tr.c2)


@pytest.mark.parametrize('bottom_only', [False, True])
def test_remap_groups_quartic(bottom_only):
    """A PQM and a PPM reconstruction in one group: the quartic terms for
    the one, none for the other, as in blom_tpu."""
    jq, tq, p, _ = _recons('pqm', 1)
    jp, tp, _, _ = _recons('ppm', 1)
    pd = _p_dst(p)
    ref = jh3.remap_groups([([jq, jp], jnp.asarray(pd))], bottom_only)
    out = th3.remap_groups([([tq, tp], _t(pd))], bottom_only)
    for o, r in zip(out[0], ref[0]):
        _close(o, r, WET)


def test_remap_means_quartic():
    jr, tr, p, _ = _recons('pqm', 1)
    pd = _p_dst(p)
    _close(th3.remap_means(tr, _t(pd)), jh3.remap_means(jr, jnp.asarray(pd)),
           WET)


@pytest.mark.parametrize('kind', ['ppm', 'pqm'])
def test_integrate_to(kind):
    jr, tr, p, t = _recons(kind, 1)
    pq = _p_dst(p, seed=4)
    _close(th3.integrate_to(tr, _t(pq)),
           jh3.integrate_to(jr, jnp.asarray(pq)), WET)
    # the integral to the column bottom is the column's content
    full = th3.integrate_to(tr, _t(p[-1:]))[0].numpy()
    np.testing.assert_allclose(full[WET], (t * np.diff(p, axis=0)).sum(0)[WET],
                               rtol=1e-12)


def _remap_groups_parabolic(groups, bottom_only_empties=False):
    """remap_groups as it was before the quartic terms: the reference of
    the bit-for-bit test."""
    heps = th3.heps
    prep = []
    for rc_list, p_dst in groups:
        p = rc_list[0].p
        prep.append((p, torch.clamp(p[1:] - p[:-1], min=0.), rc_list, p_dst))
    kk = prep[0][1].shape[0]
    accs = [[torch.zeros_like(q) for _ in rl] for _, _, rl, q in prep]
    points = [[torch.zeros_like(q) for _ in rl] for _, _, rl, q in prep]
    found = [torch.zeros(q.shape, dtype=torch.bool) for *_, q in prep]
    for k in range(kk):
        for g, (p, dx, rc_list, pq) in enumerate(prep):
            p_up, dxk = p[k], dx[k]
            dxik = 1.0 / torch.clamp(dxk, min=heps)
            x = torch.clamp((pq - p_up[None]) * dxik[None], 0., 1.)
            x2 = x * x
            inl = ((pq >= p_up[None]) & (pq <= (p_up + dxk)[None])
                   & (dxk[None] > heps) & (~found[g]))
            for t, rc in enumerate(rc_list):
                c0, c1, c2 = rc.c0[k][None], rc.c1[k][None], rc.c2[k][None]
                poly = c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x
                accs[g][t] = accs[g][t] + dxk[None] * poly
                points[g][t] = torch.where(inl, c0 + c1 * x + c2 * x2,
                                           points[g][t])
            found[g] = found[g] | inl
    out = []
    for g, (p, dx, rc_list, p_dst) in enumerate(prep):
        dpd = p_dst[1:] - p_dst[:-1]
        dpdi = 1.0 / torch.clamp(dpd, min=heps)
        wet = dx > heps
        kidx = th3._kidx(kk, wet.ndim, wet.device)
        kbot = torch.where(wet, kidx, -1).amax(0)
        deepest = wet & (kidx == kbot[None])
        means_g = []
        for t, rc in enumerate(rc_list):
            means = (accs[g][t][1:] - accs[g][t][:-1]) * dpdi
            if bottom_only_empties:
                botv = torch.where(deepest, rc.c0 + rc.c1 + rc.c2, 0.).sum(0)
                means_g.append(torch.where(dpd > heps, means, botv[None]))
            else:
                point_l = torch.where(found[g][:-1], points[g][t][:-1],
                                      means)
                means_g.append(torch.where(dpd > heps, means, point_l))
        out.append(means_g)
    return out


def _remap_means_parabolic(rc, p_dst):
    """remap_means as it was before the quartic terms."""
    heps = th3.heps
    dx = torch.clamp(rc.p[1:] - rc.p[:-1], min=0.)
    dxi = 1.0 / torch.clamp(dx, min=heps)
    pq = p_dst
    acc = torch.zeros_like(pq)
    point = torch.zeros_like(pq)
    found = torch.zeros(pq.shape, dtype=torch.bool)
    for k in range(dx.shape[0]):
        p_up, dxk = rc.p[k][None], dx[k][None]
        c0, c1, c2 = rc.c0[k][None], rc.c1[k][None], rc.c2[k][None]
        x = torch.clamp((pq - p_up) * dxi[k][None], 0., 1.)
        x2 = x * x
        acc = acc + dxk * (c0 * x + .5 * c1 * x2 + (1. / 3.) * c2 * x2 * x)
        inl = (pq >= p_up) & (pq <= p_up + dxk) & (dxk > heps) & ~found
        point = torch.where(inl, c0 + c1 * x + c2 * x2, point)
        found = found | inl
    dpd = p_dst[1:] - p_dst[:-1]
    means = (acc[1:] - acc[:-1]) / torch.clamp(dpd, min=heps)
    point_l = torch.where(found[:-1], point[:-1], means)
    return torch.where(dpd > heps, means, point_l)


@pytest.mark.parametrize('bottom_only', [False, True])
def test_parabolic_remaps_bit_for_bit(bottom_only):
    """The PPM main path (ale.remap_plain, K2's plain version) is what it
    was before the quartic terms, bit for bit."""
    p, t = _columns(5)
    pd = _p_dst(p)
    rcs = th3.ppm_reconstruct_multi(_t(p), [_t(t), _t(t * t)])
    rv = th3.ppm_reconstruct(_t(pd), _t(t[::-1].copy()), th3.MONOTONIC, True)
    groups = [(rcs, _t(pd)), ([rv], _t(p))]
    out = th3.remap_groups(groups, bottom_only)
    ref = _remap_groups_parabolic(groups, bottom_only)
    for og, rg in zip(out, ref):
        for o, r in zip(og, rg):
            assert torch.equal(o, r)
    assert torch.equal(th3.remap_means(rcs[0], _t(pd)),
                       _remap_means_parabolic(rcs[0], _t(pd)))


# ------------------------------------------------------ implicit edges

@pytest.mark.parametrize('compiled', [True, False])
def test_tridiag_dirichlet(compiled):
    """The Thomas solve on identical rows (the ih4 rows of the columns):
    blom_tpu's compiled scan on WET and BOTTOM columns, blom_tpu op by op
    on every column."""
    p, t = _columns(6)
    t1, t2, t3, t4 = (np.asarray(a)
                      for a in jh3._ih4_coeffs(jnp.asarray(_dx(p))))
    rhs = t3 * np.concatenate([t[:1], t]) + t4 * np.concatenate([t, t[-1:]])
    args = (t1, t2, rhs, t[0] * 1.1, t[-1] * .9)
    with contextlib.nullcontext() if compiled else jax.disable_jit():
        ref = jh3._tridiag_dirichlet(*map(jnp.asarray, args))
    _close(th3._tridiag_dirichlet(*map(_t, args)), ref,
           WET | BOTTOM if compiled else None)


def test_ih4_coeffs():
    dx = _dx(_columns(7)[0])
    for o, r in zip(th3._ih4_coeffs(_t(dx)), jh3._ih4_coeffs(jnp.asarray(dx))):
        _close(o, r)


@pytest.mark.parametrize('side', ['left', 'right'])
@pytest.mark.parametrize('order', [2, 3, 4, 5, 6])
def test_boundary_poly(order, side):
    p, t = _columns(8)
    out = th3._boundary_poly(_t(_dx(p)), _t(t), order, side)
    ref = jh3._boundary_poly(jnp.asarray(_dx(p)), jnp.asarray(t), order, side)
    for o, r in zip(out, ref):
        _close(o, r, WET)


def _boundary_matrix(h, order, side):
    """The moment matrix of _boundary_poly, in numpy."""
    hs = ([h[i] for i in range(order)] if side == 'left'
          else [h[KK - order + i] for i in range(order)])
    cen = [None] * order
    if side == 'left':
        cen[0] = .5 * hs[0]
        for i in range(1, order):
            cen[i] = cen[i - 1] + .5 * (hs[i - 1] + hs[i])
    else:
        cen[-1] = -.5 * hs[-1]
        for i in range(order - 2, -1, -1):
            cen[i] = cen[i + 1] - .5 * (hs[i + 1] + hs[i])
    rows = []
    for a, hh in zip(cen, hs):
        row = [np.ones_like(a), a, .5 * (a * a + hh * hh / 12.),
               a * (a * a + .25 * hh * hh) / 6.,
               (a * a * (a * a + .5 * hh * hh) + hh ** 4 / 80.) / 24.,
               a * (a * a + .75 * hh * hh) * (a * a + hh * hh / 12.) / 120.]
        rows.append(np.stack(row[:order], -1))
    return np.stack(rows, -2)


@pytest.mark.parametrize('side', ['left', 'right'])
@pytest.mark.parametrize('order', [4, 6])
def test_boundary_systems(order, side):
    """The condition numbers of the module docstring, and the port's
    solver's normwise backward error below 1e-14 on every system it
    solves.  The 6-cell fit over two empty bottom layers is singular in
    f64 on some columns (a pivot cancels to zero): torch's LAPACK then
    returns NaN where blom_tpu's returns finite values (ROADMAP.md §3);
    only such columns may be non-finite."""
    p, t = _columns(9)
    A = _boundary_matrix(_dx(p), order, side)
    u = np.stack([t[i] if side == 'left' else t[KK - order + i]
                  for i in range(order)], -1)[..., None]
    cond = np.linalg.cond(A)
    assert cond[WET].max() < (1e15 if order == 4 else 1e26)
    if side == 'right':
        assert cond[BOTTOM].min() > (1e12 if order == 4 else 1e21)
    x = th3._solve(_t(A), _t(u)).numpy()
    finite = np.isfinite(x).all((-2, -1))
    two_empty = np.arange(J)[:, None] <= 1
    assert (finite | (two_empty & (side == 'right') & (order > 4))).all()
    assert _backward_error(A[finite], x[finite], u[finite]) <= 1e-14


@pytest.mark.parametrize('ords', [(3, 4), (4, 4), (4, 2)])
def test_edges_ih4(ords):
    p, t = _columns(10)
    _close(th3.edges_ih4(_t(p), _t(t), *ords),
           jh3.edges_ih4(jnp.asarray(p), jnp.asarray(t), *ords), WET)


def test_ih6_matrices():
    """Bit for bit: the powers are jax's integer_pow products."""
    dx = _dx(_columns(11)[0])
    np.testing.assert_array_equal(
        th3._ih6_matrices(_t(dx)).numpy(),
        np.asarray(jh3._ih6_matrices(jnp.asarray(dx))))
    for side in ('left', 'right'):
        np.testing.assert_array_equal(
            th3._ih6_matrices_asym(_t(dx), side).numpy(),
            np.asarray(jh3._ih6_matrices_asym(jnp.asarray(dx), side)))
    c, h = dx[1:] - .5 * dx[:-1], dx[1:]
    for o, r in zip(th3._moment_col_cell(_t(c), _t(h)),
                    jh3._moment_col_cell(jnp.asarray(c), jnp.asarray(h))):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_ih6_solve_coeffs():
    """The ih6/ih5 row coefficients of the symmetric and both asymmetric
    stencils, on the edges where each is used (2..kk-2, 1, kk-1): the
    edge system A ce = -e0 and the slope system B cs = -e0, B built here
    from its definition (edge_ih6_slope_ih5_coeff_common), each solved to
    a normwise backward error below 1e-14."""
    dx = _t(_dx(_columns(12)[0]))
    for A, rows in ((th3._ih6_matrices(dx), slice(2, KK - 1)),
                    (th3._ih6_matrices_asym(dx, 'left'), slice(1, 2)),
                    (th3._ih6_matrices_asym(dx, 'right'), slice(KK - 1, KK))):
        ce, cs = (c.numpy()[rows][..., None] for c in th3._ih6_solve_coeffs(A))
        An = A.numpy()[rows]
        e0 = np.zeros(An.shape[:-1] + (1,))
        e0[..., 0, 0] = -1.
        B = np.zeros_like(An)
        B[..., 0:5, 2:6] = An[..., 1:6, 2:6]
        B[..., 0:5, 0:2] = An[..., 0:5, 0:2] * np.arange(1., 6.)[:, None]
        B[..., 5, 2:6] = 1.
        assert _backward_error(An, ce, e0) <= 1e-14
        assert _backward_error(B, cs, e0) <= 1e-14


@pytest.mark.parametrize('ords', [(2, 2), (3, 4), (4, 4), (6, 4), (6, 6)])
def test_edges_slopes_ih6(ords):
    p, t = _columns(13)
    out = th3.edges_slopes_ih6(_t(p), _t(t), *ords)
    ref = jh3.edges_slopes_ih6(jnp.asarray(p), jnp.asarray(t), *ords)
    for o, r in zip(out, ref):
        _close(o, r, WET)


# ------------------------------------------------------ ppm_ih4 and PQM

def _coeffs(rc):
    return [c for c in rc[1:] if c is not None]


@pytest.mark.parametrize('limiting', LIMITINGS)
@pytest.mark.parametrize('kind', ['ih4', 'pqm'])
def test_reconstruct(kind, limiting):
    """With the top layer piecewise constant, as the ALE tracers."""
    p, t = _columns(14)
    fn = {'ih4': 'ppm_ih4_reconstruct', 'pqm': 'pqm_reconstruct'}[kind]
    ref = getattr(jh3, fn)(jnp.asarray(p), jnp.asarray(t), limiting, True)
    out = getattr(th3, fn)(_t(p), _t(t), limiting, True)
    assert (out.c3 is None) == (kind == 'ih4')
    for o, r in zip(_coeffs(out), _coeffs(ref)):
        _close(o, r, WET)


@pytest.mark.parametrize('pc', [(False, False), (True, True)])
@pytest.mark.parametrize('kind', ['ih4', 'pqm'])
def test_reconstruct_pc(kind, pc):
    p, t = _columns(15)
    fn = {'ih4': 'ppm_ih4_reconstruct', 'pqm': 'pqm_reconstruct'}[kind]
    ref = getattr(jh3, fn)(jnp.asarray(p), jnp.asarray(t),
                           th3.NON_OSCILLATORY, *pc)
    out = getattr(th3, fn)(_t(p), _t(t), th3.NON_OSCILLATORY, *pc)
    for o, r in zip(_coeffs(out), _coeffs(ref)):
        _close(o, r, WET)


def test_limit_pqm_monotonic():
    """The PQM limiter on identical edges and slopes (blom_tpu's ih6), on
    every column."""
    p, t = _columns(17)
    e, s = (np.asarray(a) for a in
            jh3.edges_slopes_ih6(jnp.asarray(p), jnp.asarray(t)))
    dx = _dx(p)
    args = (t, dx, e[:-1], e[1:], s[:-1] * dx, s[1:] * dx)
    out = th3._limit_pqm_monotonic(*map(_t, args))
    ref = jh3._limit_pqm_monotonic(*map(jnp.asarray, args))
    for o, r in zip(out, ref):
        _close(o, r)


COMMON_CASES = (['edges_ih4', 'ih6_64', 'ih6_66']
                + [f'{k}_{lim}' for k in ('ih4', 'pqm') for lim in LIMITINGS]
                + ['pqm_remap', 'pqm_remap_bottom'])


def _run_case(h3, name, p, t):
    """Case `name` of test_common_solver through the module h3 (blom_tpu's
    or the port's hor3map); p, t in that module's array type."""
    if name == 'edges_ih4':
        return [h3.edges_ih4(p, t)]
    if name.startswith('ih6_'):
        return list(h3.edges_slopes_ih6(p, t, int(name[4]), int(name[5])))
    kind, lim = name.split('_', 1)
    if kind == 'ih4':
        rc = h3.ppm_ih4_reconstruct(p, t, lim, True)
        return [rc.c0, rc.c1, rc.c2]
    if kind == 'pqm' and not lim.startswith('remap'):
        rc = h3.pqm_reconstruct(p, t, lim, True)
        return [rc.c0, rc.c1, rc.c2, rc.c3, rc.c4]
    rcs = [h3.pqm_reconstruct(p, tm) for tm in (t, t * .1 + 30.)]
    p_dst = (jnp.asarray(_p_dst(np.asarray(p))) if h3 is jh3
             else _t(_p_dst(p.numpy())))
    return h3.remap_groups([(rcs, p_dst)], lim == 'remap_bottom')[0]


@pytest.mark.parametrize('name', COMMON_CASES)
def test_common_solver(monkeypatch, name):
    """With both packages' batched solve replaced by `_gepp` and blom_tpu
    run op by op, every column agrees within 1e-12, the vanishing ones
    included (the module docstring)."""
    use_common_solver(monkeypatch)
    p, t = _columns(16)
    with jax.disable_jit():
        ref = _run_case(jh3, name, jnp.asarray(p), jnp.asarray(t))
    out = _run_case(th3, name, _t(p), _t(t))
    for o, r in zip(out, ref):
        _close(o, r)


# ----------------------------------------------------- oracle, properties

def _rand_column(rng, kk, jumpy=False):
    """test_oracle_parity.py's random column."""
    h = rng.uniform(0.4, 2.5, size=kk)
    x = np.concatenate([[0.0], np.cumsum(h)])
    if jumpy:
        u = np.where(np.arange(kk) < kk // 2, 1.0, 0.0) \
            + 0.1 * rng.standard_normal(kk)
    else:
        u = np.sin(np.linspace(0, 3, kk)) + 0.3 * rng.standard_normal(kk)
    return x, u


@pytest.mark.parametrize('limiting', ['no_limiting', 'monotonic',
                                      'non_oscillatory',
                                      'non_oscillatory_posdef'])
def test_ppm_ih4_matches_oracle(limiting):
    """tests/test_oracle_parity.py's ih4 case on the port."""
    rng = np.random.default_rng(7)
    kk = 12
    lim = 'none' if limiting == 'no_limiting' else limiting
    for trial in range(24):
        x, u = _rand_column(rng, kk, jumpy=trial % 2 == 0)
        if limiting == 'non_oscillatory_posdef':
            u = np.abs(u)
        pc_ref = h3o.ppm_reconstruct(x, u, limiting=limiting)
        rc = th3.ppm_ih4_reconstruct(_t(x)[:, None], _t(u)[:, None],
                                     limiting=lim)
        got = np.stack([rc.c0[:, 0].numpy(), rc.c1[:, 0].numpy(),
                        rc.c2[:, 0].numpy()])
        np.testing.assert_allclose(got, pc_ref, rtol=1e-9, atol=1e-9,
                                   err_msg=f'trial {trial}')


def _cell_means(poly, p):
    Pi = np.polynomial.Polynomial(poly).integ()
    return np.asarray([(Pi(p[k + 1]) - Pi(p[k])) / (p[k + 1] - p[k])
                       for k in range(len(p) - 1)])


def test_ih4_exact_for_cubics():
    rng = np.random.default_rng(0)
    p = np.concatenate([[0.], np.cumsum(rng.uniform(.5, 2., 12))])
    poly = [1.3, -2.0, 0.7, 0.35]
    e = th3.edges_ih4(_t(p)[:, None], _t(_cell_means(poly, p))[:, None])
    np.testing.assert_allclose(e[:, 0].numpy(),
                               np.polynomial.Polynomial(poly)(p),
                               rtol=1e-9, atol=1e-9)


def test_ih6_exact_for_quintics():
    rng = np.random.default_rng(1)
    p = np.concatenate([[0.], np.cumsum(rng.uniform(.8, 1.2, 14))])
    poly = [0.4, 1.1, -0.3, 0.08, -0.01, 0.002]
    e, s = th3.edges_slopes_ih6(_t(p)[:, None],
                                _t(_cell_means(poly, p))[:, None],
                                lb_ord=6, rb_ord=6)
    P = np.polynomial.Polynomial(poly)
    sl = slice(2, 14 - 1)
    np.testing.assert_allclose(e[sl, 0].numpy(), P(p)[sl], rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(s[sl, 0].numpy(), P.deriv()(p)[sl],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('limiting', LIMITINGS)
def test_pqm_mean_preservation(limiting):
    rng = np.random.default_rng(2)
    kk = 10
    p = np.concatenate([[0.], np.cumsum(rng.uniform(.5, 2., kk))])
    tm = rng.uniform(1., 3., kk)
    rc = th3.pqm_reconstruct(_t(p)[:, None], _t(tm)[:, None], limiting)
    mean = rc.c0 + rc.c1 / 2. + rc.c2 / 3. + rc.c3 / 4. + rc.c4 / 5.
    np.testing.assert_allclose(mean[:, 0].numpy(), tm, rtol=1e-10)


def test_pqm_remap_conserves():
    rng = np.random.default_rng(3)
    kk = 12
    p_src = np.concatenate([[0.], np.cumsum(rng.uniform(.5, 2., kk))])
    tm = rng.uniform(1., 3., kk)
    rc = th3.pqm_reconstruct(_t(p_src)[:, None], _t(tm)[:, None])
    p_dst = np.linspace(0., p_src[-1], 9)
    means = th3.remap_means(rc, _t(p_dst)[:, None])
    np.testing.assert_allclose(float((means[:, 0].numpy()
                                      * np.diff(p_dst)).sum()),
                               np.sum(tm * np.diff(p_src)), rtol=1e-12)


def test_pqm_monotonic_no_overshoot():
    kk = 12
    p = np.arange(kk + 1, dtype=float)
    tm = np.where(np.arange(kk) < kk // 2, 1.0, 3.0).astype(float)
    rc = th3.pqm_reconstruct(_t(p)[:, None], _t(tm)[:, None],
                             limiting=th3.MONOTONIC)
    xi = np.linspace(0., 1., 33)
    vals = sum(c[:, 0, None].numpy() * xi ** i
               for i, c in enumerate(_coeffs(rc)))
    assert vals.min() >= 1.0 - 1e-9
    assert vals.max() <= 3.0 + 1e-9


def test_ppm_ih4_reconstruct_smooth():
    """ih4-PPM of a sine: edges within 2e-4 away from the boundaries."""
    kk = 24
    p = np.linspace(0., 2 * np.pi, kk + 1)
    tm = np.diff(-np.cos(p)) / np.diff(p)
    rc = th3.ppm_ih4_reconstruct(_t(p)[:, None], _t(tm)[:, None],
                                 limiting='none')
    err = np.abs(rc.c0[:, 0].numpy()[2:-2] - np.sin(p[:-1])[2:-2]).max()
    assert err < 2e-4
