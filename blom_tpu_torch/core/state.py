"""Model state and shared state operators.

Counterpart of `blom_tpu/core/state.py` (BLOM's mod_state.F90:34-93):
struct of tensors, layout (time, k, j, i) with i innermost, the two
leap-frog time levels on a leading axis of size 2.  The step updates a
State in place (slot writes such as ``s.dp[n] = ...`` and field
rebinding); `State.clone` gives an independent copy."""

from __future__ import annotations

import dataclasses

import torch

from .grid import Grid


@dataclasses.dataclass
class State:
    """Prognostic + auxiliary model state.  Shapes: L=(2,) time levels,
    K=(kk,), KP=(kk+1,), H=(jdm, idm)."""

    # -- primary prognostic fields (mod_state.F90:34-47), (L, K, *H)
    u: torch.Tensor        # baroclinic u [m s-1]
    v: torch.Tensor        # baroclinic v [m s-1]
    dp: torch.Tensor       # layer pressure thickness [Pa]
    dpu: torch.Tensor      # dp at u-points [Pa]
    dpv: torch.Tensor      # dp at v-points [Pa]
    temp: torch.Tensor     # potential temperature [C]
    saln: torch.Tensor     # salinity [g kg-1]
    sigma: torch.Tensor    # potential density [kg m-3]
    uflx: torch.Tensor     # accumulated u mass flux [kg m s-2]
    vflx: torch.Tensor
    utflx: torch.Tensor    # heat fluxes
    vtflx: torch.Tensor
    usflx: torch.Tensor    # salt fluxes
    vsflx: torch.Tensor

    # -- interface pressures / geopotential (KP, *H)
    p: torch.Tensor
    pu: torch.Tensor
    pv: torch.Tensor
    phi: torch.Tensor

    # -- advective flux areas (K, *H)
    cau: torch.Tensor
    cav: torch.Tensor

    # -- barotropic state (mod_state.F90:60-84)
    ubflxs: torch.Tensor     # (3, *H) barotropic mass flux sums
    vbflxs: torch.Tensor
    ub: torch.Tensor         # (L, *H)
    vb: torch.Tensor
    pb: torch.Tensor
    pbu: torch.Tensor
    pbv: torch.Tensor
    ubflxs_p: torch.Tensor   # (L, *H) predicted flux sums
    vbflxs_p: torch.Tensor
    pb_p: torch.Tensor       # (*H) predicted bottom pressure
    pbu_p: torch.Tensor
    pbv_p: torch.Tensor
    ubcors_p: torch.Tensor   # (*H) predicted coriolis sums
    vbcors_p: torch.Tensor
    sealv: torch.Tensor      # (*H) sea level [m]

    # -- barotropic solver persistent state (mod_barotp.F90:60-71)
    ubflx: torch.Tensor      # (L, *H)
    vbflx: torch.Tensor
    pb_mn: torch.Tensor
    ubflx_mn: torch.Tensor
    vbflx_mn: torch.Tensor
    pvtrop: torch.Tensor     # (L, *H) barotropic potential vorticity at q

    # -- pressure-gradient force state (mod_pgforc.F90:52-80)
    pgfx: torch.Tensor       # (L, K, *H)
    pgfy: torch.Tensor
    pgfx_o: torch.Tensor     # (K, *H) old level
    pgfy_o: torch.Tensor
    pgfxm: torch.Tensor      # (L, *H)
    pgfym: torch.Tensor
    xixp: torch.Tensor
    xixm: torch.Tensor
    xiyp: torch.Tensor
    xiym: torch.Tensor
    pgfxm_o: torch.Tensor    # (*H)
    pgfym_o: torch.Tensor
    xixp_o: torch.Tensor
    xixm_o: torch.Tensor
    xiyp_o: torch.Tensor
    xiym_o: torch.Tensor

    # -- time-smoothing saves (mod_tmsmt.F90:54-68)
    dpold: torch.Tensor      # (L, K, *H)
    dpuold: torch.Tensor     # (K, *H)
    dpvold: torch.Tensor
    told: torch.Tensor
    sold: torch.Tensor

    # -- passive tracers
    trc: torch.Tensor        # (L, ntr, K, *H)
    trcold: torch.Tensor     # (ntr, K, *H)

    # -- vertical-coordinate reference densities
    sigmar: torch.Tensor     # (K, *H)

    # -- misc
    kfpla: torch.Tensor      # (L, *H) int32: first physical interior layer
    ustarb: torch.Tensor     # (*H) bottom friction velocity [m s-1]

    def clone(self) -> 'State':
        return State(**{f.name: getattr(self, f.name).clone()
                        for f in dataclasses.fields(self)})


def empty_state(grid: Grid, dtype=None, ntr: int = 0) -> State:
    kk = grid.kk
    H = grid.shape
    dtype = dtype or grid.dtype
    shapes = {}
    for f in dataclasses.fields(State):
        shapes[f.name] = (2, kk) + H
    for name in ('p', 'pu', 'pv', 'phi'):
        shapes[name] = (kk + 1,) + H
    for name in ('cau', 'cav', 'pgfx_o', 'pgfy_o', 'dpuold', 'dpvold',
                 'told', 'sold', 'sigmar'):
        shapes[name] = (kk,) + H
    for name in ('ubflxs', 'vbflxs'):
        shapes[name] = (3,) + H
    for name in ('ub', 'vb', 'pb', 'pbu', 'pbv', 'ubflxs_p', 'vbflxs_p',
                 'ubflx', 'vbflx', 'pb_mn', 'ubflx_mn', 'vbflx_mn',
                 'pvtrop', 'pgfxm', 'pgfym', 'xixp', 'xixm', 'xiyp',
                 'xiym', 'kfpla'):
        shapes[name] = (2,) + H
    for name in ('pb_p', 'pbu_p', 'pbv_p', 'ubcors_p', 'vbcors_p', 'sealv',
                 'pgfxm_o', 'pgfym_o', 'xixp_o', 'xixm_o', 'xiyp_o',
                 'xiym_o', 'ustarb'):
        shapes[name] = H
    shapes['trc'] = (2, ntr, kk) + H
    shapes['trcold'] = (ntr, kk) + H
    fields = {name: torch.zeros(shp, dtype=dtype, device=grid.device)
              for name, shp in shapes.items()}
    fields['kfpla'] = torch.full(shapes['kfpla'], 2, dtype=torch.int32,
                                 device=grid.device)
    return State(**fields)


#: XLA on the CPU rewrites a cumulative sum longer than this into blocks
#: of this length
_XLA_SCAN_BLOCK = 16


def cumsum0(a):
    """torch.cumsum(a, 0) in the order of blom_tpu's jnp.cumsum on the
    CPU: up to 16 terms in order; more in blocks of 16, each summed in
    order, plus the running sum of the block totals before it."""
    k, b = a.shape[0], _XLA_SCAN_BLOCK
    if k <= b:
        return torch.cumsum(a, 0)
    nb = -(-k // b)
    pad = a.new_zeros((nb * b - k,) + a.shape[1:])
    inner = torch.cumsum(torch.cat([a, pad]).reshape((nb, b) + a.shape[1:]),
                         1)
    before = torch.cat([torch.zeros_like(inner[:1, -1]),
                        cumsum0(inner[:-1, -1])])
    return (inner + before[:, None]).reshape((nb * b,) + a.shape[1:])[:k]


def cumulative_p(dp_k):
    """Interface pressures (kk+1, ...) from layer thicknesses (kk, ...)."""
    return torch.cat([torch.zeros_like(dp_k[:1]), cumsum0(dp_k)], 0)


def dpu_dpv_upstream(grid: Grid, p_i):
    """Layer thickness at u and v points by the depth-limited half-sum
    rule (mod_pgforc.F90:452-476, mod_blom_init.F90:283-305):

      q = min(pbot(i), pbot(i-1))
      dpu(k) = .5*((min(q, p(i-1,k+1)) - min(q, p(i-1,k)))
                 + (min(q, p(i,  k+1)) - min(q, p(i,  k))))
    """
    pbot = p_i[-1]
    p_w = grid.im1(p_i)
    q = torch.minimum(pbot, grid.im1(pbot))
    dpu = .5 * ((torch.minimum(q, p_w[1:]) - torch.minimum(q, p_w[:-1]))
                + (torch.minimum(q, p_i[1:]) - torch.minimum(q, p_i[:-1])))
    p_s = grid.jm1(p_i)
    q = torch.minimum(pbot, grid.jm1(pbot))
    dpv = .5 * ((torch.minimum(q, p_s[1:]) - torch.minimum(q, p_s[:-1]))
                + (torch.minimum(q, p_i[1:]) - torch.minimum(q, p_i[:-1])))
    return dpu * grid.iu, dpv * grid.iv
