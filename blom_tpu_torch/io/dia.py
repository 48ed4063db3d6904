"""Diagnostic accumulation and NetCDF output.

Counterpart of `blom_tpu/io/dia.py` (BLOM's phy/mod_dia.F90: up to
nphymax=10 output groups, each with its own averaging period and a
per-field selection of 2-D, layer and z-level diagnostics with
ave/min/max/sq accumulation; NetCDF output via mod_nctools.F90).

A registry of extractors over a `DiaCtx` (grid, state, forcing,
diffusion fields), accumulators that stay on the state's device between
outputs (diaacc after each step, mod_blom_step.F90:239), per-group
alarms (diaout_alarms, mod_dia.F90:2200-2311) and a NetCDF3-classic
writer (the reference's NCFORMAT=0) with an optional wet-point
compressed form (mod_nctools ncdimc/nccomp).  Every id of blom_tpu's
registry is here, under its name, computing the same function.

The z-level ids share one set of layer/bin overlap weights per time
level within an `accumulate` call (`DiaCtx.zw`), where blom_tpu's jit
shares the one array between ids: at 384x360x53 the weights take ~1 GB
in f32, and the step runs eagerly here.  The sharded NetCDF writer and
reader come with the decomposition."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import eos
from ..core.constants import alpha0, epsilp, grav, onem
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from .checksum import to_numpy
from .merdia import (DEPTHSLEV, lat_bin_weights, meridional_transport,
                     overturning_streamfunction, to_zlev_w, zlev_weights)


class DiaCtx(NamedTuple):
    """Extractor context: everything a diagnostic may read."""
    g: Grid
    s: State
    frc: object = None     # phys.forcing.Forcing
    dfl: object = None     # dynamics.diffusion_fields.DiffusionFields
    si: object = None      # phys.seaice.SeaiceState
    swabs: object = None   # phys.swabs.SwabsFields
    tridx: dict = None     # tracer indices {'itriag','itrtke','itrgls'}
    cesm: dict = None      # coupled-interval forcing fields
    e: object = None       # core.eos.EosParams (falls back to defaults)
    zw: dict = None        # time level -> z-level weights (filled on use)


def _zeros2(c):
    return torch.zeros(c.g.shape, dtype=c.s.pb.dtype, device=c.s.pb.device)


def _cesm(name):
    """A coupled-forcing field (H2D_LIP/SOP/EVA/RNFFLX/RFIFLX/FMLTFZ/
    HMLTFZ/LAMULT/USTOKES/VSTOKES ids; zeros in uncoupled runs)."""
    def fn(c, n):
        if not c.cesm or name not in c.cesm:
            return _zeros2(c)
        return c.cesm[name]
    return fn


def _si(name):
    """Sea-ice slab field (H2D_FICE/HICE/HSNW/TICE/TSRF/IAGE,
    mod_dia.F90:204-219; zeros when no ice model is active)."""
    def fn(c, n):
        if c.si is None:
            return _zeros2(c)
        return getattr(c.si, name)
    return fn


def _swabs(name):
    """Shortwave-absorption profile field (H2D_SWFC1/SWFC2/SWAL1/SWAL2;
    zeros when the swabs fields are absent)."""
    def fn(c, n):
        if c.swabs is None:
            return _zeros2(c)
        return getattr(c.swabs, name)
    return fn


def _trc_by_index(key, floor=None):
    """A named tracer of the tracer block by its index (LYR_TKE/GLS/
    IDLAGE, mod_dia.F90:220-240); zeros when it is not carried."""
    def fn(c, n):
        idx = -1 if not c.tridx else c.tridx.get(key, -1)
        if idx is None or idx < 0:
            return torch.zeros(c.s.temp.shape[1:], dtype=c.s.temp.dtype,
                               device=c.s.temp.device)
        v = c.s.trc[n, idx]
        return v if floor is None else torch.clamp_min(v, floor)
    return fn


def _wflx(c, n):
    """Diagnosed vertical mass flux through interfaces [kg s-1]
    (LYR_WFLX): the cumulative horizontal flux divergence of the
    accumulated uflx/vflx, downward positive."""
    g = c.g
    div = (g.ip1(c.s.uflx[n]) - c.s.uflx[n]
           + g.jp1(c.s.vflx[n], 'v', True) - c.s.vflx[n])
    return torch.cumsum(div, 0) * g.ip


def _wflx2(c, n):
    w = _wflx(c, n)
    return w * w


def _kidx(a):
    return torch.arange(a.shape[0], device=a.device)[:, None, None]


def _bottom(extract):
    """Deepest-wet-layer value of a layer field (ACC_SBOT/ACC_TBOT)."""
    def fn(c, n):
        a = extract(c, n)
        wet = c.s.dp[n] > 1.e-3
        kidx = _kidx(a)
        kbot = torch.where(wet, kidx, 0).amax(0)
        onehot = (kidx == kbot[None]).to(a.dtype)
        return (a * onehot).sum(0)
    return fn


def _bfsq(c, n):
    """Interface Brunt-Vaisala frequency from the layered density
    (cmnfld_bfsqf, mod_cmnfld_routines.F90:61-421)."""
    dp_k = c.s.dp[n]
    sig = c.s.sigma[n]
    dp_mid = torch.clamp_min(.5 * (dp_k[:-1] + dp_k[1:]), epsilp)
    bv = grav * grav * (sig[1:] - sig[:-1]) / dp_mid
    return torch.cat([bv[:1], bv], 0)


def _ivol(stagger):
    """Ice volume at u/v-points [m] (ACC_IVOLU/IVOLV): hicem*ficem of
    the two p-cells beside the edge (mod_dia.F90:1136,1141)."""
    def fn(c, n):
        if c.si is None:
            return _zeros2(c)
        hf = c.si.hicem * c.si.ficem
        if stagger == 'u':
            return (c.g.im1(hf) + hf) * c.g.iu
        return (c.g.jm1(hf) + hf) * c.g.iv
    return fn


def _dpvor(c, n):
    """Thickness of the potential-vorticity definition (LYR_DPVOR,
    mod_momtum.F90:473-575 dpvor), at the mid time level m = 1-n where
    momtum evaluates it."""
    from ..dynamics.momtum import potvor_field
    m = 1 - n
    _, dpv = potvor_field(c.g, c.s.dp[m], c.s.u[m], c.s.v[m],
                          return_dpvor=True)
    return dpv


def _mfl_trc(mfl, trc, direction):
    """Eddy-induced / submesoscale tracer flux: the mass flux times the
    edge-mean tracer (mod_eddtra.F90:1836-1905, LYR_U/VT/SFLTD/SM)."""
    def fn(c, n):
        t = getattr(c.s, trc)[n]
        nbr = c.g.im1(t) if direction == 'u' else c.g.jm1(t)
        return getattr(c.dfl, mfl)[1 - n] * .5 * (t + nbr)
    return fn


_ONECM = 98.06      # 1 cm of pressure thickness [Pa] (mod_constants)
_DBCL82 = 3.e-4     # Levitus (1982) buoyancy criterion [m s-2]
_DRCB04 = .03       # de Boyer Montegut (2004) density criterion [kg m-3]
_ZREFB04 = 10.      # de Boyer Montegut reference depth [m]


def _mld_walk(z_mid, crit_val, crit, wet, z_bot, z0, c0):
    """The crossing walk of both MLD estimators (cmnfld_mldl82/mldb04,
    mod_cmnfld_routines.F90:933-1084): down through the wet layers,
    carrying the last sub-critical (z, value) pair; at the first layer
    whose criterion value exceeds `crit`, the crossing depth linearly
    interpolated in the criterion value; the bottom depth where it never
    crosses.  blom_tpu's lax.scan over k as a k-loop."""
    zup, cup = z0, c0
    done = torch.zeros(z0.shape, dtype=torch.bool, device=z0.device)
    out = z_bot
    for k in range(z_mid.shape[0]):
        zlo, clo, w = z_mid[k], crit_val[k], wet[k]
        cross = w & (clo > crit) & ~done
        cupc = torch.clamp_max(cup, crit - 1e-14)
        zx = ((zup * (clo - crit) + zlo * (crit - cupc))
              / torch.clamp_min(clo - cupc, 1e-30))
        out = torch.where(cross, zx, out)
        done = done | cross
        adv = w & ~done
        zup = torch.where(adv, zlo, zup)
        cup = torch.where(adv, clo, cup)
    return out


def _mldl82(c, n):
    """Levitus (1982) mixed-layer depth: the buoyancy difference of the
    surface water displaced to the local mid-layer pressure exceeds
    dbcl82 (cmnfld_mldl82, mod_cmnfld_routines.F90:933-996); depth as
    pressure/onem."""
    p = cumulative_p(c.s.dp[n]) * c.g.ip
    dp_k = c.s.dp[n]
    temp, saln = c.s.temp[n], c.s.saln[n]
    p_mid = p[:-1] + .5 * dp_k
    z_mid = p_mid / onem
    rho_srf = eos.rho(p_mid[1:], temp[0][None], saln[0][None])
    rho_loc = eos.rho(p_mid[1:], temp[1:], saln[1:])
    db = grav * (1. - rho_srf / torch.clamp_min(rho_loc, 1.))
    wet = dp_k[1:] > _ONECM
    z_bot = p[-1] / onem
    out = _mld_walk(z_mid[1:], db, _DBCL82, wet, z_bot,
                    z_mid[0], torch.zeros_like(z_bot))
    return out * c.g.ip


def _mldb04(c, n):
    """de Boyer Montegut et al. (2004) mixed-layer depth: sig0 exceeds
    its value at the 10 m reference depth by drcb04 (cmnfld_mldb04,
    mod_cmnfld_routines.F90:998-1084)."""
    e = c.e if c.e is not None else _default_eos()
    p = cumulative_p(c.s.dp[n]) * c.g.ip
    dp_k = c.s.dp[n]
    z_mid = (p[:-1] + .5 * dp_k) / onem
    s0 = eos.sig0(e, c.s.temp[n], c.s.saln[n])

    # sig0 at the reference depth: linear interpolation between the
    # bracketing mid-layer depths (mod_cmnfld_routines.F90:1029-1039)
    above = z_mid <= _ZREFB04
    nmax = torch.clamp_min(above.to(torch.int32).sum(0), 1)
    kup = nmax - 1                                   # deepest above ref
    kidx = _kidx(dp_k)

    def pick(a, kq):
        return torch.where(kidx == kq[None], a, 0.).sum(0)

    klo = torch.clamp_max(kup + 1, dp_k.shape[0] - 1)
    zu, zl = pick(z_mid, kup), pick(z_mid, klo)
    su, sl = pick(s0, kup), pick(s0, klo)
    w = torch.clamp((_ZREFB04 - zu) / torch.clamp_min(zl - zu, 1e-12),
                    0., 1.)
    sig0ref = (1. - w) * su + w * sl

    ds = s0 - sig0ref[None]
    wet = (dp_k > _ONECM) & (z_mid > _ZREFB04)
    z_bot = p[-1] / onem
    out = _mld_walk(z_mid, ds, _DRCB04, wet, z_bot,
                    torch.full_like(z_bot, _ZREFB04),
                    torch.zeros_like(z_bot))
    # shallow columns: full depth (mod_cmnfld_routines.F90:1014-1018)
    out = torch.where(z_bot < _ZREFB04, z_bot, out)
    return out * c.g.ip


_EOS_DEFAULT = []


def _default_eos():
    if not _EOS_DEFAULT:
        _EOS_DEFAULT.append(eos.init_eos(pref=0.))
    return _EOS_DEFAULT[0]


def _isotherm_depth(tcrit):
    """Depth [m] of an isotherm (ACC_T20D/ACC_T17D)."""
    def fn(c, n):
        p = cumulative_p(c.s.dp[n])
        z_mid = .5 * (p[:-1] + p[1:]) / onem
        colder = c.s.temp[n] < tcrit
        kk = c.s.dp.shape[1]
        return torch.where(colder, z_mid, p[kk] / onem).amin(0) * c.g.ip
    return fn


def _btmstr(c, n):
    """Barotropic mass streamfunction [kg s-1]: the south-to-north
    cumulative barotropic u transport (ACC_BTMSTR)."""
    ut = c.s.ub[n] * c.s.pbu[n] * c.g.scuy / 9.806
    return torch.cumsum(ut, -2) * c.g.iu


def _pv(c, n):
    """Layer potential vorticity (ACC_PV): (zeta + f) / dp."""
    g = c.g
    u, v = c.s.u[n], c.s.v[n]
    # circulation / area form of relative vorticity at q
    vy = v * g.scvy
    ux = u * g.scux
    vort = ((vy - g.im1(vy)) - (ux - g.jm1(ux))) * g.scq2i
    f = g.corioq
    dq = .25 * (c.s.dp[n] + g.im1(c.s.dp[n])
                + g.jm1(c.s.dp[n]) + g.im1(g.jm1(c.s.dp[n])))
    return (vort + f) / torch.clamp_min(dq, epsilp) * g.iq


def _tau_p(c):
    return (.5 * (c.frc.taux + c.g.ip1(c.frc.taux)),
            .5 * (c.frc.tauy + c.g.jp1(c.frc.tauy, 'v', True)))


def _abswnd(c, n):
    taux_p, tauy_p = _tau_p(c)
    return torch.sqrt(torch.sqrt(taux_p ** 2 + tauy_p ** 2))


def _ustar(c, n):
    taux_p, tauy_p = _tau_p(c)
    return torch.sqrt(torch.sqrt(taux_p ** 2 + tauy_p ** 2) / 1000.)


def _frc(name):
    def fn(c, n):
        return getattr(c.frc, name)
    return fn


def _dfl2(name):
    def fn(c, n):
        return getattr(c.dfl, name)[n]
    return fn


def _dfl(name):
    def fn(c, n):
        return getattr(c.dfl, name)
    return fn


def _wmass(c, n):
    """dp times the wet cell areas, (K, J, I)."""
    return c.s.dp[n] * (c.g.scp2 * c.g.ip)[None]


def _colga(name):
    """Mass-weighted global average of a layer field (MSC_TEMPGA/
    SALNGA)."""
    def fn(c, n):
        w = (c.g.scp2 * c.g.ip)[None]
        return ((getattr(c.s, name)[n] * c.s.dp[n] * w).sum()
                / torch.clamp_min((c.s.dp[n] * w).sum(), 1e-30))
    return fn


def _srfga(name):
    """Area-weighted global average of a top-layer field (MSC_SSTGA/
    SSSGA)."""
    def fn(c, n):
        return ((getattr(c.s, name)[n][0] * c.g.scp2 * c.g.ip).sum()
                / torch.clamp_min((c.g.scp2 * c.g.ip).sum(), 1e-30))
    return fn


def _psrf(c, n):
    return c.s.p[0] if c.s.p.dim() == 3 else torch.zeros_like(c.s.pb[n])


# field extractors: name -> (dims, fn(ctx, lvl) -> tensor)
# dims: '2d' (J, I), '3d' (K, J, I) layer, 'zlv' (ddm, J, I) z-level,
#       'tr3d' (ntr, K, J, I), 'trzlv' (ntr, ddm, J, I), 'scalar' ()
FIELD_REGISTRY: Dict[str, Tuple[str, Callable]] = {
    # ---- 2-D (H2D_* ids, mod_dia.F90:204-219) ----
    'sealv': ('2d', lambda c, n: c.s.sealv),
    'slvsq': ('2d', lambda c, n: c.s.sealv ** 2),
    'pbot': ('2d', lambda c, n: c.s.pb[n]),
    'psrf': ('2d', _psrf),
    'sst': ('2d', lambda c, n: c.s.temp[n][0]),
    'sstsq': ('2d', lambda c, n: c.s.temp[n][0] ** 2),
    'sss': ('2d', lambda c, n: c.s.saln[n][0]),
    'ssssq': ('2d', lambda c, n: c.s.saln[n][0] ** 2),
    'ub': ('2d', lambda c, n: c.s.ub[n]),
    'vb': ('2d', lambda c, n: c.s.vb[n]),
    'ustarb': ('2d', lambda c, n: c.s.ustarb),
    'pbu': ('2d', lambda c, n: c.s.pbu[n]),
    'pbv': ('2d', lambda c, n: c.s.pbv[n]),
    'ubflxs': ('2d', lambda c, n: c.s.ubflxs[1]),
    'vbflxs': ('2d', lambda c, n: c.s.vbflxs[1]),
    'sbot': ('2d', _bottom(lambda c, n: c.s.saln[n])),
    'tbot': ('2d', _bottom(lambda c, n: c.s.temp[n])),
    'sigmx': ('2d', lambda c, n: c.s.sigma[n][0]),
    'btmstr': ('2d', _btmstr),
    'mldl82': ('2d', _mldl82),
    'mldb04': ('2d', _mldb04),
    't20d': ('2d', _isotherm_depth(20.)),
    't17d': ('2d', _isotherm_depth(17.)),
    # forcing-sourced 2-D fields
    'taux': ('2d', _frc('taux')),
    'tauy': ('2d', _frc('tauy')),
    'ztx': ('2d', _frc('taux')),
    'mty': ('2d', _frc('tauy')),
    'swa': ('2d', _frc('sswflx')),
    'nsf': ('2d', _frc('surflx')),
    'surflx': ('2d', _frc('surflx')),
    'sfl': ('2d', _frc('salflx')),
    'salflx': ('2d', _frc('salflx')),
    'brnflx': ('2d', _frc('brnflx')),
    'surrlx': ('2d', _frc('surrlx')),
    'salrlx': ('2d', _frc('salrlx')),
    'abswnd': ('2d', _abswnd),
    'ustar': ('2d', _ustar),
    'ustar3': ('2d', lambda c, n: _ustar(c, n) ** 3),
    # ---- layer 3-D (LYR_* ids) ----
    'temp': ('3d', lambda c, n: c.s.temp[n]),
    'saln': ('3d', lambda c, n: c.s.saln[n]),
    'dp': ('3d', lambda c, n: c.s.dp[n]),
    'dz': ('3d', lambda c, n: c.s.dp[n]),
    'dpu': ('3d', lambda c, n: c.s.dpu[n]),
    'dpv': ('3d', lambda c, n: c.s.dpv[n]),
    'uvel': ('3d', lambda c, n: c.s.u[n] + c.s.ub[n][None]),
    'vvel': ('3d', lambda c, n: c.s.v[n] + c.s.vb[n][None]),
    'sigma': ('3d', lambda c, n: c.s.sigma[n]),
    'uflx': ('3d', lambda c, n: c.s.uflx[n]),
    'vflx': ('3d', lambda c, n: c.s.vflx[n]),
    'utflx': ('3d', lambda c, n: c.s.utflx[n]),
    'vtflx': ('3d', lambda c, n: c.s.vtflx[n]),
    'usflx': ('3d', lambda c, n: c.s.usflx[n]),
    'vsflx': ('3d', lambda c, n: c.s.vsflx[n]),
    'bfsq': ('3d', _bfsq),
    'pv': ('3d', _pv),
    # diffusivity / eddy-transport fields (LYR_DIF*, LYR_*MFLTD/SM)
    'difint': ('3d', _dfl('difint')),
    'difiso': ('3d', _dfl('difiso')),
    'difdia': ('3d', _dfl('difdia')),
    'umfltd': ('3d', _dfl2('umfltd')),
    'vmfltd': ('3d', _dfl2('vmfltd')),
    'umflsm': ('3d', _dfl2('umflsm')),
    'vmflsm': ('3d', _dfl2('vmflsm')),
    # all passive tracers (LYR_TRC)
    'trc': ('tr3d', lambda c, n: c.s.trc[n]),
    # ---- global scalars (MSC_* ids) ----
    'massgs': ('scalar', lambda c, n: _wmass(c, n).sum() / 9.806),
    'volgs': ('scalar', lambda c, n: _wmass(c, n).sum()
               / (9.806 * 1000.)),
    'tempga': ('scalar', _colga('temp')),
    'salnga': ('scalar', _colga('saln')),
    'sstga': ('scalar', _srfga('temp')),
    'sssga': ('scalar', _srfga('saln')),
    # ---- sea ice (H2D_FICE/HICE/HSNW/TICE/TSRF/IAGE) ----
    'fice': ('2d', _si('ficem')),
    'hice': ('2d', _si('hicem')),
    'hsnw': ('2d', _si('hsnwm')),
    'tice': ('2d', _si('ticem')),
    'tsrf': ('2d', _si('tsrfm')),
    'iage': ('2d', _si('iagem')),
    # ---- shortwave absorption profile (H2D_SWFC1/2, SWAL1/2) ----
    'swfc1': ('2d', _swabs('swfc1')),
    'swfc2': ('2d', _swabs('swfc2')),
    'swal1': ('2d', _swabs('swal1')),
    'swal2': ('2d', _swabs('swal2')),
    # ---- vertical mixing coefficients (LYR_DIFV*) ----
    'difvho': ('3d', _dfl('difvho')),
    'difvso': ('3d', _dfl('difvso')),
    'difvmo': ('3d', _dfl('difvmo')),
    # ---- named tracers (LYR_TKE/GLS/IDLAGE) ----
    'tke': ('3d', _trc_by_index('itrtke')),
    'gls': ('3d', _trc_by_index('itrgls')),
    'idlage': ('3d', _trc_by_index('itriag')),
    # ---- diagnosed vertical mass flux (LYR_WFLX/WFLX2) ----
    'wflx': ('3d', _wflx),
    'wflx2': ('3d', _wflx2),
    # ---- coupled forcing fields (H2D ids of the mod_cesm slots) ----
    'lip': ('2d', _cesm('lip')),
    'sop': ('2d', _cesm('sop')),
    'eva': ('2d', _cesm('eva')),
    'rnfflx': ('2d', _cesm('rnf')),
    'rfiflx': ('2d', _cesm('rfi')),
    'fmltfz': ('2d', _cesm('fmltfz')),
    'hmltfz': ('2d', _cesm('hmlt')),
    'lamult': ('2d', _cesm('lamult')),
    'lasl': ('2d', _cesm('hstokes')),
    'ustokes': ('2d', _cesm('ustokes')),
    'vstokes': ('2d', _cesm('vstokes')),
    'slp': ('2d', _cesm('slp')),
    # ---- sea-ice drift/volume and albedo (H2D_UICE/VICE/IVOLU/IVOLV/
    # ALB; mod_seaice.F90:40-41) ----
    'uice': ('2d', _si('uicem')),
    'vice': ('2d', _si('vicem')),
    'alb': ('2d', _si('albm')),
    'ivolu': ('2d', _ivol('u')),
    'ivolv': ('2d', _ivol('v')),
    # ---- KPP boundary-layer depth (H2D_BLD/MAXBLD) ----
    'bld': ('2d', lambda c, n: c.dfl.bld),
    'maxbld': ('2d', lambda c, n: c.dfl.bld),
    # ---- thickness of the potential vorticity (LYR_DPVOR) ----
    'dpvor': ('3d', _dpvor),
    # ---- component-wise tracer fluxes: eddy-induced (td), submesoscale
    # (sm) and isopycnal diffusion (ld, dynamics.diffus) ----
    'utfltd': ('3d', _mfl_trc('umfltd', 'temp', 'u')),
    'usfltd': ('3d', _mfl_trc('umfltd', 'saln', 'u')),
    'vtfltd': ('3d', _mfl_trc('vmfltd', 'temp', 'v')),
    'vsfltd': ('3d', _mfl_trc('vmfltd', 'saln', 'v')),
    'utflsm': ('3d', _mfl_trc('umflsm', 'temp', 'u')),
    'usflsm': ('3d', _mfl_trc('umflsm', 'saln', 'u')),
    'vtflsm': ('3d', _mfl_trc('vmflsm', 'temp', 'v')),
    'vsflsm': ('3d', _mfl_trc('vmflsm', 'saln', 'v')),
    'utflld': ('3d', lambda c, n: c.dfl.utflld),
    'usflld': ('3d', lambda c, n: c.dfl.usflld),
    'vtflld': ('3d', lambda c, n: c.dfl.vtflld),
    'vsflld': ('3d', lambda c, n: c.dfl.vsflld),
    # ---- mixed-layer TKE budget terms (H2D_MTKE*) ----
    'mtkeus': ('2d', lambda c, n: c.dfl.mtke[0]),
    'mtkeni': ('2d', lambda c, n: c.dfl.mtke[1]),
    'mtkebf': ('2d', lambda c, n: c.dfl.mtke[2]),
    'mtkers': ('2d', lambda c, n: c.dfl.mtke[3]),
    'mtkepe': ('2d', lambda c, n: c.dfl.mtke[4]),
    'mtkeke': ('2d', lambda c, n: c.dfl.mtke[5]),
}


def _zweights(c, n):
    """The z-level weights of time level n, built once per context."""
    if c.zw is None:
        return zlev_weights(cumulative_p(c.s.dp[n]))
    if n not in c.zw:
        c.zw[n] = zlev_weights(cumulative_p(c.s.dp[n]))
    return c.zw[n]


def _zlv(extract):
    """The z-level remap of a 3-D extractor (LVL_* ids,
    mod_dia.F90:241-276 and ale_remap_diazlv)."""
    def fn(c, n):
        return to_zlev_w(extract(c, n), *_zweights(c, n))
    return fn


# previous-leapfrog-level accumulated mass fluxes (ACC_UFLXOLD/VFLXOLD,
# mod_dia.F90:618, behind LVL_WFLX), ids of their own
FIELD_REGISTRY['uflxold'] = ('3d', lambda c, n: c.s.uflx[1 - n])
FIELD_REGISTRY['vflxold'] = ('3d', lambda c, n: c.s.vflx[1 - n])

# z-level twins of the layer fields (LVL_* ids)
for _name in ('temp', 'saln', 'uvel', 'vvel', 'uflx', 'vflx', 'utflx',
              'vtflx', 'usflx', 'vsflx', 'bfsq', 'difint', 'difiso',
              'difdia', 'dz', 'pv', 'umfltd', 'vmfltd', 'umflsm',
              'vmflsm', 'difvho', 'difvso', 'difvmo', 'tke', 'gls',
              'idlage', 'wflx', 'wflx2',
              'utfltd', 'usfltd', 'vtfltd', 'vsfltd',
              'utflsm', 'usflsm', 'vtflsm', 'vsflsm',
              'utflld', 'usflld', 'vtflld', 'vsflld',
              'uflxold', 'vflxold'):
    FIELD_REGISTRY[_name + 'lvl'] = ('zlv', _zlv(FIELD_REGISTRY[_name][1]))
del _name


def _trclvl(c, n):
    """LVL_TRC (mod_dia.F90:226): z-level twins of the whole passive
    tracer stack."""
    ntr = c.s.trc.shape[1]
    if not ntr:
        return torch.zeros((0, len(DEPTHSLEV)) + tuple(c.g.shape),
                           dtype=c.s.pb.dtype, device=c.s.pb.device)
    w = _zweights(c, n)
    return torch.stack([to_zlev_w(c.s.trc[n, i], *w) for i in range(ntr)])


FIELD_REGISTRY['trclvl'] = ('trzlv', _trclvl)


def _aux(name):
    """ben02/NIW auxiliary field (H2D_DFL/HMAT/IDKEDT): from the
    coupled-forcing dict, else the sea-ice slab when it has it, else
    zeros (the reference gates these on allocated(...),
    mod_dia.F90:1628)."""
    def fn(c, n):
        if c.cesm and name in c.cesm:
            return c.cesm[name]
        v = getattr(c.si, name, None) if c.si is not None else None
        if v is not None:
            return v
        return _zeros2(c)
    return fn


def _brnpd(c, n):
    """Brine plume pressure depth (ACC_BRNPD; pbrnda of
    mod_mxlayr.F90:97,557): layer 2's lower interface where there is a
    brine flux, zero elsewhere."""
    p2 = (c.s.p[2] - c.s.p[0]) * c.g.ip
    if c.frc is None:
        return torch.zeros_like(p2)
    return torch.where(c.frc.brnflx > 0., p2, 0.)


FIELD_REGISTRY.update({
    'dfl': ('2d', _aux('dfl')),          # d(nsf)/dT [W m-2 K-1]
    'hmat': ('2d', _aux('hmat')),        # material enthalpy flux
    'idkedt': ('2d', _aux('idkedt')),    # NIW KE tendency (phys/niw)
    'brnpd': ('2d', _brnpd),
    'gls_psi': FIELD_REGISTRY['gls'],    # ACC_GLS_PSI naming alias
    'gls_psilvl': FIELD_REGISTRY['glslvl'],
    # the reference's scratch output slots (util1-4 passthroughs)
    'utilh2d': ('2d', lambda c, n: _zeros2(c)),
    'utillyr': ('3d', lambda c, n: torch.zeros_like(c.s.dp[n])),
    'utillvl': ('zlv', lambda c, n: torch.zeros(
        (len(DEPTHSLEV),) + tuple(c.g.shape), dtype=c.s.pb.dtype,
        device=c.s.pb.device)),
})

# ------------------------------------------------------------------ #
# MSC_* derived diagnostics (diamer global and meridional ids,
# mod_dia.F90:233-238, 4150-4340): computed at output time from the
# group's accumulated means.  Each entry lists the accumulated base ids
# it reads; init_group accumulates the missing ones.
# ------------------------------------------------------------------ #

_CP_SW = 3990.        # seawater heat capacity of the heat ids
_GRAV = 9.806


def _msc_osf_layer(dep):
    def fn(means, grid, wlat):
        return overturning_streamfunction(means[dep], wlat,
                                          scale=1. / _GRAV)
    return fn


def _msc_osf_depth(dep):
    def fn(means, grid, wlat):
        t = torch.einsum('lji,dji->ld', wlat, means[dep]) / _GRAV
        return torch.cat([torch.zeros_like(t[:, :1]),
                          torch.cumsum(t, 1)], 1)
    return fn


def _msc_mer(dep, scale):
    def fn(means, grid, wlat):
        return meridional_transport(means[dep], wlat, scale=scale)
    return fn


def _msc_mer_sum(deps, scale):
    def fn(means, grid, wlat):
        out = meridional_transport(means[deps[0]], wlat, scale=scale)
        for d in deps[1:]:
            out = out + meridional_transport(means[d], wlat, scale=scale)
        return out
    return fn


def _msc_massgs(means, grid, wlat):
    w = grid.scp2 * grid.ip
    return (means['dp'].sum(0) * w).sum() / _GRAV


def _msc_volgs(means, grid, wlat):
    return _msc_massgs(means, grid, wlat) * alpha0


def _msc_colga(dep):
    def fn(means, grid, wlat):
        w = grid.scp2 * grid.ip
        num = ((means[dep] * means['dp']).sum(0) * w).sum()
        den = torch.clamp_min((means['dp'].sum(0) * w).sum(), 1e-30)
        return num / den
    return fn


def _msc_srfga(dep):
    def fn(means, grid, wlat):
        w = grid.scp2 * grid.ip
        return (means[dep] * w).sum() / torch.clamp_min(w.sum(), 1e-30)
    return fn


_HEAT = ('vtflx', 'vtfltd', 'vtflsm', 'vtflld')
_SALT = ('vsflx', 'vsfltd', 'vsflsm', 'vsflld')

#: name -> (deps, dims tag, derive(means, grid, wlat))
MSC_REGISTRY: Dict[str, tuple] = {
    # overturning streamfunctions: layer space and depth space, for the
    # resolved, eddy-induced (TD) and submesoscale transports
    'mmflxl': (('vflx',), 'latsig1', _msc_osf_layer('vflx')),
    'mmftdl': (('vmfltd',), 'latsig1', _msc_osf_layer('vmfltd')),
    'mmfsml': (('vmflsm',), 'latsig1', _msc_osf_layer('vmflsm')),
    'mmflxd': (('vflxlvl',), 'latdep1', _msc_osf_depth('vflxlvl')),
    'mmftdd': (('vmfltdlvl',), 'latdep1', _msc_osf_depth('vmfltdlvl')),
    'mmfsmd': (('vmflsmlvl',), 'latdep1', _msc_osf_depth('vmflsmlvl')),
    # vertically integrated meridional heat/salt transports per
    # component (resolved / TD / submeso / lateral-diffusive)
    'mhflx': (('vtflx',), 'lat', _msc_mer('vtflx', _CP_SW / _GRAV)),
    'mhftd': (('vtfltd',), 'lat', _msc_mer('vtfltd', _CP_SW / _GRAV)),
    'mhfsm': (('vtflsm',), 'lat', _msc_mer('vtflsm', _CP_SW / _GRAV)),
    'mhfld': (('vtflld',), 'lat', _msc_mer('vtflld', _CP_SW / _GRAV)),
    'msflx': (('vsflx',), 'lat', _msc_mer('vsflx', 1e-3 / _GRAV)),
    'msftd': (('vsfltd',), 'lat', _msc_mer('vsfltd', 1e-3 / _GRAV)),
    'msfsm': (('vsflsm',), 'lat', _msc_mer('vsflsm', 1e-3 / _GRAV)),
    'msfld': (('vsflld',), 'lat', _msc_mer('vsflld', 1e-3 / _GRAV)),
    # total transports across latitude circles (the reference's zigzag
    # section masstr/heattr/salttr)
    'masstr': (('vflx',), 'lat', _msc_mer('vflx', 1. / _GRAV)),
    'heattr': (_HEAT, 'lat', _msc_mer_sum(_HEAT, _CP_SW / _GRAV)),
    'salttr': (_SALT, 'lat', _msc_mer_sum(_SALT, 1e-3 / _GRAV)),
    # global sums / averages
    'massgs': (('dp',), 'scalar', _msc_massgs),
    'volgs': (('dp',), 'scalar', _msc_volgs),
    'tempga': (('temp', 'dp'), 'scalar', _msc_colga('temp')),
    'salnga': (('saln', 'dp'), 'scalar', _msc_colga('saln')),
    'sstga': (('sst',), 'scalar', _msc_srfga('sst')),
    'sssga': (('sss',), 'scalar', _msc_srfga('sss')),
}


#: per-field accumulation operators (the ave/min/max/sq encoding of
#: mod_dia.F90's ACC_* tables; 'msc' marks an output-time derived id)
VALID_OPS = ('ave', 'min', 'max', 'sq', 'msc')


@dataclasses.dataclass
class DiaGroup:
    """One accumulation group (a GLB_FNAMETAG entry,
    mod_dia.F90:278-282): the count of accumulated steps (a 0-d tensor),
    {key: running tensor} on the state's device, and the (name, op)
    fields."""
    nacc: torch.Tensor
    acc: dict
    fields: tuple


def _acc_key(name: str, op: str) -> str:
    """Accumulator and output key: the reference's derived-id naming of
    the non-average ops (MLDL82MN/MX/SQ etc.), so that one group can
    hold several ops of one field."""
    return name + {'min': 'mn', 'max': 'mx', 'sq': 'sq'}.get(op, '') \
        if op in ('min', 'max', 'sq') else name


def _norm_fields(fields):
    """Accept 'name' or ('name', op) entries; default op 'ave'."""
    out = []
    for f in fields:
        if isinstance(f, str):
            out.append((f, 'ave'))
        else:
            name, op = f
            assert op in VALID_OPS, op
            out.append((name, op))
    return tuple(out)


def _fresh(v, op):
    """A reset accumulator shaped like v."""
    if op == 'min':
        return torch.full_like(v, torch.inf)
    if op == 'max':
        return torch.full_like(v, -torch.inf)
    return torch.zeros_like(v)


def init_group(grid: Grid, state: State, fields, dtype=torch.float64,
               forcing=None, dfl=None, si=None, swabs=None, tridx=None,
               cesm=None):
    """A zeroed group over `fields` ('name' or (name, op)); the base ids
    that the requested MSC ids read are added at 'ave'."""
    fields = _norm_fields(fields)
    have = {n for n, op in fields if op != 'msc'}
    extra = []
    for name, op in fields:
        if op != 'msc':
            continue
        for dep in MSC_REGISTRY[name][0]:
            if dep not in have:
                have.add(dep)
                extra.append((dep, 'ave'))
    fields = fields + tuple(extra)
    c = DiaCtx(grid, state, forcing, dfl, si, swabs, tridx, cesm, zw={})
    acc = {}
    for name, op in fields:
        if op == 'msc':
            continue
        proto = FIELD_REGISTRY[name][1](c, 0)
        acc[_acc_key(name, op)] = _fresh(proto, op)
    return DiaGroup(nacc=torch.zeros((), dtype=dtype,
                                     device=state.dp.device),
                    acc=acc, fields=fields)


def accumulate(grid: Grid, group: DiaGroup, s: State, n: int,
               forcing=None, dfl=None, si=None, swabs=None,
               tridx=None, cesm=None) -> DiaGroup:
    """Add time level n of the state to the running accumulators
    (diaacc, mod_dia.F90:1097-2200; the op semantics of the ACC_*
    encoding).  Returns a new group; nothing is read back to the host."""
    c = DiaCtx(grid, s, forcing, dfl, si, swabs, tridx, cesm, zw={})
    acc = dict(group.acc)
    for name, op in group.fields:
        if op == 'msc':
            continue
        v = FIELD_REGISTRY[name][1](c, n)
        key = _acc_key(name, op)
        if op == 'ave':
            acc[key] = acc[key] + v
        elif op == 'sq':
            acc[key] = acc[key] + v * v
        elif op == 'min':
            acc[key] = torch.minimum(acc[key], v)
        else:
            acc[key] = torch.maximum(acc[key], v)
    return DiaGroup(nacc=group.nacc + 1., acc=acc, fields=group.fields)


def reset(group: DiaGroup) -> DiaGroup:
    acc = {}
    for name, op in group.fields:
        if op == 'msc':
            continue
        key = _acc_key(name, op)
        acc[key] = _fresh(group.acc[key], op)
    return DiaGroup(nacc=torch.zeros_like(group.nacc), acc=acc,
                    fields=group.fields)


# ------------------------------------------------------------------ #
# multi-group configuration and alarms (GLB_* arrays and diaout_alarms,
# mod_dia.F90:278-282, 2200-2311)
# ------------------------------------------------------------------ #

@dataclasses.dataclass
class DiaGroupCfg:
    """Static config of one output group (one slot of the GLB_* arrays,
    mod_dia.F90:278-282)."""
    fnametag: str = 'hd'
    aveperio: int = 1      # >0: days per average; <0: -N averages/day
    filefreq: int = 30     # days of averages per file
    compflag: int = 0      # 1 = wet-point compressed output
    ncformat: int = 0      # 0 = classic NetCDF3
    fields: tuple = ()     # ('name' | (name, op), ...)

    def steps_per_output(self, nstep_in_day: int) -> int:
        if self.aveperio < 0:
            return max(1, nstep_in_day // (-self.aveperio))
        return max(1, self.aveperio * nstep_in_day)

    # GLB_AVEPERIO calendar codes (mod_rdlim.F90:1197-1203):
    # 30 -> calendar month, 360..366 -> calendar year
    @property
    def monthly(self) -> bool:
        return self.aveperio == 30

    @property
    def annual(self) -> bool:
        return 360 <= self.aveperio <= 366

    def alarm(self, clock, done_steps: int, nstep_in_day: int) -> bool:
        """diaout_alarms (mod_dia.F90:2290-2305): monthly and annual
        groups fire at a day boundary when the (already stepped) date
        has entered day 1 of a month / of the year; the others on their
        fixed step period."""
        at_day = done_steps % nstep_in_day == 0
        if self.annual:
            d = clock.date
            return at_day and d.month == 1 and d.day == 1
        if self.monthly:
            return at_day and clock.date.day == 1
        return done_steps % self.steps_per_output(nstep_in_day) == 0


_SUFFIX_OPS = {'mn': 'min', 'mx': 'max', 'sq': 'sq'}


def _nml_key_to_field(key: str) -> Optional[Tuple[str, str]]:
    """Map a DIAPHY namelist id (H2D_SST, LYR_TEMP, LVL_SALN, MSC_SSTGA,
    H2D_MLDL82MN, ...) to a (registry name, op) pair; None for ids with
    no counterpart."""
    key = key.lower()
    for pre in ('h2d_', 'lyr_', 'lvl_', 'msc_', 'acc_'):
        if key.startswith(pre):
            kind, name = pre[:-1], key[len(pre):]
            break
    else:
        return None
    op = 'ave'
    if name == 'maxbld':
        # ACC_MAXBLD accumulates the maximum by definition (mod_dia.F90)
        return ('maxbld', 'max')
    if kind == 'h2d' and name[-2:] in _SUFFIX_OPS \
            and name[:-2] in FIELD_REGISTRY:
        op = _SUFFIX_OPS[name[-2:]]
        name = name[:-2]
    if kind == 'lvl':
        name = name + 'lvl'
    if kind == 'msc':
        return (name, 'msc') if name in MSC_REGISTRY else None
    if name not in FIELD_REGISTRY:
        return None
    return name, op


def _aslist(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def load_diaphy(groups: dict) -> list:
    """Per-group configs from a parsed &DIAPHY namelist group (values
    are scalars or per-group lists, the GLB_* slot convention).  Ids
    with no counterpart are ignored (`unsupported_diaphy_keys` lists
    them)."""
    if 'DIAPHY' not in groups:
        return []
    g = {k.lower(): v for k, v in groups['DIAPHY'].items()}
    tags = _aslist(g.get('glb_fnametag', ['hd']))
    nphy = len(tags)

    def per_group(key, default):
        v = _aslist(g.get(key, [default] * nphy))
        return (v + [default] * nphy)[:nphy]

    ave = per_group('glb_aveperio', 1)
    ffq = per_group('glb_filefreq', 30)
    cmp_ = per_group('glb_compflag', 0)
    ncf = per_group('glb_ncformat', 0)

    fields = [[] for _ in range(nphy)]
    for key, val in g.items():
        if key.startswith('glb_'):
            continue
        mapped = _nml_key_to_field(key)
        if mapped is None:
            continue
        for i, flag in enumerate(_aslist(val)[:nphy]):
            if int(flag) != 0:
                fields[i].append(mapped)

    return [DiaGroupCfg(fnametag=str(tags[i]), aveperio=int(ave[i]),
                        filefreq=int(ffq[i]), compflag=int(cmp_[i]),
                        ncformat=int(ncf[i]), fields=tuple(fields[i]))
            for i in range(nphy)]


def unsupported_diaphy_keys(groups: dict) -> list:
    """DIAPHY ids of the deck that have no registry counterpart."""
    if 'DIAPHY' not in groups:
        return []
    return [key for key in groups['DIAPHY']
            if not key.lower().startswith('glb_')
            and _nml_key_to_field(key.lower()) is None]


def diafnm(runid: str, fnametag: str, time_days: float) -> str:
    """Diagnostic file name (diafnm, mod_dia.F90:352-446 simplified)."""
    return f'{runid}_{fnametag}_{time_days:010.3f}.nc'


def _means(group: DiaGroup):
    """(1 / nacc, [(key, op, dims, mean as numpy)]) of the group's
    non-derived fields; 'ave' and 'sq' divided by the count."""
    q = 1.0 / max(float(group.nacc), 1.0)
    out = []
    for name, op in _norm_fields(group.fields):
        if op == 'msc':
            continue
        key = _acc_key(name, op)
        mean = to_numpy(group.acc[key])
        if op in ('ave', 'sq'):
            mean = mean * q
        out.append((key, op, FIELD_REGISTRY[name][0], mean))
    return q, out


def write_netcdf(path: str, grid: Grid, group: DiaGroup, time_days: float,
                 fill_land=True, ncformat: int = 0):
    """Write the accumulated means to one NetCDF file (diaout,
    mod_dia.F90:2311-3300 / mod_nctools ncwrtr); ncformat 0 = NetCDF3
    classic, 1 = 64-bit offset (GLB_NCFORMAT's CDF/CDF2,
    mod_nctools.F90:93-218)."""
    from scipy.io import netcdf_file

    jdm, idm = grid.shape
    ipm = to_numpy(grid.ip) > 0
    q, means = _means(group)

    with netcdf_file(path, 'w', version=2 if ncformat else 1) as f:
        f.createDimension('time', None)
        f.createDimension('y', jdm)
        f.createDimension('x', idm)
        f.createDimension('sigma', grid.kk)
        f.createDimension('depth', len(DEPTHSLEV))

        tvar = f.createVariable('time', 'd', ('time',))
        tvar[0] = time_days
        tvar.units = 'days since 0001-01-01'

        dvar = f.createVariable('depth', 'd', ('depth',))
        dvar[:] = DEPTHSLEV
        dvar.units = 'm'

        lat = f.createVariable('plat', 'd', ('y', 'x'))
        lat[:] = to_numpy(grid.plat)
        lon = f.createVariable('plon', 'd', ('y', 'x'))
        lon[:] = to_numpy(grid.plon)

        ntr_made = False
        for name, op, dims, mean in means:
            if dims == 'scalar':
                v = f.createVariable(name, 'd', ('time',))
                v[0] = mean
                continue
            if dims == '2d':
                shape = ('time', 'y', 'x')
                mask = ipm
            elif dims == 'zlv':
                shape = ('time', 'depth', 'y', 'x')
                mask = ipm[None]
            elif dims in ('tr3d', 'trzlv'):
                if dims == 'trzlv' and mean.shape[0] == 0:
                    continue
                if not ntr_made:
                    f.createDimension('ntr', mean.shape[0])
                    ntr_made = True
                shape = ('time', 'ntr',
                         'sigma' if dims == 'tr3d' else 'depth', 'y', 'x')
                mask = ipm[None, None]
            else:
                shape = ('time', 'sigma', 'y', 'x')
                mask = ipm[None]
            v = f.createVariable(name, 'f', shape)
            out = mean.astype('f4')
            if fill_land:
                out = np.where(mask, out, np.float32(-1e33))
            v[0] = out
            v._FillValue = np.float32(-1e33)

        # ---- MSC_* derived diagnostics (diamer, mod_dia.F90:4150-4340):
        # overturning streamfunctions, meridional transports and global
        # means, from the accumulated means at output time over 1-degree
        # latitude bins.  Without MSC ids, the mmflxl/mhflx/msflx trio
        # whenever vflx was accumulated.
        fields = _norm_fields(group.fields)
        names = {n for n, _ in fields}
        msc = [n for n, op in fields if op == 'msc']
        if not msc and 'vflx' in names:
            msc = [n for n in ('mmflxl', 'mhflx', 'msflx')
                   if all(d in names for d in MSC_REGISTRY[n][0])]
        if not msc:
            return
        lats = np.arange(-89.5, 90., 1.)
        wlat = lat_bin_weights(grid.plat, lats)
        dmeans = {n: a * q for n, a in group.acc.items()}
        dimmed = set()

        def need(dim, size):
            if dim not in dimmed:
                f.createDimension(dim, size)
                dimmed.add(dim)
                if dim == 'lat':
                    lv = f.createVariable('lat', 'd', ('lat',))
                    lv[:] = lats
                    lv.units = 'degrees_north'

        for n in msc:
            deps, tag, derive = MSC_REGISTRY[n]
            out = to_numpy(derive(dmeans, grid, wlat))
            if tag == 'scalar':
                v = f.createVariable(n, 'd', ('time',))
                v[0] = out
                continue
            need('lat', len(lats))
            if tag == 'latsig1':
                need('sigma1', grid.kk + 1)
                v = f.createVariable(n, 'f', ('time', 'lat', 'sigma1'))
            elif tag == 'latdep1':
                need('depth1', len(DEPTHSLEV) + 1)
                v = f.createVariable(n, 'f', ('time', 'lat', 'depth1'))
            else:
                v = f.createVariable(n, 'f', ('time', 'lat'))
            v[0] = out.astype('f4')


def write_netcdf_compressed(path: str, grid: Grid, group: DiaGroup,
                            time_days: float):
    """Compressed (ocean points only) output: each field packed into a
    1-D 'pcomp' dimension of the wet points, the index map saved once
    (the compressed path of mod_nctools ncdimc/ncpack/nccomp,
    mod_nctools.F90:140-2539).  The MSC ids are not point fields and go
    to the uncompressed writer only."""
    from scipy.io import netcdf_file

    ipm = to_numpy(grid.ip) > 0
    idx = np.flatnonzero(ipm.ravel()).astype('i4')
    _, means = _means(group)

    with netcdf_file(path, 'w') as f:
        f.createDimension('time', None)
        f.createDimension('pcomp', idx.size)
        f.createDimension('sigma', grid.kk)
        f.createDimension('depth', len(DEPTHSLEV))

        tvar = f.createVariable('time', 'd', ('time',))
        tvar[0] = time_days
        pvar = f.createVariable('pcomp', 'i', ('pcomp',))
        pvar[:] = idx
        pvar.compress = 'y x'

        for name, op, dims, mean in means:
            if dims == 'scalar':
                v = f.createVariable(name, 'd', ('time',))
                v[0] = mean
            elif dims == '2d':
                v = f.createVariable(name, 'f', ('time', 'pcomp'))
                v[0] = mean.ravel()[idx].astype('f4')
            elif dims in ('tr3d', 'trzlv'):
                if dims == 'trzlv' and mean.shape[0] == 0:
                    continue
                dim = 'ntrsig' if dims == 'tr3d' else 'ntrdep'
                flat = mean.reshape(mean.shape[0] * mean.shape[1],
                                    -1)[:, idx]
                if dim not in f.dimensions:
                    f.createDimension(dim, flat.shape[0])
                v = f.createVariable(name, 'f', ('time', dim, 'pcomp'))
                v[0] = flat.astype('f4')
            else:
                zdim = 'depth' if dims == 'zlv' else 'sigma'
                v = f.createVariable(name, 'f', ('time', zdim, 'pcomp'))
                v[0] = mean.reshape(mean.shape[0], -1)[:, idx].astype('f4')
