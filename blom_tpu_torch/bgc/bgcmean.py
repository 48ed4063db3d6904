"""BGC diagnostic accumulation and output (bgcmean).

Counterpart of `blom_tpu/bgc/bgcmean.py` (iHAMOCC's diagnostics,
hamocc/mo_bgcmean.F90: output groups with their own frequencies;
srf/lyr/lvl field classes accumulated by accsrf/acclyr/acclvl with
layer-thickness weights :1965-2095, finished by finsrf/finlyr
:2164-2228, written by wrtsrf/wrtlyr/wrtlvl :2232-2405).

Field sources:
- 'trc'  — a BGC tracer of the state's tracer block (per-mass units;
  layer fields, dz-weighted as acclyr weights them);
- 'diag' — a per-step diagnostic of hamocc_step's dict (surface fluxes
  and vertically integrated rates are 2-D 'srf'; omegaC, omegaA and co3
  are 3-D layer fields), which `blom_step` hands out through its
  `bgc_diag_out` hook;
- 'lvl'  — the z-level remap of a 3-D source (acclvl, with the depth
  table of io/merdia.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.constants import onem
from ..core.state import cumulative_p
from ..io.checksum import to_numpy
from ..io.merdia import DEPTHSLEV, to_zlev_w, zlev_weights
from .params import BgcTracers as T

#: name -> (kind, source) where kind in {'srf', 'lyr', 'lvl'} and source
#: is ('trc', tracer attribute) or ('diag', key)
FIELD_REGISTRY: Dict[str, Tuple[str, tuple]] = {
    # surface / integrated fluxes (jco2flux... ids, mo_bgcmean.F90:371+)
    'co2flux': ('srf', ('diag', 'co2flux')),
    'oxflux': ('srf', ('diag', 'oxflux')),
    'niflux': ('srf', ('diag', 'niflux')),
    'n2oflux': ('srf', ('diag', 'n2oflux')),
    'dmsflux': ('srf', ('diag', 'dmsflux')),
    'pco2': ('srf', ('diag', 'pco2')),
    'intphosy': ('srf', ('diag', 'intphosy')),
    'intdnit': ('srf', ('diag', 'intdnit')),
    'intnfix': ('srf', ('diag', 'intnfix')),
    'expoor': ('srf', ('diag', 'expoor')),
    'expoca': ('srf', ('diag', 'expoca')),
    'exposi': ('srf', ('diag', 'exposi')),
    'carflx_bot': ('srf', ('diag', 'carflx_bot')),
    'calflx_bot': ('srf', ('diag', 'calflx_bot')),
    'bsiflx_bot': ('srf', ('diag', 'bsiflx_bot')),
    # 3-D carbonate system diagnostics
    'omegac': ('lyr', ('diag', 'omegaC')),
    'omegaa': ('lyr', ('diag', 'omegaA')),
    'co3': ('lyr', ('diag', 'co3')),
}

#: tracer concentration fields (LYR_/LVL_ per-tracer ids)
for _nm in ('sco212', 'alkali', 'phosph', 'oxygen', 'ano3', 'silica',
            'iron', 'phy', 'zoo', 'det', 'doc', 'calc', 'opal',
            'an2o', 'dms', 'hi'):
    FIELD_REGISTRY[_nm] = ('lyr', ('trc', _nm))
    FIELD_REGISTRY[_nm + 'lvl'] = ('lvl', ('trc', _nm))
for _nm, _key in (('omegac', 'omegaC'), ('omegaa', 'omegaA'),
                  ('co3', 'co3')):
    FIELD_REGISTRY[_nm + 'lvl'] = ('lvl', ('diag', _key))
del _nm, _key

DEFAULT_SRF = ('co2flux', 'pco2', 'dmsflux', 'oxflux', 'intphosy',
               'expoor', 'expoca', 'exposi', 'carflx_bot')
DEFAULT_LYR = ('sco212', 'alkali', 'phosph', 'oxygen', 'ano3', 'silica',
               'phy', 'det', 'doc', 'omegac', 'co3')
DEFAULT_FIELDS = DEFAULT_SRF + DEFAULT_LYR


@dataclasses.dataclass
class BgcmGroup:
    """One bgcmean accumulation group (a slot of the GLB_* arrays,
    mo_bgcmean.F90:93-130)."""
    nacc: torch.Tensor
    acc: dict                    # name -> running sum (dz-weighted for lyr)
    wgt: dict                    # name -> accumulated dz weights (lyr only)
    fields: tuple


def _tracer_index(name, ti):
    if ti is not None and hasattr(ti, name):
        return getattr(ti, name)
    return getattr(T, name)


def _extract(s, n, itrbgc, ti, diags, name, zw):
    """The field `name` at time level n (None when its diagnostic is not
    in `diags`) and its kind; `zw` caches the z-level weights."""
    kind, (src, key) = FIELD_REGISTRY[name]
    if src == 'trc':
        fld = s.trc[n, itrbgc + _tracer_index(key, ti)]
    else:
        fld = diags.get(key)
        if fld is None:
            return None, kind
    if kind == 'lvl':
        if not zw:
            zw.append(zlev_weights(cumulative_p(s.dp[n])))
        fld = to_zlev_w(fld, *zw[0])
    return fld, kind


def init_bgcm(grid, s, itrbgc: int, fields=DEFAULT_FIELDS, ti=None,
              dtype=torch.float64) -> BgcmGroup:
    """Zeroed accumulators on the state's device (inisrf/inilyr/inilvl,
    mo_bgcmean.F90:1809-1899)."""
    dev = s.dp.device
    acc, wgt = {}, {}
    for name in fields:
        kind = FIELD_REGISTRY[name][0]
        if kind == 'srf':
            shape = tuple(grid.shape)
        elif kind == 'lyr':
            shape = (grid.kk,) + tuple(grid.shape)
            wgt[name] = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            shape = (len(DEPTHSLEV),) + tuple(grid.shape)
        acc[name] = torch.zeros(shape, dtype=dtype, device=dev)
    return BgcmGroup(nacc=torch.zeros((), dtype=dtype, device=dev),
                     acc=acc, wgt=wgt, fields=tuple(fields))


def acc_bgcm(group: BgcmGroup, grid, s, n: int, itrbgc: int, diags,
             ti=None) -> BgcmGroup:
    """Accumulate one step (accsrf/acclyr/acclvl,
    mo_bgcmean.F90:1965-2095); layer fields dz-weighted (acclyr's
    wghtsflg=1 path), so that their averages are thickness means."""
    acc = dict(group.acc)
    wgt = dict(group.wgt)
    dz = s.dp[n] / onem * grid.ip
    zw = []
    for name in group.fields:
        fld, kind = _extract(s, n, itrbgc, ti, diags, name, zw)
        if fld is None:
            continue
        if kind == 'lyr':
            acc[name] = acc[name] + fld * dz
            wgt[name] = wgt[name] + dz
        else:
            acc[name] = acc[name] + fld
    return BgcmGroup(nacc=group.nacc + 1., acc=acc, wgt=wgt,
                     fields=group.fields)


def finalize_bgcm(group: BgcmGroup):
    """The averages (finsrf/finlyr, mo_bgcmean.F90:2164-2228): srf and
    lvl divided by nacc, lyr by their accumulated weights."""
    nacc = torch.clamp_min(group.nacc, 1.)
    out = {}
    for name in group.fields:
        a = group.acc[name]
        if FIELD_REGISTRY[name][0] == 'lyr':
            out[name] = a / torch.clamp_min(group.wgt[name], 1e-30)
        else:
            out[name] = a / nacc
    return out


def reset_bgcm(group: BgcmGroup) -> BgcmGroup:
    return BgcmGroup(
        nacc=torch.zeros_like(group.nacc),
        acc={k: torch.zeros_like(v) for k, v in group.acc.items()},
        wgt={k: torch.zeros_like(v) for k, v in group.wgt.items()},
        fields=group.fields)


def write_bgcm(path: str, grid, group: BgcmGroup, time_days: float):
    """NetCDF3-classic output (wrtsrf/wrtlyr/wrtlvl,
    mo_bgcmean.F90:2232-2405)."""
    from scipy.io import netcdf_file

    means = finalize_bgcm(group)
    jdm, idm = grid.shape
    ipm = to_numpy(grid.ip) > 0

    with netcdf_file(path, 'w') as f:
        f.createDimension('time', None)
        f.createDimension('y', jdm)
        f.createDimension('x', idm)
        f.createDimension('sigma', grid.kk)
        f.createDimension('depth', len(DEPTHSLEV))
        tvar = f.createVariable('time', 'd', ('time',))
        tvar[0] = time_days
        dvar = f.createVariable('depth', 'd', ('depth',))
        dvar[:] = DEPTHSLEV

        for name in group.fields:
            kind = FIELD_REGISTRY[name][0]
            a = to_numpy(means[name]).astype('f4')
            dims = {'srf': ('time', 'y', 'x'),
                    'lyr': ('time', 'sigma', 'y', 'x'),
                    'lvl': ('time', 'depth', 'y', 'x')}[kind]
            v = f.createVariable(name, 'f', dims)
            v[0] = np.where(ipm if kind == 'srf' else ipm[None], a,
                            np.float32(-1e33))
            v._FillValue = np.float32(-1e33)
