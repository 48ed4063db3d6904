"""Namelist-driven case builder.

Counterpart of `build_case` in `blom_tpu/drivers/case.py`: a BLOM
`limits` deck (rdlim, mod_rdlim.F90:137-250) builds a runnable
experiment, with the deck's momentum, barotropic, advection and ALE
reconstruction options applied in blom_tpu's order, for every expcnf of
blom_tpu's dispatch (fuk95, channel, single_column, noforcing, and the
grid-file ben02clim, ben02syn and cesm).  `run_case` is blom_tpu's run loop (the
standalone main program, drivers/nocoupler/blom.F:20-67): diagnostic
groups with their output alarms, rotating restarts, the final checksum
and run.status."""

from __future__ import annotations

import math
import os

import torch

from ..core import config as cfg_mod
from ..core.config import RunConfig
from ..dynamics.barotp import BarotpParams
from ..dynamics.momtum import MomtumParams
from . import standalone

_DTYPES = {'float64': torch.float64, 'float32': torch.float32}


def build_case(limits_path: str = None, cfg: RunConfig = None,
               device=None):
    """Build a Model from a BLOM `limits` deck, or from `cfg` when given
    (the expcnf dispatch of mod_inigeo/mod_inifrc).  Returns (model,
    cfg).  Runs on the card unless `device` names another; without CUDA
    and without `device` it raises."""
    if cfg is None:
        cfg = cfg_mod.load_limits(limits_path)
    if cfg.dtype not in _DTYPES:
        raise ValueError(f'dtype {cfg.dtype!r}: expected one of '
                         f'{tuple(_DTYPES)}')
    dtype = _DTYPES[cfg.dtype]

    if cfg.expcnf == 'fuk95':
        model = standalone.build_fuk95(dtype=dtype, device=device,
                                       vcoord=cfg.vcoord.vcoord_type)
    elif cfg.expcnf == 'channel':
        model = standalone.build_channel(dtype=dtype, baclin=cfg.baclin,
                                         batrop=cfg.batrop, device=device)
    elif cfg.expcnf in ('single_column', 'noforcing'):
        # blom_tpu builds the single column for noforcing too
        model = standalone.build_single_column(
            dtype=dtype, baclin=cfg.baclin, batrop=cfg.batrop,
            device=device)
    elif cfg.expcnf in ('ben02clim', 'ben02syn', 'cesm'):
        # production grid-file configurations (mod_rdlim.F90 GRFILE/
        # ICFILE; mod_inigeo + mod_inicon dispatch); as in blom_tpu, no
        # arctic fold is passed on: the grid is closed in j
        if not cfg.grfile:
            raise ValueError(
                f'expcnf {cfg.expcnf!r} requires GRFILE in the deck')
        model = standalone.build_gridfile(
            cfg.grfile, kdm=cfg.kdm, baclin=cfg.baclin,
            batrop=cfg.batrop, expcnf=cfg.expcnf,
            icfile=cfg.icfile or None, dtype=dtype, pref=cfg.pref,
            cwmod=cfg.cwmod, idate=cfg.idate, idate0=cfg.idate0,
            device=device)
    else:
        raise ValueError(f'unsupported expcnf {cfg.expcnf!r}')

    model.par = model.par._replace(
        momtum=MomtumParams(
            mdv2hi=cfg.mdv2hi, mdv2lo=cfg.mdv2lo, mdv4hi=cfg.mdv4hi,
            mdv4lo=cfg.mdv4lo, vsc2hi=cfg.vsc2hi, vsc2lo=cfg.vsc2lo,
            vsc4hi=cfg.vsc4hi, vsc4lo=cfg.vsc4lo, cbar=cfg.cbar,
            cb=cfg.cb, mommth=cfg.mommth),
        barotp=BarotpParams(cwbdts=cfg.cwbdts, cwbdls=cfg.cwbdls,
                            mommth=cfg.mommth),
        pgfmth=cfg.pgfmth,
        advmth=cfg.advmth,
        cppm_compatibility=cfg.cppm_compatibility,
        cppm_limiting=cfg.cppm_limiting)
    if model.par.ale is not None:
        # &ALE_REGRID_REMAP reconstruction options
        # (mod_ale_regrid_remap.F90:62-81)
        model.par = model.par._replace(ale=model.par.ale._replace(
            reconstruction_method=cfg.ale.reconstruction_method,
            upper_bndr_ord=cfg.ale.upper_bndr_ord,
            lower_bndr_ord=cfg.ale.lower_bndr_ord,
            tracer_limiting=cfg.ale.tracer_limiting,
            velocity_limiting=cfg.ale.velocity_limiting,
            tracer_pc_upper=cfg.ale.tracer_pc_upper_bndr,
            velocity_pc_upper=cfg.ale.velocity_pc_upper_bndr))
    return model, cfg


def run_case(model, cfg: RunConfig, rundir: str = '.',
             dia_fields=('sst', 'sss', 'sealv', 'temp', 'saln'),
             nsteps: int = None):
    """Integrate nday2 - nday1 days (or `nsteps` steps) in chunks:
    accumulate and write the diagnostics of the deck's &DIAPHY groups
    (or of one default group over `dia_fields`, and of a bgcmean group
    when the BGC runs), check every step with chkvar, print the budget
    deltas under cnsvdi, write rotating restarts every rstfrq days and at
    the end, and write run.status (blom.F:56-64).  Returns (state,
    clock, crc), crc the final dp checksum."""
    from ..bgc import bgcmean as bgcm_mod
    from ..dynamics import chkvar as chk_mod
    from ..dynamics.budget import BudgetSums, budget_deltas
    from ..io import checksum as cks
    from ..io import dia as dia_mod
    from ..io import restart as rst

    clock = model.clock
    nspd = clock.nstep_in_day
    if nsteps is None:
        nsteps = (cfg.nday2 - cfg.nday1) * nspd

    # diagnostic groups: the deck's &DIAPHY (GLB_* arrays,
    # mod_dia.F90:278-344) or one default group over `dia_fields`
    gcfgs = list(cfg.dia_groups)
    if not gcfgs:
        gcfgs = [dia_mod.DiaGroupCfg(
            fnametag='hd', aveperio=max(1, cfg.nday2 - cfg.nday1),
            fields=tuple(dia_fields))]
    groups = tuple(
        dia_mod.init_group(model.grid, model.state, gc.fields,
                           forcing=model.forcing, dfl=model.dfl)
        for gc in gcfgs)

    # the BGC output group (mo_bgcmean.F90), on the same alarms with the
    # 'bgcm' file tag
    if model.par.itrbgc >= 0:
        groups = groups + (bgcm_mod.init_bgcm(
            model.grid, model.state, model.par.itrbgc,
            ti=model.par.bgc_ti),)
        gcfgs.append(dia_mod.DiaGroupCfg(
            fnametag='bgcm', aveperio=max(1, cfg.nday2 - cfg.nday1)))

    # calendar-month and -year groups (GLB_AVEPERIO 30 and 360..366,
    # mod_rdlim.F90:1197-1203) fire at day boundaries; the chunk divides
    # every output period so that alarms fire on chunk boundaries
    # (diaout_alarms, mod_dia.F90:2200-2311)
    periods = [nspd if (gc.monthly or gc.annual)
               else gc.steps_per_output(nspd) for gc in gcfgs]
    chunk = nspd
    for p in periods:
        chunk = math.gcd(chunk, p)

    s = model.state
    done = 0
    while done < nsteps:
        n = min(chunk, nsteps - done)
        s, clock, extras = standalone.run(model, n, dia_group=groups,
                                          cnsvdi=cfg.cnsvdi, chk=True)
        groups = extras['dia_group']
        model.state = s
        model.clock = clock
        ok = extras['ok'].cpu().numpy()
        if not ok.all():
            bad_step = int(ok.argmin())
            nstep_abs = clock.nstep - n + bad_step + 1
            lev = 1 - (nstep_abs - 1) % 2
            chk_mod.chkvar_host(model.grid, s, lev, nstep=nstep_abs)
        if cfg.cnsvdi:
            b = extras['budgets']   # (steps of the chunk, checkpoints)
            first = BudgetSums(*(a[0, 0] for a in b))
            last = BudgetSums(*(a[-1, -1] for a in b))
            print(f'budget deltas over steps {done + 1}..{done + n}: '
                  f'{budget_deltas(first, last)}')
        done += n
        # per-group output alarms (diaout, mod_dia.F90:2311-3300; the
        # BGC group by bgcmean, mo_bgcmean.F90:2232-2405)
        groups = list(groups)
        for gi, gc in enumerate(gcfgs):
            if not (gc.alarm(clock, done, nspd) or done == nsteps):
                continue
            path = os.path.join(rundir, dia_mod.diafnm(
                cfg.runid, gc.fnametag, clock.time))
            g = groups[gi]
            if isinstance(g, bgcm_mod.BgcmGroup):
                bgcm_mod.write_bgcm(path, model.grid, g, clock.time)
                groups[gi] = bgcm_mod.reset_bgcm(g)
                continue
            if gc.compflag:
                dia_mod.write_netcdf_compressed(path, model.grid, g,
                                                clock.time)
            else:
                dia_mod.write_netcdf(path, model.grid, g, clock.time,
                                     ncformat=gc.ncformat)
            groups[gi] = dia_mod.reset(g)
        groups = tuple(groups)
        # restart alarm (rstfrq days; mod_restart.F90:1143-1200)
        if cfg.rstfrq > 0 and done % (cfg.rstfrq * nspd) == 0:
            rst.restart_write_rotating(rundir, cfg.runid, s, clock)

    rst.restart_write_rotating(rundir, cfg.runid, s, clock)

    # the final global dp checksum and run.status (blom.F:56-64)
    crc = cks.field_crc(s.dp)
    with open(os.path.join(rundir, 'run.status'), 'w') as f:
        f.write('success\n')
    return s, clock, crc
