"""Standalone model driver.

Counterpart of `build_fuk95`, `build_channel`, `build_gridfile`,
`build_single_column`, `build_tripolar` and `run` in
`blom_tpu/drivers/standalone.py` (BLOM's drivers/nocoupler/blom.F:20-67):
build the fuk95, the channel, a grid-file, the single-column or the
synthetic tripolar configuration, initialize it and integrate the step
loop.  Runs on the card unless the caller passes another device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..bgc.ciso import CisoParams
from ..bgc.params import NBGC, BgcParams, make_tracer_index
from ..bgc.step import BgcForcing, init_bgc_tracers, zero_bgc_forcing
from ..core import eos, init, modeltime
from ..core.grid import Grid
from ..core.state import State
from ..dynamics import cppm as cppm_mod
from ..dynamics.ale import make_ale_params
from ..dynamics.barotp import BarotpParams
from ..dynamics.diffusion_fields import DiffusionFields, zero_diffusion_fields
from ..dynamics.momtum import MomtumParams
from ..dynamics.step import StepParams, blom_step
from ..phys.forcing import Forcing, zero_forcing
from ..phys.swabs import SwabsFields, init_swabs


@dataclasses.dataclass
class Model:
    grid: Grid
    e: eos.EosParams
    par: StepParams
    coeffs_i: cppm_mod.CppmCoeffs
    coeffs_j: cppm_mod.CppmCoeffs
    clock: modeltime.ModelTime
    state: State
    forcing: Forcing
    dfl: DiffusionFields
    swabs: SwabsFields
    bgc_forcing: Optional[BgcForcing] = None


def _device(device):
    """The device an entry point builds on: CUDA unless the caller names
    one; without CUDA that is an error, not a fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the '
                'plain PyTorch path on the CPU')
        device = 'cuda'
    return device


def _assemble(grid, e, par, clock, state, forcing, dtype, device,
              bgc_forcing=None) -> Model:
    """The model around a configuration's grid, state and forcing: the
    CPPM coefficients of both sweep axes, zero diffusion fields and
    Jerlov type-3 shortwave absorption."""
    kdm = grid.kk
    ip_np = grid.ip.cpu().double().numpy()
    coeffs_i = cppm_mod.init_cppm_coeffs(
        ip_np, grid.scpx.cpu().double().numpy(), axis=-1,
        periodic=grid.periodic_i, dtype=dtype, device=device)
    coeffs_j = cppm_mod.init_cppm_coeffs(
        ip_np, grid.scpy.cpu().double().numpy(), axis=-2,
        periodic=grid.periodic_j, dtype=dtype, device=device,
        arctic=grid.arctic)
    dfl = zero_diffusion_fields(kdm, grid.shape, dtype, device)
    swabs = init_swabs(grid.shape, 'jerlov', 3, dtype, device)
    return Model(grid=grid, e=e, par=par, coeffs_i=coeffs_i,
                 coeffs_j=coeffs_j, clock=clock, state=state,
                 forcing=forcing, dfl=dfl, swabs=swabs,
                 bgc_forcing=bgc_forcing)


def build_fuk95(dtype=torch.float64, itdm=None, jtdm=None, kdm=None,
                device=None, vcoord='cntiso_hybrid', use_idlage=False,
                use_bgc=False, use_ciso=False) -> Model:
    """Assemble the fuk95 experiment (tests/fuk95/limits deck values).

    Matches blom_tpu's build_fuk95 field for field.
    With the default vertical coordinate: the ALE regrid/remap
    (`make_ale_params(kdm)`), the CVMix-lite vertical mixing
    (`VmixParams()`), the lateral diffusivity estimate (`DifestParams()`)
    and Jerlov type-3 shortwave absorption;
    ``par._replace(ale=None, vmix=None, difest=None)`` gives the
    adiabatic dynamical core.  With ``vcoord='isopyc_bulkml'``: the
    isopycnic initial state (a 5 m mixed layer over isopycnic layers,
    many of them massless), ``vcoord_isopyc=True`` and no ALE.
    `use_idlage` adds the ideal-age tracer (trc slot 0), `use_bgc` the
    19 tracers of the base BGC chain after it, initialized as blom_tpu
    initializes them, with uniform BGC surface forcing
    (`model.bgc_forcing`); with `use_ciso` also the 12 carbon-isotope
    tracers after them (NOINYOCISO: `par.bgc_ti` the extended tracer
    index, `par.bgc_cp` the isotope parameters).  `device` defaults to
    CUDA and raises when CUDA is missing."""
    from ..configs import fuk95 as cfg

    device = _device(device)
    itdm = itdm or cfg.ITDM
    jtdm = jtdm or cfg.JTDM
    kdm = kdm or cfg.KDM

    baclin, batrop = 180., 6.
    clock = modeltime.init_timevars('fuk95', baclin, batrop,
                                    20000101, 20000101)
    grid = cfg.make_grid(baclin, itdm, jtdm, kdm, dtype=dtype, device=device)
    e = eos.init_eos(pref=0., expcnf='fuk95')

    isopyc = vcoord == 'isopyc_bulkml'
    profiles = (cfg.initial_profiles_isopyc if isopyc
                else cfg.initial_profiles)
    z, sigma, saln, sigmar, phi = profiles(itdm, jtdm, kdm)
    # temperature from the analytic profile, in f64 on the host
    temp = eos.tofsig(e, torch.from_numpy(sigma),
                      torch.from_numpy(saln)).numpy()
    niag = 1 if use_idlage else 0
    itrbgc = niag if use_bgc else -1
    bgc_ti = bgc_cp = None
    if use_bgc and use_ciso:
        bgc_ti = make_tracer_index(use_ciso=True)
        bgc_cp = CisoParams()
        ntr = niag + bgc_ti.ntotal
    else:
        ntr = niag + (NBGC if use_bgc else 0)
    state = init.init_state(grid, e, phi=phi, temp=temp, saln=saln,
                            sigmar=sigmar, dtype=dtype, ntr=ntr)

    par = StepParams(
        baclin=baclin, lstep=clock.lstep, dlt=clock.dlt,
        momtum=MomtumParams(vsc2hi=.2, vsc2lo=.2, cbar=.05, cb=.002,
                            mommth='enscon'),
        barotp=BarotpParams(cwbdts=0., cwbdls=25., mommth='enscon'),
        pgfmth='dynamic enthalpy', vcoord_isopyc=isopyc,
        ale=None if isopyc else make_ale_params(kdm),
        itriag=0 if use_idlage else -1, itrbgc=itrbgc,
        bgc=BgcParams() if use_bgc else None, bgc_ti=bgc_ti,
        bgc_cp=bgc_cp)
    forcing = zero_forcing(kdm, grid.shape, dtype, device)
    bgc_forcing = None
    if use_bgc:
        state = init_bgc_tracers(state, itrbgc, e, ti=bgc_ti, cp=bgc_cp)
        bgc_forcing = zero_bgc_forcing(grid.shape, dtype, device)
    return _assemble(grid, e, par, clock, state, forcing, dtype, device,
                     bgc_forcing)


def build_channel(dtype=torch.float64, itdm=None, jtdm=None, kdm=None,
                  ztx0=-.05, baclin=300., batrop=10., device=None,
                  use_idlage=False) -> Model:
    """Assemble the channel experiment (channel/mod_channel.F90), as
    blom_tpu's build_channel does: the 208x512x30 grid of
    `configs/channel.py` (read when called), the ALE regrid/remap, the
    vertical mixing and lateral diffusivity defaults, coastal
    wave-breaking damping, and a constant zonal wind stress `ztx0`
    masked at u and v points.  `use_idlage` adds the ideal-age tracer
    (trc slot 0), as blom_tpu's build_gridfile does.  `device` defaults
    to CUDA and raises when CUDA is missing."""
    from ..configs import channel as cfg

    device = _device(device)
    itdm = itdm or cfg.ITDM
    jtdm = jtdm or cfg.JTDM
    kdm = kdm or cfg.KDM

    clock = modeltime.init_timevars('channel', baclin, batrop,
                                    20000101, 20000101)
    grid = cfg.make_grid(baclin, itdm, jtdm, kdm, dtype=dtype, device=device)
    e = eos.init_eos(pref=0., expcnf='channel')

    z, sigmar, saln, phi = cfg.initial_profiles(grid, itdm, jtdm, kdm)
    temp = eos.tofsig(e, torch.from_numpy(sigmar),
                      torch.from_numpy(saln)).numpy()
    state = init.init_state(grid, e, phi=phi, temp=temp, saln=saln,
                            sigmar=sigmar, dtype=dtype,
                            ntr=1 if use_idlage else 0)

    par = StepParams(
        baclin=baclin, lstep=clock.lstep, dlt=clock.dlt,
        momtum=MomtumParams(vsc2hi=.2, vsc2lo=.2, cbar=.05, cb=.002,
                            mommth='enscon'),
        barotp=BarotpParams(cwbdts=5.e-5, cwbdls=25., mommth='enscon'),
        pgfmth='dynamic enthalpy', vcoord_isopyc=False,
        ale=make_ale_params(kdm), itriag=0 if use_idlage else -1)

    forcing = zero_forcing(kdm, grid.shape, dtype, device)
    taux, tauy = cfg.wind_stress(grid.shape, ztx0)
    forcing = dataclasses.replace(
        forcing,
        taux=torch.as_tensor(taux, dtype=dtype, device=device) * grid.iu,
        tauy=torch.as_tensor(tauy, dtype=dtype, device=device) * grid.iv)
    return _assemble(grid, e, par, clock, state, forcing, dtype, device)


def build_gridfile(grfile: str, kdm: int, baclin: float,
                   batrop: float, expcnf: str = 'ben02clim',
                   icfile: str = None, dtype=torch.float64,
                   pref: float = 2000.e4, cwmod=(), arctic: bool = False,
                   idate: int = 20000101, idate0: int = None,
                   use_idlage: bool = False, device=None) -> Model:
    """The grid-file experiment, as blom_tpu's build_gridfile builds it:
    the expcnf dispatch branch of the production configurations
    (ben02clim, ben02syn and cesm on tnx*-class grids; mod_inigeo and
    mod_inicon, mod_rdlim.F90:137-250).

    grfile: a BLOM-convention grid NetCDF or .npz (core/geoenv.py);
    icfile: an optional WOA-style z-level T/S climatology with variables
    t_an/s_an (k, j, i on the model grid) and depth_bnds (k, 2); without
    it a horizontally uniform, stably stratified profile.  Forcing starts
    at zero: the coupled cap supplies it per step (drivers/coupled.py).
    `device` defaults to CUDA and raises when CUDA is missing."""
    from ..core.geoenv import geoenv_file
    from ..core.inicon import inicon_woa

    device = _device(device)
    clock = modeltime.init_timevars(expcnf, baclin, batrop,
                                    idate, idate0 or idate)
    grid = geoenv_file(grfile, kk=kdm, baclin=baclin, periodic_i=True,
                       arctic=arctic, dtype=dtype, cwmod=cwmod,
                       device=device)
    e = eos.init_eos(pref=pref, expcnf=expcnf)

    jj, ii = grid.shape
    if icfile is not None:
        from scipy.io import netcdf_file
        with netcdf_file(icfile, 'r', mmap=False) as nc:
            t_src = np.array(nc.variables['t_an'][:], np.float64)
            s_src = np.array(nc.variables['s_an'][:], np.float64)
            bnds = np.array(nc.variables['depth_bnds'][:], np.float64)
        if t_src.ndim == 4:
            t_src, s_src = t_src[0], s_src[0]
    else:
        zc, bnds, t_prof, s_prof = fallback_profile()
        t_src = np.broadcast_to(t_prof[:, None, None],
                                (len(zc), jj, ii)).copy()
        s_src = np.broadcast_to(s_prof[:, None, None],
                                (len(zc), jj, ii)).copy()
    temp, saln, sigmar, phi = inicon_woa(grid, e, t_src, s_src, bnds)

    state = init.init_state(grid, e, phi=phi, temp=temp, saln=saln,
                            sigmar=sigmar, dtype=dtype,
                            ntr=1 if use_idlage else 0)
    par = StepParams(
        baclin=baclin, lstep=clock.lstep, dlt=clock.dlt,
        momtum=MomtumParams(vsc2hi=.2, vsc2lo=.2, cbar=.05, cb=.002,
                            mommth='enscon'),
        barotp=BarotpParams(cwbdts=5.e-5, cwbdls=25., mommth='enscon'),
        pgfmth='dynamic enthalpy', vcoord_isopyc=False,
        ale=make_ale_params(kdm), itriag=0 if use_idlage else -1)
    forcing = zero_forcing(kdm, grid.shape, dtype, device)
    return _assemble(grid, e, par, clock, state, forcing, dtype, device)


def fallback_profile(zc=None):
    """build_gridfile's profile where no icfile is given: numpy (zc,
    depth_bnds, T, S) at the level centres `zc` [m] (blom_tpu's 30 levels
    from 25 to 4000 m by default), a thermocline of 700 m and a
    halocline of 1000 m e-folding depth."""
    if zc is None:
        zc = np.linspace(25., 4000., 30)
    dz = np.gradient(zc)
    bnds = np.stack([zc - .5 * dz, zc + .5 * dz], 1)
    return (zc, bnds, 2. + 18. * np.exp(-zc / 700.),
            34.2 + .8 * (1. - np.exp(-zc / 1000.)))


def build_single_column(dtype=torch.float64, kdm=None, baclin=1800.,
                        batrop=60., device=None) -> Model:
    """The single-column experiment (single_column/
    mod_single_column.F90), as blom_tpu's build_single_column builds it:
    a 1x1 grid periodic in i and j, the analytic thermocline of
    `configs/single_column.py`, enscon momentum at its default
    viscosities, the ALE regrid/remap.  `device` defaults to CUDA and
    raises when CUDA is missing."""
    from ..configs import single_column as cfg

    device = _device(device)
    kdm = kdm or cfg.KDM
    clock = modeltime.init_timevars('single_column', baclin, batrop,
                                    20000101, 20000101)
    grid = cfg.make_grid(baclin, kdm, dtype=dtype, device=device)
    e = eos.init_eos(pref=0., expcnf='single_column')

    z, temp, saln, phi = cfg.initial_profiles(kdm)
    sigmar = eos.sig(e, torch.from_numpy(temp),
                     torch.from_numpy(saln)).numpy()
    state = init.init_state(grid, e, phi=phi, temp=temp, saln=saln,
                            sigmar=sigmar, dtype=dtype)
    par = StepParams(
        baclin=baclin, lstep=clock.lstep, dlt=clock.dlt,
        momtum=MomtumParams(mommth='enscon'),
        barotp=BarotpParams(mommth='enscon'),
        pgfmth='dynamic enthalpy', vcoord_isopyc=False,
        ale=make_ale_params(kdm))
    forcing = zero_forcing(kdm, grid.shape, dtype, device)
    return _assemble(grid, e, par, clock, state, forcing, dtype, device)


def build_tripolar(dtype=torch.float64, itdm=32, jtdm=24, kdm=6,
                   baclin=180., batrop=6., device=None) -> Model:
    """Assemble the synthetic tripolar-fold experiment
    (configs/tripolar.py) as blom_tpu's build_tripolar does:
    i-periodic, closed south, the Arctic bipolar fold on the top row
    (nreg=2 topology, mod_xc.F90:2405-2700), the initial state's
    fold-duplicated top row synced, enscon momentum, no coastal
    wave-breaking damping, the ALE regrid/remap, and the vertical
    mixing, lateral diffusivity estimate and thermf at their defaults.
    `itdm` must be even: the q/v top-row sync mirrors the western half
    onto the eastern.  `device` defaults to CUDA and raises when CUDA is
    missing."""
    from ..configs import tripolar as cfg
    from ..parallel.arctic import sync_state

    if itdm % 2:
        raise ValueError(f'build_tripolar: itdm={itdm} must be even (the '
                         'fold mirrors the top row onto its own halves)')
    device = _device(device)
    clock = modeltime.init_timevars('fuk95', baclin, batrop,
                                    20000101, 20000101)
    grid = cfg.make_grid(baclin, itdm, jtdm, kdm, dtype=dtype,
                         device=device)
    e = eos.init_eos(pref=0., expcnf='fuk95')

    z, temp, saln, sigmar, phi = cfg.initial_profiles(itdm, jtdm, kdm)
    state = init.init_state(grid, e, phi=phi, temp=temp, saln=saln,
                            sigmar=sigmar, dtype=dtype)
    # enforce the fold-duplicated top row on the initial state
    state = sync_state(state)

    par = StepParams(
        baclin=baclin, lstep=clock.lstep, dlt=clock.dlt,
        momtum=MomtumParams(vsc2hi=.2, vsc2lo=.2, cbar=.05, cb=.002,
                            mommth='enscon'),
        barotp=BarotpParams(cwbdts=0., cwbdls=25., mommth='enscon'),
        pgfmth='dynamic enthalpy', vcoord_isopyc=False,
        ale=make_ale_params(kdm))
    forcing = zero_forcing(kdm, grid.shape, dtype, device)
    return _assemble(grid, e, par, clock, state, forcing, dtype, device)


def _accumulate(model, group, s, n, dfl, bgc_diags):
    """Accumulate time level n into one group or a tuple/list of groups
    (dia groups and bgcmean groups), as blom_tpu's scan body does."""
    from ..bgc.bgcmean import BgcmGroup, acc_bgcm
    from ..io import dia

    def one(g):
        if isinstance(g, BgcmGroup):
            return acc_bgcm(g, model.grid, s, n, model.par.itrbgc,
                            bgc_diags or {}, ti=model.par.bgc_ti)
        return dia.accumulate(
            model.grid, g, s, n, model.forcing, dfl, swabs=model.swabs,
            tridx={'itriag': model.par.itriag, 'itrtke': model.par.itrtke,
                   'itrgls': model.par.itrgls})

    if isinstance(group, (tuple, list)):
        return type(group)(one(g) for g in group)
    return one(group)


def run(model: Model, nsteps: int, dia_group=None, cnsvdi: bool = False,
        chk: bool = False):
    """Integrate `nsteps` baroclinic steps from the model's clock and
    state.  The first steps from initial conditions are forward
    (delt1 = baclin), later ones leap-frog (delt1 = 2*baclin).

    Steps alternate the time-level parity, (m, n) = (0, 1) first, as
    blom_tpu's pairs of steps and its odd tail do.  `model.state` is
    left unchanged; `model.dfl` takes the last step's diffusion fields.

    In-step instrumentation (BLOM's diaacc, budget_sums and chkvar,
    mod_blom_step.F90:96-252), all kept on the device until the run
    returns: `dia_group` (a DiaGroup or BgcmGroup, or a tuple or list of
    them) is accumulated after every step at its new time level;
    `cnsvdi` collects the budget sums of every step's seven checkpoints;
    `chk` a per-step chkvar flag.  Returns (state, clock), and with any
    of them on also an extras dict: 'dia_group' (the accumulated group
    or groups), 'budgets' (a BudgetSums of (nsteps, ncheck) tensors),
    'ok' (a (nsteps,) bool tensor)."""
    from ..bgc.bgcmean import BgcmGroup
    from ..dynamics.budget import BudgetSums
    from ..dynamics.chkvar import chkvar

    with_dia = dia_group is not None
    groups = (dia_group if isinstance(dia_group, (tuple, list))
              else [dia_group] if with_dia else [])
    with_bgcm = any(isinstance(g, BgcmGroup) for g in groups)

    s = model.state.clone()
    dfl = model.dfl
    delt1s = []
    c = model.clock
    for _ in range(nsteps):
        delt1s.append(c.delt1)
        c = c.step()
    args = (model.grid, model.e, model.par, model.coeffs_i, model.coeffs_j)
    budgets, oks = [], []
    for i, d in enumerate(delt1s):
        m, n = (0, 1) if i % 2 == 0 else (1, 0)
        bout = [] if cnsvdi else None
        bgcd = [] if with_bgcm else None
        s, dfl = blom_step(*args, s, model.forcing, dfl, m, n, d,
                           model.swabs, model.bgc_forcing,
                           budget_out=bout, bgc_diag_out=bgcd)
        if cnsvdi:
            budgets.append(bout)
        if chk:
            oks.append(chkvar(model.grid, s, n)[0])
        if with_dia:
            dia_group = _accumulate(model, dia_group, s, n, dfl,
                                    bgcd[0] if bgcd else {})
    model.dfl = dfl
    if not (with_dia or cnsvdi or chk):
        return s, c
    extras = {}
    if with_dia:
        extras['dia_group'] = dia_group
    if cnsvdi:
        extras['budgets'] = BudgetSums(*(
            torch.stack([torch.stack([getattr(b, k) for b in step])
                         for step in budgets])
            for k in BudgetSums._fields))
    if chk:
        extras['ok'] = torch.stack(oks)
    return s, c, extras
