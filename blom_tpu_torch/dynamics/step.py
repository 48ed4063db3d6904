"""One baroclinic model step.

Counterpart of `blom_tpu/dynamics/step.py` (BLOM's
mod_blom_step.F90:74-324) for both vertical coordinates.  The ALE
(cntiso_hybrid) step: tmsmt1, the ALE regrid/remap, cmnfld with the
lateral diffusivities and the GM eddy transport, advect (CPPM, or
incremental remapping with advmth='remap'), pbcor1, the lateral
diffusion (along layers, or along neutral surfaces with
ltedtp='neutral'), pgforc (dynamic enthalpy or geopotential), momtum,
the vertical mixing (CVMix-lite or KPP, with the tidal term when set)
with the implicit vertical diffusion of tracers and momentum, barotp,
pbcor2 and tmsmt2.  The isopycnic (isopyc_bulkml)
step: no regrid, the isopycnic GM (eddtra_isopyc) when egc > 0, the
mixed-layer wind stress in momtum, then convec, the diapycnal mixing
(diapfl) with the estimator's diffusivity, merged with the TKE/GLS
closure's when par.itrtke is set, and the bulk mixed layer (mxlayr) in
place of the implicit vertical diffusion.  On the ALE path the TKE/GLS
slots are plain tracers, as in blom_tpu.  Surface restoring
(par.thermf with trxday or srxday > 0) fills the relaxation fluxes of a
new Forcing before the vertical physics that read them (mxlayr, or
ale_vdifft); the caller's forcing is left as it is.  On a
tripolar grid the step ends with the fold's top-row sync (sync_state).
On either coordinate the tracers' source terms follow the vertical physics:
the ideal age (idlage_step) and the BGC chain (hamocc_step).  Each
phase runs under blom_tpu's guard.

The step updates the State in place; m, n are the Python-int time-level
slots and delt1 a Python float.  The eddy-transport limiter reads one
flag on the host per sweep (eddtra.host_syncs); nothing else syncs."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..bgc.step import BgcForcing, hamocc_step
from ..core import eos
from ..core.constants import epsilp, grav, onem
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..phys import tke
from ..phys.forcing import Forcing
from ..phys.swabs import SwabsFields
from ..phys.thermf import ThermfParams, thermf_relax
from ..phys.vmix import VmixParams, difest_vertical, difest_vertical_kpp
from ..tracers.idlage import idlage_step
from .advect import advect
from .ale import AleParams, ale_regrid_remap
from .ale_vdiff import ale_vdifft, ale_vdiffm
from .barotp import BarotpParams, barotp
from .budget import budget_col_sums, budget_sums_many
from .cmnfld import cmnfld
from .convec import convec
from .cppm import CppmCoeffs
from .diapfl import diapfl
from .difest import DifestParams, difest_lateral
from .diffus import diffus
from .diffusion_fields import DiffusionFields
from .eddtra import eddtra, eddtra_isopyc
from .momtum import MomtumParams, momtum
from .mxlayr import MxlayrParams, mxlayr
from .ndiff import ndiff
from .pbcor import pbcor1, pbcor2
from .pgforc import pgforc
from .tmsmt import tmsmt1, tmsmt2


class StepParams(NamedTuple):
    """Static per-run parameters of the step function."""
    baclin: float
    lstep: int
    dlt: float
    momtum: MomtumParams = MomtumParams()
    barotp: BarotpParams = BarotpParams()
    pgfmth: str = 'dynamic enthalpy'
    advmth: str = 'cppm'
    cppm_compatibility: str = 'full'
    cppm_limiting: str = 'non_oscillatory'
    vcoord_isopyc: bool = False
    ale: Optional[AleParams] = None
    vmix: Optional[VmixParams] = VmixParams()
    itriag: int = -1
    itrtke: int = -1
    itrgls: int = -1
    itrbgc: int = -1
    bgc: object = None        # BgcParams when itrbgc >= 0
    bgc_ti: object = None     # extended BGC tracer index (with bgc_cp)
    bgc_cp: object = None     # carbon-isotope parameters (ciso.CisoParams)
    nday_in_year: float = 360.
    difest: Optional[DifestParams] = DifestParams()
    thermf: Optional[ThermfParams] = ThermfParams()
    mxlayr: MxlayrParams = MxlayrParams()
    ltedtp: str = 'layer'     # 'layer' | 'neutral' (mod_diffusion.F90:99)
    barotp_fn: object = None  # in place of barotp: the margin-k solver
    #                           (barotp_shmap.make_barotp_shmap)


def _diffus_on(par: StepParams) -> bool:
    return par.difest is not None and (par.difest.egc > 0.
                                       or par.difest.egmndf > 0.)


def check_supported(grid: Grid, par: StepParams):
    """The port runs every option of StepParams on both coordinates, so
    this refuses nothing; callers check a configuration through it."""


def _difest_v(par: StepParams):
    """The vertical-mixing estimator: CVMix-lite, or with par.vmix.use_kpp
    the full KPP boundary layer (difest_vertical_hybrid's CVMix_kpp path,
    mod_difest.F90:900-1200)."""
    if par.vmix is not None and par.vmix.use_kpp:
        return difest_vertical_kpp
    return difest_vertical


def _tke_closure(grid: Grid, s: State, forcing: Forcing, kdiff,
                 par: StepParams, n: int, delt1):
    """Update the TKE/GLS tracers of level n in place and return the
    diffusivity merged with the closure's (difest_isobml's TKE branch,
    mod_difest.F90:2641-2930).  With itrgls < 0 psi is diagnostic: it is
    read from trc[n, itrgls] (the last slot) and only the TKE slot is
    written, as in blom_tpu."""
    dp_k = s.dp[n]
    p_i = cumulative_p(dp_k) * grid.ip
    sig = s.sigma[n]
    dp_mid = torch.clamp(.5 * (dp_k[:-1] + dp_k[1:]), min=epsilp)
    bvfsq_i = grav * grav * (sig[1:] - sig[:-1]) / dp_mid
    bvfsq = torch.cat([bvfsq_i[:1], bvfsq_i], 0)

    u_p = .5 * (s.u[n] + grid.ip1(s.u[n]))
    v_p = .5 * (s.v[n] + grid.jp1(s.v[n], 'v', True))
    du, dv = u_p[1:] - u_p[:-1], v_p[1:] - v_p[:-1]
    du2_i = du * du + dv * dv
    du2l = torch.cat([du2_i[:1], du2_i], 0)

    kidx = torch.arange(dp_k.shape[0], device=dp_k.device)[:, None, None]
    kmax = torch.where(dp_k > epsilp, kidx, 0).amax(0)
    taux_p = .5 * (forcing.taux + grid.ip1(forcing.taux))
    tauy_p = .5 * (forcing.tauy + grid.jp1(forcing.tauy, 'v', True))
    ustar = torch.sqrt(torch.sqrt(taux_p * taux_p + tauy_p * tauy_p)
                       / 1000.)

    tke_tr = torch.clamp(s.trc[n, par.itrtke], min=tke.tke_min)
    gls_tr = torch.clamp(s.trc[n, par.itrgls], min=tke.gls_psi_min)
    tp = tke.TkeParams(use_gls=par.itrgls >= 0)
    tke_new, gls_new, nus, _ = tke.tke_gls_update(
        tke_tr, gls_tr, kdiff, du2l, bvfsq, dp_k, p_i, ustar, s.ustarb,
        kmax, delt1, tp)
    s.trc[n, par.itrtke] = tke_new
    if par.itrgls >= 0:
        s.trc[n, par.itrgls] = gls_new
    return s, torch.maximum(kdiff, nus)


# Per-phase device timing, off (None) by default.  A caller that sets
# `phase_marks` to a list gets from each blom_step on the card one
# (name, CUDA event) pair recorded before each phase, and ('end', event)
# after the last; a phase's time is the gap to the next mark.
phase_marks: Optional[list] = None


def _mark(name: str):
    if phase_marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        phase_marks.append((name, ev))


def init_fluxes(s: State, m: int) -> State:
    """Reset mid-level flux accumulators (init_fluxes,
    mod_state.F90:341-383)."""
    for name in ('uflx', 'vflx', 'utflx', 'vtflx', 'usflx', 'vsflx'):
        getattr(s, name)[m].zero_()
    return s


def blom_step(grid: Grid, e: eos.EosParams, par: StepParams,
              coeffs_i: CppmCoeffs, coeffs_j: CppmCoeffs,
              s: State, forcing: Forcing, dfl: DiffusionFields,
              m: int, n: int, delt1: float,
              swabs: Optional[SwabsFields] = None,
              bgc_forcing: Optional[BgcForcing] = None,
              budget_out: Optional[list] = None,
              bgc_diag_out: Optional[list] = None):
    """Advance one baroclinic time step (mod_blom_step.F90:74-324) in
    place.  Returns (state, dfl): the diffusion and eddy-transport fields
    are per-step state (difest/eddtra fill them, advect and momtum read
    them).  Vertical mixing runs when par.vmix and swabs are given, the
    BGC when par.itrbgc >= 0 and bgc_forcing is given.

    When `budget_out` is a list, the mass, heat and salt budget sums of
    BLOM's seven cnsvdi checkpoints (budget_sums calls 1..7,
    mod_blom_step.F90:96-230) are appended to it, as device tensors: the
    columns are collapsed at each checkpoint and summed together at the
    end of the step.  When `bgc_diag_out` is a list, hamocc_step's
    diagnostics are appended to it (accfields, mo_hamocc_step.F90:101).
    With both None the step is unchanged."""
    dlt = par.dlt
    isopyc = par.vcoord_isopyc
    cols = [] if budget_out is not None else None

    def ckpt(lvl):
        if cols is not None:
            _mark('budget')
            cols.append(budget_col_sums(grid, s, lvl))

    ckpt(n)   # budget_sums(1,n) before anything (mod_blom_step.F90:96)
    _mark('init_fluxes+tmsmt1')
    s = init_fluxes(s, m)
    s = tmsmt1(grid, s, n, isopyc)

    # ALE vertical regrid + remap (mod_blom_step.F90:131-135)
    if not isopyc and par.ale is not None:
        _mark('ale_regrid_remap')
        s = ale_regrid_remap(grid, e, par.ale, s, m, n, delt1)
        ckpt(n)   # budget_sums(2,n) after the remap (:132)

    # derived fields, lateral diffusivities, GM eddy transport
    # (mod_blom_step.F90:136-147; the isopycnic GM is
    # eddtra_gm_isopyc_bulkml, mod_eddtra.F90:228)
    if par.difest is not None and (not isopyc or par.difest.egc > 0.):
        _mark('cmnfld')
        cf = cmnfld(grid, e, s, n)
        _mark('difest_lateral')
        dfl = difest_lateral(grid, s, cf, par.difest, dfl, m, n)
        if par.difest.egc > 0.:
            _mark('eddtra')
            dfl = (eddtra_isopyc(grid, s, dfl, m, n, delt1) if isopyc
                   else eddtra(grid, s, cf, dfl, m, n, delt1))

    _mark('advect')
    s = advect(grid, s, dfl, coeffs_i, coeffs_j, m, n, delt1, dlt,
               par.advmth, par.cppm_compatibility, par.cppm_limiting)
    _mark('pbcor1')
    s = pbcor1(grid, s, m, n, dlt)

    # lateral tracer diffusion: along layers (mod_blom_step.F90:152
    # diffus; along isopycnals on the isopycnic coordinate) or along
    # neutral surfaces (BLOM runs it in the ale_regrid_remap jslice
    # pipeline, mod_ale_regrid_remap.F90:1643-1670)
    if _diffus_on(par):
        if par.ltedtp == 'neutral' and not isopyc:
            _mark('ndiff')
            s = ndiff(grid, e, s, dfl, m, n, delt1, cf.mld * onem)
        else:
            _mark('diffus')
            s, dfl = diffus(grid, e, s, dfl, m, n, delt1)
    ckpt(n)   # budget_sums(2|3,n) after advect/diffus (:156,159)

    _mark('pgforc')
    s = pgforc(grid, e, s, m, n, par.pgfmth)
    _mark('momtum')
    s, utotn, vtotn = momtum(grid, s, forcing, par.momtum, dfl.difwgt,
                             m, n, delt1, dlt, isopyc)

    if isopyc:
        # convective adjustment and diapycnal mixing
        # (mod_blom_step.F90:174-186)
        _mark('convec')
        s = convec(grid, e, s, m, n)
        ckpt(n)   # budget_sums(3,n) after convec (:177)
        if par.vmix is not None and swabs is not None:
            _mark('difest_vertical')
            vf = _difest_v(par)(grid, e, s, forcing, swabs, par.vmix, n)
            dfl = dataclasses.replace(dfl, difvho=vf.Kdiff_t,
                                      difvso=vf.Kdiff_s, difvmo=vf.Kvisc_m,
                                      bld=vf.mld * grid.ip)
            kdiff = vf.Kdiff_t
            if par.itrtke >= 0:
                # the TKE(/GLS) closure's diffusivity joins the
                # estimator's (difest_isobml, mod_difest.F90:2641-2930)
                _mark('tke_closure')
                s, kdiff = _tke_closure(grid, s, forcing, kdiff, par, n,
                                        delt1)
            _mark('diapfl')
            s = diapfl(grid, e, s, kdiff, m, n, delt1)
        ckpt(n)   # budget_sums(4,n) after diapfl (:183)

    # surface thermodynamics: the restoring fluxes (thermf,
    # mod_blom_step.F90:188-189)
    if par.thermf is not None and (par.thermf.trxday > 0.
                                   or par.thermf.srxday > 0.):
        _mark('thermf')
        forcing = thermf_relax(grid, s, forcing, par.thermf, n,
                               forcing.sstclm, forcing.sssclm)

    if isopyc:
        # the bulk mixed layer (mod_blom_step.F90:191-193)
        _mark('mxlayr')
        s, dfl = mxlayr(grid, e, s, forcing, par.mxlayr, m, n, delt1,
                        swabs=swabs, dfl=dfl)
    elif par.vmix is not None and swabs is not None:
        # vertical physics (mod_blom_step.F90:196-207): mixing
        # coefficients and penetration factors, then implicit vertical
        # diffusion
        _mark('difest_vertical')
        vf = _difest_v(par)(grid, e, s, forcing, swabs, par.vmix, n)
        dfl = dataclasses.replace(dfl, difvho=vf.Kdiff_t,
                                  difvso=vf.Kdiff_s, difvmo=vf.Kvisc_m,
                                  bld=vf.mld * grid.ip)
        _mark('ale_vdifft')
        s = ale_vdifft(grid, e, s, forcing, vf, m, n, delt1)
        _mark('ale_vdiffm')
        s = ale_vdiffm(grid, s, vf, m, n, delt1)
        ckpt(n)   # budget_sums(4,n) after ale_vdiffm (:205)

    # tracer sources and sinks (updtrc, mod_blom_step.F90:209-213), after
    # the vertical physics
    if par.itriag >= 0:
        _mark('idlage')
        s = idlage_step(s, par.itriag, n, delt1, par.nday_in_year)
    if par.itrbgc >= 0 and bgc_forcing is not None:
        _mark('hamocc')
        s, bgc_diags = hamocc_step(grid, e, par.bgc, s, bgc_forcing,
                                   par.itrbgc, n, m, delt1, ti=par.bgc_ti,
                                   cp=par.bgc_cp)
        if bgc_diag_out is not None:
            bgc_diag_out.append(bgc_diags)
    ckpt(n)   # budget_sums(5,n) after updtrc (:215)

    _mark('barotp')
    # the margin-k block solver takes its place through par.barotp_fn
    # (mod_barotp.F90:387-397)
    s = (par.barotp_fn or barotp)(grid, s, utotn, vtotn, m, n, par.lstep,
                                  dlt, par.barotp)
    _mark('pbcor2')
    s = pbcor2(grid, e, s, m, n, dlt)
    ckpt(m)   # budget_sums(6,m) after pbcor2 (:224)
    _mark('tmsmt2')
    s = tmsmt2(grid, s, m, n, isopyc)
    ckpt(m)   # budget_sums(7,m) after tmsmt2 (:230)
    if cols is not None:
        _mark('budget')
        budget_out.extend(budget_sums_many(cols))

    if grid.arctic:
        # enforce the fold-duplicated top-row degrees of freedom (the
        # role of the reference's xctilr fold writes on tripolar grids,
        # mod_xc.F90:2405-2700); keeps mirrored copies bit-identical
        # against roundoff-order drift
        _mark('arctic_sync')
        from ..parallel.arctic import sync_state
        s = sync_state(s)
    _mark('end')
    return s, dfl
