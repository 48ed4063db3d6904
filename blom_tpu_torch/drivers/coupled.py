"""Coupled-mode ocean cap: import/export field translation and the
coupling advance loop.

Counterpart of `blom_tpu/drivers/coupled.py`: BLOM's NUOPC cap
(drivers/nuopc/ocn_comp_nuopc.F90:100-950 DataInitialize and
ModelAdvance), the import/export translation (ocn_import_export.F90:
237-330, ocn_import and ocn_export), the CESM forcing adapter
(cesm/mod_cesm.F90:61-330, the two-slot time smoothing of getfrc_cesm)
and the coupled-mode thermodynamics (cesm/mod_thermf_cesm.F90:60-260
thermf_cesm).  The coupler hands fields already mapped to the ocean grid
(the mediator's job), as tensors on the model's device; the cap
translates them, smooths them in time and steps the model, with no host
synchronization of its own."""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import eos
from ..core.constants import grav, onem
from ..core.grid import Grid
from ..core.state import State, cumulative_p
from ..io.merdia import to_zlev_w, zlev_weights

SPCIFH = 3990.
T0DEG = 273.15
SREF = 34.65
ALPHA0 = 1.e-3


class ImportFields(NamedTuple):
    """Coupler -> ocean fields, all (jdm, idm), on the ocean grid
    (fldsToOcn, ocn_import_export.F90:237-300)."""
    taux: torch.Tensor      # Foxx_taux [N m-2]
    tauy: torch.Tensor      # Foxx_tauy
    swnet: torch.Tensor     # Foxx_swnet [W m-2], positive down
    lat: torch.Tensor       # Foxx_lat latent
    sen: torch.Tensor       # Foxx_sen sensible
    lwup: torch.Tensor      # Foxx_lwup
    lwdn: torch.Tensor      # Faxa_lwdn
    rain: torch.Tensor      # Faxa_rain [kg m-2 s-1]
    snow: torch.Tensor      # Faxa_snow
    evap: torch.Tensor      # Foxx_evap
    rofl: torch.Tensor      # Foxx_rofl liquid runoff
    rofi: torch.Tensor      # Foxx_rofi frozen runoff
    melth: torch.Tensor     # Fioi_melth ice melt heat [W m-2]
    meltw: torch.Tensor     # Fioi_meltw ice melt water [kg m-2 s-1]
    salt: torch.Tensor      # Fioi_salt ice salt flux [kg m-2 s-1]
    ifrac: torch.Tensor     # Si_ifrac ice fraction
    pslv: torch.Tensor      # Sa_pslv sea-level pressure [Pa]
    duu10n: torch.Tensor    # So_duu10n 10-m wind speed squared [m2 s-2]
    # glc runoff (Forr_rofl_glc/Forr_rofi_glc, :251-252), summed into
    # the liquid and frozen runoff
    rofl_glc: torch.Tensor
    rofi_glc: torch.Tensor
    # wave coupling (Sw_*, :266-269)
    lamult: torch.Tensor    # Langmuir enhancement factor []
    ustokes: torch.Tensor   # surface Stokes drift [m s-1]
    vstokes: torch.Tensor
    hstokes: torch.Tensor   # Stokes depth scale [m]
    # BGC-relevant atmosphere and ice fields (:244-288)
    bcpho: torch.Tensor     # Fioi_bcpho hydrophobic black carbon from ice
    bcphi: torch.Tensor     # Fioi_bcphi hydrophilic black carbon
    flxdst: torch.Tensor    # Fioi_flxdst dust from ice [kg m-2 s-1]
    ndep: torch.Tensor      # Faxa_ndep nitrogen deposition [kg N m-2 s-1]
    co2prog: torch.Tensor   # Sa_co2prog prognostic atm CO2 [ppmv]
    co2diag: torch.Tensor   # Sa_co2diag diagnostic atm CO2 [ppmv]
    # extended-N-cycle deposition (Faxa_hmat/Faxa_hmat_oa/Faxa_hlat,
    # ocn_import_export.F90:280-284); zeros unless the extNcycle or
    # sediment options are on
    hmat: Optional[torch.Tensor] = None    # matured ammonium deposition
    hmoa: Optional[torch.Tensor] = None    # hmat, open-ocean share
    hlat: Optional[torch.Tensor] = None    # latent ammonium deposition


N_IMPORTS = 33


def zero_imports(shape, dtype=torch.float64, device='cpu') -> ImportFields:
    """Imports of a quiet coupler: zeros, with a Langmuir factor of 1."""
    z = torch.zeros(tuple(shape), dtype=dtype, device=device)
    one = torch.ones(tuple(shape), dtype=dtype, device=device)
    flds = [z] * 18 + [z, z, one, z, z, z] + [z] * 9
    return ImportFields(*flds)


# z-levels of the ocn->glc export profiles (ocn_import_export.F90:73-89)
NLEV_EXPORT = 30
EXPORT_LEVELS = tuple(30. + 60. * i for i in range(NLEV_EXPORT))
EXPORT_LEVEL_BNDS = tuple((60. * i, 60. * (i + 1))
                          for i in range(NLEV_EXPORT))


class ExportFields(NamedTuple):
    """Ocean -> coupler fields (fldsFrOcn,
    ocn_import_export.F90:309-336)."""
    So_omask: torch.Tensor
    So_t: torch.Tensor       # surface temperature [K]
    So_s: torch.Tensor       # surface salinity
    So_u: torch.Tensor       # surface current
    So_v: torch.Tensor
    So_dhdx: torch.Tensor    # sea-level slope
    So_dhdy: torch.Tensor
    So_bldepth: torch.Tensor  # boundary-layer depth [m]
    Fioo_q: torch.Tensor     # freezing potential heat flux [W m-2]
    # BGC outgassing fluxes (:320-330); zeros when the BGC is off
    Faoo_fco2_ocn: torch.Tensor   # CO2 flux [kg CO2 m-2 s-1]
    Faoo_fdms_ocn: torch.Tensor   # DMS flux
    Faoo_fbrf_ocn: torch.Tensor   # bromoform flux
    # ocn->glc level profiles (:331-336), (NLEV_EXPORT, J, I)
    So_t_depth: torch.Tensor
    So_s_depth: torch.Tensor
    # extended-N-cycle outgassing (ocn_import_export.F90:323-324);
    # zeros when the extNcycle is off
    Faoo_fn2o_ocn: Optional[torch.Tensor] = None   # N2O [kg N2O m-2 s-1]
    Faoo_fnh3_ocn: Optional[torch.Tensor] = None   # NH3 [kg NH3 m-2 s-1]


CESM_FIELDS = ('swa', 'nsf', 'hmlt', 'lip', 'sop', 'eva', 'rnf', 'rfi',
               'fmltfz', 'sfl', 'ztx', 'mty', 'ustarw', 'slp', 'abswnd',
               'ficem', 'lamult', 'ustokes', 'vstokes', 'hstokes')


@dataclasses.dataclass
class CesmForcing:
    """Two-slot forcing storage for the coupling interval's time
    smoothing (mod_cesm.F90:67-100, the *_da arrays; slot 0 the previous
    interval, slot 1 the current), each (2, J, I)."""
    swa: torch.Tensor
    nsf: torch.Tensor
    hmlt: torch.Tensor
    lip: torch.Tensor
    sop: torch.Tensor
    eva: torch.Tensor
    rnf: torch.Tensor
    rfi: torch.Tensor
    fmltfz: torch.Tensor
    sfl: torch.Tensor
    ztx: torch.Tensor
    mty: torch.Tensor
    ustarw: torch.Tensor
    slp: torch.Tensor
    abswnd: torch.Tensor
    ficem: torch.Tensor
    lamult: torch.Tensor
    ustokes: torch.Tensor
    vstokes: torch.Tensor
    hstokes: torch.Tensor


def init_cesm_forcing(shape, dtype=torch.float64,
                      device='cpu') -> CesmForcing:
    """Both slots zero, the Langmuir factor 1."""
    z = torch.zeros((2,) + tuple(shape), dtype=dtype, device=device)
    one = torch.ones((2,) + tuple(shape), dtype=dtype, device=device)
    return CesmForcing(*([z] * 16 + [one, z, z, z]))


def import_forcing(cf: CesmForcing, imp: ImportFields) -> CesmForcing:
    """Rotate the slots and ingest a new coupling interval's fields
    (ocn_import, ocn_import_export.F90: the *_da slot writes)."""
    nsf = imp.lat + imp.sen + imp.lwup + imp.lwdn
    ustarw = torch.sqrt(torch.sqrt(imp.taux ** 2 + imp.tauy ** 2) / 1000.)

    def put(two, new):
        return torch.stack([two[1], new])

    return CesmForcing(
        swa=put(cf.swa, imp.swnet), nsf=put(cf.nsf, nsf),
        hmlt=put(cf.hmlt, imp.melth), lip=put(cf.lip, imp.rain),
        sop=put(cf.sop, imp.snow), eva=put(cf.eva, imp.evap),
        rnf=put(cf.rnf, imp.rofl + imp.rofl_glc),
        rfi=put(cf.rfi, imp.rofi + imp.rofi_glc),
        fmltfz=put(cf.fmltfz, imp.meltw), sfl=put(cf.sfl, imp.salt),
        ztx=put(cf.ztx, imp.taux), mty=put(cf.mty, imp.tauy),
        ustarw=put(cf.ustarw, ustarw), slp=put(cf.slp, imp.pslv),
        abswnd=put(cf.abswnd, torch.sqrt(torch.clamp_min(imp.duu10n, 0.))),
        ficem=put(cf.ficem, imp.ifrac),
        lamult=put(cf.lamult, imp.lamult),
        ustokes=put(cf.ustokes, imp.ustokes),
        vstokes=put(cf.vstokes, imp.vstokes),
        hstokes=put(cf.hstokes, imp.hstokes))


def getfrc_cesm(cf: CesmForcing, nstep_in_cpl: int, istep: int,
                smtfrc: bool = True):
    """Time-smoothed instantaneous forcing within a coupling interval
    (getfrc_cesm, mod_cesm.F90:202-330): a cosine blend of the two
    stored intervals, its weight a Python float of the step count."""
    if smtfrc:
        w1 = .5 * (1. + math.cos((istep % nstep_in_cpl + 1) * math.pi
                                 / nstep_in_cpl))
    else:
        w1 = 0.
    w2 = 1. - w1
    return {k: w1 * getattr(cf, k)[0] + w2 * getattr(cf, k)[1]
            for k in CESM_FIELDS}


def thermf_cesm(grid: Grid, e: eos.EosParams, s: State, frc: dict,
                m: int, n: int, baclin: float):
    """Coupled-mode surface thermodynamics (thermf_cesm,
    mod_thermf_cesm.F90:60-260): heat and salt fluxes from the coupler's
    fields, the virtual salt flux with its global correction (a plain
    sum over the wet points, as in blom_tpu), and the freezing and
    melting potentials exported to the sea ice."""
    dpotl = s.dp[n, 0]
    totl = s.temp[n, 0] + T0DEG
    sotl = s.saln[n, 0]
    tice_f = eos.tfrz(e, sotl) + T0DEG
    tfrzm = eos.tfrz(e, .5 * (s.saln[m, 0] + s.saln[n, 0])) + T0DEG

    fwflx = (frc['eva'] + frc['lip'] + frc['sop'] + frc['rnf']
             + frc['rfi'] + frc['fmltfz'])
    brnflx = torch.clamp_min(-sotl * frc['fmltfz'] * 1.e-3 + frc['sfl'], 0.)
    vrtsfl = -sotl * fwflx * 1.e-3

    area = torch.sum(grid.scp2 * grid.ip)
    sflxc = torch.sum(-(SREF * fwflx * 1.e-3 + vrtsfl) * grid.scp2
                      * grid.ip) / area
    salflx = -(vrtsfl + sflxc + frc['sfl']) * 1.e3

    # freezing and melting potentials (mod_thermf_cesm.F90:94-101)
    frzpot = torch.clamp_min(tice_f - totl, 0.) * SPCIFH * dpotl \
        / (2. * grav)
    tm = .5 * (s.temp[m, 0] + s.temp[n, 0]) + T0DEG
    dpm = .5 * (s.dp[m, 0] + s.dp[n, 0])
    mltpot = torch.clamp_max(tfrzm - tm, 0.) * SPCIFH * dpm / grav

    hmltfz = frc['hmlt'] + frzpot / baclin
    surflx = -(frc['swa'] + frc['nsf'] + hmltfz)
    sswflx = -frc['swa']

    return {'surflx': surflx * grid.ip, 'sswflx': sswflx * grid.ip,
            'salflx': salflx * grid.ip,
            'brnflx': -brnflx * 1.e3 * grid.ip,
            'frzpot': frzpot * grid.ip, 'mltpot': mltpot * grid.ip,
            'ustar': frc['ustarw'] * grid.ip}


def sfcstr_cesm(grid: Grid, frc: dict):
    """Surface stress at u and v points (mod_sfcstr_cesm.F90): the
    p-point coupler stress averaged onto the staggered points."""
    taux = .5 * (frc['ztx'] + grid.im1(frc['ztx'])) * grid.iu
    tauy = .5 * (frc['mty'] + grid.jm1(frc['mty'])) * grid.iv
    return taux, tauy


_SPVAL = 1.e30
_EXPORT_BNDS = {}


def _export_bounds(dtype, device):
    """The export levels' bounds as a tensor, copied to each device
    once, so that an export copies nothing to the card."""
    key = (dtype, str(device))
    if key not in _EXPORT_BNDS:
        _EXPORT_BNDS[key] = torch.as_tensor(np.asarray(EXPORT_LEVEL_BNDS),
                                            dtype=dtype, device=device)
    return _EXPORT_BNDS[key]


def ocn_export(grid: Grid, e: eos.EosParams, s: State, n: int,
               frzpot, baclin: float,
               bgc_fluxes: dict = None) -> ExportFields:
    """Fields handed back to the coupler (ocn_export,
    ocn_import_export.F90): surface state, sea-level slopes, the
    boundary-layer depth proxy (the top two layers), the freezing
    potential, and the two 30-level profiles (1e30 in a bin below the
    sea floor), their z-level weights built once per export."""
    u_srf = .5 * (s.u[n, 0] + s.ub[n] + grid.ip1(s.u[n, 0] + s.ub[n]))
    v_srf = .5 * (s.v[n, 0] + s.vb[n] + grid.jp1(s.v[n, 0] + s.vb[n]))
    dhdx = (grid.ip1(s.sealv) - grid.im1(s.sealv)) / (2. * grid.scpx)
    dhdy = (grid.jp1(s.sealv) - grid.jm1(s.sealv)) / (2. * grid.scpy)
    bld = (s.dp[n, 0] + s.dp[n, 1]) / onem

    # ocn->glc level profiles at the standard 30 levels
    # (ocn_import_export.F90:73-89, acc_t_depth/acc_s_depth)
    p_i = cumulative_p(s.dp[n]) * grid.ip
    w, den = zlev_weights(p_i, _export_bounds(p_i.dtype, p_i.device))
    t_depth = to_zlev_w(s.temp[n], w, den, fill=_SPVAL)
    s_depth = to_zlev_w(s.saln[n], w, den, fill=_SPVAL)
    del w

    z2 = torch.zeros_like(grid.ip)
    if bgc_fluxes is None:
        bgc_fluxes = {}
    return ExportFields(
        So_omask=grid.ip,
        So_t=(s.temp[n, 0] + T0DEG) * grid.ip,
        So_s=s.saln[n, 0] * grid.ip,
        So_u=u_srf * grid.ip, So_v=v_srf * grid.ip,
        So_dhdx=dhdx * grid.ip, So_dhdy=dhdy * grid.ip,
        So_bldepth=bld * grid.ip,
        Fioo_q=frzpot / baclin * grid.ip,
        Faoo_fco2_ocn=bgc_fluxes.get('co2flux', z2) * grid.ip,
        Faoo_fdms_ocn=bgc_fluxes.get('dmsflux', z2) * grid.ip,
        Faoo_fbrf_ocn=bgc_fluxes.get('brfflux', z2) * grid.ip,
        So_t_depth=t_depth, So_s_depth=s_depth,
        Faoo_fn2o_ocn=bgc_fluxes.get('n2oflux', z2) * grid.ip,
        Faoo_fnh3_ocn=bgc_fluxes.get('nh3flux', z2) * grid.ip)


class OcnCap:
    """The coupled driver loop (ModelAdvance,
    ocn_comp_nuopc.F90:886-950): each coupling interval ingests the
    imports, runs nstep_in_cpl model steps with smoothed forcing and
    returns the exports.  The model's state is stepped in place and
    stays on its device."""

    def __init__(self, model, nstep_in_cpl: int, smtfrc: bool = True):
        self.model = model
        self.nstep_in_cpl = nstep_in_cpl
        self.smtfrc = smtfrc
        dp = model.state.dp
        self.cf = init_cesm_forcing(model.grid.shape, dp.dtype, dp.device)
        self.nstep = 0
        self.frzpot = torch.zeros(model.grid.shape, dtype=dp.dtype,
                                  device=dp.device)
        self.bgc_fluxes = {}

    def data_initialize(self) -> ExportFields:
        """The cap's DataInitialize phase (ocn_comp_nuopc.F90:367-560):
        export the initial ocean state to the mediator before the first
        ModelAdvance, so that the other components spin up against it."""
        model = self.model
        n = 1 - (self.nstep % 2)
        return ocn_export(model.grid, model.e, model.state, n,
                          self.frzpot, model.par.baclin, self.bgc_fluxes)

    def advance(self, imp: ImportFields) -> ExportFields:
        """One coupling interval: nstep_in_cpl steps, then the exports of
        the newest time level.  delt1 is a Python float, baclin for the
        first step from initial conditions and 2*baclin after it."""
        from ..dynamics.step import blom_step
        model = self.model
        self.cf = import_forcing(self.cf, imp)
        s = model.state
        dfl = model.dfl
        for _ in range(self.nstep_in_cpl):
            frc = getfrc_cesm(self.cf, self.nstep_in_cpl, self.nstep,
                              self.smtfrc)
            m = self.nstep % 2
            n = 1 - m
            flx = thermf_cesm(model.grid, model.e, s, frc, m, n,
                              model.par.baclin)
            taux, tauy = sfcstr_cesm(model.grid, frc)
            forcing = dataclasses.replace(
                model.forcing, taux=taux, tauy=tauy,
                surflx=flx['surflx'], sswflx=flx['sswflx'],
                salflx=flx['salflx'], brnflx=flx['brnflx'],
                lamult=frc['lamult'])
            delt1 = (model.par.baclin if self.nstep == 0
                     else 2. * model.par.baclin)
            s, dfl = blom_step(model.grid, model.e, model.par,
                               model.coeffs_i, model.coeffs_j, s,
                               forcing, dfl, m, n, delt1, model.swabs)
            self.frzpot = flx['frzpot']
            self.nstep += 1
        model.state = s
        model.dfl = dfl
        # the newest time level: the n of the last step
        n = 1 - ((self.nstep - 1) % 2)
        return ocn_export(model.grid, model.e, s, n, self.frzpot,
                          model.par.baclin, self.bgc_fluxes)
