"""Typed run configuration.

The port's own copy of `blom_tpu/core/config.py`: one config tree in
place of BLOM's namelist groups (mod_rdlim.F90), run strings
(mod_config.F90) and compile-time flags, loadable from an unmodified
BLOM `limits` deck; a &DIAPHY group becomes `dia_groups`
(`io.dia.load_diaphy`)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from . import namelist as nml


@dataclasses.dataclass
class VCoordConfig:
    # &VCOORD (mod_vcoord.F90 readnml_vcoord)
    vcoord_type: str = 'cntiso_hybrid'   # isopyc_bulkml | cntiso_hybrid | plevel
    dpmin_surface: float = 1.5           # [m]
    dpmin_inflation_factor: float = 1.0
    sigref_spec: str = 'inicon'
    plevel_spec: str = 'inflation'
    sigdia_spec: str = 'inicon'
    sigref: Optional[Sequence[float]] = None
    plevel: Optional[Sequence[float]] = None
    sigref_adaption: bool = False


@dataclasses.dataclass
class AleRegridRemapConfig:
    # &ALE_REGRID_REMAP (mod_ale_regrid_remap.F90 namelist)
    reconstruction_method: str = 'ppm'   # 'plm' | 'ppm' | 'pqm'
    upper_bndr_ord: int = 6
    lower_bndr_ord: int = 4
    density_limiting: str = 'monotonic'
    tracer_limiting: str = 'non_oscillatory'
    velocity_limiting: str = 'non_oscillatory'
    density_pc_upper_bndr: bool = False
    density_pc_lower_bndr: bool = False
    tracer_pc_upper_bndr: bool = True
    tracer_pc_lower_bndr: bool = False
    velocity_pc_upper_bndr: bool = True
    velocity_pc_lower_bndr: bool = False
    dpmin_interior: float = .1           # [m]
    regrid_method: str = 'nudge'         # 'direct' | 'nudge'
    k_range_plevel: int = 4
    regrid_nudge_ts: float = 86400.      # [s]
    stab_fac_limit: float = .75
    smooth_diff_max: float = 50000.      # [m2 s-1]
    dktzu: int = 4
    dktzl: int = 2


@dataclasses.dataclass
class DiffusionConfig:
    # &DIFFUSION (mod_diffusion.F90:200-546 readnml_diffusion)
    eitmth: str = 'gm'          # eddy-induced transport: 'intdif' | 'gm'
    edritp: str = 'large scale'
    edwmth: str = 'smooth'
    eddf2d: bool = False
    edsprs: bool = True
    egc: float = 0.
    eggam: float = 200.
    eglsmn: float = 4000.
    egmndf: float = 0.
    egmxdf: float = 1500.
    egidfq: float = 1.
    rhiscf: float = 0.
    edanis: bool = False
    redi3d: bool = False
    rhsctp: bool = False
    edfsmo: bool = False
    ri0: float = 1.2
    bdmtyp: int = 2
    bdmc1: float = 5.e-8
    bdmc2: float = 1.e-5
    bdmldp: bool = False
    iwdflg: int = 1
    iwdfac: float = .06
    nubmin: float = 1.e-6
    tkepf: float = 0.
    smobld: bool = True
    lngmtp: str = 'none'
    ltedtp: str = 'layer'
    ndiff_surface_align: bool = False


@dataclasses.dataclass
class RunConfig:
    """&LIMITS core run parameters (mod_rdlim.F90)."""

    # experiment / time
    nday1: int = 0
    nday2: int = 1
    idate: int = 20000101
    idate0: int = 20000101
    runid: str = 'BLOM_run'
    expcnf: str = 'fuk95'
    grfile: str = ''               # grid NetCDF (GRFILE)
    icfile: str = ''               # initial-condition climatology (ICFILE)
    kdm: int = 53                  # layers for grid-file configs
    pref: float = 0.               # reference pressure [Pa]
    baclin: float = 180.           # baroclinic dt [s]
    batrop: float = 6.             # barotropic dt [s]

    # momentum dissipation / friction (mod_momtum.F90:53-90)
    mdv2hi: float = 0.
    mdv2lo: float = 0.
    mdv4hi: float = 0.
    mdv4lo: float = 0.
    mdc2hi: float = 0.
    mdc2lo: float = 0.
    vsc2hi: float = .2
    vsc2lo: float = .2
    vsc4hi: float = 0.
    vsc4lo: float = 0.
    cbar: float = .05
    cb: float = .002
    cwbdts: float = 0.
    cwbdls: float = 25.

    # scheme selections
    mommth: str = 'enscon'               # enscon | enecon | enedis
    pgfmth: str = 'dynamic enthalpy'     # geopotential | dynamic enthalpy
    bmcmth: str = 'uc'                   # uc | dluc
    advmth: str = 'cppm'                 # remap | cppm
    cppm_compatibility: str = 'full'     # full | partial
    cppm_limiting: str = 'non_oscillatory'  # monotonic | non_oscillatory
    mldmth: str = 'lev82'
    mlrmth: str = 'none'

    # mixed layer / TKE parameters
    rm0: float = 1.2
    rm5: float = 0.
    ce: float = 0.
    niwgf: float = 0.
    niwbf: float = .35
    niwlf: float = .5

    # shortwave absorption
    swamth: str = 'jerlov'
    jwtype: int = 3
    chlopt: str = 'climatology'

    # relaxation
    trxday: float = 0.
    srxday: float = 0.
    trxdpt: float = 1.
    srxdpt: float = 1.
    trxlim: float = 1.5
    srxlim: float = .5
    aptflx: bool = False
    apsflx: bool = False
    ditflx: bool = False
    disflx: bool = False
    srxbal: bool = False

    # diagnostics / io
    itest: int = 0
    jtest: int = 0
    cnsvdi: bool = False
    csdiag: bool = False
    rstfrq: int = 30

    # channel width modifications (&CWMOD, mod_geoenv.F90:64,777-862):
    # tuple of (cwmtag, cwmedg, cwmi, cwmj, cwmwth), consumed by
    # geoenv.apply_cwmod when the grid is read from file
    cwmod: tuple = ()

    # sub-groups
    vcoord: VCoordConfig = dataclasses.field(default_factory=VCoordConfig)
    ale: AleRegridRemapConfig = dataclasses.field(
        default_factory=AleRegridRemapConfig)
    diffusion: DiffusionConfig = dataclasses.field(
        default_factory=DiffusionConfig)

    # diagnostic output groups of &DIAPHY (GLB_* arrays,
    # mod_dia.F90:278-344), io.dia.DiaGroupCfg
    dia_groups: tuple = ()

    # numerics of the implementation (no reference equivalent)
    dtype: str = 'float64'        # compute dtype for prognostic state
    sum_dtype: str = 'float64'    # dtype for global reductions


def _fill(dc, entries: dict):
    """Set dataclass fields present in a parsed namelist group (lower-cased)."""
    names = {f.name for f in dataclasses.fields(dc)}
    for k, v in entries.items():
        key = k.lower()
        if key in names:
            setattr(dc, key, v)
    return dc


def load_limits(path: str) -> RunConfig:
    """Build a RunConfig from a BLOM `limits` namelist deck."""
    groups = nml.read_namelist_file(path)
    cfg = RunConfig()
    if 'LIMITS' in groups:
        _fill(cfg, groups['LIMITS'])
    if 'VCOORD' in groups:
        _fill(cfg.vcoord, groups['VCOORD'])
    if 'ALE_REGRID_REMAP' in groups:
        _fill(cfg.ale, groups['ALE_REGRID_REMAP'])
    if 'DIFFUSION' in groups:
        _fill(cfg.diffusion, groups['DIFFUSION'])
    if 'CWMOD' in groups:
        g = {k.lower(): v for k, v in groups['CWMOD'].items()}

        def _aslist(x):
            return list(x) if isinstance(x, (list, tuple)) else [x]

        tags = _aslist(g.get('cwmtag', []))
        cfg.cwmod = tuple(
            (tag, edg, int(ci), int(cj), float(w))
            for tag, edg, ci, cj, w in zip(
                tags, _aslist(g.get('cwmedg', [])),
                _aslist(g.get('cwmi', [])), _aslist(g.get('cwmj', [])),
                _aslist(g.get('cwmwth', []))))
    if 'DIAPHY' in groups:
        from ..io.dia import load_diaphy
        cfg.dia_groups = tuple(load_diaphy(groups))
    return cfg
