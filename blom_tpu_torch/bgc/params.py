"""BGC tracer indices and parameters.

A copy of `blom_tpu/bgc/params.py`, which imports no JAX (the port keeps
its own copy of every module it needs).  Counterpart of BLOM's index
module hamocc/mo_param1_bgc.F90 (base tracer block) and parameter module
hamocc/mo_param_bgc.F90.  BLOM assigns indices at runtime from namelist
switches; here the base configuration (no AGG / cisonew / natDIC / CFC /
extNcycle / DOMclasses / BROMO, sediment bypassed) is a static index
namespace, and every rate constant is a field of one NamedTuple.

Rates are stored in their reference units (1/day, m/day) and scaled by
the per-step `dtb` (timestep in days) inside the process code; BLOM
folds dtb in at init (mo_param_bgc.F90:829-846).
"""

from __future__ import annotations

from typing import NamedTuple


class BgcTracers:
    """Indices within the BGC tracer block (offsets from itrbgc).

    Order mirrors the reference base set (mo_param1_bgc.F90:158-175,
    i_base = 18) + the hi slot (mo_carbch `hi` persistent field).
    """
    sco212 = 0    # DIC [kmol C m-3]
    alkali = 1    # total alkalinity [keq m-3]
    phosph = 2    # phosphate
    oxygen = 3    # dissolved O2
    gasnit = 4    # dissolved N2
    ano3 = 5      # nitrate
    silica = 6    # silicate
    doc = 7       # dissolved organic carbon (P units)
    phy = 8       # phytoplankton (P units)
    zoo = 9       # zooplankton (P units)
    det = 10      # detritus / POC (P units)
    calc = 11     # calcite shells
    opal = 12     # biogenic silica
    an2o = 13     # laughing gas N2O
    dms = 14      # dimethyl sulfide
    iron = 15     # dissolved iron
    fdust = 16    # non-aggregated dust
    dicsat = 17   # saturated DIC diagnostic tracer
    hi = 18       # hydrogen-ion concentration (pH solver state)


NBGC = 19

#: names in index order (restart/diagnostic labelling)
TRACER_NAMES = (
    'sco212', 'alkali', 'phosph', 'oxygen', 'gasnit', 'ano3', 'silica',
    'doc', 'phy', 'zoo', 'det', 'calc', 'opal', 'an2o', 'dms', 'iron',
    'fdust', 'dicsat', 'hi')


class TracerIndex(BgcTracers):
    """Base index namespace extended with optional tracer blocks; build
    with make_tracer_index.  Mirrors the reference's runtime index
    assignment from compile/namelist switches
    (mo_param1_bgc.F90:158-320: i_base, then conditional blocks for
    cisonew/AGG/CFC/natDIC/BROMO/extNcycle/shelfsea)."""
    ntotal = NBGC
    names = TRACER_NAMES


def make_tracer_index(use_bromo=False, use_extncycle=False,
                      use_natdic=False, use_shelfsea=False,
                      use_cfc=False, use_ciso=False):
    """Assign extension tracer slots after the base block in the
    reference's canonical order (mo_param1_bgc.F90:176-320).  Returns a
    TracerIndex subclass with .ntotal and .names."""
    ns = type('TI', (TracerIndex,), {})
    nxt = NBGC
    names = list(TRACER_NAMES)

    def add(*tags):
        nonlocal nxt
        for tag in tags:
            setattr(ns, tag, nxt)
            names.append(tag)
            nxt += 1

    if use_ciso:           # i_iso block (mo_param1_bgc.F90:334-346)
        add('sco213', 'sco214', 'doc13', 'doc14', 'phy13', 'phy14',
            'zoo13', 'zoo14', 'det13', 'det14', 'calc13', 'calc14')
    if use_cfc:            # icfc11/icfc12/isf6 (mo_param1_bgc.F90:252-262)
        add('cfc11', 'cfc12', 'sf6')
    if use_natdic:         # inatsco212/inatalkali/inatcalc (:382-391);
        # nathi is a module field in the reference (mo_carbch.F90:91) —
        # here a slot like the base hi
        add('natsco212', 'natalkali', 'natcalc', 'nathi')
    if use_bromo:          # ibromo (:276-283)
        add('bromo')
    if use_extncycle:      # ianh4/iano2 (:293-301)
        add('anh4', 'ano2')
    if use_shelfsea:       # ishelfage (:303-310)
        add('shelfage')
    ns.ntotal = nxt
    ns.names = tuple(names)
    return ns


class BgcParams(NamedTuple):
    """Static BGC parameters (defaults = mo_param_bgc.F90 base values,
    WLIN sinking as in the standard NorESM configuration)."""

    # stoichiometry (mo_param_bgc.F90:158-173)
    ro2ut: float = 172.
    rcar: float = 122.
    rnit: float = 16.
    riron: float = 5. * 122. * 1.e-6
    rdnit0: float = 0.8 * 172.
    rdnit1: float = 0.8 * 172. - 16.
    rdnit2: float = 0.4 * 172.
    rdn2o1: float = 2. * 172. - 2.5 * 16.
    rdn2o2: float = 2. * 172. - 2. * 16.

    # light (mo_param_bgc.F90:260-264)
    atten_w: float = 0.04
    atten_c: float = 0.03 * 122. * (12. / 60.) * 1.e6
    pi_alpha: float = 0.02 * 0.4

    # phytoplankton (mo_param_bgc.F90:281-301)
    phytomi: float = 1.e-11
    bkphy: float = 4.e-8
    dyphy: float = 0.004
    bluefix: float = 0.005
    tf2: float = -0.0042
    tf1: float = 0.2253
    tf0: float = -2.7819
    tff: float = 0.2395

    # zooplankton (mo_param_bgc.F90:307-315; zinges/epsher are the
    # vcoord-dependent defaults for cntiso_hybrid, :663-664)
    grami: float = 1.e-10
    bkzoo: float = 1.e-7
    grazra: float = 1.5
    spemor: float = 3.e6
    gammap: float = 0.03
    gammaz: float = 0.06
    ecan: float = 0.95
    zinges: float = 0.7
    epsher: float = 0.8

    # export production (mo_param_bgc.F90:333-336; WLIN/M4AGO branch
    # of ini_param_biol, :677-679 — the standard NorESM values; the
    # AGG branch uses 14/10.5, the legacy base 40/30)
    bkopal: float = 1.e-5
    rcalc: float = 7.
    ropal: float = 80.

    # remineralization (mo_param_bgc.F90:341-357)
    o2thresh_aerob: float = 5.e-8
    o2thresh_hypoxic: float = 5.e-7
    no3thresh_sulf: float = 3.e-6
    remido: float = 0.004
    drempoc: float = 0.025
    drempoc_anaerob: float = 1.25e-3
    dremopal: float = 0.008
    dremcalc: float = 0.0045
    dremn2o: float = 0.01
    dremsul: float = 0.005

    # iron (mo_param_bgc.F90:272-276)
    fesoly: float = 0.55e-9
    relaxfe: float = 0.05 / 365.

    # DMS (mo_param_bgc.F90:497-502)
    dmsp1: float = 10.
    dmsp2: float = 0.0011
    dmsp3: float = 0.1296
    dmsp4: float = 1.25 * 0.10
    dmsp5: float = 0.0136
    dmsp6: float = 0.1e-07

    # sinking (mo_param_bgc.F90:518-525); use_wlin = depth-increasing
    # POC speed min(wmin + wlin z, wmax)
    use_wlin: bool = True
    wpoc_const: float = 5.
    wcal_const: float = 30.
    wopal_const: float = 30.
    # Stokes settling of 1 um quartz (mo_param_bgc.F90:758-761)
    wdust_const: float = (9.81 * 86400. / 18. * (2600. - 1025.) / 1.567
                          * 1000. * 1.e-8 * 1.e-4)
    wmin: float = 5.75
    wmax: float = 60.
    wlin: float = 0.0142

    # atmosphere mixing ratios (mo_param_bgc.F90:226-231 + atm_co2 deck)
    atm_co2: float = 284.7    # ppm
    atm_o2: float = 196800.   # ppm
    atm_n2: float = 802000.   # ppm
    atm_n2o: float = 270.1e3  # ppt

    # vertical grid thresholds (mo_vgrid.F90:41-50)
    dp_min: float = 1.e-12
    dp_min_sink: float = 1.
    dp_ez: float = 100.

    # pH solver (mo_carchm.F90:31-49)
    niter: int = 20
    ah_min: float = 1.e-11
    ah_max: float = 1.e-5

    sedbypass: bool = True
