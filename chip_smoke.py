#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blom_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # on cuda:0

Phases, each reported as one JSON line; any failure exits nonzero:

1. the card: name and power limit from nvidia-smi;
2. build: the four CUDA sources compiled by nvcc for sm_90a from
   blom_tpu_torch/csrc (one nvcc each, all at once; every variant is an
   instantiation of its kernel's template), with ptxas registers, stack
   frames, spills and static shared memory of every instantiation, and
   the dynamic shared memory of a block of the CPPM sweep on each axis,
   of each momentum instantiation and of ALE K1 and K2 at the main
   path's kk; it fails if an instantiation of the CPPM sweep, K1 or K2
   has a stack frame or spills;
3. kernels: each kernel in each variant against its plain PyTorch
   version on the card, at the main path's shapes (kk=53, J=360, I=384;
   the momentum core also on a tripolar grid, its fold pre-pass first;
   two CPPM tracers, and the main variant also at NT_CHECK's 0, 1 and 3
   on both axes; the ALE remap with ntr 0 and 5, and 37 for the main
   path's limiters: many chunks of fields, beyond any fixed cap on the
   tracers): the CPPM sweep in its four (compatibility, limiting)
   variants on both axes, the momentum core in its three schemes, ALE
   K1 and K2 with each of the
   three limiters (K2 also with the tracer and velocity limiters of the
   channel deck B), in f64 (rtol = atol = 1e-12) and in f32 (max |err| <=
   F32_REL * max |ref| per output); median time of the kernel and of the
   plain version from CUDA events, the bound from the bytes each call
   must move and the operations its loops do, and the momentum kernel's
   own device time from torch.profiler; then K1 and K2 in each limiter at
   KK_DEEP levels on a small ragged grid, against their plain versions in
   f64 and f32: neither has a cap on the levels below what its tile fits
   in shared memory;
4. slice: the full fuk95 step (ALE regrid/remap, lateral and vertical
   mixing) with bench.py's physics at 384x360x53 in f32 through
   build_fuk95 and run, for 10 and for 11 steps after a warm-up: finite
   fields, mass drift, salinity near 35 (SALN_DEV_ALE), launch counts
   (CPPM 2, momentum 1, ALE regrid 1 and ALE remap 1 per step, all in
   the main path's variants), the eddy-transport limiter's
   host syncs per step, seconds per step and grid-points/s; then the
   device time of each phase of the step, from the events blom_step
   records; then the adiabatic core alone (par._replace(ale=None,
   vmix=None, difest=None)) for a few steps;
5. parity: the full step at 24x8x8 in f64 on the card against the CPU,
   one step at each time-level parity (gated), and 4 driver steps
   (reported);
6. isopyc: fuk95 in the isopycnic coordinate (isopyc_bulkml: convec,
   diapfl, mxlayr, eddtra_isopyc) with bench.py's physics at 384x360x53
   in f32, 10 timed steps after a 2-step warm-up: finite fields, mass
   drift, the mixed layer's thickness over water within ISOPYC_ML,
   launches (CPPM 2 and momentum 1 per step, no ALE kernel), host
   syncs, seconds per step and grid-points/s, then the device time of
   each phase; isopyc_kernels: the inputs of the CPPM sweep on both axes
   and of the momentum core in one step from the warmed-up state (many
   layers massless, counted), each kernel against its plain version in
   f32 (F32_REL) and on the same inputs in f64 (1e-12); isopyc_parity:
   one f64 step of each time-level parity at 24x8x10, card against CPU;
7. tracers: fuk95 with the ideal age and the BGC base chain (20
   tracers) with bench.py's physics at 384x360x53 in f32, 10 timed steps
   after 2: the slice's gates, the BGC's (oxygen and the hydrogen ion in
   range over water, total phosphorus drifting by at most P_DRIFT_FACTOR
   times blom_tpu's own f32 drift) and the age's, launches per step as
   the main path's, host syncs no more than the main path's, s/step,
   grid-points/s and the device time of each phase; tracers_kernels: the
   CPPM sweep's inputs on both axes (nt 22) and ALE K2's (ntr 20) from
   one step of the warmed-up run, each kernel against its plain version
   in f32 and in f64, timed beside its plain version and its bound;
   tracers_isopyc: the isopycnic fuk95 with the BGC (NOIIAOC) at
   384x360x53 in f32, 2 timed steps after 1, the isopyc gates and the
   BGC's; tracers_isopyc_kernels: the CPPM sweep on both axes (nt 21)
   on the inputs of one step of that run (massless layers, counted),
   checked and timed as tracers_kernels (no K2 call); on both tracer
   paths every CPPM and K2 launch must carry the path's tracer count
   (recorded in the run by observe_carried); tracers_parity: one f64
   step of each time-level parity of the tracer step at 24x8x8, card
   against CPU, the tracers one by one;
   ciso: fuk95 with the BGC and its carbon isotopes (NOINYOCISO, 31
   tracers) with bench.py's physics at 384x360x53 in f32, 10 timed steps
   after 2: the slice's gates, the BGC's (P_DRIFT_REF['ciso']), delta13C
   of DIC over water within D13C_RANGE and Delta14C finite, launches and
   host syncs as the tracer path's, every CPPM launch carrying 33 fields
   and every K2 launch 31 tracers, s/step, grid-points/s and the device
   time of each phase; ciso_kernels: the CPPM sweep on both axes (nt 33)
   and K2 (ntr 31) on the inputs of one step of that run, checked and
   timed as tracers_kernels; ciso_budget: one hamocc_step at 384x360x53
   in f64 under full ice, the 13C inventory conserved and the 14C
   inventory scaled by c14dec within CISO_BUDGET_RTOL; ciso_parity: one
   f64 step of each time-level parity at 24x8x8, card against CPU, the
   31 tracers one by one; sediment: hamocc_step_with_sediment on
   NOINYOC's state at 384x360x53 in f32 with the detritus seeded, 4
   calls: finite tracers and sediment, POC gained in every wet column,
   ms per call and the inventory's totals with the sediment before and
   after;
8. decks: each limits deck of DECKS (D with the geopotential PGF,
   DECK_PGFMTH; its phases also timed as fuk95) (written under build/decks/) built
   by the port's build_case, first as fuk95 at 384x360x53 in f32 for 4
   timed steps after a 1-step warm-up, then as the channel at its full
   208x512 width with 16 layers in f64 for one timed step after a
   one-step warm-up (CHANNEL_KDM, CHANNEL_DTYPE: see there), the runs
   each from the initial state: finite fields, mass drift, salinity near
   35, for the channel moving water (CHANNEL_SPEED), the launches of
   every (kernel, instantiation) per step, seconds per step and
   grid-points/s; for the channel then one f64 step of each time-level
   parity at 24x32x10 on the card against the CPU (gated);
9. tripolar: the synthetic tripolar grid (the Arctic bipolar fold,
   NOINYARCTIC) through build_tripolar at 384x360x53 in f32, 10 timed
   steps after 2: finite fields, the mass of the physical rows (all but
   the fold's duplicated top row) drifting by at most 1e-5, salinity
   near 35 (SALN_DEV_ALE), transport across the seam, launches per step
   (CPPM 2, momentum 1 and its fold pre-pass 1, K1 1, K2 1), host syncs
   no more than the main path's, s/step, grid-points/s and the device
   time of each phase (the fold's sync among them); tripolar_kernels:
   the CPPM sweep's inputs on both axes (the j-sweep's 363 rows, three
   of them fold ghosts) and the momentum core's from one step of the
   warmed-up run, each kernel against its plain version in f32 and in
   f64, timed beside its plain version and its bound;
   tripolar_symmetry: 4 steps at SYMMETRY_SIZE with the port's
   end-of-step fold sync replaced by the identity, the asymmetry of
   every field of STATE_KINDS within SYMMETRY_FACTOR times blom_tpu's
   own f32 asymmetry, run op by op (tripolar_symmetry_reference.py), or
   SYMMETRY_ULPS ulps of the field's largest magnitude; tripolar_parity:
   one f64 step of each time-level parity at 16x12x6 from a state three
   steps in, card against CPU;
10. the vertical physics: kpp, fuk95 with bench.py's physics, KPP with
   the tidal term (twedon from SEED in TWEDON_RANGE over water, written
   under build/tidal/ and read back with read_tidaldissip) under a wind
   stress, a cooling and a seeded Langmuir factor, at 384x360x53 in f32
   for 10 timed steps after 2: the slice's gates, launches per step as
   the main path's, host syncs per step no more than its, s/step,
   grid-points/s and the device time of each phase, then
   difest_vertical_kpp and the tidal term on the final state
   (kpp_gates); kpp_parity: one f64 step of each time-level parity at
   24x8x8 with KPP, the tidal field and the geopotential PGF, card
   against CPU; tke: the isopycnic fuk95 with the TKE/GLS closure (two
   tracer slots, itrtke 0, itrgls 1) at 384x360x53 in f32, 3 timed steps
   after 1: the isopycnic gates, both slots at their floors or above
   over water and TKE above twice its floor somewhere, launches (CPPM 2,
   momentum 1 a step), every CPPM launch at 4 fields, s/step and the
   phase times; tke_kernels: the CPPM sweep at nt 4 on both axes on the
   inputs of one step of that run (massless layers, counted), checked
   and timed as tracers_kernels; tke_parity: one f64 step of each parity
   at 24x8x10, card against CPU, the slots one by one (deck D, the main
   path's variants with the geopotential PGF, runs among the decks);
   highorder: fuk95 with bench.py's physics at 384x360x53 in f32 under
   each ALE method that runs off kernels K1 and K2 (HIGHORDER_VARIANTS:
   PPM with implicit ih4 edges, PQM with ih6/ih5 edges and slopes, the
   direct regrid), 4 timed steps from the initial state after 2: the
   slice's gates (salinity within SALN_DEV_DIRECT under the direct
   regrid), launches per step (CPPM 2, momentum 1, K1 0, K2 0), s/step,
   the device time of each phase with the ALE phase apart, and the peak
   device memory allocated; highorder_drift: the direct regrid in f32 at
   SALN_REF_SIZE for those 4 steps, its salinity beside blom_tpu's own
   (SALN_REF) within SALN_DEV_DIRECT; highorder_parity: one f64 step of
   each time-level parity under each method at 24x8x8, card against
   CPU; transport: fuk95 with bench.py's physics at 384x360x53 in f32
   under each lateral transport option (TRANSPORT_VARIANTS:
   incremental-remapping advection, advmth='remap', in place of the
   CPPM sweeps; neutral diffusion, ltedtp='neutral', in place of the
   along-layer diffus), 4 timed steps from the initial state after 2:
   the slice's gates, launches per step (remap: CPPM 0, momentum 1, K1
   1, K2 1; neutral: CPPM 2, momentum 1, K1 1, K2 1), s/step,
   grid-points/s, the device time of each phase with 'advect' and
   'ndiff' apart, the peak device memory allocated, and one call of the
   option's phase under torch.profiler (its device launches and busy
   share); transport_parity: one f64 step of each time-level parity
   under each option at 24x8x8, card against CPU;
11. surface: fuk95 with bench.py's physics at 384x360x53 in f32 under
   surface restoring (SURFACE_VARIANTS: ThermfParams(trxday=30.,
   srxday=30.) on the ALE coordinate, the same with the
   chlorophyll_ohl03 shortwave from updswa of a seeded log10-chl
   climatology under 200 W m-2 of shortwave heating, and the isopycnic
   coordinate), towards an SSS
   climatology read by rdcsss from a seeded .npz with a block of missing
   values and an SST one interpolated from 48 seeded slices by
   clim_indices/intp1d, both within 3 C and 1 g/kg of the top layer, 4
   timed steps after 2 (isopycnic 2 after 1): the slice's gates (the
   isopycnic ones there), the restoring fluxes of the last step nonzero
   over water, zero on land and within their clamp bounds (reached),
   launches per step (ALE: CPPM 2, momentum 1, K1 1, K2 1; isopycnic:
   CPPM 2, momentum 1), s/step, the 'thermf' phase's device time and the
   peak device memory; on the isopycnic path also diapfl with settemmin's
   per-layer floor on the final state; surface_parity: one f64 step of
   each time-level parity under each variant at 24x8x10, card against
   CPU; ben02: the ben02 chain (asflux, thermf_ben02 growing and melting
   ice, sfcstr_ben02) on seeded fields and niw_ke_tendency on the
   restoring path's final state at 360x384 in f64 on the card against
   the CPU within BEN02_REL, then the chain in f32 on the card: finite,
   0 <= ficem <= fice_max, hicem >= 0;
12. diagnostics: the fuk95 main path with the instrumentation on
   (bench.py's physics, 384x360x53 f32): every registry id of io/dia.py
   that the path defines at 'ave', one each of min, max and sq on
   mixed-layer and sst ids and every MSC id in three groups, with cnsvdi
   and chk, 4 timed steps after 2, beside the same steps without it:
   the slice's gates, every ok flag, nacc, the accumulators finite over
   water, the budget's relative mass change, launches per step as the
   main path's, host syncs in the timed steps (eddtra's counter and the
   synchronizing calls that torch.cuda.set_sync_debug_mode counts) no
   more than without it and none but eddtra's; s/step of both, the
   device ms per step of accumulate and of the budget checkpoints, the
   peak device memory, the seconds and bytes of write_netcdf and
   write_netcdf_compressed; dia_parity: one f64 step of each time-level
   parity with the instrumentation at 24x8x8, card against CPU, the
   accumulators and budget sums within STEP_REL (the diffusive salt
   fluxes, rounding alone in fuk95, of the diffusive heat fluxes);
   restart: ERS (4 steps straight against 2, write_restart, read_restart
   onto the card, 2) for NOINY and NOINYAGE at 384x360x53 f32, every
   State field bit for bit, the write and read seconds and the file
   size; run_case: a deck with &DIAPHY (DIA_DECK: a sub-daily and a
   compressed group) through build_case and run_case at 384x360x53 f32
   for 4 steps: the files tests/test_dia_groups.py expects, sst finite
   over water, the restart, run.status and the final dp CRC;
13. the other configurations and the coupled cap: coupled, the cap at
   NorESM's tnx1 shape (384x360x53 in f32, tripolar): a NetCDF grid file
   of build_tripolar's geometry (5500 m deep, qlat from plat) and a
   WOA-shaped initial-condition file (t_an, s_an, depth_bnds on the 33
   standard levels to 5500 m, build_gridfile's fallback profile warmer
   by 4 K * cos(plat)), both from blom_tpu_torch/tools/gridfiles.py,
   under build/coupled/, build_gridfile(expcnf='cesm', arctic=True) on
   the card, OcnCap with 20 steps an interval (an hour): data_initialize,
   one interval of warm-up and one timed under tests/test_coupled.py's
   imports (the shortwave scaled by max(cos(plat), 0)); gates: fields
   finite, physical-row mass drift <= 1e-5, launches per step (CPPM 2,
   momentum 1, its fold pre-pass 1, K1 1, K2 1), the synchronizing calls
   of the timed interval no more than eddtra's counter, every export
   finite over water and zero on land, So_t within the initial surface
   range +-2 K, the two 30-level profiles 1e30 exactly in the bins below
   the sea floor, the freezing potential >= 0; reported: the build's
   seconds (grid read, inicon_woa), s/step, grid-points/s, the export's
   ms and the peak memory; coupled_parity: build_gridfile(arctic=True)
   at 32x24x6 in f64 from the same kind of files, one interval of 2
   steps on the card against the CPU, every State field and export
   within STEP_REL; single_column: build_single_column on the card for
   48 steps in f64 (tests/test_configs.py's checks) and in f32 (finite,
   the thermocline above 5 K, max |u| and the heat drift within 10x
   blom_tpu's own f32 readings, SC_F32_REF), launches per step (CPPM 2,
   momentum 1, K1 1, K2 1); short_period_check: check_cppm,
   check_momtum and check_ale where an axis is shorter than their
   stencils, exact (max |err| 0.0) in f64 and f32: the CPPM sweep in
   each variant on periodic lines of length 1, 2 and 3 along i and j
   and on 1x1, the momentum core in each scheme periodic in both axes
   at (J, I) of MOMTUM_SHORT, K1 and K2 in each limiter on one column of
   25 levels, each timed at 1x1; testsuite: the port's compset runner
   over its whole TESTLIST on the card, every line PASS; then for each
   of its compsets at the runner's own shape (f64, 32x16x6, the
   tripolar grid 32x24x6) runner_parity, one step of each time-level
   parity on the card against the CPU from the state two CPU steps
   reach, within STEP_REL, and runner_kernels, every kernel launch of
   that step exact against its plain version on the step's inputs;
14. sharded_barotp: the margin-k barotropic solver
   (dynamics/barotp_shmap.py) in the step through StepParams.barotp_fn,
   on a mesh of blocks stacked in one process: fuk95 with bench.py's
   physics at 384x360x53 in f32 on a 2x2 mesh of 180x192 blocks, one
   warm-up step and then NSTEPS_SHARDED steps from the same state with
   the plain solver and with the blocks, every State and diffusion
   field equal bit for bit after each step, and one f64 step the same;
   the synthetic tripolar grid at that size in f32, one step from a
   warmed-up state on meshes 1x2 and 2x2, bitwise across the two and
   within STEP_REL of the plain step; each blocks solver is called once
   before its steps (its exchanges' constant tensors reach the card
   then), and in every step it makes no more synchronizing calls
   (count_syncs) than the plain solver; reported: s/step and barotp ms
   of both solvers (CUDA events), exchanges per step, synchronizing
   calls per step, and the launches of the four kernels in the blocks'
   steps (as the main path's);
15. the kernels summary line (with the tracer counts each kernel met,
   its tripolar inputs, its short-period checks and its checks on the
   runner's inputs) and the script's
   total seconds, then the device line last.  It fails if a variant of a
   kernel launched on none of the paths (fuk95, the core, the isopycnic
   path, the tracer paths, the carbon-isotope path, the decks, the
   tripolar grid, the vertical physics, the high-order ALE methods, the
   transport options, the surface physics, the instrumented path, the
   restarts, run_case, the cap, the single column, the runner, the
   sharded barotropic solver).

Inputs are made from a fixed seed.  Without CUDA, or without the
package beside it, the script exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

SEED = 1234
KK, JJ, II, NT = 53, 360, 384, 2
NT_CHECK = (0, 1, 3)    # other tracer counts of the CPPM check (main variant)
F32_REL = 1e-4          # f32 kernel tolerance, relative to max |ref|
STEP_REL = 1e-5         # whole-step parity tolerance (see tests)
# salinity over water stays within these of its uniform 35: the adiabatic
# core keeps it to rounding; the ALE remap integrates each column from
# its top, and in f32 the difference of two such integrals over a thin
# destination layer loses ~1e-5 of 35 per step (blom_tpu's jnp ALE in
# f32 gives the same 2.4e-4 after one step at 96x32x53)
SALN_DEV = 1e-4
SALN_DEV_ALE = 5e-3
# The direct regrid's salinity gate.  That regrid keeps interior layers
# to 0.1 m and leaves the deepest wet layer of a column any thickness
# below it, so the remap's f32 rounding (above) moves salinity further
# than under the nudge regrid, and further each step as those layers
# thin.  SALN_REF is blom_tpu's own f32 direct run after the 4 steps
# from the initial state that `highorder` gates, at SALN_REF_SIZE
# (ale_drift_reference.py: CPU, 64-bit types off; the port beside it
# reads 1.22x that, blom_tpu's run is NaN by step 6, ROADMAP.md §3).
# The gate is twice SALN_REF; `highorder` also runs the port's direct
# regrid on the card at SALN_REF_SIZE for those steps against it.
SALN_REF_SIZE = dict(itdm=96, jtdm=64, kdm=53)
SALN_REF = 0.005245208740234375
SALN_DEV_DIRECT = 2. * SALN_REF
NTR_CHECK = (0, 5, 37)  # tracer counts of the ALE remap check
NTR_MANY = 37           # of those, checked in the main path's pair only
KK_DEEP, JJ_DEEP, II_DEEP = 80, 24, 41   # the ALE kernels' deep check
# The channel as blom_tpu builds it (ROADMAP section 3, each shown by
# blom_tpu itself on the CPU): with its 30 layers the initial sigma
# ladder reaches sigma 30.5, beyond the EOS at S = 35, so the initial
# temperature is NaN (16 layers is the most that stays finite); in f32
# its first ALE step is NaN next to the shelf's vanishing bottom layers;
# in f64 it turns NaN within a few steps (deck C at 16x24x8 after nine
# steps run op by op, tests/test_torch_case.py), and so does the port,
# at a step that depends on rounding.  The channel decks therefore run
# at the full 208x512 with 16 layers, in f64, for their first step only:
# a warm-up step and a timed step, each from the initial state; the port
# follows blom_tpu's first step to rounding (tests/test_torch_case.py).
# The decks run for 2 + 10 steps as fuk95.
CHANNEL_KDM = 16
CHANNEL_DTYPE = 'float64'
# max |u + ub| after the timed step [m s-1]: the wind (and the
# barotropic adjustment of the initial state, ~0.8 m s-1 in ub from the
# first step on, blom_tpu's too) must move the water, and no faster than
# this
CHANNEL_SPEED = (1e-4, 2.)
PARITY_CHANNEL = dict(ITDM=24, JTDM=32, KDM=10)
NSTEPS_ISOPYC = 10      # timed steps of the isopycnic path
# The tracer paths: fuk95 with the ideal age and the BGC base chain (20
# tracers: the CPPM sweep carries 22 fields, ALE K2 remaps 20 tracers),
# and the isopycnic fuk95 with the BGC (NOIIAOC, 19 tracers)
NSTEPS_TRACERS = (2, 10)            # warm-up, timed steps
NSTEPS_TRACERS_ISOPYC = (1, 2)
OXYGEN_RANGE = (0., 5e-4)   # over water (tests/test_bgc.py:217-219)
# the ideal age may go below 0 only by f32 rounding: after 10 steps the
# oldest water is 1.16e-4 years, whose f32 ulp is 7.3e-12, so 1e-10 is
# ~14 of its ulps (tests/test_tracers.py:27 allows 1e-14 in f64)
AGE_FLOOR_F32 = -1e-10
# total phosphorus may drift by f32 rounding of the transport; the gate is
# P_DRIFT_FACTOR times what blom_tpu's own f32 run shows on the CPU at
# 96x32x53 over the same steps (tracer_drift_reference.py), by path
# ('ciso': `JAX_PLATFORMS=cpu python3 tracer_drift_reference.py`, its
# third run, on an 8-core Intel Xeon; equal to the 'tracers' run's, as
# neither the age nor the isotopes feed back on the base tracers)
P_DRIFT_REF = {'tracers': -5.452903606428805e-08,
               'tracers_isopyc': 6.964558196820292e-08,
               'ciso': -5.452903606428805e-08}
P_DRIFT_FACTOR = 10.
PARITY_TRACERS = dict(itdm=24, jtdm=8, kdm=8)
# The carbon-isotope path (NOINYOCISO): fuk95 with the BGC and its 12
# isotope tracers (31 tracers: the CPPM sweep carries 33 fields, ALE K2
# remaps 31 tracers)
NSTEPS_CISO = (2, 10)               # warm-up, timed steps
D13C_RANGE = (-40., 20.)            # permil, tests/test_ciso.py:192-207
CISO_BUDGET_RTOL = 1e-9             # tests/test_ciso.py:144-189
PARITY_CISO = dict(itdm=24, jtdm=8, kdm=8)
NCALLS_SEDIMENT = 4                 # tests/test_sediment.py:157-190
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores

# The decks: BLOM `limits` namelists; each selects one momentum scheme,
# one CPPM variant and the ALE limiters, so that with the fuk95 main path
# every variant of every kernel runs.  Each is run as the channel (its
# time steps and coastal wave-breaking damping) and as fuk95 (its time
# steps; build_fuk95 keeps them whatever the deck says).
# {name: (MOMMTH, CPPM_COMPATIBILITY, CPPM_LIMITING, TRACER_LIMITING,
# VELOCITY_LIMITING)}
DECKS = {
    'A': ('enecon', 'partial', 'non_oscillatory', 'monotonic', 'monotonic'),
    'B': ('enedis', 'full', 'monotonic', 'non_oscillatory_posdef',
          'non_oscillatory'),
    'C': ('enscon', 'partial', 'monotonic', 'non_oscillatory',
          'non_oscillatory'),
    'D': ('enscon', 'full', 'non_oscillatory', 'non_oscillatory',
          'non_oscillatory'),
}
# {name: PGFMTH} where a deck leaves the dynamic-enthalpy default: deck D
# runs the main path's variants with the geopotential PGF
DECK_PGFMTH = {'D': 'geopotential'}
EXPERIMENTS = {'channel': dict(baclin='300.', batrop='10.', cwbdts='5.e-5'),
               'fuk95': dict(baclin='180.', batrop='6.', cwbdts='0.')}
DECK_TEXT = """\
! {expcnf} deck {name}
&LIMITS
  NDAY1    = 0,
  NDAY2    = 1,
  EXPCNF   = '{expcnf}',
  BACLIN   = {baclin},
  BATROP   = {batrop},
  CWBDTS   = {cwbdts},
  CWBDLS   = 25.,
  MOMMTH   = '{mommth}',
  PGFMTH   = '{pgfmth}',
  CPPM_COMPATIBILITY = '{compat}',
  CPPM_LIMITING      = '{lim}',
  DTYPE    = '{dtype}'
/
&ALE_REGRID_REMAP
  TRACER_LIMITING   = '{tlim}',
  VELOCITY_LIMITING = '{vlim}'
/
"""


def deck_text(name, dtype, expcnf='channel'):
    """The limits deck `name` of DECKS for `expcnf`, computing in
    `dtype`."""
    mommth, compat, lim, tlim, vlim = DECKS[name]
    return DECK_TEXT.format(name=name, expcnf=expcnf, mommth=mommth,
                            pgfmth=DECK_PGFMTH.get(name, 'dynamic enthalpy'),
                            compat=compat, lim=lim, tlim=tlim, vlim=vlim,
                            dtype=dtype, **EXPERIMENTS[expcnf])


def emit(phase, **kw):
    print(json.dumps({'phase': phase, **kw}), flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


KERNEL_NAMES = ('cppm_sweep_kernel', 'momtum_uv_kernel', 'momtum_fold_kernel',
                'ale_regrid_kernel', 'ale_remap_kernel')


def short_name(mangled):
    """'cppm_sweep_kernel<f,1,0>' for the mangled name of an instantiation
    (type f or d, then the integer and bool template arguments)."""
    for name in KERNEL_NAMES:
        i = mangled.find(name)
        if i < 0:
            continue
        rest = mangled[i + len(name):]
        if not rest.startswith('I'):
            return name
        args = re.findall(r'L[ib](\d+)E|([fd])(?=L|E)', rest[1:])
        return name + '<' + ','.join(a or b for a, b in args) + '>'
    return mangled


def ptxas_summary(log):
    """{function: {'registers': n, 'static_smem': b, 'stack_frame': b,
    'spill_stores': b, 'spill_loads': b}} from nvcc's -Xptxas -v output,
    for every kernel instantiation and every device function compiled on
    its own.  Dynamic shared memory is sized at launch (momentum:
    momentum_smem; CPPM: by the line length of the call)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) or \
            re.search(r'Function properties for (\w+)', line)
        if m:
            name = short_name(m.group(1))
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            out.setdefault(name, {})['spill_stores'] = int(m.group(1))
            out[name]['spill_loads'] = int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out.setdefault(name, {})['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', line)
            out[name]['static_smem'] = int(m.group(1)) if m else 0
        m = re.search(r'(\d+) bytes stack frame', line)
        if m and name:
            out.setdefault(name, {})['stack_frame'] = int(m.group(1))
    return out


def time_ms(fn, reps=20, warm=3):
    """Median milliseconds of one call, from CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def compare(outs, refs, dtype):
    """(ok, max_abs_err, max_rel_err) over matching output tensors."""
    import torch
    ok, worst_abs, worst_rel = True, 0.0, 0.0
    for o, r in zip(outs, refs):
        if r.numel() == 0:           # no tracers
            ok &= tuple(o.shape) == tuple(r.shape)
            continue
        err = (o - r).abs()
        scale = float(r.abs().max())
        e = float(err.max())
        worst_abs = max(worst_abs, e)
        worst_rel = max(worst_rel, e / max(scale, 1e-300))
        if dtype == torch.float64:
            ok &= bool((err <= 1e-12 * (1. + r.abs())).all())
        else:
            ok &= e <= F32_REL * scale
        ok &= bool(torch.isfinite(o).all())
    return ok, worst_abs, worst_rel


# ---------------------------------------------------------------- kernels

_CPPM_COEFFS = {}


def cppm_inputs(ax, periodic, dtype, dev, nt=NT, shape=(KK, JJ, II)):
    import numpy as np
    import torch
    from blom_tpu_torch.dynamics.cppm import CppmCoeffs, init_cppm_coeffs
    KK, JJ, II = shape
    rng = np.random.default_rng(SEED)
    ip = np.ones((JJ, II))
    ip[rng.uniform(size=(JJ, II)) < .02] = 0.
    if not periodic:
        # closed ends of the sweep axis, as the fuk95 walls
        if ax == -1:
            ip[:, 0] = ip[:, -1] = 0.
        else:
            ip[0, :] = ip[-1, :] = 0.
    dx = rng.uniform(.6, 1.5, (JJ, II))
    # the host set-up of the coefficients, in f64, once per axis and
    # periodicity; a dtype conversion rounds as building in it does
    key = (ax, periodic, shape)
    if key not in _CPPM_COEFFS:
        _CPPM_COEFFS[key] = init_cppm_coeffs(ip, dx, axis=ax,
                                             periodic=periodic)
    co = CppmCoeffs(*[c.to(device=dev, dtype=torch.int32 if
                           c.dtype == torch.int32 else dtype)
                      for c in _CPPM_COEFFS[key]])
    h = rng.uniform(.2, 2., (KK, JJ, II))
    p = np.concatenate([np.zeros((1, JJ, II)), np.cumsum(h, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)
    args = (t(h), t(rng.uniform(1., 4., (nt, KK, JJ, II))),
            t(rng.uniform(-.3, .3, (KK, JJ, II))),
            t(rng.uniform(5., 12., (JJ, II))), t(p[:-1]), t(p[1:]),
            t(1. / rng.uniform(.8, 1.2, (JJ, II))))
    div = t(rng.uniform(-.1, .1, (KK, JJ, II)))
    return co, args, div


# rows of each of tmc0/tmcl/tmcr that the LU solve of a cell's stencil
# class needs (the kernel loads all 12, in the sectors its warp reads
# anyway), by class tag
# S0000, S1111, S1110, S0111, S1100, S0110, S0011, S0100, S0010
TMC_ROWS = (0, 12, 9, 9, 6, 6, 6, 0, 0)


def cppm_bytes(dtype, has_div, compat, lim, stencil, nt=NT, n3_planes=0,
               shape=(KK, JJ, II)):
    """Bytes the sweep in variant (compat, lim) must move: each 3-D input
    and output once, and the planes it reads: db, ai, hevc (4), ssc, scc,
    d2m (non-oscillatory only) and, with full compatibility, the int32
    stencil class and the tmc rows of each cell's class in `stencil`;
    `n3_planes` of db and ai given as 3-D fields instead; `shape` the
    (kk, J, I) of the sweep's fields."""
    import torch
    kk, jj, ii = shape
    es = torch.finfo(dtype).bits // 8
    n3 = 4 + int(has_div) + nt + 2 + 2 * nt + n3_planes   # in + out, 3-D
    n2 = 2 - n3_planes + 4 + 2 + int(lim == 'non_oscillatory')
    nbytes = es * (n3 * kk * jj * ii + n2 * jj * ii)
    if compat == 'full':
        rows = torch.tensor(TMC_ROWS)[stencil.long().cpu()].sum()
        nbytes += 4 * jj * ii + es * 3 * int(rows)
    return nbytes


# arithmetic operations per cell of the CPPM kernel on its longest branch
# (counted from csrc/cppm_sweep.cu): ~210 for the thickness part and the
# compatible-edge LU solve, ~170 per tracer.  An upper count for every
# variant; its time is below the bytes' time in each of them.
def cppm_ops_per_cell(nt=NT):
    return 210 + 170 * nt


# per point of the momentum kernel, each intermediate once (counted from
# csrc/momtum_uv.cu, a division or square root as one): ~62 for the total
# velocities, weights and dpmx, ~78 for dl2u/dl2v, potvor, defor1/2 and
# ke, 54 for the viscosities, 50 for uflux1/vflux1, ~220 for the update
# of u and v in enscon; enedis adds ~60 for its flux bounds and upwind
# selection.  The count of enedis, for every scheme.
MOMTUM_OPS_PER_POINT = 525


def bound(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F32_FLOPS * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


CPPM_VARIANTS = (('full', 'non_oscillatory'), ('full', 'monotonic'),
                 ('partial', 'non_oscillatory'), ('partial', 'monotonic'))


def check_cppm(dev, results, lines=None, exact=False,
               label='kernel_check'):
    """The CPPM sweep in each variant, with and without div_corr, in f64
    and f32, against its plain version: on `lines`, (ax, periodic, shape,
    timed) each, or by default the main path's grid on both axes and
    periodicities, timed where the main path sweeps (i closed, j
    periodic), then the main variant at NT_CHECK's tracer counts.  With
    `exact` every output must equal the plain one (max |err| 0.0), else
    be within `compare`'s tolerance.  A timed line times every variant
    in f32 on the main grid, the main variant with div_corr elsewhere."""
    import math
    import torch
    from blom_tpu_torch.dynamics import cppm, cppm_cuda
    main = lines is None
    if main:
        lines = [(ax, periodic, (KK, JJ, II), periodic == (ax == -2))
                 for ax in (-1, -2) for periodic in (False, True)]
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for ax, periodic, shape, timed in lines:
            co, args, div = cppm_inputs(ax, periodic, dtype, dev,
                                        shape=shape)
            for compat, lim in CPPM_VARIANTS:
                var = dict(compatibility=compat, limiting=lim)
                for d in (None, div):
                    ref = cppm._cppm_sweep_body(*args, co, periodic, d, ax,
                                                **var)
                    out = cppm_cuda.cppm_sweep_cuda(
                        *args, co, periodic, div_corr=d, ax=ax, **var)
                    torch.cuda.synchronize()
                    ok, eabs, erel = compare(out, ref, dtype)
                    if exact:
                        ok &= eabs == 0.
                    rec = dict(kernel='cppm_sweep',
                               variant=f'{compat}/{lim}',
                               dtype=str(dtype)[6:], ax=ax,
                               periodic=periodic, shape=list(shape),
                               div_corr=d is not None, ok=ok,
                               max_abs_err=eabs, max_rel_err=erel)
                    if dtype == torch.float32 and timed and (
                            main or (d is not None
                                     and (compat, lim) == CPPM_VARIANTS[0])):
                        rec['ms'] = time_ms(
                            lambda: cppm_cuda.cppm_sweep_cuda(
                                *args, co, periodic, div_corr=d, ax=ax,
                                **var))
                        rec['plain_ms'] = time_ms(
                            lambda: cppm._cppm_sweep_body(
                                *args, co, periodic, d, ax, **var),
                            reps=5, warm=1)
                        b, by = bound(
                            cppm_bytes(dtype, d is not None, compat, lim,
                                       co.stencil, shape=shape),
                            cppm_ops_per_cell() * math.prod(shape))
                        rec['bound_ms'], rec['bound_by'] = b, by
                    emit(label, **rec)
                    results.append(rec)
                    ok_all &= ok
    if not main:
        return ok_all
    # the main variant at the other tracer counts of NT_CHECK, on both
    # axes with the main path's periodicity, the second sweep's div_corr
    for dtype in (torch.float64, torch.float32):
        for ax in (-1, -2):
            periodic = ax == -2
            for nt in NT_CHECK:
                co, args, div = cppm_inputs(ax, periodic, dtype, dev, nt)
                ref = cppm._cppm_sweep_body(*args, co, periodic, div, ax)
                out = cppm_cuda.cppm_sweep_cuda(*args, co, periodic,
                                                div_corr=div, ax=ax)
                torch.cuda.synchronize()
                ok, eabs, erel = compare(out, ref, dtype)
                ok &= all(tuple(o.shape) == tuple(r.shape)
                          for o, r in zip(out, ref))
                rec = dict(kernel='cppm_sweep',
                           variant='full/non_oscillatory',
                           dtype=str(dtype)[6:], ax=ax, periodic=periodic,
                           div_corr=True, nt=nt, ok=ok, max_abs_err=eabs,
                           max_rel_err=erel)
                emit('kernel_check', **rec)
                results.append(rec)
                ok_all &= ok
    return ok_all


def momtum_inputs(periodic_i, dtype, dev, arctic=False, shape=(KK, JJ, II),
                  water=.9):
    """Random land (a tenth; none with water=1), fields and fluxes on a
    grid periodic in j, or with `arctic` on a tripolar one: closed in j,
    walled in the south, the top row on the fold."""
    import numpy as np
    import torch
    from blom_tpu_torch.core.grid import finish_grid
    from blom_tpu_torch.dynamics.momtum import Momtum2DIn, MomtumKIn
    KK, JJ, II = shape
    rng = np.random.default_rng(SEED)
    depths = np.where(rng.uniform(size=(JJ, II)) < water, 200., 0.)
    if not periodic_i:
        depths[:, 0] = depths[:, -1] = 0.
    if arctic:
        depths[0] = 0.
    ones = np.ones((JJ, II))
    gs = 650.
    grid = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=depths,
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=periodic_i, periodic_j=not arctic, kk=KK, baclin=180.,
        arctic=arctic, dtype=dtype, device=dev)
    ip, iu, iv = (g.cpu().double().numpy() for g in (grid.ip, grid.iu,
                                                     grid.iv))
    H3, H2 = (KK, JJ, II), (JJ, II)
    dp = rng.uniform(1e4, 3e5, H3) * ip
    dpu = rng.uniform(1e4, 3e5, H3) * iu
    dpv = rng.uniform(1e4, 3e5, H3) * iv
    z = np.zeros((1, JJ, II))
    p = np.concatenate([z, np.cumsum(dp, 0)])
    pu = np.concatenate([z, np.cumsum(dpu, 0)])
    pv = np.concatenate([z, np.cumsum(dpv, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)
    f = MomtumKIn(
        u_m=t(rng.normal(0., .3, H3) * iu), u_n=t(rng.normal(0., .3, H3) * iu),
        v_m=t(rng.normal(0., .3, H3) * iv), v_n=t(rng.normal(0., .3, H3) * iv),
        dp_m=t(dp), dpu_m=t(dpu), dpv_m=t(dpv),
        p_lo=t(p[:-1]), p_hi=t(p[1:]), pu_lo=t(pu[:-1]), pu_hi=t(pu[1:]),
        pv_lo=t(pv[:-1]), pv_hi=t(pv[1:]),
        stress_u=t(rng.normal(0., 1e-6, H3) * iu),
        stress_v=t(rng.normal(0., 1e-6, H3) * iv),
        pgf_u=t(rng.normal(0., 1e-3, H3) * iu),
        pgf_v=t(rng.normal(0., 1e-3, H3) * iv))
    d2 = Momtum2DIn(
        ubflxs_m=t(rng.normal(0., 1e7, H2) * iu),
        ubflxs_n=t(rng.normal(0., 1e7, H2) * iu),
        vbflxs_m=t(rng.normal(0., 1e7, H2) * iv),
        vbflxs_n=t(rng.normal(0., 1e7, H2) * iv),
        pbu_m=t(pu[-1]), pbv_m=t(pv[-1]),
        pbu_n=t(pu[-1] * 1.01), pbv_n=t(pv[-1] * 1.01),
        drag=t(rng.uniform(0., 1e-7, H2) * ip),
        ubrhs=t(rng.normal(0., 1e-5, H2) * iu),
        vbrhs=t(rng.normal(0., 1e-5, H2) * iv),
        difwgt=t(rng.uniform(0., 1., H2) * ip))
    return grid, f, d2


def momtum_bytes(dtype, shape=(KK, JJ, II)):
    """Bytes the momentum core must move: 17 (k, j, i) inputs, 12 (j, i)
    inputs and 21 grid planes read and u_new, v_new written."""
    import torch
    kk, jj, ii = shape
    es = torch.finfo(dtype).bits // 8
    return es * ((17 + 2) * kk * jj * ii + (12 + 21) * jj * ii)


def profiler_ms(call, kernel, reps=5):
    """Device milliseconds per call of the kernels whose name holds
    `kernel`, from torch.profiler (None if it sees no device time); with
    a tuple of names, {name: ms} from one profiled run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out = {}
    for name in (kernel if isinstance(kernel, tuple) else (kernel,)):
        total = sum(ev.device_time_total for ev in events if name in ev.key)
        out[name] = total / 1e3 / reps if total > 0 else None
    return out if isinstance(kernel, tuple) else out[kernel]


def momentum_smem():
    """{instantiation: bytes} of dynamic shared memory per block of each
    momentum kernel instantiation."""
    import torch
    from blom_tpu_torch.dynamics import momtum, momtum_cuda
    return {f'momtum_uv_kernel<{t},{n}>': momtum_cuda.shared_bytes(dt, m)
            for t, dt in (('f', torch.float32), ('d', torch.float64))
            for n, m in enumerate(momtum.MOMMTHS)}


ALE_KERNELS = {'ale_regrid': 6, 'ale_remap': 18}   # instantiations


def ale_smem(name):
    """{instantiation type: bytes} of dynamic shared memory per block of
    the ALE kernel `name` (K1 'ale_regrid', K2 'ale_remap') at the main
    path's kk."""
    import torch
    from blom_tpu_torch.dynamics import ale_cuda
    return {f'{name}_kernel<{t}>': ale_cuda.shared_bytes(name, dt, KK)
            for t, dt in (('f', torch.float32), ('d', torch.float64))}


# kernels whose every instantiation must build with no stack frame and no
# spills: the CPPM sweep's 4 variants, K1's 3 limiters, K2's 9 limiter
# pairs, each in f32 and f64
FRAME_GATED = {'cppm_sweep': 8, 'ale_regrid': 6, 'ale_remap': 18}


def frames_ok(ptxas):
    """{kernel: all its instantiations built, with no stack frame and no
    spills} for each kernel of FRAME_GATED."""
    out = {}
    for name, count in FRAME_GATED.items():
        inst = {k: v for k, v in ptxas.get(name, {}).items()
                if k.startswith(f'{name}_kernel<')}
        out[name] = len(inst) == count and all(
            v.get('stack_frame', 0) == 0 and v.get('spill_stores', 0) == 0
            and v.get('spill_loads', 0) == 0 for v in inst.values())
    return out


def cppm_smem():
    """{axis/dtype: bytes} of dynamic shared memory per block of the CPPM
    sweep at the main path's line lengths (i: II, j: JJ)."""
    import torch
    from blom_tpu_torch.dynamics import cppm_cuda
    return {f'{a}/{t}': cppm_cuda.shared_bytes(n, ax, dt)
            for a, ax, n in (('i', -1, II), ('j', -2, JJ))
            for t, dt in (('f32', torch.float32), ('f64', torch.float64))}


def check_momtum(dev, results, cases=None, exact=False,
                 label='kernel_check'):
    """The momentum core in each scheme, in f64 and f32, against its
    plain version: on `cases`, (periodic_i, arctic, shape, water, timed)
    each, or by default the main path's grid closed and periodic in i,
    and periodic in i on a tripolar grid (the fold pre-pass, then the
    main kernel), timed closed in i (the main path's grid).  With
    `exact` every output must equal the plain one (max |err| 0.0), else
    be within `compare`'s tolerance."""
    import math
    import torch
    from blom_tpu_torch.dynamics import momtum, momtum_cuda
    tsfac, delt1 = 6. / 360., 360.
    if cases is None:
        cases = [(periodic_i, arctic, (KK, JJ, II), .9, not periodic_i)
                 for periodic_i, arctic in ((False, False), (True, False),
                                            (True, True))]
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for periodic_i, arctic, shape, water, timed in cases:
            grid, f, d2 = momtum_inputs(periodic_i, dtype, dev, arctic,
                                        shape=shape, water=water)
            for mommth in momtum.MOMMTHS:
                # the main path's parameters with each scheme, plus nonzero
                # biharmonic and background viscosities so that every term
                # of the body is exercised
                par = momtum.MomtumParams(mommth=mommth, mdv2hi=2.,
                                          mdv2lo=1., vsc4hi=.1, vsc4lo=.05)
                ref = momtum._uv_body(grid, par, f, d2, tsfac, delt1)
                out = momtum_cuda.momtum_uv_cuda(grid, par, f, d2, tsfac,
                                                 delt1)
                torch.cuda.synchronize()
                ok, eabs, erel = compare(out, ref, dtype)
                if exact:
                    ok &= eabs == 0.
                rec = dict(kernel='momtum_uv', variant=mommth,
                           dtype=str(dtype)[6:], periodic_i=periodic_i,
                           arctic=arctic, shape=list(shape), ok=ok,
                           max_abs_err=eabs, max_rel_err=erel)
                if dtype == torch.float32 and timed:
                    def call():
                        return momtum_cuda.momtum_uv_cuda(grid, par, f, d2,
                                                          tsfac, delt1)
                    rec['ms'] = time_ms(call)
                    rec['plain_ms'] = time_ms(lambda: momtum._uv_body(
                        grid, par, f, d2, tsfac, delt1), reps=5, warm=1)
                    b, by = bound(momtum_bytes(dtype, shape),
                                  MOMTUM_OPS_PER_POINT * math.prod(shape))
                    rec['bound_ms'], rec['bound_by'] = b, by
                    rec['profiler_ms'] = profiler_ms(call,
                                                     'momtum_uv_kernel')
                emit(label, **rec)
                results.append(rec)
                ok_all &= ok
    return ok_all


def ale_inputs(dtype, dev, ntr=0, shape=(KK, JJ, II)):
    """Columns as in tests/test_ale_pallas.py at `shape`, the main path's
    by default: interfaces, T, S, target densities, tracers, velocities on
    their own interfaces."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    H3 = shape

    def cum(dp):
        return np.concatenate([np.zeros((1,) + H3[1:]), np.cumsum(dp, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)
    p = cum(rng.uniform(.5, 3., H3) * 1.e4)
    temp = rng.uniform(2., 18., H3)
    saln = rng.uniform(33., 36., H3)
    sigmar = np.sort(rng.uniform(24., 28., H3), axis=0)
    trc = [t(rng.uniform(0., 2., H3)) for _ in range(ntr)]
    u, v = rng.uniform(-.3, .3, H3), rng.uniform(-.3, .3, H3)
    pu = cum(rng.uniform(.5, 3., H3) * 1.e4)
    pv = cum(rng.uniform(.5, 3., H3) * 1.e4)
    return dict(p=t(p), temp=t(temp), saln=t(saln), sigmar=t(sigmar),
                trc=trc, u=t(u), v=t(v), pu=t(pu), pv=t(pv))


# arithmetic operations per column, counted from the plain version's
# expressions (blom_tpu_torch/ops/hor3map.py ppm_reconstruct,
# dynamics/ale.py regrid_nudge, hor3map.remap_groups), which
# csrc/ale_regrid.cu and csrc/ale_remap.cu (with csrc/ppm_tile.cuh)
# evaluate in the same order:
# ~90 per edge for the weights, 7 per edge and field for the edge value,
# ~20 per cell and field for the limiter tests and the coefficients, ~40
# per cell for the two densities, ~10 per interface for the regime
# choice and the clamp; in K2 ~6 per cell for the prefix sum and ~15 per
# destination edge.  The data-dependent branches (the slope clamp and
# parabola limit where they apply, the search for the transition
# interface, the isopycnal nudge) are not counted, so these counts and
# the bounds from them are lower bounds.
def ale_regrid_ops(kk=KK):
    return (kk + 1) * (90 + 2 * 7) + kk * (2 * 20 + 40 + 10)


def ale_remap_ops(ntr, kk=KK):
    per_field = (kk + 1) * 7 + kk * (20 + 6) + (kk + 1) * 15
    return 3 * (kk + 1) * 90 + (2 + ntr + 2) * per_field


def ale_bytes(dtype, kind, ntr=0, shape=(KK, JJ, II)):
    import torch
    kk, jj, ii = shape
    es = torch.finfo(dtype).bits // 8
    if kind == 'regrid':      # p_src, temp, saln, sigmar -> p_dst, sfac
        levels = 3 * (kk + 1) + 3 * kk
    else:                     # 6 interface fields, tracers + u, v in/out
        levels = 6 * (kk + 1) + 2 * (2 + ntr + 2) * kk
    return es * levels * jj * ii


def check_ale(dev, results, shape=None, exact=False,
              label='kernel_check'):
    """K1 and K2 against their plain versions in f64 and f32, on `shape`
    (each limiter for both groups, no tracers) or by default on the main
    path's grid: K2 at NTR_CHECK's tracer counts with each limiter for
    both groups and deck B's pair, K1 in each limiter, then
    check_ale_deep; timed in f32 with no tracers and one limiter for both
    groups (on `shape` the non-oscillatory one).  With `exact` every
    output must equal the plain one (max |err| 0.0), else be within
    `compare`'s tolerance."""
    import torch
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.dynamics import ale, ale_cuda
    e = eos.init_eos(pref=0., expcnf='fuk95')
    delt1 = 360.
    main = shape is None
    shape = (KK, JJ, II) if main else tuple(shape)
    kk, jj, ii = shape
    # (tracer_limiting, velocity_limiting) of the K2 checks: each limiter
    # for both groups, and on the main grid the pair of the channel deck B
    k2_pairs = [(lim, lim) for lim in ale.LIMITERS] + (
        [DECKS['B'][3:]] if main else [])
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for ntr in (NTR_CHECK if main else (0,)):
            x = ale_inputs(dtype, dev, ntr, shape=shape)
            pairs = k2_pairs if ntr != NTR_MANY else [
                ('non_oscillatory', 'non_oscillatory')]
            for tlim, vlim in pairs:
                par = ale.make_ale_params(kk)._replace(
                    tracer_limiting=tlim, velocity_limiting=vlim)
                timed = (dtype == torch.float32 and ntr == 0
                         and tlim == vlim
                         and (main or tlim == 'non_oscillatory'))
                rargs = (e, par, x['p'], x['temp'], x['saln'], x['sigmar'],
                         delt1)
                ref = ale.regrid_plain(*rargs)
                if ntr == 0 and tlim == vlim:
                    out = ale_cuda.regrid_cuda(*rargs)
                    torch.cuda.synchronize()
                    ok, eabs, erel = compare(out, ref, dtype)
                    if exact:
                        ok &= eabs == 0.
                    rec = dict(kernel='ale_regrid', variant=tlim,
                               dtype=str(dtype)[6:], shape=list(shape),
                               ok=ok, max_abs_err=eabs, max_rel_err=erel)
                    if timed:
                        rec['ms'] = time_ms(
                            lambda: ale_cuda.regrid_cuda(*rargs))
                        rec['plain_ms'] = time_ms(
                            lambda: ale.regrid_plain(*rargs), reps=5,
                            warm=1)
                        b, by = bound(ale_bytes(dtype, 'regrid',
                                                shape=shape),
                                      ale_regrid_ops(kk) * jj * ii)
                        rec['bound_ms'], rec['bound_by'] = b, by
                    emit(label, **rec)
                    results.append(rec)
                    ok_all &= ok
                p_dst = ref[0]
                margs = (par, x['p'], [x['temp'], x['saln']] + x['trc'],
                         x['pu'], x['u'], x['pv'], x['v'], p_dst,
                         p_dst * .98, p_dst * .97)
                mref = ale.remap_plain(*margs)
                mout = ale_cuda.remap_cuda(*margs)
                torch.cuda.synchronize()
                ok, eabs, erel = compare(
                    list(mout[0]) + [mout[1], mout[2]],
                    list(mref[0]) + [mref[1], mref[2]], dtype)
                if exact:
                    ok &= eabs == 0.
                rec = dict(kernel='ale_remap', variant=f'{tlim}/{vlim}',
                           dtype=str(dtype)[6:], ntr=ntr, shape=list(shape),
                           ok=ok, max_abs_err=eabs, max_rel_err=erel)
                if timed:
                    # the main path's configuration: fuk95 and the
                    # channel carry no tracers
                    rec['ms'] = time_ms(lambda: ale_cuda.remap_cuda(*margs))
                    rec['plain_ms'] = time_ms(
                        lambda: ale.remap_plain(*margs), reps=5, warm=1)
                    b, by = bound(ale_bytes(dtype, 'remap', ntr,
                                            shape=shape),
                                  ale_remap_ops(ntr, kk) * jj * ii)
                    rec['bound_ms'], rec['bound_by'] = b, by
                emit(label, **rec)
                results.append(rec)
                ok_all &= ok
    return ok_all & (check_ale_deep(dev, results) if main else True)


def check_ale_deep(dev, results):
    """K1 and K2 in each limiter (the same for tracers and velocities) at
    KK_DEEP levels on a JJ_DEEP x II_DEEP grid, whose last tile of columns
    ends inside it, against their plain versions in f64 and f32, with
    two tracers."""
    import torch
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.dynamics import ale, ale_cuda
    e = eos.init_eos(pref=0., expcnf='fuk95')
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        x = ale_inputs(dtype, dev, 2, (KK_DEEP, JJ_DEEP, II_DEEP))
        for lim in ale.LIMITERS:
            par = ale.make_ale_params(KK_DEEP)._replace(
                tracer_limiting=lim, velocity_limiting=lim)
            rargs = (e, par, x['p'], x['temp'], x['saln'], x['sigmar'],
                     360.)
            ref = ale.regrid_plain(*rargs)
            out = ale_cuda.regrid_cuda(*rargs)
            p_dst = ref[0]
            margs = (par, x['p'], [x['temp'], x['saln']] + x['trc'],
                     x['pu'], x['u'], x['pv'], x['v'], p_dst, p_dst * .98,
                     p_dst * .97)
            mref = ale.remap_plain(*margs)
            mout = ale_cuda.remap_cuda(*margs)
            torch.cuda.synchronize()
            for name, variant, o, r in (
                    ('ale_regrid', lim, out, ref),
                    ('ale_remap', f'{lim}/{lim}',
                     list(mout[0]) + [mout[1], mout[2]],
                     list(mref[0]) + [mref[1], mref[2]])):
                ok, eabs, erel = compare(o, r, dtype)
                rec = dict(kernel=name, variant=variant,
                           dtype=str(dtype)[6:], kk=KK_DEEP,
                           shape=[JJ_DEEP, II_DEEP], ok=ok,
                           max_abs_err=eabs, max_rel_err=erel)
                if name == 'ale_remap':
                    rec['ntr'] = len(x['trc'])
                emit('kernel_check', **rec)
                results.append(rec)
                ok_all &= ok
    return ok_all


# ------------------------------------------------------------------ slice

def mass(model, dp):
    g = model.grid
    return float((dp.double().sum(0) * g.scp2.double()
                  * g.ip.double()).sum())


BENCH_DIFEST = dict(egc=.85, egmndf=100.)     # bench.py:67-69


def _counts():
    """{kernel: the launch counter of its wrapper, keyed by the
    instantiation it launches}."""
    from blom_tpu_torch.dynamics import ale_cuda, cppm_cuda, momtum_cuda
    return {'cppm_sweep': cppm_cuda.launches,
            'momtum_uv': momtum_cuda.launches,
            'momtum_fold': momtum_cuda.fold_launches,
            'ale_regrid': ale_cuda.regrid_launches,
            'ale_remap': ale_cuda.remap_launches}


def _key(k):
    return k if isinstance(k, str) else '/'.join(k)


# {kernel: {tracer count: launches}} since zero_counters, recorded by the
# wrappers observe_carried installs
_CARRIED = {'cppm_sweep': {}, 'ale_remap': {}}


def observe_carried():
    """Wrap the CPPM sweep's and ALE K2's wrappers so that each call that
    returns from the card records the tracer count it carried: for the
    CPPM sweep the fields after h (nt, the rows of tm), for K2 the
    tracers besides T and S (ntr).  A wrapper given CUDA tensors launches
    its kernel or raises, so these are launches."""
    from blom_tpu_torch.dynamics import ale_cuda, cppm_cuda
    for mod, fn, name, field, count in (
            (cppm_cuda, 'cppm_sweep_cuda', 'cppm_sweep', 0,
             lambda a: a[1].shape[0]),
            (ale_cuda, 'remap_cuda', 'ale_remap', 1,
             lambda a: len(a[2]) - 2)):
        def wrapped(*a, _orig=getattr(mod, fn), _name=name, _field=field,
                    _count=count, **kw):
            out = _orig(*a, **kw)
            if a[_field].is_cuda:
                n = _count(a)
                _CARRIED[_name][n] = _CARRIED[_name].get(n, 0) + 1
            return out
        setattr(mod, fn, wrapped)


def counters():
    """The launch counts of every kernel wrapper, {kernel: {instantiation:
    n}} (CPPM 'compatibility/limiting', momentum scheme, K1 limiter, K2
    'tracer/velocity' limiters), the host syncs of the eddy-transport
    limiter, and under 'carried' the launches of the CPPM sweep and K2 by
    the tracer count they carried, {kernel: {count: n}}."""
    from blom_tpu_torch.dynamics import eddtra
    out = {name: {_key(k): n for k, n in c.items()}
           for name, c in _counts().items()}
    out['host_syncs'] = eddtra.host_syncs
    out['carried'] = {k: dict(sorted(v.items()))
                      for k, v in _CARRIED.items()}
    return out


def zero_counters():
    from blom_tpu_torch.dynamics import eddtra
    for c in _counts().values():
        for k in c:
            c[k] = 0
    for c in _CARRIED.values():
        c.clear()
    eddtra.host_syncs = 0


def expected_launches(par, arctic=False):
    """{kernel: {instantiation: launches per step}} of a step with `par`:
    two CPPM sweeps (none under incremental remapping, advmth='remap'),
    one momentum launch and on a tripolar grid one of its fold pre-pass,
    one launch of each ALE kernel when ALE is on with the method the
    kernels compute (explicit-edge PPM and the nudge regrid; the other
    methods run plain); every other instantiation 0."""
    from blom_tpu_torch.dynamics.ale import ale_kernels_ok
    sweeps = 0 if par.advmth == 'remap' else 2
    out = {'cppm_sweep': {f'{par.cppm_compatibility}/{par.cppm_limiting}':
                          sweeps},
           'momtum_uv': {par.momtum.mommth: 1},
           'momtum_fold': {par.momtum.mommth: 1} if arctic else {},
           'ale_regrid': {}, 'ale_remap': {}}
    if par.ale is not None and ale_kernels_ok(par.ale):
        out['ale_regrid'] = {par.ale.tracer_limiting: 1}
        out['ale_remap'] = {f'{par.ale.tracer_limiting}/'
                            f'{par.ale.velocity_limiting}': 1}
    return out


def launches_ok(counts, par, nsteps, arctic=False):
    exp = expected_launches(par, arctic)
    return all(n == exp[k].get(v, 0) * nsteps
               for k, per in counts.items() if k in exp
               for v, n in per.items())


def run_slice(dev, paths, syncs):
    """The fuk95 main path; its launch counts go to paths['fuk95'] and,
    for the adiabatic core, paths['fuk95_core']; the eddy limiter's host
    syncs per step of its 10-step run to syncs['fuk95']."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    t0 = time.perf_counter()
    model = standalone.build_fuk95(dtype=torch.float32, itdm=II, jtdm=JJ,
                                   kdm=KK, device=dev)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST))
    torch.cuda.synchronize()
    emit('slice_build', seconds=time.perf_counter() - t0)
    mass0 = mass(model, model.state.dp[1])

    standalone.run(model, 2)      # warm-up: allocator, first launches
    torch.cuda.synchronize()
    ok_all = True
    for nsteps in (10, 11):
        zero_counters()
        t0 = time.perf_counter()
        s, _ = standalone.run(model, nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        syncs_n = counts.pop('host_syncs')
        paths.setdefault('fuk95', counts)
        syncs.setdefault('fuk95', syncs_n / nsteps)
        ok, rec = slice_gates(model, s, nsteps, mass0)
        ok &= launches_ok(counts, model.par, nsteps)
        emit('slice', steps=nsteps, ok=ok, **rec, launches=counts,
             host_syncs_per_step=syncs_n / nsteps,
             seconds_per_step=wall / nsteps,
             gridpoints_per_s=II * JJ * KK * nsteps / wall)
        ok_all &= ok
    profile_phases(model)
    ok_all &= run_core(model, mass0, paths)
    return ok_all


def slice_gates(model, s, nsteps, mass0):
    """Finite fields, mass drift <= 1e-5, salinity within SALN_DEV of 35
    (SALN_DEV_ALE with the ALE remap on, SALN_DEV_DIRECT with the direct
    regrid)."""
    import torch
    new = 1 if nsteps % 2 == 0 else 0      # slot of the newest level
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
    drift = (mass(model, s.dp[new]) - mass0) / mass0
    saln_dev = float(((s.saln[new] - 35.) * model.grid.ip).abs().max())
    ale = model.par.ale
    saln_tol = (SALN_DEV if ale is None else SALN_DEV_DIRECT
                if ale.regrid_method == 'direct' else SALN_DEV_ALE)
    ok = finite and abs(drift) <= 1e-5 and saln_dev <= saln_tol
    return ok, dict(finite=finite, rel_mass_drift=drift,
                    max_saln_dev=saln_dev, max_abs_v=float(s.v.abs().max()))


def run_core(model, mass0, paths, nsteps=4):
    """The adiabatic dynamical core alone, through the same model."""
    import dataclasses
    import torch
    from blom_tpu_torch.drivers import standalone
    core = dataclasses.replace(model, par=model.par._replace(
        ale=None, vmix=None, difest=None))
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(core, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    counts.pop('host_syncs')
    paths['fuk95_core'] = counts
    ok, rec = slice_gates(core, s, nsteps, mass0)
    ok &= launches_ok(counts, core.par, nsteps)
    emit('slice_adiabatic_core', steps=nsteps, ok=ok, **rec,
         launches=counts, seconds_per_step=wall / nsteps)
    return ok


def profile_phases(model, nsteps=4, phase='phase_profile'):
    """Device milliseconds of each phase of the step, from the CUDA events
    that blom_step records while `step.phase_marks` is a list."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import step
    step.phase_marks = marks = []
    try:
        standalone.run(model, nsteps)
    finally:
        step.phase_marks = None
    torch.cuda.synchronize()
    ms = {}
    for (name, e0), (_, e1) in zip(marks, marks[1:]):
        if name != 'end':
            ms[name] = ms.get(name, 0.) + e0.elapsed_time(e1) / nsteps
    step_ms = marks[0][1].elapsed_time(marks[-1][1]) / nsteps
    emit(phase, steps=nsteps, step_ms=step_ms,
         phase_ms=dict(sorted(ms.items(), key=lambda kv: -kv[1])))
    return step_ms, ms


PARITY_FIELDS = ('u', 'v', 'dp', 'temp', 'saln', 'pb', 'ubflx', 'vbflx',
                 'pgfx', 'pgfy', 'uflx', 'vflx')


def worst_field(a, b, fields=PARITY_FIELDS):
    """(field, max |a - b| / max |a|) of the field that differs most; a on
    the CPU, b anywhere."""
    w = ('', 0.0)
    for name in fields:
        x = getattr(a, name)
        y = getattr(b, name).cpu()
        # the tracers one by one: their scales differ by orders
        pairs = ([(f'{name}[{i}]', x[:, i], y[:, i])
                  for i in range(x.shape[1])] if name == 'trc'
                 else [(name, x, y)])
        for label, xi, yi in pairs:
            r = float((xi - yi).abs().max()
                      / xi.abs().max().clamp_min(1e-300))
            if r > w[1]:
                w = (label, r)
    return w


def one_step_parity(models, dev, fields=PARITY_FIELDS):
    """{parity: worst_field} of one step at each time-level parity from
    the same state, card against CPU; models = {device: Model}."""
    from blom_tpu_torch.dynamics import step
    one_step = {}
    for m_, n_ in ((0, 1), (1, 0)):
        out = {}
        for d, mo in models.items():
            out[d], _ = step.blom_step(
                mo.grid, mo.e, mo.par, mo.coeffs_i, mo.coeffs_j,
                mo.state.clone(), mo.forcing, mo.dfl, m_, n_,
                mo.clock.delt1, mo.swabs, mo.bgc_forcing)
        one_step[f'm{m_}n{n_}'] = worst_field(out['cpu'], out[dev], fields)
    return one_step


def run_parity(dev, nsteps=4):
    """The full step with bench.py's physics at 24x8x8 in f64, on the
    card and on the CPU, from the same initial state.  Gated: one step at
    each time-level parity, worst field's max |card - cpu| / max |cpu|
    within STEP_REL.  Reported: the same after each of `nsteps` steps of
    the driver; from the second step on, the regrid's case choices and
    the eddy limiter flip on rounding-level differences (see
    tests/test_torch_slice.py), so those are not gated."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    models = {}
    for d in (dev, 'cpu'):
        m = standalone.build_fuk95(dtype=torch.float64, itdm=24, jtdm=8,
                                   kdm=8, device=d)
        m.par = m.par._replace(difest=DifestParams(**BENCH_DIFEST))
        models[d] = m
    one_step = one_step_parity(models, dev)
    per_step = []
    for k in range(1, nsteps + 1):
        out = {d: standalone.run(mo, k)[0] for d, mo in models.items()}
        per_step.append(worst_field(out['cpu'], out[dev]))
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('parity_cuda_vs_cpu', ok=ok, tolerance=STEP_REL,
         one_step=one_step, driver_steps=nsteps,
         driver_worst_per_step=per_step)
    return ok


# ------------------------------------------------------------ isopycnic

ISOPYC = 'isopyc_bulkml'
# mixed-layer thickness over water [m] after the timed steps: fuk95 has
# no forcing, so the mixed layer stays near its 5 m minimum
# (tests/test_configs.py:67-68)
ISOPYC_ML = (2., 12.)
PARITY_ISOPYC = dict(itdm=24, jtdm=8, kdm=10)


def build_isopyc(dev, dtype, **size):
    """fuk95 in the isopycnic coordinate with bench.py's physics, which
    runs cmnfld, the lateral diffusivities, eddtra_isopyc and diffus."""
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    model = standalone.build_fuk95(dtype=dtype, vcoord=ISOPYC, device=dev,
                                   **size)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST))
    return model


def isopyc_gates(model, s, nsteps, mass0):
    """Finite fields, mass drift <= 1e-5, the mixed layer within
    ISOPYC_ML over water, kfpla within [2, kk] (salinity is not uniform
    here: convec and diapfl set S from the layer's reference density)."""
    import torch
    from blom_tpu_torch.core.constants import onem
    new = 1 if nsteps % 2 == 0 else 0
    g = model.grid
    wet = g.ip > 0
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
    drift = (mass(model, s.dp[new]) - mass0) / mass0
    ml = ((s.dp[new][0] + s.dp[new][1]).double() / onem)[wet]
    kf = s.kfpla[new][wet]
    ml_lo, ml_hi = float(ml.min()), float(ml.max())
    ok = (finite and abs(drift) <= 1e-5
          and ISOPYC_ML[0] < ml_lo and ml_hi < ISOPYC_ML[1]
          and int(kf.min()) >= 2 and int(kf.max()) <= g.kk)
    return ok, dict(finite=finite, rel_mass_drift=drift,
                    ml_thickness_m=[ml_lo, ml_hi],
                    kfpla=[int(kf.min()), int(kf.max())],
                    max_abs_v=float(s.v.abs().max()))


def run_isopyc(dev, paths, syncs):
    """The isopycnic path at the main path's width in f32: 2 warm-up and
    NSTEPS_ISOPYC timed steps, launches per step, gates, s/step and
    grid-points/s, then the device time of each phase; then its kernels
    on their inputs from this run (check_isopyc_kernels)."""
    import torch
    from blom_tpu_torch.drivers import standalone
    t0 = time.perf_counter()
    model = build_isopyc(dev, torch.float32, itdm=II, jtdm=JJ, kdm=KK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mass0 = mass(model, model.state.dp[1])
    s_warm, clock = standalone.run(model, 2)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, NSTEPS_ISOPYC)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    syncs_n = counts.pop('host_syncs')
    syncs['fuk95_isopyc'] = syncs_n / NSTEPS_ISOPYC
    paths['fuk95_isopyc'] = counts
    ok, rec = isopyc_gates(model, s, NSTEPS_ISOPYC, mass0)
    ok &= launches_ok(counts, model.par, NSTEPS_ISOPYC)
    emit('isopyc', shape=[KK, JJ, II], dtype='float32',
         build_seconds=build_s, warmup_steps=2, steps=NSTEPS_ISOPYC, ok=ok,
         **rec, launches=counts,
         host_syncs_per_step=syncs_n / NSTEPS_ISOPYC,
         seconds_per_step=wall / NSTEPS_ISOPYC,
         gridpoints_per_s=II * JJ * KK * NSTEPS_ISOPYC / wall)
    profile_phases(model, 2, 'isopyc_phase_profile')
    ok &= check_isopyc_kernels(model, s_warm, clock.delt1)
    return ok


def capture_kernel_inputs(model, s, delt1):
    """The inputs of every CPPM sweep, momentum, ALE K1 and K2 call of one
    step from state `s` (parity m, n = 0, 1), cloned as each wrapper
    receives them."""
    import dataclasses
    from blom_tpu_torch.dynamics import ale_cuda, cppm_cuda, momtum_cuda
    from blom_tpu_torch.dynamics import step

    def clone(x):
        if isinstance(x, list):
            return [clone(y) for y in x]
        return x.clone() if hasattr(x, 'clone') else x

    calls = {'cppm_sweep': [], 'momtum_uv': [], 'ale_regrid': [],
             'ale_remap': []}
    wrappers = {'cppm_sweep': (cppm_cuda, 'cppm_sweep_cuda'),
                'momtum_uv': (momtum_cuda, 'momtum_uv_cuda'),
                'ale_regrid': (ale_cuda, 'regrid_cuda'),
                'ale_remap': (ale_cuda, 'remap_cuda')}
    orig = {k: getattr(mod, fn) for k, (mod, fn) in wrappers.items()}

    def capture(name):
        def cap(*a, **kw):
            if name == 'momtum_uv':
                grid, par, f, d2, tsfac, d1 = a
                args = [grid, par, type(f)(*map(clone, f)),
                        type(d2)(*map(clone, d2)), tsfac, d1]
            else:
                args = [clone(x) for x in a]
            calls[name].append((args, dict(kw)))
            return orig[name](*a, **kw)
        return cap

    for k, (mod, fn) in wrappers.items():
        setattr(mod, fn, capture(k))
    try:
        step.blom_step(model.grid, model.e, model.par, model.coeffs_i,
                       model.coeffs_j, s.clone(), model.forcing,
                       dataclasses.replace(model.dfl), 0, 1, delt1,
                       model.swabs, model.bgc_forcing)
    finally:
        for k, (mod, fn) in wrappers.items():
            setattr(mod, fn, orig[k])
    return calls


def _to_f64(x):
    """x with its floating tensors (also inside a grid or a tuple) in
    f64."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to_f64(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    if isinstance(x, tuple) and hasattr(x, '_fields'):
        return type(x)(*map(_to_f64, x))
    if isinstance(x, list):
        return [_to_f64(y) for y in x]
    return x


def check_isopyc_kernels(model, s, delt1):
    """The CPPM sweep on each axis and the momentum core on the inputs
    one isopycnic step gives them (many layers massless), each against
    its plain version: in f32 within F32_REL, and the same inputs cast to
    f64 within 1e-12."""
    import torch
    from blom_tpu_torch.dynamics import cppm, cppm_cuda, momtum, momtum_cuda
    calls = capture_kernel_inputs(model, s, delt1)
    wet = model.grid.ip > 0
    kernel = {'cppm_sweep': cppm_cuda.cppm_sweep_cuda,
              'momtum_uv': momtum_cuda.momtum_uv_cuda}

    def plain(name, a, kw):
        if name == 'momtum_uv':
            return momtum._uv_body(*a)
        return cppm._cppm_sweep_body(
            *a, kw.get('div_corr'), kw['ax'], kw['compatibility'],
            kw['limiting'])

    ok_all = len(calls['cppm_sweep']) == 2 and len(calls['momtum_uv']) == 1
    for name, cl in calls.items():
        for a, kw in cl:
            h = a[0] if name == 'cppm_sweep' else a[2].dp_m
            rec = dict(kernel=name, n_layers_dp_zero=int(
                ((h == 0) & wet).sum()), wet_cells=int(wet.sum()) * h.shape[0])
            if name == 'cppm_sweep':
                rec['ax'] = kw['ax']
            ok = True
            for tag, args, kwt in (
                    ('f32', a, kw),
                    ('f64', [_to_f64(x) for x in a],
                     {k: _to_f64(v) for k, v in kw.items()})):
                out = kernel[name](*args, **kwt)
                ref = plain(name, args, kwt)
                torch.cuda.synchronize()
                o, e_abs, e_rel = compare(out, ref, args[0].dtype
                                          if name == 'cppm_sweep'
                                          else args[2].u_m.dtype)
                rec[f'{tag}_ok'], rec[f'{tag}_max_abs_err'] = o, e_abs
                rec[f'{tag}_max_rel_err'] = e_rel
                ok &= o
            rec['ok'] = ok
            emit('isopyc_kernels', **rec)
            ok_all &= ok and rec['n_layers_dp_zero'] > 0
    return ok_all


def run_isopyc_parity(dev):
    """One f64 step of each time-level parity of the isopycnic path at
    PARITY_ISOPYC size, card against CPU, within STEP_REL."""
    import torch
    models = {d: build_isopyc(d, torch.float64, **PARITY_ISOPYC)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev)
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('isopyc_parity', ok=ok, tolerance=STEP_REL, size=PARITY_ISOPYC,
         one_step=one_step)
    return ok


# --------------------------------------------------------------- tracers

def build_tracers(dev, dtype, isopyc=False, ciso=False, **size):
    """fuk95 with bench.py's physics and the tracers: the ideal age and
    the BGC base chain (NOINYAGE with NOINYOC), in the isopycnic
    coordinate the BGC alone (NOIIAOC), or with `ciso` the BGC and its
    carbon isotopes (NOINYOCISO)."""
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    if ciso:
        tracers = dict(use_bgc=True, use_ciso=True)
    elif isopyc:
        tracers = dict(vcoord=ISOPYC, use_bgc=True)
    else:
        tracers = dict(use_idlage=True, use_bgc=True)
    model = standalone.build_fuk95(dtype=dtype, device=dev, **tracers,
                                   **size)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST))
    return model


def p_inventory(model, s, lev):
    """Total phosphorus (phosphate, phytoplankton, zooplankton, DOC and
    detritus) times the layer mass, summed in f64, as
    tracer_drift_reference.py sums blom_tpu's."""
    from blom_tpu_torch.bgc.params import BgcTracers as T
    t = s.trc[lev, model.par.itrbgc:].double()
    tot = t[T.phosph] + t[T.phy] + t[T.zoo] + t[T.doc] + t[T.det]
    return float((tot * s.dp[lev].double()).sum())


def bgc_gates(model, s, nsteps, p0, key):
    """Finite tracers; over water (the layers the BGC step treats as
    wet) oxygen within OXYGEN_RANGE and the hydrogen ion within the pH
    solver's clip [ah_min, ah_max]; total phosphorus drifting by no more
    than P_DRIFT_FACTOR times blom_tpu's own f32 drift (P_DRIFT_REF)."""
    import torch
    from blom_tpu_torch.bgc.params import BgcTracers as T
    from blom_tpu_torch.core.constants import onem
    new = 1 if nsteps % 2 == 0 else 0
    par, b = model.par.bgc, model.par.itrbgc
    trc = s.trc[new]
    wet = (s.dp[new] > par.dp_min * onem) & (model.grid.ip > .5)[None]
    oxy, hi = trc[b + T.oxygen][wet], trc[b + T.hi][wet]
    lo, up = (torch.tensor(v, dtype=trc.dtype)
              for v in (par.ah_min, par.ah_max))
    drift = p_inventory(model, s, new) / p0 - 1.
    limit = P_DRIFT_FACTOR * abs(P_DRIFT_REF[key])
    rec = dict(finite_trc=bool(torch.isfinite(trc).all()),
               oxygen=[float(oxy.min()), float(oxy.max())],
               hi=[float(hi.min()), float(hi.max())],
               rel_p_drift=drift, p_drift_limit=limit,
               p_drift_blom_tpu_f32=P_DRIFT_REF[key])
    ok = (rec['finite_trc']
          and OXYGEN_RANGE[0] < rec['oxygen'][0]
          and rec['oxygen'][1] < OXYGEN_RANGE[1]
          and float(lo) <= rec['hi'][0] and rec['hi'][1] <= float(up)
          and abs(drift) <= limit)
    return ok, rec


def age_gates(model, s, nsteps):
    """tests/test_tracers.py:14-27 after `nsteps` steps from rest: the
    age zero at the surface, no older than the steps allow below, the
    bottom water aged, and not below AGE_FLOOR_F32."""
    new = 1 if nsteps % 2 == 0 else 0
    ip = model.grid.ip > 0
    age = s.trc[new, model.par.itriag].double()
    expected = nsteps * 2 * 180. / (86400. * 360.)
    rec = dict(age_surface_max=float(age[0][ip].max()),
               age_k3_max=float(age[3][ip].max()),
               age_bottom_mean=float(age[-1][ip].mean()),
               age_min=float(age.min()), age_expected=expected)
    ok = (rec['age_surface_max'] < 1e-4
          and rec['age_k3_max'] <= expected * 1.05
          and rec['age_bottom_mean'] > .2 * expected
          and rec['age_min'] >= AGE_FLOOR_F32)
    return ok, rec


def ciso_gates(model, s, nsteps):
    """Over water (the layers the BGC step treats as wet) delta13C of DIC
    within D13C_RANGE and Delta14C of DIC finite."""
    import torch
    from blom_tpu_torch.bgc import ciso
    from blom_tpu_torch.core.constants import onem
    new = 1 if nsteps % 2 == 0 else 0
    par, b, ti = model.par.bgc, model.par.itrbgc, model.par.bgc_ti
    blk = s.trc[new, b:b + ti.ntotal].double()
    wet = (s.dp[new] > par.dp_min * onem) & (model.grid.ip > .5)[None]
    d13 = ciso.delta13c(blk, ti, model.par.bgc_cp)[wet]
    d14 = ciso.delta14c(blk, ti, model.par.bgc_cp)[wet]
    rec = dict(delta13c=[float(d13.min()), float(d13.max())],
               delta13c_range=list(D13C_RANGE),
               delta14c=[float(d14.min()), float(d14.max())],
               delta14c_finite=bool(torch.isfinite(d14).all()))
    ok = (D13C_RANGE[0] < rec['delta13c'][0]
          and rec['delta13c'][1] < D13C_RANGE[1] and rec['delta14c_finite'])
    return ok, rec


def run_tracers(dev, paths, syncs, results, isopyc=False, ciso=False):
    """The tracer path at the main path's width in f32 (fuk95 with the
    age and the BGC, with isopyc the isopycnic fuk95 with the BGC, with
    ciso fuk95 with the BGC and its carbon isotopes, whose gates add
    ciso_gates and whose path has no age):
    warm-up and timed steps from rest, the gates of its coordinate and
    the BGC's, launches and host syncs per step, the tracer count each
    CPPM and K2 launch carried, s/step and grid-points/s, then the device
    time of each phase, then its kernels on their inputs
    (check_tracer_kernels, records to `results`).  On the ALE path the
    eddy limiter's host syncs per step must not exceed the plain fuk95
    path's over the same steps (the tracers do not feed back on the
    dynamics); the isopycnic run's are reported beside the plain
    isopycnic path's, over other steps."""
    import torch
    from blom_tpu_torch.drivers import standalone
    phase = 'ciso' if ciso else ('tracers_isopyc' if isopyc
                                 else 'tracers')
    warm, nsteps = (NSTEPS_CISO if ciso else NSTEPS_TRACERS_ISOPYC if isopyc
                    else NSTEPS_TRACERS)
    t0 = time.perf_counter()
    model = build_tracers(dev, torch.float32, isopyc, ciso, itdm=II,
                          jtdm=JJ, kdm=KK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mass0 = mass(model, model.state.dp[1])
    p0 = p_inventory(model, model.state, 1)
    s_warm, clock = standalone.run(model, warm)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    nsync = counts.pop('host_syncs')
    paths[f'fuk95_{phase}'] = counts
    if isopyc:
        ok, rec = isopyc_gates(model, s, nsteps, mass0)
    else:
        ok, rec = slice_gates(model, s, nsteps, mass0)
        ok_a, rec_a = (ciso_gates if ciso else age_gates)(model, s, nsteps)
        ok &= ok_a
        rec.update(rec_a)
    ok_b, rec_b = bgc_gates(model, s, nsteps, p0, phase)
    ok &= ok_b and launches_ok(counts, model.par, nsteps)
    # every CPPM sweep carried T, S and the tracers, every K2 launch the
    # tracers
    ntr = model.state.trc.shape[1]
    ok &= counts['carried'] == {
        'cppm_sweep': {2 + ntr: 2 * nsteps},
        'ale_remap': {ntr: nsteps} if model.par.ale is not None else {}}
    # BGC adds no host read: no more syncs than the plain path's
    plain = syncs['fuk95_isopyc' if isopyc else 'fuk95']
    if not isopyc:
        ok &= nsync / nsteps <= plain
    emit(phase, shape=[KK, JJ, II], dtype='float32',
         ntr=ntr, build_seconds=build_s,
         warmup_steps=warm, steps=nsteps, ok=ok, **rec, **rec_b,
         launches=counts, host_syncs_per_step=nsync / nsteps,
         plain_host_syncs_per_step=plain,
         seconds_per_step=wall / nsteps,
         gridpoints_per_s=II * JJ * KK * nsteps / wall)
    profile_phases(model, 1 if isopyc else 2, f'{phase}_phase_profile')
    ok &= check_tracer_kernels(model, s_warm, clock.delt1, results, phase)
    return ok


def check_tracer_kernels(model, s, delt1, results, phase):
    """The CPPM sweep on both axes (nt = 2 + ntr) and, with ALE on, ALE
    K2 (ntr tracers) on the inputs one tracer step from state `s` gives
    them, each against its plain version in f32 (F32_REL) and on the same
    inputs cast to f64 (1e-12); their times at these counts beside the
    plain versions' and the bounds, each record appended to `results`.
    The CPPM records count the massless wet cells of h; on the isopycnic
    path (no ALE: no K2 call) there must be some, as in
    check_isopyc_kernels."""
    import torch
    from blom_tpu_torch.dynamics import ale, ale_cuda, cppm, cppm_cuda
    calls = capture_kernel_inputs(model, s, delt1)
    isopyc = model.par.ale is None
    wet = model.grid.ip > 0
    kernel = {'cppm_sweep': cppm_cuda.cppm_sweep_cuda,
              'ale_remap': ale_cuda.remap_cuda}

    def plain(name, a, kw):
        if name == 'ale_remap':
            return ale.remap_plain(*a)
        return cppm._cppm_sweep_body(
            *a, kw.get('div_corr'), kw['ax'], kw['compatibility'],
            kw['limiting'])

    def flat(name, out):
        return (list(out[0]) + [out[1], out[2]] if name == 'ale_remap'
                else list(out))

    ok_all = (len(calls['cppm_sweep']) == 2
              and len(calls['ale_remap']) == (0 if isopyc else 1))
    for name in ('cppm_sweep', 'ale_remap'):
        for a, kw in calls[name]:
            if name == 'cppm_sweep':
                rec = dict(kernel=name, path=phase, ax=kw['ax'],
                           nt=a[1].shape[0],
                           variant=f"{kw['compatibility']}/"
                                   f"{kw['limiting']}",
                           div_corr=kw.get('div_corr') is not None,
                           n_cells_dp_zero=int(((a[0] == 0) & wet).sum()),
                           wet_cells=int(wet.sum()) * a[0].shape[0],
                           dynamic_smem=cppm_cuda.shared_bytes(
                               a[0].shape[2 if kw['ax'] == -1 else 1],
                               kw['ax'], a[0].dtype))
                dtype = a[0].dtype
                if isopyc:
                    ok_all &= rec['n_cells_dp_zero'] > 0
            else:
                rec = dict(kernel=name, path=phase, ntr=len(a[2]) - 2,
                           variant=f'{a[0].tracer_limiting}/'
                                   f'{a[0].velocity_limiting}')
                dtype = a[1].dtype
            ok = True
            for tag, args, kwt in (
                    ('f32', a, kw),
                    ('f64', [_to_f64(x) for x in a],
                     {k: _to_f64(v) for k, v in kw.items()})):
                out = kernel[name](*args, **kwt)
                ref = plain(name, args, kwt)
                torch.cuda.synchronize()
                o, e_abs, e_rel = compare(
                    flat(name, out), flat(name, ref),
                    torch.float64 if tag == 'f64' else dtype)
                rec[f'{tag}_ok'], rec[f'{tag}_max_abs_err'] = o, e_abs
                rec[f'{tag}_max_rel_err'] = e_rel
                ok &= o
            rec['ok'] = ok
            rec['ms'] = time_ms(lambda: kernel[name](*a, **kw))
            rec['plain_ms'] = time_ms(lambda: plain(name, a, kw), reps=5,
                                      warm=1)
            if name == 'cppm_sweep':
                nbytes = cppm_bytes(
                    dtype, rec['div_corr'], kw['compatibility'],
                    kw['limiting'], a[7].stencil, rec['nt'],
                    n3_planes=int(a[3].dim() == 3) + int(a[6].dim() == 3))
                nops = cppm_ops_per_cell(rec['nt']) * KK * JJ * II
            else:
                nbytes = ale_bytes(dtype, 'remap', rec['ntr'])
                nops = ale_remap_ops(rec['ntr']) * JJ * II
            rec['bound_ms'], rec['bound_by'] = bound(nbytes, nops)
            emit(f'{phase}_kernels', **rec)
            results.append(rec)
            ok_all &= ok
    return ok_all


def run_tracers_parity(dev):
    """One f64 step of each time-level parity of the tracer step at
    PARITY_TRACERS size, card against CPU, within STEP_REL, the tracers
    one by one among the fields."""
    import torch
    models = {d: build_tracers(d, torch.float64, **PARITY_TRACERS)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev, PARITY_FIELDS + ('trc',))
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('tracers_parity', ok=ok, tolerance=STEP_REL, size=PARITY_TRACERS,
         one_step=one_step)
    return ok


def _isotope_inventories(model, s, lev):
    """The 13C and 14C inventories of level `lev` (DIC, shells and
    rcar times the organic pools, times the layer mass), summed in f64,
    as tests/test_ciso.py:144-189 sums blom_tpu's."""
    from blom_tpu_torch.core.constants import onem
    ti, rcar = model.par.bgc_ti, model.par.bgc.rcar
    t = s.trc[lev, model.par.itrbgc:].double()
    d = s.dp[lev].double() / onem
    out = []
    for sco, calc, org in ((ti.sco213, ti.calc13, (ti.doc13, ti.phy13,
                                                   ti.zoo13, ti.det13)),
                           (ti.sco214, ti.calc14, (ti.doc14, ti.phy14,
                                                   ti.zoo14, ti.det14))):
        o = sum(t[r] for r in org)
        out.append(float(((t[sco] + t[calc] + rcar * o) * d).sum()))
    return out


def run_ciso_budget(dev):
    """One hamocc_step of NOINYOCISO at the main path's width in f64 on
    the card under full ice (no gas exchange), as tests/test_ciso.py's
    budget test: the 13C inventory conserved and the 14C inventory
    scaled by c14dec, each within CISO_BUDGET_RTOL."""
    import torch
    from blom_tpu_torch.bgc.step import hamocc_step
    from blom_tpu_torch.drivers import standalone
    model = standalone.build_fuk95(dtype=torch.float64, itdm=II, jtdm=JJ,
                                   kdm=KK, device=dev, use_bgc=True,
                                   use_ciso=True)
    par, dtsec = model.par, 180.
    f = model.bgc_forcing._replace(
        fice=torch.ones_like(model.bgc_forcing.fice))
    c13_0, c14_0 = _isotope_inventories(model, model.state, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1, _ = hamocc_step(model.grid, model.e, par.bgc, model.state.clone(),
                        f, par.itrbgc, 0, 0, dtsec, ti=par.bgc_ti,
                        cp=par.bgc_cp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c13_1, c14_1 = _isotope_inventories(model, s1, 0)
    dec = par.bgc_cp.c14dec(dtsec / 86400.)
    err13 = abs(c13_1 / c13_0 - 1.)
    err14 = abs(c14_1 / (c14_0 * dec) - 1.)
    finite = bool(torch.isfinite(s1.trc).all())
    ok = finite and err13 <= CISO_BUDGET_RTOL and err14 <= CISO_BUDGET_RTOL
    emit('ciso_budget', ok=ok, shape=[KK, JJ, II], dtype='float64',
         ntr=model.state.trc.shape[1], finite=finite, c13_rel_err=err13,
         c14_rel_err=err14, c14dec=dec, tolerance=CISO_BUDGET_RTOL,
         hamocc_seconds=wall)
    return ok


def run_ciso_parity(dev):
    """One f64 step of each time-level parity of the NOINYOCISO step at
    PARITY_CISO size, card against CPU, within STEP_REL, the 31 tracers
    one by one among the fields."""
    import torch
    models = {d: build_tracers(d, torch.float64, ciso=True, **PARITY_CISO)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev, PARITY_FIELDS + ('trc',))
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('ciso_parity', ok=ok, tolerance=STEP_REL, size=PARITY_CISO,
         ntr=models['cpu'].state.trc.shape[1], one_step=one_step)
    return ok


def bgc_inventory(model, s, sed, lev):
    """inventory_bgc of level `lev` with the sediment `sed`: the
    concentrations and geometric thicknesses as hamocc_step makes them."""
    from blom_tpu_torch.bgc.inventory import inventory_bgc
    from blom_tpu_torch.bgc.params import NBGC
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.core.constants import onem, rho0
    from blom_tpu_torch.core.state import cumulative_p
    import torch
    par, b, g = model.par.bgc, model.par.itrbgc, model.grid
    dp = s.dp[lev]
    pmid = cumulative_p(dp)[:-1] + .5 * dp
    rho = eos.rho(pmid, s.temp[lev], s.saln[lev]) / rho0
    lyr = (dp > par.dp_min * onem) & (g.ip > .5)
    dz = torch.where(lyr, dp / (onem * rho), 0.)
    oc = s.trc[lev, b:b + NBGC] * rho[None]
    inv = inventory_bgc(oc, dz, g.scp2, g.ip, par, sed=sed)
    return {k: float(inv[k]) for k in ('totalcarbon', 'totalphos',
                                       'totalsil', 'totalnitr',
                                       'totalalk', 'totvol')}


def run_sediment(dev):
    """hamocc_step_with_sediment on the card on NOINYOC's state at the
    main path's width in f32, the detritus seeded at 1e-6 as
    tests/test_sediment.py:157-190 seeds it, for NCALLS_SEDIMENT calls:
    finite tracers and sediment, POC gained in the top sediment layer of
    every wet column; ms per call, and inventory_bgc's totals with the
    sediment before and after."""
    import dataclasses
    import torch
    from blom_tpu_torch.bgc import sediment as sd
    from blom_tpu_torch.bgc.params import BgcTracers as T
    from blom_tpu_torch.bgc.step import hamocc_step_with_sediment
    from blom_tpu_torch.drivers import standalone
    model = standalone.build_fuk95(dtype=torch.float32, itdm=II, jtdm=JJ,
                                   kdm=KK, device=dev, use_bgc=True)
    par, b, g = model.par, model.par.itrbgc, model.grid
    s = model.state.clone()
    s.trc[:, b + T.det] = 1.e-6
    sed = sd.init_sediment(g.shape, torch.float32, dev)
    inv0 = bgc_inventory(model, s, sed, 0)
    ms = []
    for _ in range(NCALLS_SEDIMENT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, sed, _ = hamocc_step_with_sediment(
            g, model.e, par.bgc, s, model.bgc_forcing, sed, b, 0, 1, 1800.)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    inv1 = bgc_inventory(model, s, sed, 0)
    finite = bool(torch.isfinite(s.trc).all())
    sed_finite = all(bool(torch.isfinite(getattr(sed, f.name)).all())
                     for f in dataclasses.fields(sed))
    wet = g.ip > 0
    poc = sed.sedlay[sd.SedSolid.sso12, 0][wet]
    ok = finite and sed_finite and bool((poc > 0.).all())
    emit('sediment', ok=ok, shape=[KK, JJ, II], dtype='float32',
         calls=NCALLS_SEDIMENT, finite_trc=finite, finite_sediment=sed_finite,
         poc_top_min=float(poc.min()), wet_columns=int(wet.sum()),
         ms_per_call=ms, inventory_before=inv0, inventory_after=inv1)
    return ok


# -------------------------------------------------------------- tripolar

NSTEPS_TRIPOLAR = (2, 10)           # warm-up, timed steps
# The fold symmetry check: the port's run and blom_tpu's own f32 run on
# the CPU (tripolar_symmetry_reference.py, 64-bit types off, op by op)
# at this size, 4 steps with the end-of-step fold sync replaced by the
# identity.  Each field of STATE_KINDS may be at most SYMMETRY_FACTOR
# times as asymmetric as blom_tpu's, or SYMMETRY_ULPS f32 ulps of the
# field's largest magnitude where that is more (blom_tpu's is 0 in most
# fields).  blom_tpu compiled by XLA is 10^3-10^6 times as asymmetric:
# its fusions contract multiplies and adds differently at a point and
# at its mirror, which neither the port nor blom_tpu op by op does.
SYMMETRY_SIZE = dict(itdm=384, jtdm=64, kdm=53)
SYMMETRY_STEPS = 4
SYMMETRY_FACTOR = 10.
SYMMETRY_ULPS = 4.
# blom_tpu's own f32 asymmetry of that run, by field
# (tripolar_symmetry_reference.py on the CPU: 64-bit types off, op by op)
SYMMETRY_REF = {
    'dp': 0.0, 'temp': 0.0, 'saln': 0.0, 'sigma': 0.0, 'sealv': 0.0,
    'pb': 0.0, 'pb_p': 0.0, 'pb_mn': 0.0, 'trc': 0.0, 'dpold': 0.0,
    'told': 0.0, 'sold': 0.0, 'trcold': 0.0, 'sigmar': 0.0,
    'ustarb': 3.637978807091713e-12, 'phi': 0.0, 'p': 0.0,
    'u': 1.6370904631912708e-11, 'dpu': 0.0, 'dpuold': 0.0, 'pbu': 0.0,
    'pbu_p': 0.0, 'pu': 0.0, 'ub': 7.275957614183426e-12, 'ubflx': 0.25,
    'ubflx_mn': 0.125, 'ubflxs': 4.0, 'ubflxs_p': 8.0,
    'ubcors_p': 2.2737367544323206e-13, 'uflx': 30.0, 'utflx': 352.0,
    'usflx': 1088.0, 'cau': 0.0001220703125, 'pgfx': 0.0, 'pgfx_o': 0.0,
    'pgfxm': 0.0, 'pgfxm_o': 0.0, 'v': 1.1368683772161603e-11, 'dpv': 0.0,
    'dpvold': 0.0, 'pbv': 0.0, 'pbv_p': 0.0, 'pv': 0.0,
    'vb': 1.1368683772161603e-13, 'vbflx': 0.001953125,
    'vbflx_mn': 0.00390625, 'vbflxs': 0.125, 'vbflxs_p': 0.25,
    'vbcors_p': 5.684341886080802e-14, 'vflx': 14.0, 'vtflx': 1344.0,
    'vsflx': 2048.0, 'cav': 0.0001220703125, 'pgfy': 0.0, 'pgfy_o': 0.0,
    'pgfym': 0.0, 'pgfym_o': 0.0, 'pvtrop': 1.3877787807814457e-17}
PARITY_TRIPOLAR = dict(itdm=16, jtdm=12, kdm=6)


def physical_mass(model, dp):
    """Mass over the physical rows of a tripolar grid: all but the fold's
    duplicated top row (tools/testsuite.py:81-86)."""
    g = model.grid
    return float((dp.double()[:, :-1].sum(0)
                  * (g.scp2 * g.ip).double()[:-1]).sum())


def run_tripolar(dev, paths, syncs, results):
    """The tripolar grid at the main path's size in f32 through
    build_tripolar and run: warm-up and timed steps, the gates, launches
    and host syncs per step, s/step and grid-points/s, the device time of
    each phase; then its kernels on their inputs from this run
    (check_tripolar_kernels, records to `results`)."""
    import torch
    from blom_tpu_torch.drivers import standalone
    warm, nsteps = NSTEPS_TRIPOLAR
    t0 = time.perf_counter()
    model = standalone.build_tripolar(dtype=torch.float32, itdm=II,
                                      jtdm=JJ, kdm=KK, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mass0 = physical_mass(model, model.state.dp[1])
    s_warm, clock = standalone.run(model, warm)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    nsync = counts.pop('host_syncs')
    paths['tripolar'] = counts
    new = 1 if nsteps % 2 == 0 else 0
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
    drift = (physical_mass(model, s.dp[new]) - mass0) / mass0
    saln_dev = float(((s.saln[new] - 35.) * model.grid.ip).abs().max())
    seam = float(s.vflx[:, :, -1, :].abs().max())
    plain = syncs['fuk95']
    ok = (finite and abs(drift) <= 1e-5 and saln_dev <= SALN_DEV_ALE
          and seam > 0. and nsync / nsteps <= plain
          and launches_ok(counts, model.par, nsteps, arctic=True))
    emit('tripolar', shape=[KK, JJ, II], dtype='float32',
         build_seconds=build_s, warmup_steps=warm, steps=nsteps, ok=ok,
         finite=finite, rel_physical_mass_drift=drift,
         max_saln_dev=saln_dev, max_abs_vflx_seam=seam,
         max_abs_v=float(s.v.abs().max()), launches=counts,
         host_syncs_per_step=nsync / nsteps,
         plain_host_syncs_per_step=plain,
         seconds_per_step=wall / nsteps,
         gridpoints_per_s=II * JJ * KK * nsteps / wall)
    profile_phases(model, 2, 'tripolar_phase_profile')
    ok &= check_tripolar_kernels(model, s_warm, clock.delt1, results)
    return ok


def check_tripolar_kernels(model, s, delt1, results):
    """The CPPM sweep on both axes (the j-sweep over the 363 rows of the
    fold-extended domain) and the momentum core (fold pre-pass and main
    kernel) on the inputs one tripolar step from state `s` gives them,
    each against its plain version in f32 (F32_REL) and on the same
    inputs cast to f64 (1e-12); the time of each call beside its plain
    version's and its bound, and for the momentum core each kernel's own
    device time from torch.profiler."""
    import torch
    from blom_tpu_torch.dynamics import cppm, cppm_cuda, momtum, momtum_cuda
    calls = capture_kernel_inputs(model, s, delt1)
    kernel = {'cppm_sweep': cppm_cuda.cppm_sweep_cuda,
              'momtum_uv': momtum_cuda.momtum_uv_cuda}

    def plain(name, a, kw):
        if name == 'momtum_uv':
            return momtum._uv_body(*a)
        return cppm._cppm_sweep_body(
            *a, kw.get('div_corr'), kw['ax'], kw['compatibility'],
            kw['limiting'])

    ok_all = len(calls['cppm_sweep']) == 2 and len(calls['momtum_uv']) == 1
    for name in ('cppm_sweep', 'momtum_uv'):
        for a, kw in calls[name]:
            if name == 'cppm_sweep':
                shape = tuple(a[0].shape)
                rec = dict(kernel=name, path='tripolar', ax=kw['ax'],
                           shape=list(shape),
                           variant=f"{kw['compatibility']}/"
                                   f"{kw['limiting']}",
                           div_corr=kw.get('div_corr') is not None)
                dtype = a[0].dtype
            else:
                rec = dict(kernel=name, path='tripolar',
                           variant=a[1].mommth, arctic=a[0].arctic)
                dtype = a[2].u_m.dtype
            ok = True
            for tag, args, kwt in (
                    ('f32', a, kw),
                    ('f64', [_to_f64(x) for x in a],
                     {k: _to_f64(v) for k, v in kw.items()})):
                out = kernel[name](*args, **kwt)
                ref = plain(name, args, kwt)
                torch.cuda.synchronize()
                o, e_abs, e_rel = compare(
                    out, ref, torch.float64 if tag == 'f64' else dtype)
                rec[f'{tag}_ok'], rec[f'{tag}_max_abs_err'] = o, e_abs
                rec[f'{tag}_max_rel_err'] = e_rel
                ok &= o
            rec['ok'] = ok
            rec['ms'] = time_ms(lambda: kernel[name](*a, **kw))
            rec['plain_ms'] = time_ms(lambda: plain(name, a, kw), reps=5,
                                      warm=1)
            if name == 'cppm_sweep':
                nbytes = cppm_bytes(
                    dtype, rec['div_corr'], kw['compatibility'],
                    kw['limiting'], a[7].stencil, a[1].shape[0],
                    n3_planes=int(a[3].dim() == 3) + int(a[6].dim() == 3),
                    shape=shape)
                nops = cppm_ops_per_cell(a[1].shape[0]) * shape[0] \
                    * shape[1] * shape[2]
            else:
                # the function's own bound, as on the main path: the
                # fold pre-pass's ghost buffer and its recomputed stages
                # are the design's cost, so they show as time over it
                nbytes = momtum_bytes(dtype)
                nops = MOMTUM_OPS_PER_POINT * KK * JJ * II

                def call():
                    return kernel[name](*a, **kw)
                prof = profiler_ms(call, ('momtum_uv_kernel',
                                          'momtum_fold_kernel'))
                rec['profiler_ms'] = prof['momtum_uv_kernel']
                rec['fold_profiler_ms'] = prof['momtum_fold_kernel']
            rec['bound_ms'], rec['bound_by'] = bound(nbytes, nops)
            emit('tripolar_kernels', **rec)
            results.append(rec)
            ok_all &= ok
    return ok_all


def fold_asymmetry(s):
    """{field: max |arctic_sync(a) - a|} over the fields of STATE_KINDS."""
    from blom_tpu_torch.parallel import arctic
    return {name: float((arctic.arctic_sync(getattr(s, name), kind, vec)
                         - getattr(s, name)).abs().max())
            if getattr(s, name).numel() else 0.
            for name, (kind, vec) in arctic.STATE_KINDS.items()}


def run_tripolar_symmetry(dev):
    """SYMMETRY_STEPS steps of build_tripolar at SYMMETRY_SIZE in f32 with
    the end-of-step fold sync replaced by the identity: the fold reads of
    the stencils alone must keep the state symmetric to rounding.  Each
    field of STATE_KINDS within SYMMETRY_FACTOR times blom_tpu's own f32
    asymmetry of the same run (SYMMETRY_REF) or SYMMETRY_ULPS f32 ulps of
    the field's largest magnitude, whichever is larger."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.parallel import arctic
    model = standalone.build_tripolar(dtype=torch.float32, device=dev,
                                      **SYMMETRY_SIZE)
    sync = arctic.sync_state
    arctic.sync_state = lambda st: st
    try:
        s, _ = standalone.run(model, SYMMETRY_STEPS)
    finally:
        arctic.sync_state = sync
    torch.cuda.synchronize()
    err = fold_asymmetry(s)
    eps = float(torch.finfo(torch.float32).eps)
    limits = {}
    for name in err:
        a = getattr(s, name)
        scale = float(a.abs().max()) if a.numel() else 0.
        limits[name] = max(SYMMETRY_FACTOR * SYMMETRY_REF.get(name, 0.),
                           SYMMETRY_ULPS * eps * scale)
    bad = {k: (err[k], limits[k]) for k in err if err[k] > limits[k]}
    ok = (bool(torch.isfinite(s.dp).all()) and not bad
          and set(SYMMETRY_REF) == set(err)
          and float(s.v.abs().max()) > 0.)
    emit('tripolar_symmetry', ok=ok, size=SYMMETRY_SIZE,
         steps=SYMMETRY_STEPS, factor=SYMMETRY_FACTOR, asymmetry=err,
         blom_tpu_f32_asymmetry=SYMMETRY_REF, limits=limits,
         over_limit=bad)
    return ok


def state_to(s, dev):
    """A copy of `s`, a dataclass of tensors (State, DiffusionFields), on
    `dev`."""
    import dataclasses
    return type(s)(**{f.name: getattr(s, f.name).to(dev, copy=True)
                      for f in dataclasses.fields(s)})


def run_tripolar_parity(dev):
    """One f64 step of each time-level parity of the tripolar step at
    PARITY_TRIPOLAR size, card against CPU, from the state the CPU reaches
    in three steps (the fold rows carry flow), within STEP_REL."""
    import dataclasses
    import torch
    from blom_tpu_torch.drivers import standalone
    cpu = standalone.build_tripolar(dtype=torch.float64, device='cpu',
                                    **PARITY_TRIPOLAR)
    s, _ = standalone.run(cpu, 3)
    models = {'cpu': dataclasses.replace(cpu, state=s)}
    card = standalone.build_tripolar(dtype=torch.float64, device=dev,
                                     **PARITY_TRIPOLAR)
    card.dfl = type(cpu.dfl)(**{f.name: getattr(cpu.dfl, f.name).to(dev)
                                for f in dataclasses.fields(cpu.dfl)})
    models[dev] = dataclasses.replace(card, state=state_to(s, dev))
    one_step = one_step_parity(models, dev)
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('tripolar_parity', ok=ok, tolerance=STEP_REL,
         size=PARITY_TRIPOLAR, from_step=3, one_step=one_step)
    return ok


# ------------------------------------------------ the vertical physics

# KPP with the tidal field and the Langmuir factor on fuk95: a wind
# stress, a cooling (so that the nonlocal term is active) and seeded
# fields; its parity step also takes the geopotential PGF
NSTEPS_KPP = (2, 10)                # warm-up, timed steps
KPP_TAUX = .1                       # N m-2 at u points
KPP_SURFLX = 200.                   # W m-2, > 0 cools
TWEDON_RANGE = (.01, .05)           # kg s-2 over water
LAMULT_RANGE = (1., 2.)
PARITY_KPP = dict(itdm=24, jtdm=8, kdm=8)
# The TKE/GLS closure on the isopycnic fuk95 (two tracer slots, itrtke 0,
# itrgls 1, as tests/test_tke.py:103-111 builds them)
NSTEPS_TKE = (1, 3)
PARITY_TKE = dict(itdm=24, jtdm=8, kdm=10)
# the slots may fall below their floors only by f32 rounding in the
# transport and mixing that carry them (1e-5 is ~80 f32 ulps)
TKE_FLOOR_REL = 1e-5


def twedon_path(shape):
    """build/tidal/twedon_<J>x<I>.npz beside this script."""
    from pathlib import Path
    path = Path(__file__).resolve().parent / 'build' / 'tidal'
    path.mkdir(parents=True, exist_ok=True)
    return str(path / f'twedon_{shape[0]}x{shape[1]}.npz')


def build_kpp(dev, dtype, pgfmth='dynamic enthalpy', **size):
    """fuk95 with bench.py's physics, KPP and the tidal term: twedon made
    from SEED in TWEDON_RANGE over water, written to a .npz and read back
    with read_tidaldissip; the forcing KPP_TAUX, KPP_SURFLX and a seeded
    Langmuir factor in LAMULT_RANGE."""
    import dataclasses
    import numpy as np
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    from blom_tpu_torch.phys.tidaldissip import read_tidaldissip
    from blom_tpu_torch.phys.vmix import VmixParams
    model = standalone.build_fuk95(dtype=dtype, device=dev, **size)
    g = model.grid
    H = tuple(g.shape)
    rng = np.random.default_rng(SEED)
    ip = g.ip.cpu().double().numpy()
    path = twedon_path(H)
    np.savez(path, twedon=rng.uniform(*TWEDON_RANGE, H) * ip)
    twedon = read_tidaldissip(path, dtype=dtype, device=dev)
    model.forcing = dataclasses.replace(
        model.forcing, taux=KPP_TAUX * g.iu, surflx=KPP_SURFLX * g.ip,
        lamult=torch.as_tensor(rng.uniform(*LAMULT_RANGE, H), dtype=dtype,
                               device=dev))
    model.par = model.par._replace(
        difest=DifestParams(**BENCH_DIFEST), pgfmth=pgfmth,
        vmix=VmixParams(use_kpp=True, twedon=twedon))
    return model


def kpp_gates(model, s, n):
    """tests/test_kpp.py on the final state's level n: difest_vertical_kpp
    leaves the surface interface 0, the nonlocal term active over water
    (cooling), the OBL depth finite and >= 1 m; the tidal increment of
    difest_vertical >= 0 and larger at the deepest interior interface
    than at the shallowest, on the mean over water
    (tests/test_kpp.py:135-171)."""
    import torch
    from blom_tpu_torch.phys.vmix import difest_vertical, difest_vertical_kpp
    g, par = model.grid, model.par.vmix
    wet = g.ip > 0
    vf = difest_vertical_kpp(g, model.e, s, model.forcing, model.swabs, par,
                             n)
    tid = difest_vertical(g, model.e, s, model.forcing, model.swabs, par, n)
    base = difest_vertical(g, model.e, s, model.forcing, model.swabs,
                           par._replace(twedon=None), n)
    dk = (tid.Kdiff_t - base.Kdiff_t)[:, wet].double()
    hbl = vf.mld[wet].double()
    rec = dict(kdiff_surface_max=float(vf.Kdiff_t[0].abs().max()),
               nonlocal_max=float(vf.t_ns_nonloc[1:][:, wet].max()),
               obl_depth_m=[float(hbl.min()), float(hbl.max())],
               obl_finite=bool(torch.isfinite(vf.mld).all()),
               tidal_increment_min=float(dk.min()),
               tidal_increment_mean=[float(dk[1].mean()),
                                     float(dk[-1].mean())])
    ok = (rec['kdiff_surface_max'] == 0. and rec['nonlocal_max'] > 0.
          and rec['obl_finite'] and rec['obl_depth_m'][0] >= 1.
          and rec['tidal_increment_min'] >= 0.
          and rec['tidal_increment_mean'][1] > rec['tidal_increment_mean'][0])
    return ok, rec


def run_kpp(dev, paths, syncs):
    """KPP with the tidal term at the main path's width in f32: warm-up
    and timed steps, the slice's gates, launches per step as the main
    path's and host syncs per step no more than its, s/step and
    grid-points/s, the device time of each phase, then kpp_gates on the
    final state."""
    import torch
    from blom_tpu_torch.drivers import standalone
    warm, nsteps = NSTEPS_KPP
    t0 = time.perf_counter()
    model = build_kpp(dev, torch.float32, itdm=II, jtdm=JJ, kdm=KK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mass0 = mass(model, model.state.dp[1])
    standalone.run(model, warm)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    nsync = counts.pop('host_syncs')
    paths['fuk95_kpp'] = counts
    ok, rec = slice_gates(model, s, nsteps, mass0)
    ok &= launches_ok(counts, model.par, nsteps)
    ok &= nsync / nsteps <= syncs['fuk95']
    ok_k, rec_k = kpp_gates(model, s, 1 if nsteps % 2 == 0 else 0)
    ok &= ok_k
    emit('kpp', shape=[KK, JJ, II], dtype='float32', build_seconds=build_s,
         warmup_steps=warm, steps=nsteps, ok=ok, **rec, **rec_k,
         launches=counts, host_syncs_per_step=nsync / nsteps,
         plain_host_syncs_per_step=syncs['fuk95'],
         seconds_per_step=wall / nsteps,
         gridpoints_per_s=II * JJ * KK * nsteps / wall)
    profile_phases(model, 2, 'kpp_phase_profile')
    return ok


def run_kpp_parity(dev):
    """One f64 step of each time-level parity with KPP, the tidal field
    and the geopotential PGF at PARITY_KPP, card against CPU, within
    STEP_REL."""
    import torch
    models = {d: build_kpp(d, torch.float64, 'geopotential', **PARITY_KPP)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev)
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('kpp_parity', ok=ok, tolerance=STEP_REL, size=PARITY_KPP,
         one_step=one_step)
    return ok


def build_tke(dev, dtype, **size):
    """The isopycnic fuk95 with bench.py's physics and the TKE/GLS
    closure: two tracer slots at their minima (init_tke_tracers), itrtke
    0, itrgls 1."""
    import torch
    from blom_tpu_torch.phys.tke import init_tke_tracers
    model = build_isopyc(dev, dtype, **size)
    s, g = model.state, model.grid
    shape = (g.kk,) + tuple(g.shape)
    s.trc = init_tke_tracers(torch.zeros((2, 2) + shape, dtype=dtype,
                                         device=dev), 0, 1)
    s.trcold = torch.zeros((2,) + shape, dtype=dtype, device=dev)
    model.par = model.par._replace(itrtke=0, itrgls=1)
    return model


def tke_gates(model, s, nsteps):
    """Over water the TKE and psi slots at their floors or above (within
    TKE_FLOOR_REL), and TKE above twice its floor somewhere (the bottom
    friction condition, tests/test_tke.py:103-125)."""
    import torch
    from blom_tpu_torch.phys import tke
    new = 1 if nsteps % 2 == 0 else 0
    wet = model.grid.ip > 0
    t = s.trc[new, model.par.itrtke][:, wet].double()
    q = s.trc[new, model.par.itrgls][:, wet].double()
    rec = dict(finite_trc=bool(torch.isfinite(s.trc).all()),
               tke=[float(t.min()), float(t.max())],
               gls=[float(q.min()), float(q.max())],
               tke_min=tke.tke_min, gls_psi_min=tke.gls_psi_min)
    lo = 1. - TKE_FLOOR_REL
    ok = (rec['finite_trc'] and rec['tke'][0] >= tke.tke_min * lo
          and rec['gls'][0] >= tke.gls_psi_min * lo
          and rec['tke'][1] > 2. * tke.tke_min)
    return ok, rec


def run_tke(dev, paths, syncs, results):
    """The TKE/GLS closure on the isopycnic path at the main path's width
    in f32: warm-up and timed steps, the isopycnic gates and tke_gates,
    launches per step (CPPM 2, momentum 1), every CPPM launch carrying 4
    fields, s/step and grid-points/s, the device time of each phase; then
    the CPPM sweep at nt 4 on the inputs of one step of this run
    (check_tracer_kernels, phase 'tke')."""
    import torch
    from blom_tpu_torch.drivers import standalone
    warm, nsteps = NSTEPS_TKE
    t0 = time.perf_counter()
    model = build_tke(dev, torch.float32, itdm=II, jtdm=JJ, kdm=KK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mass0 = mass(model, model.state.dp[1])
    s_warm, clock = standalone.run(model, warm)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    nsync = counts.pop('host_syncs')
    paths['fuk95_tke'] = counts
    ok, rec = isopyc_gates(model, s, nsteps, mass0)
    ok_t, rec_t = tke_gates(model, s, nsteps)
    ok &= ok_t and launches_ok(counts, model.par, nsteps)
    ok &= counts['carried'] == {'cppm_sweep': {4: 2 * nsteps},
                                'ale_remap': {}}
    emit('tke', shape=[KK, JJ, II], dtype='float32', build_seconds=build_s,
         warmup_steps=warm, steps=nsteps, ok=ok, **rec, **rec_t,
         launches=counts, host_syncs_per_step=nsync / nsteps,
         plain_host_syncs_per_step=syncs['fuk95_isopyc'],
         seconds_per_step=wall / nsteps,
         gridpoints_per_s=II * JJ * KK * nsteps / wall)
    profile_phases(model, 1, 'tke_phase_profile')
    ok &= check_tracer_kernels(model, s_warm, clock.delt1, results, 'tke')
    return ok


def run_tke_parity(dev):
    """One f64 step of each time-level parity with the closure at
    PARITY_TKE, card against CPU, within STEP_REL, the two slots one by
    one among the fields."""
    import torch
    models = {d: build_tke(d, torch.float64, **PARITY_TKE)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev, PARITY_FIELDS + ('trc',))
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('tke_parity', ok=ok, tolerance=STEP_REL, size=PARITY_TKE,
         one_step=one_step)
    return ok


# ------------------------------------------------------------- highorder

NSTEPS_HIGHORDER = (2, 4)           # warm-up, timed steps
PARITY_HIGHORDER = dict(itdm=24, jtdm=8, kdm=8)
# the ALE methods that run plain, off kernels K1 and K2
HIGHORDER_VARIANTS = {
    'ppm_ih4': dict(reconstruction_method='ppm_ih4'),
    'pqm': dict(reconstruction_method='pqm', upper_bndr_ord=6,
                lower_bndr_ord=4),
    'direct': dict(regrid_method='direct'),
}


def build_highorder(dev, dtype, variant, **size):
    """fuk95 with bench.py's physics and the ALE method of `variant`."""
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    model = standalone.build_fuk95(dtype=dtype, device=dev, **size)
    model.par = model.par._replace(
        difest=DifestParams(**BENCH_DIFEST),
        ale=model.par.ale._replace(**HIGHORDER_VARIANTS[variant]))
    return model


def run_variants(dev, paths, phase, variants, build, nsteps, record,
                 gates=slice_gates):
    """Each variant of `variants` (build(dev, dtype, name, **size) builds
    it) at the main path's width in f32: nsteps = (warm-up, timed) steps,
    or {variant: (warm-up, timed)}, gates(model, s, nsteps, mass0) (the
    slice's), launches per step (expected_launches), s/step,
    grid-points/s, the device time of each phase and the peak device
    memory allocated from the build on (base_mem_bytes: what was
    allocated before it), emitted as `phase`, with record(name, model,
    phase_ms, s)'s keys (a key ending in '_ok' gates too).  The timed
    steps start again from the initial state; their launch counts go to
    paths[f'fuk95_{name}']."""
    import torch
    from blom_tpu_torch.drivers import standalone
    ok_all = True
    for name in variants:
        warm, nsteps_v = (nsteps[name] if isinstance(nsteps, dict)
                          else nsteps)
        torch.cuda.reset_peak_memory_stats(dev)
        base_mem = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        model = build(dev, torch.float32, name, itdm=II, jtdm=JJ, kdm=KK)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        mass0 = mass(model, model.state.dp[1])
        standalone.run(model, warm)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        s, _ = standalone.run(model, nsteps_v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        syncs_n = counts.pop('host_syncs')
        paths[f'fuk95_{name}'] = counts
        ok, rec = gates(model, s, nsteps_v, mass0)
        ok &= launches_ok(counts, model.par, nsteps_v)
        step_ms, phase_ms = profile_phases(model, 2,
                                           f'{phase}_{name}_phase_profile')
        extra = record(name, model, phase_ms, s)
        ok &= all(v for k, v in extra.items() if k.endswith('_ok'))
        emit(phase, variant=name, shape=[KK, JJ, II], dtype='float32',
             build_seconds=build_s, warmup_steps=warm, steps=nsteps_v,
             ok=ok, **rec, launches=counts,
             launches_per_step_expected=expected_launches(model.par),
             host_syncs_per_step=syncs_n / nsteps_v,
             seconds_per_step=wall / nsteps_v,
             gridpoints_per_s=II * JJ * KK * nsteps_v / wall,
             step_ms=step_ms, **extra,
             peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
             base_mem_bytes=base_mem)
        ok_all &= ok
        del model, s
    return ok_all


def run_variants_parity(dev, phase, variants, build, size):
    """One f64 step of each time-level parity under each variant of
    `variants` at `size`, card against CPU, within STEP_REL."""
    import torch
    ok_all = True
    for name in variants:
        models = {d: build(d, torch.float64, name, **size)
                  for d in (dev, 'cpu')}
        one_step = one_step_parity(models, dev)
        ok = all(r <= STEP_REL for _, r in one_step.values())
        emit(phase, variant=name, ok=ok, tolerance=STEP_REL, size=size,
             one_step=one_step)
        ok_all &= ok
    return ok_all


def run_highorder(dev, paths):
    """Each ALE method of HIGHORDER_VARIANTS through run_variants
    (launches per step CPPM 2, momentum 1, K1 and K2 0; the
    'ale_regrid_remap' phase reported apart), then the direct regrid at
    SALN_REF_SIZE, as blom_tpu's reading SALN_REF was taken
    (run_highorder_drift)."""
    def record(name, model, phase_ms, s):
        return dict(ale=model.par.ale._asdict(),
                    saln_tol=(SALN_DEV_DIRECT if name == 'direct'
                              else SALN_DEV_ALE),
                    ale_ms=phase_ms.get('ale_regrid_remap'))
    ok = run_variants(dev, paths, 'highorder', HIGHORDER_VARIANTS,
                      build_highorder, NSTEPS_HIGHORDER, record)
    return ok & run_highorder_drift(dev)


def run_highorder_drift(dev):
    """The direct regrid in f32 at SALN_REF_SIZE, NSTEPS_HIGHORDER's
    timed steps from the initial state: the slice's gates, its salinity
    deviation beside blom_tpu's own there (SALN_REF)."""
    import torch
    from blom_tpu_torch.drivers import standalone
    nsteps = NSTEPS_HIGHORDER[1]
    model = build_highorder(dev, torch.float32, 'direct', **SALN_REF_SIZE)
    mass0 = mass(model, model.state.dp[1])
    s, _ = standalone.run(model, nsteps)
    ok, rec = slice_gates(model, s, nsteps, mass0)
    emit('highorder_drift', variant='direct', size=SALN_REF_SIZE,
         dtype='float32', steps=nsteps, ok=ok, **rec,
         blom_tpu_saln_dev=SALN_REF,
         ratio=rec['max_saln_dev'] / SALN_REF, saln_tol=SALN_DEV_DIRECT)
    return ok


def run_highorder_parity(dev):
    """One f64 step of each time-level parity under each ALE method of
    HIGHORDER_VARIANTS at PARITY_HIGHORDER, card against CPU, within
    STEP_REL."""
    return run_variants_parity(dev, 'highorder_parity', HIGHORDER_VARIANTS,
                               build_highorder, PARITY_HIGHORDER)


# -------------------------------------------------------------- transport

NSTEPS_TRANSPORT = (2, 4)           # warm-up, timed steps
PARITY_TRANSPORT = dict(itdm=24, jtdm=8, kdm=8)
# the lateral transport options: incremental-remapping advection in place
# of the CPPM sweeps, neutral diffusion in place of diffus; both plain
# PyTorch, as blom_tpu runs them as plain XLA
TRANSPORT_VARIANTS = {'remap': dict(advmth='remap'),
                      'neutral': dict(ltedtp='neutral')}


def build_transport(dev, dtype, variant, **size):
    """fuk95 with bench.py's physics and the transport option of
    `variant`."""
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    model = standalone.build_fuk95(dtype=dtype, device=dev, **size)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST),
                                   **TRANSPORT_VARIANTS[variant])
    return model


def phase_trace(call):
    """One call of `call` under torch.profiler: the device activities it
    recorded (kernel launches, memory copies and sets), their device
    milliseconds summed, and the call's host-clock milliseconds up to a
    synchronise (under the profiler); busy_share is their ratio, None
    where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return dict(launches=len(events), device_ms=busy_ms, wall_ms=wall_ms,
                busy_share=busy_ms / wall_ms if busy_ms > 0 else None)


def transport_call(name, model):
    """A call of the transport option's own phase on a copy of the
    model's state at level n = 1: advect under incremental remapping,
    ndiff (with cmnfld's mixed layer) under neutral diffusion."""
    from blom_tpu_torch.core.constants import onem
    from blom_tpu_torch.dynamics.advect import advect
    from blom_tpu_torch.dynamics.cmnfld import cmnfld
    from blom_tpu_torch.dynamics.ndiff import ndiff
    g, s, delt1 = model.grid, model.state.clone(), model.clock.delt1
    if name == 'remap':
        return lambda: advect(g, s, model.dfl, model.coeffs_i,
                              model.coeffs_j, 0, 1, delt1, model.par.dlt,
                              'remap')
    mld = cmnfld(g, model.e, s, 1).mld * onem
    return lambda: ndiff(g, model.e, s, model.dfl, 0, 1, delt1, mld)


def run_transport(dev, paths):
    """Each transport option of TRANSPORT_VARIANTS through run_variants
    (launches per step: remap CPPM 0, neutral CPPM 2; momentum, K1 and K2
    1 each), the 'advect' and 'ndiff' phases reported apart; then one
    call of the option's phase traced (phase_trace)."""
    def record(name, model, phase_ms, s):
        return dict(change=TRANSPORT_VARIANTS[name], saln_tol=SALN_DEV_ALE,
                    advect_ms=phase_ms.get('advect'),
                    ndiff_ms=phase_ms.get('ndiff'),
                    diffus_ms=phase_ms.get('diffus'),
                    phase_trace=phase_trace(transport_call(name, model)))
    return run_variants(dev, paths, 'transport', TRANSPORT_VARIANTS,
                        build_transport, NSTEPS_TRANSPORT, record)


def run_transport_parity(dev):
    """One f64 step of each time-level parity under each transport option
    at PARITY_TRANSPORT, card against CPU, within STEP_REL."""
    return run_variants_parity(dev, 'transport_parity', TRANSPORT_VARIANTS,
                               build_transport, PARITY_TRANSPORT)


# ---------------------------------------------------------------- surface

NSTEPS_SURFACE = {'restoring': (2, 4), 'restoring_chl': (2, 4),
                  'restoring_isopyc': (1, 2)}    # warm-up, timed steps
PARITY_SURFACE = dict(itdm=24, jtdm=8, kdm=10)
# surface restoring (ThermfParams' other fields at their defaults), with
# the chlorophyll shortwave, and on the isopycnic coordinate
RESTORING = dict(trxday=30., srxday=30.)
SURFACE_VARIANTS = {'restoring': dict(), 'restoring_chl':
                    dict(swamth='chlorophyll_ohl03'),
                    'restoring_isopyc': dict(vcoord=ISOPYC)}
# the chlorophyll variant's shortwave heating [W m-2, positive up], so
# that its absorption profile acts (fuk95's forcing has none)
SSWFLX_CHL = -200.
# the climatologies' differences from the top layer: beyond trxlim
# (1.5 C) and srxlim (0.5 g/kg), so that the clamps bite
SST_SPREAD, SSS_SPREAD = 3., 1.
BEN02_REL = 1e-10
_THERMF = []     # the Forcing of the last thermf_relax call (observe_thermf)


def observe_thermf():
    """Wrap the step's thermf_relax so that _THERMF holds the Forcing of
    its last call; returns the original, to put back."""
    from blom_tpu_torch.dynamics import step
    orig = step.thermf_relax

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        _THERMF[:] = [out]
        return out
    step.thermf_relax = wrapped
    return orig


def surface_climatologies(model, seed=SEED):
    """(sstclm, sssclm) on the model's device and dtype at its clock: the
    SSS from 12 seeded months written to an .npz under build/ with a
    block of missing values, read back by rdcsss (its fill over the
    mask) and interpolated by intp1d at month_interp(); the SST from 48
    seeded slices by clim_indices and intp1d at the day of the year.
    Each slice is the initial top layer plus one seeded anomaly within
    SST_SPREAD (SSS_SPREAD) and a smaller slice-to-slice noise."""
    from pathlib import Path
    import numpy as np
    import torch
    from blom_tpu_torch.phys.intp1d import clim_indices, intp1d
    from blom_tpu_torch.phys.rdcsss import rdcsss
    g, clock = model.grid, model.clock
    dev, dtype = g.ip.device, g.ip.dtype
    rng = np.random.default_rng(seed)
    H = tuple(g.shape)
    t0 = model.state.temp[1, 0].double().cpu().numpy()
    s0 = model.state.saln[1, 0].double().cpu().numpy()
    sst = (t0 + rng.uniform(-SST_SPREAD, SST_SPREAD, H)
           + rng.uniform(-.1, .1, (48,) + H))
    sss = (s0 + rng.uniform(-SSS_SPREAD, SSS_SPREAD, H)
           + rng.uniform(-.05, .05, (12,) + H))
    j0, i0 = H[0] // 3, H[1] // 3
    sss[:, j0:j0 + H[0] // 8, i0:i0 + H[1] // 8] = -9.99e33
    path = Path(__file__).resolve().parent / 'build' / 'surface'
    path.mkdir(parents=True, exist_ok=True)
    path = path / f'sss_{H[1]}x{H[0]}.npz'
    np.savez(path, sss=sss)
    sssc = rdcsss(str(path), mask=g.ip.cpu(), dtype=dtype, device=dev)
    xmi, *months = clock.month_interp()
    sssclm = intp1d(*(sssc[mo - 1] for mo in months), xmi)
    frac = (clock.nstep % clock.nstep_in_day) / clock.nstep_in_day
    *slices, x = clim_indices(clock.nday_of_year, frac, 48,
                              clock.nday_in_year)
    sstc = torch.as_tensor(sst, dtype=dtype, device=dev)
    return intp1d(*(sstc[k] for k in slices), x), sssclm


def build_surface(dev, dtype, variant, **size):
    """fuk95 with bench.py's physics restoring towards
    surface_climatologies(); 'restoring_chl' with the chlorophyll_ohl03
    absorption from updswa of a seeded 12-month log10-chl climatology
    and SSWFLX_CHL of shortwave heating over water, 'restoring_isopyc' on
    the isopycnic coordinate."""
    import dataclasses
    import numpy as np
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    from blom_tpu_torch.phys.swabs import updswa
    from blom_tpu_torch.phys.thermf import ThermfParams
    kw = dict(SURFACE_VARIANTS[variant])
    swamth = kw.pop('swamth', None)
    model = standalone.build_fuk95(dtype=dtype, device=dev, **kw, **size)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST),
                                   thermf=ThermfParams(**RESTORING))
    sstclm, sssclm = surface_climatologies(model)
    model.forcing = dataclasses.replace(model.forcing, sstclm=sstclm,
                                        sssclm=sssclm)
    if swamth is not None:
        rng = np.random.default_rng(SEED + 1)
        chl10c = torch.as_tensor(
            rng.uniform(-2., 1., (12,) + tuple(model.grid.shape)),
            dtype=dtype, device=dev)
        model.swabs = updswa(swamth, chl10c, model.clock.month_interp())
        sw = SSWFLX_CHL * model.grid.ip
        model.forcing = dataclasses.replace(model.forcing, surflx=sw,
                                            sswflx=sw.clone())
    return model


def restoring_gates(model, forcing):
    """The restoring fluxes of the last step (`forcing`, thermf_relax's):
    over water nonzero (all but one point in 10^4: an f32 difference can
    round to zero) and within their clamp bounds
    (spcifh*trxdpt*onem/grav*trxlim/(trxday*86400) and the salt analogue,
    plus f32 rounding), the bound reached where the clamp bites; zero on
    land."""
    from blom_tpu_torch.core.constants import grav, onem, spcifh
    par = model.par.thermf
    wet = model.grid.ip > 0
    rec, ok = {}, True
    for name, day, dpt, lim, c in (
            ('surrlx', par.trxday, par.trxdpt, par.trxlim, spcifh),
            ('salrlx', par.srxday, par.srxdpt, par.srxlim, 1.)):
        f = getattr(forcing, name).double()
        bound = c * dpt * onem / grav * lim / (day * 86400.)
        top = float(f[wet].abs().max())
        nonzero = float((f[wet] != 0.).double().mean())
        land = float(f[~wet].abs().max()) if bool((~wet).any()) else 0.
        good = (nonzero >= 1. - 1e-4 and land == 0.
                and bound * (1. - 1e-5) <= top <= bound * (1. + 1e-5))
        rec[name] = dict(max_abs=top, bound=bound, nonzero_share=nonzero,
                         land_max_abs=land, ok=good)
        ok &= good
    return ok, rec


def surface_gates(model, s, nsteps, mass0):
    """The slice's gates (the isopycnic ones on that coordinate) and
    restoring_gates on the fluxes of the run's last step."""
    ok, rec = (isopyc_gates if model.par.vcoord_isopyc else slice_gates)(
        model, s, nsteps, mass0)
    rok, rrec = restoring_gates(model, _THERMF[0])
    return ok and rok, dict(rec, restoring=rrec)


def temmin_check(model, s, nsteps):
    """diapfl on the newest level of the isopycnic path's final state,
    with settemmin's per-layer floor and with the -3 C default: finite,
    the floor not lowering any temperature; the cells it lifts counted."""
    import torch
    from blom_tpu_torch.dynamics.diapfl import diapfl
    from blom_tpu_torch.phys.temmin import settemmin
    g = model.grid
    n = 1 if nsteps % 2 == 0 else 0
    kdiff = torch.full_like(s.dp[n], 1e-5)
    tmn = settemmin(model.e, s.sigmar, True)
    out = {k: diapfl(g, model.e, s.clone(), kdiff, 1 - n, n,
                     model.clock.delt1, temmin=t).temp[n]
           for k, t in (('field', tmn), ('none', None))}
    lift = out['field'].double() - out['none'].double()
    ok = bool(torch.isfinite(out['field']).all()) and float(lift.min()) >= 0.
    return ok, dict(ok=ok, temmin_range=[float(tmn[1:].min()),
                                         float(tmn[1:].max())],
                    cells_lifted=int((lift > 0.).sum()),
                    max_lift=float(lift.max()))


def run_surface(dev, paths, final):
    """Each variant of SURFACE_VARIANTS through run_variants with
    surface_gates (launches per step: ALE CPPM 2, momentum 1, K1 1, K2
    1; isopycnic CPPM 2, momentum 1), the 'thermf' phase reported apart,
    and on the isopycnic path temmin_check; niw_inputs of the restoring
    variant's final state go to final['restoring'] (for run_ben02)."""
    from blom_tpu_torch.dynamics import step

    def record(name, model, phase_ms, s):
        rec = dict(thermf=model.par.thermf._asdict(),
                   swamth=SURFACE_VARIANTS[name].get('swamth', 'jerlov'),
                   thermf_ms=phase_ms.get('thermf'),
                   mxlayr_ms=phase_ms.get('mxlayr'))
        if name == 'restoring':
            final['restoring'] = niw_inputs(model, s)
        if model.par.vcoord_isopyc:
            rec['temmin_ok'], rec['temmin'] = temmin_check(
                model, s, NSTEPS_SURFACE[name][1])
        return rec
    orig = observe_thermf()
    try:
        ok = run_variants(dev, paths, 'surface', SURFACE_VARIANTS,
                          build_surface, NSTEPS_SURFACE, record,
                          gates=surface_gates)
    finally:
        step.thermf_relax = orig
    return ok


def run_surface_parity(dev):
    """One f64 step of each time-level parity under each variant of
    SURFACE_VARIANTS at PARITY_SURFACE, card against CPU, within
    STEP_REL."""
    return run_variants_parity(dev, 'surface_parity', SURFACE_VARIANTS,
                               build_surface, PARITY_SURFACE)


def surface_grid(dev, dtype):
    """fuk95's grid at the main path's (J, I) (4 layers: only the surface
    counts) and its eos."""
    from blom_tpu_torch.configs import fuk95
    from blom_tpu_torch.core import eos
    return (fuk95.make_grid(180., II, JJ, 4, dtype=dtype, device=dev),
            eos.init_eos(pref=0., expcnf='fuk95'))


def ben02_inputs(dev, dtype, seed=SEED):
    """The ben02 chain's inputs at the main path's (J, I), from a seed:
    surface_grid(), a seeded atmosphere, the cold case's open water just
    above freezing and the warm case's ice cover, as
    tests/test_ben02.py:83-138 sets them up."""
    import dataclasses
    import numpy as np
    import torch
    from blom_tpu_torch.core.eos import tfrz
    from blom_tpu_torch.phys import ben02, seaice
    from blom_tpu_torch.phys.swabs import init_swabs
    grid, e = surface_grid(dev, dtype)
    H = tuple(grid.shape)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def clim(**kw):
        c = ben02.neutral_clim(H, dtype, device=dev, **kw)
        return c._replace(
            tsrf_d=c.tsrf_d + t(rng.uniform(-3., 3., H)),
            shtfl=t(rng.uniform(-40., 40., H)),
            lhtfl=t(rng.uniform(-80., 20., H)),
            tau_d=t(rng.uniform(0., .3, H)), uwnd=t(rng.uniform(-1., 1., H)),
            vwnd=t(rng.uniform(-1., 1., H)),
            rnfins=t(rng.uniform(0., 1e-5, H)))
    ice0 = seaice.init_seaice(H, dtype, device=dev)
    sotl = t(35. + rng.uniform(-1., 1., H))
    cases = {
        'cold': (clim(dswrf=0., tsrf=248.), ice0,
                 tfrz(e, sotl) + .001, t(np.full(H, 5. * 9806.))),
        'warm': (clim(dswrf=300., tsrf=295.), dataclasses.replace(
            ice0, ficem=t(rng.uniform(.3, .7, H)),
            hicem=t(rng.uniform(.1, .4, H)),
            hsnwm=t(rng.uniform(0., .05, H)), tsrfm=t(np.full(H, 270.)),
            ticem=t(np.full(H, 270.))),
            t(6. + rng.uniform(-1., 1., H)), t(np.full(H, 20. * 9806.)))}
    sw = init_swabs(H, 'jerlov', 3, dtype, dev)
    return grid, e, sotl, cases, sw


def ben02_chain(dev, dtype):
    """asflux, thermf_ben02 and sfcstr_ben02 of both ben02_inputs cases:
    {name: tensor}."""
    import torch
    from blom_tpu_torch.phys import ben02
    g, e, sotl, cases, sw = ben02_inputs(dev, dtype)
    H = tuple(g.shape)
    out = {}
    for case, (clim, ice, totl, dp1) in cases.items():
        b = ben02.asflux(e, ben02.init_ben02(H, dtype, device=dev),
                         clim, ice, totl + 273.15, sotl)
        for k in ('nsf', 'dfl', 'eva', 'taufac', 'cd_m', 'ch_m'):
            out[f'{case}.asflux.{k}'] = getattr(b, k)
        new, flx = ben02.thermf_ben02(g, e, b, clim, ice, dp1, totl,
                                      sotl, torch.zeros_like(sotl),
                                      sw.swfc2, sw.swal2, 1800.)
        for k in ('ficem', 'hicem', 'hsnwm', 'tsrfm', 'ticem'):
            out[f'{case}.ice.{k}'] = getattr(new, k)
        for k, v in flx.items():
            out[f'{case}.flx.{k}'] = v
        taux, tauy = ben02.sfcstr_ben02(g, b, clim, new)
        out[f'{case}.sfcstr.taux'], out[f'{case}.sfcstr.tauy'] = taux, tauy
    return out


NIW_FIELDS = ('u', 'v', 'dpu', 'dpv', 'ubflxs_p', 'vbflxs_p', 'pbu', 'pbv')


def niw_inputs(model, s):
    """What niw_ke_tendency reads of state `s` (the two mixed-layer
    layers of u, v, dpu, dpv; the barotropic fluxes and pressures), in
    f64 on the host, with the step's delt1 and dlt."""
    return dict(
        {k: (getattr(s, k)[:, :2] if k in ('u', 'v', 'dpu', 'dpv')
             else getattr(s, k)).double().cpu() for k in NIW_FIELDS},
        delt1=model.clock.delt1, dlt=model.par.dlt)


def niw_fields(final, dev):
    """niw_ke_tendency, twice (m = 0, then 1), on niw_inputs `final` in
    f64 on `dev` with surface_grid(): {name: tensor}."""
    import types
    import torch
    from blom_tpu_torch.phys.niw import init_niw, niw_ke_tendency
    g, _ = surface_grid(dev, torch.float64)
    st = types.SimpleNamespace(**{k: final[k].to(dev) for k in NIW_FIELDS})
    niw = init_niw(g.shape, torch.float64, device=dev)
    out = {}
    for m in range(2):
        niw = niw_ke_tendency(g, st, niw, m, final['delt1'], final['dlt'])
        out[f'niw{m}.idkedt'] = niw.idkedt
        out[f'niw{m}.umlres'] = niw.umlres
    return out


def run_ben02(dev, final):
    """The ben02 chain and niw_ke_tendency (on niw_inputs `final`) at
    360x384 in f64 on the card against the CPU (worst max |card - cpu| /
    max |cpu| within BEN02_REL), then the chain in f32 on the card:
    finite, 0 <= ficem <= fice_max, hicem >= 0."""
    import torch
    from blom_tpu_torch.phys.seaice import fice_max
    t0 = time.perf_counter()
    card = dict(ben02_chain(dev, torch.float64), **niw_fields(final, dev))
    cpu = dict(ben02_chain('cpu', torch.float64),
               **niw_fields(final, 'cpu'))
    errs = {k: float((card[k].cpu() - v).abs().max()
                     / v.abs().max().clamp_min(1e-300))
            for k, v in cpu.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    ok = worst[1] <= BEN02_REL
    f32 = ben02_chain(dev, torch.float32)
    finite = all(bool(torch.isfinite(v).all()) for v in f32.values())
    fice = [f32[f'{c}.ice.ficem'] for c in ('cold', 'warm')]
    hice = [f32[f'{c}.ice.hicem'] for c in ('cold', 'warm')]
    bounds = (all(float(f.min()) >= 0. and float(f.max()) <= fice_max
                  for f in fice) and all(float(h.min()) >= 0. for h in hice))
    grew = float(f32['cold.ice.ficem'].max())
    ok &= finite and bounds and grew > 0.
    emit('ben02', ok=ok, shape=[JJ, II], tolerance=BEN02_REL,
         f64_worst=worst, fields=len(errs), f32_finite=finite,
         f32_ice_bounds=bounds, f32_cold_max_ficem=grew,
         seconds=time.perf_counter() - t0)
    return ok


# ------------------------------------------------------------------ decks

def deck_path(name, dtype, expcnf):
    """Write deck `name` for `expcnf` under build/decks/ beside this
    script."""
    from pathlib import Path
    path = Path(__file__).resolve().parent / 'build' / 'decks'
    path.mkdir(parents=True, exist_ok=True)
    path = path / f'limits_{expcnf}_{name}_{dtype}'
    path.write_text(deck_text(name, dtype, expcnf))
    return str(path)


def build_deck_case(cfg, device, **size):
    """build_case of the deck `cfg` at `size`: for the channel the sizes
    ITDM, JTDM, KDM of configs/channel.py (build_channel reads them when
    called), for fuk95 build_fuk95's itdm, jtdm, kdm (its grid spacing
    stays 650 m at every size, as in bench.py's fuk95)."""
    import functools
    from blom_tpu_torch.configs import channel
    from blom_tpu_torch.drivers import case, standalone
    if cfg.expcnf == 'fuk95':
        new = {(standalone, 'build_fuk95'): functools.partial(
            standalone.build_fuk95, **size)}
    else:
        new = {(channel, k): v for k, v in size.items()}
    old = {t: getattr(*t) for t in new}
    try:
        for (mod, k), v in new.items():
            setattr(mod, k, v)
        return case.build_case(cfg=cfg, device=device)[0]
    finally:
        for (mod, k), v in old.items():
            setattr(mod, k, v)


# Each deck runs as fuk95 at the main path's size in f32 for 1 + 4
# steps (2 + 10 until the isopycnic phases took ~2 minutes more), and as
# the channel at its full width in f64 for one step (see CHANNEL_KDM).
# {expcnf: (dtype, size, warm-up steps, timed steps)}
DECK_RUNS = {
    'fuk95': ('float32', dict(itdm=II, jtdm=JJ, kdm=KK), 1, 4),
    'channel': (CHANNEL_DTYPE, dict(KDM=CHANNEL_KDM), 1, 1),
}


def run_deck(dev, name, expcnf, paths):
    """Deck `name` as `expcnf` (DECK_RUNS) through build_case and run: the
    warm-up and then the timed steps, both from the initial state; gates,
    launches of every (kernel, instantiation), s/step.  For the channel
    also max |u + ub| within CHANNEL_SPEED and the f64 one-step parity at
    PARITY_CHANNEL size."""
    import torch
    from blom_tpu_torch.core.config import load_limits
    from blom_tpu_torch.drivers import standalone
    dtype, size, warmup, nsteps = DECK_RUNS[expcnf]
    t0 = time.perf_counter()
    cfg = load_limits(deck_path(name, dtype, expcnf))
    model = build_deck_case(cfg, dev, **size)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g = model.grid
    shape = (g.kk,) + tuple(g.shape)
    mass0 = mass(model, model.state.dp[1])
    standalone.run(model, warmup)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    s, _ = standalone.run(model, nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    syncs = counts.pop('host_syncs')
    paths[f'{expcnf}_{name}'] = counts
    ok, rec = slice_gates(model, s, nsteps, mass0)
    new = 1 if nsteps % 2 == 0 else 0          # slot of the newest level
    speed = float((s.u[new] + s.ub[new][None]).abs().max())
    if expcnf == 'channel':
        ok &= CHANNEL_SPEED[0] < speed < CHANNEL_SPEED[1]
    ok &= launches_ok(counts, model.par, nsteps)
    npts = shape[0] * shape[1] * shape[2]
    emit(f'deck_{expcnf}', deck=name, shape=shape, dtype=cfg.dtype,
         build_seconds=build_s, warmup_steps=warmup, steps=nsteps, ok=ok,
         **rec, max_abs_u_plus_ub=speed, launches=counts,
         host_syncs_per_step=syncs / nsteps,
         seconds_per_step=wall / nsteps,
         gridpoints_per_s=npts * nsteps / wall)
    if expcnf == 'fuk95' and name in DECK_PGFMTH:
        # the geopotential PGF's device time beside the other phases
        profile_phases(model, 2, f'deck_fuk95_{name}_phase_profile')
    del model, s
    if expcnf != 'channel':
        return ok

    cfg = load_limits(deck_path(name, 'float64', expcnf))
    models = {d: build_deck_case(cfg, d, **PARITY_CHANNEL)
              for d in (dev, 'cpu')}
    one_step = one_step_parity(models, dev)
    pok = all(r <= STEP_REL for _, r in one_step.values())
    emit('channel_parity_cuda_vs_cpu', deck=name, ok=pok,
         tolerance=STEP_REL, size=PARITY_CHANNEL, one_step=one_step)
    return ok and pok


# ---------------------------------------------- diagnostics and restarts

NSTEPS_DIA = (2, 4)                 # warm-up, timed steps
NSTEPS_ERS = 4                      # straight run; the split run is 2 + 2
PARITY_DIA = dict(itdm=24, jtdm=8, kdm=8)
MASS_REL = 1e-5                     # the slice's mass gate
# the along-layer diffusive salt fluxes: fuk95's salinity is uniform, so
# they are rounding alone (~1e-12 of the diffusive heat fluxes at 24x8x8)
# and differ between the card and the CPU by a fraction of their own
# size.  dia_parity holds their error within STEP_REL of the diffusive
# heat flux of the same direction and kind (the same operator on a
# tracer with gradients): a wrong salt flux of that operator's size
# fails, rounding does not
DIA_NOISE = {'usflld': 'utflld', 'vsflld': 'vtflld',
             'usflldlvl': 'utflldlvl', 'vsflldlvl': 'vtflldlvl'}
# one each of min, max and sq on mixed-layer and sst ids
DIA_OPS = (('mldl82', 'min'), ('mldb04', 'max'), ('sst', 'sq'))
# tests/test_dia_groups.py's deck at the main path's dtype: a sub-daily
# group (240 averages a day: every 2 steps at baclin 180 s) and a
# wet-point compressed one
DIA_DECK = """\
&LIMITS
  NDAY1 = 0
  NDAY2 = 1
  RUNID = 'dg001'
  EXPCNF = 'fuk95'
  BACLIN = 180.
  BATROP = 6.
  RSTFRQ = 0
  DTYPE = 'float32'
/
&DIAPHY
  GLB_FNAMETAG = 'hd','hm'
  GLB_AVEPERIO = -240, 1
  GLB_FILEFREQ = 1, 30
  GLB_COMPFLAG = 0, 1
  GLB_NCFORMAT = 0, 0
  H2D_SST = 1, 1
  H2D_SSS = 1, 0
  H2D_MLDL82 = 0, 1
  H2D_MLDL82MX = 1, 0
  H2D_TAUX = 1, 0
  LYR_TEMP = 0, 1
  LVL_SALN = 0, 1
  MSC_TEMPGA = 1, 1
/
"""


def scratch_dir(name):
    """A fresh directory build/<name> beside this script (git ignores
    build/)."""
    import shutil
    from pathlib import Path
    path = Path(__file__).resolve().parent / 'build' / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def dia_groups(model):
    """Three groups over every registry id that the model's path defines
    (the tracer-stack ids need tracers): the 2-D and scalar ids with
    DIA_OPS; the layer ids; the z-level ids with every MSC id (which
    adds the layer ids they read).  At 384x360x53 in f32 each group's
    file stays under the 2 GiB offsets of NetCDF3 classic (one group of
    all the layer and z-level ids would not: ~2.2 GB)."""
    from blom_tpu_torch.io import dia
    ntr = model.state.trc.shape[1]
    fields = {'2d': [], '3d': [], 'zlv': []}
    for name, (dims, _) in dia.FIELD_REGISTRY.items():
        if dims in ('tr3d', 'trzlv') and not ntr:
            continue
        fields[{'scalar': '2d', 'tr3d': '3d', 'trzlv': 'zlv'}.get(
            dims, dims)].append(name)
    fields['2d'] += list(DIA_OPS)
    fields['zlv'] += [(n, 'msc') for n in dia.MSC_REGISTRY]
    return tuple(dia.init_group(model.grid, model.state, f,
                                forcing=model.forcing, dfl=model.dfl)
                 for f in fields.values())


def count_syncs(fn):
    """(fn(), the synchronizing CUDA calls it made), counted as the
    warnings of torch.cuda.set_sync_debug_mode('warn').  The first time a
    process sets that mode, the setter itself warns once; that warning is
    not fn's and is not counted."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        n0 = len(caught)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return out, sum('synchroniz' in str(w.message) for w in caught[n0:])


def finite_over_water(group, wet):
    """{key: all finite over water} of a group's accumulators."""
    import torch
    return {k: bool(torch.isfinite(a[..., wet] if a.dim() >= 2 else a)
                    .all()) for k, a in group.acc.items()}


def event_timer(fn, events):
    """fn wrapped to append a pair of CUDA events around each call."""
    import torch

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **kw)
        e1.record()
        events.append((e0, e1))
        return out
    return timed


def profiled(fn, nsteps):
    """(fn(), profile): the device ms per step of the budget checkpoints
    (the 'budget' phase blom_step marks), of the steps themselves (first
    mark to 'end'), of standalone._accumulate and, within it, of the
    z-level weights, the z-level products and the mixed-layer walks
    (CUDA events around each call), over fn, a run of `nsteps`."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import step
    from blom_tpu_torch.io import dia
    wrapped = {(standalone, '_accumulate'): []}
    wrapped.update({(dia, name): [] for name in (
        'zlev_weights', 'to_zlev_w', '_mld_walk')})
    origs = {key: getattr(*key) for key in wrapped}
    for (mod, name), events in wrapped.items():
        setattr(mod, name, event_timer(origs[mod, name], events))
    step.phase_marks = marks = []
    try:
        out = fn()
    finally:
        step.phase_marks = None
        for (mod, name), f in origs.items():
            setattr(mod, name, f)
    torch.cuda.synchronize()

    def ms(events):
        return sum(e0.elapsed_time(e1) for e0, e1 in events) / nsteps
    budget = sum(e0.elapsed_time(e1) for (name, e0), (_, e1)
                 in zip(marks, marks[1:]) if name == 'budget')
    first, steps_ms = marks[0][1], 0.
    for (name, ev), nxt in zip(marks, marks[1:] + [None]):
        if name == 'end':
            steps_ms += first.elapsed_time(ev)
            first = nxt and nxt[1]
    parts = {name: evs for (mod, name), evs in wrapped.items()
             if mod is dia}
    return out, dict(
        budget_ms_per_step=budget / nsteps,
        accumulate_ms_per_step=ms(wrapped[standalone, '_accumulate']),
        accumulate_parts_ms_per_step={n: ms(e) for n, e in parts.items()},
        accumulate_part_calls_per_step={n: len(e) / nsteps
                                        for n, e in parts.items()},
        step_ms_without_accumulate=steps_ms / nsteps)


def run_diagnostics(dev, paths, syncs, models):
    """The fuk95 main path with the instrumentation on, at 384x360x53 in
    f32 with bench.py's physics: every registry id the path defines at
    'ave', DIA_OPS and every MSC id in three groups, cnsvdi and chk.  Plain
    and instrumented, each NSTEPS_DIA (warm-up, timed) from the initial
    state, the instrumented timed steps profiled; gates: the slice's,
    every ok flag, nacc, the accumulators finite over water, the budget's
    relative mass change within MASS_REL, launches per step as the main
    path's, host syncs in the timed steps (eddtra's counter, and the
    synchronizing calls that set_sync_debug_mode counts) no more than the
    plain run's, and every synchronizing call of the instrumented run
    eddtra's; reported: s/step of both, the device ms per step of
    accumulate and of the budget checkpoints, the peak device memory,
    the seconds and bytes of write_netcdf and write_netcdf_compressed of
    each group.  The model, at its initial state, goes into
    models['NOINY'] for the restart phase."""
    import os
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    from blom_tpu_torch.io import dia
    warm, nsteps = NSTEPS_DIA
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    model = standalone.build_fuk95(dtype=torch.float32, itdm=II, jtdm=JJ,
                                   kdm=KK, device=dev)
    model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST))
    mass0 = mass(model, model.state.dp[1])
    dfl0 = model.dfl

    standalone.run(model, warm)
    zero_counters()
    t0 = time.perf_counter()
    _, plain_syncs = count_syncs(lambda: standalone.run(model, nsteps))
    plain_wall = time.perf_counter() - t0
    plain_eddtra = counters()['host_syncs']

    groups = dia_groups(model)
    model.dfl = dfl0
    standalone.run(model, warm, dia_group=groups, cnsvdi=True, chk=True)
    model.dfl = dfl0
    torch.cuda.synchronize()
    peak_before = torch.cuda.max_memory_allocated(dev)
    zero_counters()
    t0 = time.perf_counter()
    ((s, _, ex), instr_syncs), prof = profiled(lambda: count_syncs(
        lambda: standalone.run(model, nsteps, dia_group=groups,
                               cnsvdi=True, chk=True)), nsteps)
    wall = time.perf_counter() - t0
    counts = counters()
    eddtra_syncs = counts.pop('host_syncs')
    paths['fuk95_diagnostics'] = counts
    syncs['fuk95_diagnostics'] = eddtra_syncs / nsteps
    ok, rec = slice_gates(model, s, nsteps, mass0)
    ok &= launches_ok(counts, model.par, nsteps)
    flags = ex['ok'].tolist()
    wet = model.grid.ip > 0
    finite = {}
    for g in ex['dia_group']:
        finite.update(finite_over_water(g, wet))
    mass_b = ex['budgets'].mass
    mass_rel = float((mass_b[-1, -1] - mass_b[0, 0]) / mass_b[0, 0])
    nacc = [float(g.nacc) for g in ex['dia_group']]
    gates = dict(ok_flags=all(flags), nacc=nacc == [nsteps] * 3,
                 finite=all(finite.values()),
                 budget_mass=abs(mass_rel) <= MASS_REL,
                 host_syncs=(instr_syncs <= plain_syncs
                             and instr_syncs <= eddtra_syncs
                             and eddtra_syncs <= plain_eddtra))
    ok &= all(gates.values())

    out = scratch_dir('dia')
    writes = {}
    for gi, g in enumerate(ex['dia_group']):
        for writer in ('write_netcdf', 'write_netcdf_compressed'):
            path = str(out / f'group{gi}_{writer}.nc')
            t0 = time.perf_counter()
            getattr(dia, writer)(path, model.grid, g, 1.)
            writes[f'group{gi}/{writer}'] = dict(
                seconds=time.perf_counter() - t0,
                bytes=os.path.getsize(path))
            os.remove(path)
    emit('diagnostics', shape=[KK, JJ, II], dtype='float32',
         warmup_steps=warm, steps=nsteps, ok=ok, gates=gates, **rec,
         n_fields=[len(g.acc) for g in ex['dia_group']],
         not_finite=[k for k, v in finite.items() if not v],
         ok_flags=flags, nacc=nacc, budget_rel_mass_change=mass_rel,
         budget_checkpoints=list(mass_b.shape), launches=counts,
         host_syncs_per_step=eddtra_syncs / nsteps,
         sync_debug_per_step={'plain': plain_syncs / nsteps,
                              'instrumented': instr_syncs / nsteps},
         seconds_per_step=wall / nsteps,
         plain_seconds_per_step=plain_wall / nsteps, **prof,
         peak_mem_bytes=max(peak_before,
                            torch.cuda.max_memory_allocated(dev)),
         base_mem_bytes=base_mem, writes=writes)
    model.dfl = dfl0
    models['NOINY'] = model
    return ok


def run_dia_parity(dev):
    """One f64 step of each time-level parity with the instrumentation on
    at PARITY_DIA, card against CPU: every accumulator of the groups
    and the seven budget checkpoints within STEP_REL of its largest
    magnitude (DIA_NOISE's of their heat flux's)."""
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import step
    from blom_tpu_torch.dynamics.difest import DifestParams
    models = {}
    for d in (dev, 'cpu'):
        m = standalone.build_fuk95(dtype=torch.float64, device=d,
                                   **PARITY_DIA)
        m.par = m.par._replace(difest=DifestParams(**BENCH_DIFEST))
        models[d] = m
    worst = {}
    for m_, n_ in ((0, 1), (1, 0)):
        out = {}
        for d, mo in models.items():
            bout = []
            s, dfl = step.blom_step(
                mo.grid, mo.e, mo.par, mo.coeffs_i, mo.coeffs_j,
                mo.state.clone(), mo.forcing, mo.dfl, m_, n_,
                mo.clock.delt1, mo.swabs, mo.bgc_forcing, budget_out=bout)
            groups = standalone._accumulate(mo, dia_groups(mo), s, n_, dfl,
                                            {})
            acc = {k: v for g in groups for k, v in g.acc.items()}
            for i, b in enumerate(bout):
                for k in ('mass', 'heat', 'salt'):
                    acc[f'budget{i + 1}_{k}'] = getattr(b, k)
            out[d] = acc
        errs = {}
        for k, a in out['cpu'].items():
            b = out[dev][k].cpu()
            scale = out['cpu'][DIA_NOISE.get(k, k)]
            errs[k] = float((a - b).abs().max()
                            / scale.abs().max().clamp_min(1e-300))
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        worst[f'm{m_}n{n_}'] = dict(
            worst=top[0], top5=top,
            salt_diffusive={k: dict(
                rel_err=errs[k], own_max=float(out['cpu'][k].abs().max()),
                scale=float(out['cpu'][h].abs().max()))
                for k, h in DIA_NOISE.items()})
    ok = all(w['worst'][1] <= STEP_REL for w in worst.values())
    emit('dia_parity', ok=ok, tolerance=STEP_REL, size=PARITY_DIA,
         parities=worst)
    return ok


ERS_CASES = {'NOINY': {}, 'NOINYAGE': dict(use_idlage=True)}


def run_restart(dev, paths, models):
    """ERS on the card (tools/testsuite.py:138-139) for NOINY and
    NOINYAGE at 384x360x53 in f32 with bench.py's physics: NSTEPS_ERS
    steps straight against half of them, write_restart, read_restart onto
    the card and the other half; every State field bit for bit.  On a
    difference, the straight run again from the same state says whether
    the step itself is deterministic.  Reported: the write and read
    seconds and the file's size.  A case runs on the model at its initial
    state that an earlier phase left in `models` (the diagnostics phase's
    NOINY), else on one built here."""
    import dataclasses
    import os
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics.difest import DifestParams
    from blom_tpu_torch.io import restart
    ok_all = True
    out = scratch_dir('restart')
    for name, kw in ERS_CASES.items():
        model = models.pop(name, None)
        if model is None:
            model = standalone.build_fuk95(dtype=torch.float32, itdm=II,
                                           jtdm=JJ, kdm=KK, device=dev,
                                           **kw)
            model.par = model.par._replace(
                difest=DifestParams(**BENCH_DIFEST))
        dfl0 = model.dfl
        zero_counters()
        s4, c4 = standalone.run(model, NSTEPS_ERS)
        torch.cuda.synchronize()
        counts = counters()
        counts.pop('host_syncs')
        paths[f'restart_{name}'] = counts
        model.dfl = dfl0
        s2, c2 = standalone.run(model, NSTEPS_ERS // 2)
        path = str(out / f'{name}.npz')
        t0 = time.perf_counter()
        restart.write_restart(path, s2, c2)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sr, cr = restart.read_restart(path, device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        os.remove(path)
        s4r, c4r = standalone.run(
            dataclasses.replace(model, state=sr, clock=cr),
            NSTEPS_ERS - NSTEPS_ERS // 2)
        fields = [f.name for f in dataclasses.fields(s4)]
        differ = [f for f in fields
                  if not torch.equal(getattr(s4, f), getattr(s4r, f))]
        rec = {}
        if differ:
            model.dfl = dfl0
            again, _ = standalone.run(model, NSTEPS_ERS)
            rec['straight_runs_differ_in'] = [
                f for f in fields
                if not torch.equal(getattr(s4, f), getattr(again, f))]
        ok = (not differ and c4r.nstep == c4.nstep
              and launches_ok(counts, model.par, NSTEPS_ERS)
              and bool(torch.isfinite(s4.dp).all()))
        emit('restart', case=name, shape=[KK, JJ, II], dtype='float32',
             ok=ok, steps=NSTEPS_ERS, bitwise=not differ,
             differing_fields=differ, **rec, n_fields=len(fields),
             write_seconds=write_s, read_seconds=read_s, file_bytes=nbytes,
             launches=counts)
        ok_all &= ok
        del model, s4, s2, sr, s4r
    return ok_all


def run_run_case(dev, paths):
    """DIA_DECK through load_limits, build_case (fuk95 at 384x360x53) and
    run_case for 4 steps into build/run_case: 2 'hd' files and one
    compressed 'hm' file (tests/test_dia_groups.py), sst finite over
    water, the final rotating restart, run.status and the final dp CRC;
    launches per step as the main path's."""
    import os
    import numpy as np
    import torch
    from scipy.io import netcdf_file
    from blom_tpu_torch.core.config import load_limits
    from blom_tpu_torch.drivers import case
    from blom_tpu_torch.io.checksum import field_crc
    decks = scratch_dir('run_case_deck')
    (decks / 'limits').write_text(DIA_DECK)
    cfg = load_limits(str(decks / 'limits'))
    model = build_deck_case(cfg, dev, itdm=II, jtdm=JJ, kdm=KK)
    rundir = scratch_dir('run_case')
    nsteps = 4
    zero_counters()
    t0 = time.perf_counter()
    s, clock, crc = case.run_case(model, cfg, rundir=str(rundir),
                                  nsteps=nsteps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counters()
    counts.pop('host_syncs')
    paths['fuk95_run_case'] = counts
    files = sorted(os.listdir(rundir))
    hd = [f for f in files if f.startswith('dg001_hd_')]
    hm = [f for f in files if f.startswith('dg001_hm_')]
    wet = (model.grid.ip > 0).cpu().numpy()
    with netcdf_file(str(rundir / hd[-1]), 'r', mmap=False) as f:
        sst_finite = bool(np.isfinite(f.variables['sst'][0][wet]).all())
        variables = sorted(f.variables)
    gates = dict(
        files=len(hd) == 2 and len(hm) == 1,
        restart=any(f.startswith('dg001_restphy_') for f in files),
        status=(rundir / 'run.status').read_text() == 'success\n',
        crc=crc == field_crc(s.dp), sst_finite=sst_finite,
        launches=launches_ok(counts, model.par, nsteps))
    ok = all(gates.values())
    sizes = {f: os.path.getsize(rundir / f) for f in files}
    emit('run_case', shape=[KK, JJ, II], dtype=cfg.dtype, steps=nsteps,
         ok=ok, gates=gates, files=sizes, hd_variables=variables,
         crc=f'{crc:08x}', seconds=wall, launches=counts)
    for f in files:
        os.remove(rundir / f)
    return ok


# ------------------------------ the other configurations and the cap

# The grid and initial-condition files come from
# blom_tpu_torch/tools/gridfiles.py: build_tripolar's geometry with the
# climatology's 5500 m floor over all water (gridfiles.ABYSS_DEPTH), as
# a floor from 100 to 5500 m leaves massless bottom layers where the ALE
# step turns NaN (ROADMAP section 3).
NSTEP_IN_CPL = 20       # one hour of 180 s steps
COUPLED_DTYPE = 'float32'
SO_T_MARGIN = 2.        # K around the initial surface range
PARITY_COUPLED = dict(itdm=32, jtdm=24, kdm=6)
# K of warming by cos(plat) in the cap's climatology, timed and parity
# runs: in a horizontally uniform ocean the pressure gradients and slopes
# are rounding alone, and eddtra's limiter never loops
COUPLED_DT_LAT = 4.
NSTEPS_SC = 48          # a day at the single column's 1800 s steps
# blom_tpu's own single column after a day on the CPU: in f64 (as
# tests/test_configs.py gates it) and in f32 with 64-bit types off, as on
# a TPU: max |u| and the relative heat drift
SC_F32_REF = dict(max_abs_u=6.9e-5, heat_drift=4.1e-7)
SC_F32_FACTOR = 10.
SC_KK = 25
# the kernels where an axis is shorter than their stencils, each exact
# against its plain version: the CPPM sweep on periodic lines of length
# 1, 2 and 3 along i and j and on the single column, timed there
# (check_cppm's lines); the momentum core periodic in both axes, all
# water, at (J, I) of MOMTUM_SHORT, timed at 1x1 (check_momtum's
# cases); K1 and K2 on the single column's one column
SHORT_PERIODS = (1, 2, 3)
SHORT_CPPM_LINES = tuple(
    (ax, True, (SC_KK, 10, n) if ax == -1 else (SC_KK, n, 13), False)
    for ax in (-1, -2) for n in SHORT_PERIODS) + tuple(
    (ax, True, (SC_KK, 1, 1), True) for ax in (-1, -2))
MOMTUM_SHORT = ((1, 1), (1, 40), (17, 1), (2, 2))
SHORT_MOMTUM_CASES = tuple((True, False, (SC_KK, jj, ii), 1.,
                            (jj, ii) == (1, 1)) for jj, ii in MOMTUM_SHORT)
# the runner's compsets are held card against CPU from the state the CPU
# reaches in this many steps (the tripolar fold rows carry flow)
RUNNER_PARITY_FROM = 2


def build_coupled(dev, dtype, grfile, icfile, kdm):
    """build_gridfile as the cesm compset on the tripolar grid file:
    (model, {'grid_read': s, 'inicon_woa': s, 'total': s})."""
    import torch
    from blom_tpu_torch.core import geoenv, inicon
    from blom_tpu_torch.drivers import standalone
    seconds = {}

    def timed(mod, name):
        orig = getattr(mod, name)

        def fn(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            seconds[name] = time.perf_counter() - t0
            return out
        return orig, fn
    saved = []
    for mod, name, key in ((geoenv, 'geoenv_file', 'grid_read'),
                           (inicon, 'inicon_woa', 'inicon_woa')):
        orig, fn = timed(mod, name)
        saved.append((mod, name, orig))
        setattr(mod, name, fn)
    t0 = time.perf_counter()
    try:
        model = standalone.build_gridfile(
            grfile, kdm=kdm, baclin=180., batrop=6., expcnf='cesm',
            icfile=icfile, dtype=dtype, arctic=True, device=dev)
        if str(dev) != 'cpu':
            torch.cuda.synchronize()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return model, {'grid_read': seconds['geoenv_file'],
                   'inicon_woa': seconds['inicon_woa'],
                   'total': time.perf_counter() - t0}


PROFILES = ('So_t_depth', 'So_s_depth')


def export_gates(model, ex, n, so_t_range):
    """{gate: ok} of an export of time level n: every 2-D field finite over
    water and zero on land, So_t within so_t_range, each profile 1e30
    exactly in the bins below the sea floor and finite elsewhere, the
    freezing potential >= 0."""
    import torch
    from blom_tpu_torch.core.constants import onem
    from blom_tpu_torch.core.state import cumulative_p
    from blom_tpu_torch.drivers import coupled
    g = model.grid
    wet = g.ip > 0
    flat = {k: v for k, v in ex._asdict().items()
            if k not in PROFILES and k != 'So_omask'}
    p_i = cumulative_p(model.state.dp[n]) * g.ip
    lo = coupled._export_bounds(p_i.dtype, p_i.device)[:, 0] * onem
    below = lo[:, None, None] >= p_i[-1][None]
    spval = torch.tensor(1e30, dtype=p_i.dtype)
    prof = {}
    for k in PROFILES:
        a = getattr(ex, k)
        prof[k] = (bool(torch.equal(a == spval.to(a.device), below))
                   and bool(torch.isfinite(a[~below]).all()))
    so_t = ex.So_t[wet]
    return {'finite_over_water': all(bool(torch.isfinite(v[wet]).all())
                                     for v in flat.values()),
            'zero_on_land': all(bool((v[~wet] == 0.).all())
                                for v in flat.values()),
            'So_t_range': bool(((so_t >= so_t_range[0])
                                & (so_t <= so_t_range[1])).all()),
            'profiles_spval_below_floor': all(prof.values()),
            'frzpot_nonneg': bool((ex.Fioo_q >= 0.).all())}


def run_coupled(dev, paths, syncs):
    """The coupled cap at the NorESM tnx1 shape (384x360x53, tripolar) in
    COUPLED_DTYPE: the grid and initial-condition files written by
    gridfiles.coupled_files, the climatology warmer by COUPLED_DT_LAT *
    cos(plat), build_gridfile(expcnf='cesm', arctic=True), OcnCap with
    NSTEP_IN_CPL steps an interval, data_initialize, one interval of
    warm-up and one timed, under gridfiles.coupled_imports.  Gates:
    fields finite,
    physical-row mass drift <= 1e-5, launches per step as
    expected_launches(arctic=True), the synchronizing calls of the timed
    interval (set_sync_debug_mode) no more than eddtra's counter, each
    export's export_gates; reported: the build's seconds (grid read,
    inicon_woa), s/step, grid-points/s, export ms, peak memory."""
    import torch
    from blom_tpu_torch.drivers import coupled
    from blom_tpu_torch.tools import gridfiles
    dtype = getattr(torch, COUPLED_DTYPE)
    t0 = time.perf_counter()
    grfile, icfile = gridfiles.coupled_files(
        scratch_dir('coupled'), II, JJ, KK, device=dev,
        dt_lat=COUPLED_DT_LAT)
    files_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    model, build_s = build_coupled(dev, dtype, grfile, icfile, KK)
    mass0 = physical_mass(model, model.state.dp[1])
    cap = coupled.OcnCap(model, NSTEP_IN_CPL)
    ex0 = cap.data_initialize()
    so_t = ex0.So_t[model.grid.ip > 0]
    so_t_range = (float(so_t.min()) - SO_T_MARGIN,
                  float(so_t.max()) + SO_T_MARGIN)
    gates = {f'init/{k}': v for k, v in
             export_gates(model, ex0, 1, so_t_range).items()}
    imp = gridfiles.coupled_imports(model)
    cap.advance(imp)                   # warm-up interval
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    ex, nsync = count_syncs(lambda: cap.advance(imp))
    wall = time.perf_counter() - t0
    counts = counters()
    eddtra_syncs = counts.pop('host_syncs')
    paths['coupled'] = counts
    syncs['coupled'] = eddtra_syncs / NSTEP_IN_CPL
    s = model.state
    n = 1 - ((cap.nstep - 1) % 2)
    gates.update({k: v for k, v in
                  export_gates(model, ex, n, so_t_range).items()})
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
    drift = (physical_mass(model, s.dp[n]) - mass0) / mass0
    gates.update(finite=finite, mass=abs(drift) <= 1e-5,
                 launches=launches_ok(counts, model.par, NSTEP_IN_CPL,
                                      arctic=True),
                 host_syncs=nsync <= eddtra_syncs)
    export_ms = time_ms(lambda: coupled.ocn_export(
        model.grid, model.e, s, n, cap.frzpot, model.par.baclin), reps=5,
        warm=1)
    ok = all(gates.values())
    emit('coupled', shape=[KK, JJ, II], dtype=COUPLED_DTYPE, ok=ok,
         gates=gates, nstep_in_cpl=NSTEP_IN_CPL, intervals=[1, 1],
         files_seconds=files_s, build_seconds=build_s,
         rel_physical_mass_drift=drift,
         so_t_range=so_t_range,
         so_t=[float(ex.So_t[model.grid.ip > 0].min()),
               float(ex.So_t.max())],
         max_abs_u=float(s.u.abs().max()),
         max_frzpot=float(cap.frzpot.max()), launches=counts,
         host_syncs_per_step=eddtra_syncs / NSTEP_IN_CPL,
         sync_debug_calls=nsync,
         seconds_per_step=wall / NSTEP_IN_CPL,
         gridpoints_per_s=II * JJ * KK * NSTEP_IN_CPL / wall,
         export_ms=export_ms,
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    return ok


def run_coupled_parity(dev):
    """build_gridfile(arctic=True) at PARITY_COUPLED in f64 on the card
    and on the CPU from the same files (the climatology warmer by
    COUPLED_DT_LAT * cos(plat)), one OcnCap interval of 2 steps: every
    State field and every export within STEP_REL."""
    import dataclasses
    import torch
    from blom_tpu_torch.drivers import coupled
    from blom_tpu_torch.tools import gridfiles
    size = PARITY_COUPLED
    grfile, icfile = gridfiles.coupled_files(
        scratch_dir('coupled_parity'), size['itdm'], size['jtdm'],
        size['kdm'], dt_lat=COUPLED_DT_LAT)
    out = {}
    for d in ('cpu', dev):
        model = build_coupled(d, torch.float64, grfile, icfile,
                              size['kdm'])[0]
        cap = coupled.OcnCap(model, 2)
        ex = cap.advance(gridfiles.coupled_imports(model))
        out[d] = (model.state, ex)
    fields = [f.name for f in dataclasses.fields(out['cpu'][0])
              if getattr(out['cpu'][0], f.name).numel()]
    state = worst_field(out['cpu'][0], out[dev][0], fields)
    exports = worst_field(out['cpu'][1], out[dev][1],
                          [k for k, v in out['cpu'][1]._asdict().items()
                           if v is not None])
    ok = state[1] <= STEP_REL and exports[1] <= STEP_REL
    emit('coupled_parity', ok=ok, tolerance=STEP_REL, size=size,
         steps=2, worst_state=state, worst_export=exports)
    return ok


def run_single_column(dev, paths, results):
    """The single column (1x1x25, periodic in i and j) through
    build_single_column on the card for NSTEPS_SC steps in f64 and in
    f32.  f64: tests/test_configs.py's checks as written; f32: finite,
    the thermocline above 5 K, max |u| and the heat drift within
    SC_F32_FACTOR times blom_tpu's own f32 readings (SC_F32_REF).  Both:
    launches per step (CPPM 2, momentum 1, K1 1, K2 1); then the
    kernels' checks where an axis is shorter than their stencils
    (SHORT_CPPM_LINES, SHORT_MOMTUM_CASES, K1 and K2 on one column of
    SC_KK levels), exact, into `results`."""
    import torch
    from blom_tpu_torch.drivers import standalone
    ok_all = True
    for dt in ('float64', 'float32'):
        dtype = getattr(torch, dt)
        model = standalone.build_single_column(dtype=dtype, device=dev)
        s0 = model.state
        zero_counters()
        t0 = time.perf_counter()
        s, _ = standalone.run(model, NSTEPS_SC)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        counts.pop('host_syncs')
        paths[f'single_column_{dt}'] = counts
        t = s.temp[1][:, 0, 0].double()
        wet = s.dp[1][:, 0, 0] > 1.
        h0 = float((s0.temp[1].double() * s0.dp[1].double()).sum())
        h1 = float((s.temp[1].double() * s.dp[1].double()).sum())
        drift = abs(h1 - h0) / abs(h0)
        thermo = float(t[wet][0] - t[wet][-1])
        max_u = float(s.u.abs().max())
        gates = dict(
            pb0=float(s0.pb[0][0, 0]) > 0.,
            finite=all(bool(torch.isfinite(getattr(s, f)).all())
                       for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb')),
            thermocline=thermo > 5.,
            launches=launches_ok(counts, model.par, NSTEPS_SC))
        if dt == 'float64':
            gates.update(max_abs_u=max_u < 1e-6, heat=drift < 1e-6)
        else:
            gates.update(
                max_abs_u=max_u <= SC_F32_FACTOR * SC_F32_REF['max_abs_u'],
                heat=drift <= SC_F32_FACTOR * SC_F32_REF['heat_drift'])
        ok = all(gates.values())
        emit('single_column', dtype=dt, shape=[SC_KK, 1, 1],
             steps=NSTEPS_SC, ok=ok, gates=gates, thermocline_K=thermo,
             max_abs_u=max_u, rel_heat_drift=drift, launches=counts,
             seconds_per_step=wall / NSTEPS_SC)
        ok_all &= ok
    label = 'short_period_check'
    ok_all &= check_cppm(dev, results, SHORT_CPPM_LINES, exact=True,
                         label=label)
    ok_all &= check_momtum(dev, results, SHORT_MOMTUM_CASES, exact=True,
                           label=label)
    ok_all &= check_ale(dev, results, (SC_KK, 1, 1), exact=True,
                        label=label)
    return ok_all


def run_testsuite(dev, paths, results):
    """The port's compset runner (blom_tpu_torch/tools/testsuite.py) over
    its whole TESTLIST on the card: every line must read PASS, and each
    kernel the compsets run must launch.  Then run_runner_checks at the
    runner's own shapes."""
    from blom_tpu_torch.tools import testsuite
    zero_counters()
    t0 = time.perf_counter()
    lines = {}
    for name, compset, cat in testsuite.TESTLIST:
        t1 = time.perf_counter()
        res = (testsuite.ers(compset) if cat == 'restart'
               else testsuite.sms(compset))
        lines[f'{name}.{compset}'] = [res, time.perf_counter() - t1]
    counts = counters()
    counts.pop('host_syncs')
    paths['testsuite'] = counts
    launched = {k: sum(counts[k].values()) > 0 for k in
                ('cppm_sweep', 'momtum_uv', 'momtum_fold', 'ale_regrid',
                 'ale_remap')}
    ok = all(r.startswith('PASS') for r, _ in lines.values()) \
        and all(launched.values())
    emit('testsuite', ok=ok, lines=lines, launched=launched,
         seconds=time.perf_counter() - t0)
    return ok & run_runner_checks(dev, results)


def run_runner_checks(dev, results):
    """Each compset of the runner's TESTLIST at its own shape and dtype
    (testsuite.build: f64, DEFAULT_GRID, the tripolar grid 32x24x6), from
    the state the CPU reaches in RUNNER_PARITY_FROM steps:
    `runner_parity`, one step of each time-level parity on the card
    against the CPU, every State field of PARITY_FIELDS (the tracers one
    by one) within STEP_REL; `runner_kernels`, each kernel that step
    launches on the card (check_step_kernels), exact against its plain
    version on the inputs the step gives it."""
    import dataclasses
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.tools import testsuite
    ok_all = True
    for compset in dict.fromkeys(c for _, c, _ in testsuite.TESTLIST):
        t0 = time.perf_counter()
        cpu = testsuite.build(compset, device='cpu')
        s, _ = standalone.run(cpu, RUNNER_PARITY_FROM)
        card = testsuite.build(compset, device=dev)
        card.dfl = type(cpu.dfl)(**{f.name: getattr(cpu.dfl, f.name).to(dev)
                                    for f in dataclasses.fields(cpu.dfl)})
        models = {'cpu': dataclasses.replace(cpu, state=s),
                  dev: dataclasses.replace(card, state=state_to(s, dev))}
        fields = PARITY_FIELDS + (('trc',) if s.trc.numel() else ())
        one_step = one_step_parity(models, dev, fields)
        ok = all(r <= STEP_REL for _, r in one_step.values())
        emit('runner_parity', compset=compset, ok=ok, tolerance=STEP_REL,
             shape=list(s.dp.shape[1:]), from_step=RUNNER_PARITY_FROM,
             one_step=one_step, seconds=time.perf_counter() - t0)
        ok_all &= ok
        ok_all &= check_step_kernels(models[dev], models[dev].state,
                                     card.clock.delt1, results, compset)
    return ok_all


SHARDED_MESH = (2, 2)                 # 180x192 blocks at 360x384
SHARDED_TRIPOLAR_MESHES = ((1, 2), (2, 2))
NSTEPS_SHARDED = (1, 4)               # warm-up, compared steps


def _unequal(a, b):
    """The tensor fields of two dataclasses that differ in any bit
    (compared as integers, so -0.0 and 0.0 differ and NaN equals
    itself)."""
    import dataclasses
    import torch
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not torch.is_tensor(x) or x.shape != y.shape:
            out += [] if x is y else [f.name]
            continue
        if x.is_floating_point():
            it = torch.int64 if x.element_size() == 8 else torch.int32
            x, y = x.contiguous().view(it), y.contiguous().view(it)
        if not torch.equal(x, y):
            out.append(f.name)
    return out


def _steps(model, barotp_fn, s, first, nsteps):
    """`nsteps` leap-frog steps of blom_step with `barotp_fn` from state
    `s` and the model's diffusion fields, time-level parity (m, n) =
    first.  Returns copies of (s, dfl) after each step, the
    synchronizing calls of each step (count_syncs), and the mean device
    ms of a step and of a barotp call (CUDA events)."""
    import torch
    from blom_tpu_torch.dynamics import step
    bt_events, step_events = [], []
    par = model.par._replace(barotp_fn=event_timer(barotp_fn, bt_events))
    timed = event_timer(step.blom_step, step_events)
    dev = s.dp.device
    s, dfl = s.clone(), state_to(model.dfl, dev)
    (m, n), after, syncs = first, [], []
    for _ in range(nsteps):
        (s, dfl), k = count_syncs(lambda: timed(
            model.grid, model.e, par, model.coeffs_i, model.coeffs_j, s,
            model.forcing, dfl, m, n, 2. * model.par.baclin, model.swabs))
        syncs.append(k)
        after.append((state_to(s, dev), state_to(dfl, dev)))
        m, n = n, m
    torch.cuda.synchronize()
    return after, syncs, {
        what: statistics.mean(e0.elapsed_time(e1) for e0, e1 in events)
        for what, events in (('step', step_events), ('barotp', bt_events))}


def _blocks(model, shape, s):
    """make_barotp_shmap on a stacked mesh of `shape`, called once on a
    copy of `s` with zero tendencies so that the constant tensors of its
    exchanges are on the card before the timed steps."""
    import torch
    from blom_tpu_torch.dynamics.barotp_shmap import make_barotp_shmap
    from blom_tpu_torch.parallel.mesh import make_mesh
    fn = make_barotp_shmap(make_mesh(shape=shape))
    p, zero = model.par, torch.zeros_like(s.pb[0])
    fn(model.grid, s.clone(), zero, zero, 0, 1, p.lstep, p.dlt, p.barotp)
    return fn


def run_sharded_barotp(dev, paths):
    """Phase 14 (sharded_barotp): the blocks' barotp against the plain
    one inside the step, bit for bit on fuk95 in f32 and f64, and on the
    tripolar grid bitwise across meshes and within STEP_REL of the plain
    step; in every step the blocks make no more synchronizing calls than
    the plain solver.  The launches of the blocks' f32 steps go to
    paths['fuk95_sharded_barotp']."""
    import dataclasses
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import barotp
    from blom_tpu_torch.dynamics.difest import DifestParams
    warm, nsteps = NSTEPS_SHARDED
    first = (1, 0) if warm % 2 else (0, 1)
    ok_all = True
    for dt, n in (('float32', nsteps), ('float64', 1)):
        t0 = time.perf_counter()
        model = standalone.build_fuk95(dtype=getattr(torch, dt), itdm=II,
                                       jtdm=JJ, kdm=KK, device=dev)
        model.par = model.par._replace(difest=DifestParams(**BENCH_DIFEST))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        s, c = standalone.run(model, warm)
        runs = {'plain': _steps(model, barotp.barotp, s, first, n)}
        fn = _blocks(model, SHARDED_MESH, s)
        exch0 = fn.comm.exchanges
        zero_counters()
        runs['blocks'] = _steps(model, fn, s, first, n)
        exchanges = (fn.comm.exchanges - exch0) / n
        counts = counters()
        counts.pop('host_syncs')
        if dt == 'float32':
            paths['fuk95_sharded_barotp'] = counts
        differ = [(k, _unequal(a[0], b[0]) + _unequal(a[1], b[1]))
                  for k, (a, b) in enumerate(zip(runs['plain'][0],
                                                 runs['blocks'][0]))]
        differ = [(k, d) for k, d in differ if d]
        finite = all(bool(torch.isfinite(getattr(
            runs['blocks'][0][-1][0], f)).all())
            for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
        syncs = {k: r[1] for k, r in runs.items()}
        fewer_syncs = all(b <= a for a, b in zip(syncs['plain'],
                                                 syncs['blocks']))
        ok = (not differ and finite and fewer_syncs
              and launches_ok(counts, model.par, n)
              and exchanges == 1 + 5 * -(-(model.par.lstep // 2) // 2))
        ms = {k: r[2] for k, r in runs.items()}
        emit('sharded_barotp', grid='fuk95', dtype=dt, shape=[KK, JJ, II],
             mesh=list(SHARDED_MESH), blocks=[JJ // SHARDED_MESH[0],
                                              II // SHARDED_MESH[1]],
             build_seconds=build_s, warmup_steps=warm, steps=n, ok=ok,
             bitwise=not differ, differing=differ[:4], finite=finite,
             host_syncs_per_step=syncs, host_syncs_ok=fewer_syncs,
             seconds_per_step={k: v['step'] / 1e3 for k, v in ms.items()},
             barotp_ms={k: v['barotp'] for k, v in ms.items()},
             barotp_ratio=ms['blocks']['barotp'] / ms['plain']['barotp'],
             exchanges_per_step=exchanges, launches=counts)
        ok_all &= ok

    t0 = time.perf_counter()
    model = standalone.build_tripolar(dtype=torch.float32, itdm=II,
                                      jtdm=JJ, kdm=KK, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, _ = standalone.run(model, warm)
    runs = {'plain': _steps(model, barotp.barotp, s, first, 1)}
    for shape in SHARDED_TRIPOLAR_MESHES:
        runs[f'{shape[0]}x{shape[1]}'] = _steps(
            model, _blocks(model, shape, s), s, first, 1)
    a, b = (runs[f'{y}x{x}'][0][0][0] for y, x in SHARDED_TRIPOLAR_MESHES)
    across = _unequal(a, b)
    fields = [f.name for f in dataclasses.fields(a)
              if torch.is_tensor(getattr(a, f.name))
              and getattr(a, f.name).is_floating_point()
              and getattr(a, f.name).numel()]
    worst = worst_field(state_to(runs['plain'][0][0][0], 'cpu'), b, fields)
    syncs = {k: r[1] for k, r in runs.items()}
    fewer_syncs = all(b <= a for v in syncs.values()
                      for a, b in zip(syncs['plain'], v))
    ok = not across and worst[1] <= STEP_REL and fewer_syncs
    emit('sharded_barotp', grid='tripolar', dtype='float32',
         shape=[KK, JJ, II], meshes=[list(m) for m in
                                     SHARDED_TRIPOLAR_MESHES],
         build_seconds=build_s, ok=ok, bitwise_across_meshes=not across,
         differing=across[:4], tolerance=STEP_REL,
         worst_against_plain=worst, host_syncs_per_step=syncs,
         host_syncs_ok=fewer_syncs,
         barotp_ms={k: r[2]['barotp'] for k, r in runs.items()})
    return ok_all & ok


def _flat(out):
    """The tensors of a kernel's output, its lists flattened."""
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    return flat


def check_step_kernels(model, s, delt1, results, path):
    """Each kernel launch of one step from state `s` (parity m, n = 0, 1;
    capture_kernel_inputs): the CPPM sweeps, the momentum core (with its
    fold pre-pass on a tripolar grid), K1 and K2, each on the inputs the
    step gives it, against its plain version: max |err| 0.0 and finite.
    The step must launch each of them as expected_launches says."""
    import torch
    from blom_tpu_torch.dynamics import (ale, ale_cuda, cppm, cppm_cuda,
                                         momtum, momtum_cuda)
    kernel = {'cppm_sweep': cppm_cuda.cppm_sweep_cuda,
              'momtum_uv': momtum_cuda.momtum_uv_cuda,
              'ale_regrid': ale_cuda.regrid_cuda,
              'ale_remap': ale_cuda.remap_cuda}

    def plain(name, a, kw):
        if name == 'cppm_sweep':
            return cppm._cppm_sweep_body(
                *a, kw.get('div_corr'), kw['ax'], kw['compatibility'],
                kw['limiting'])
        return {'momtum_uv': momtum._uv_body,
                'ale_regrid': ale.regrid_plain,
                'ale_remap': ale.remap_plain}[name](*a)

    def describe(name, a, kw):
        if name == 'cppm_sweep':
            return (dict(ax=kw['ax'], variant=f"{kw['compatibility']}/"
                                              f"{kw['limiting']}"),
                    a[0].shape)
        if name == 'momtum_uv':
            return dict(variant=a[1].mommth, arctic=a[0].arctic), \
                a[2].dp_m.shape
        if name == 'ale_regrid':
            return dict(variant=a[1].tracer_limiting), a[3].shape
        return (dict(variant=f'{a[0].tracer_limiting}/'
                             f'{a[0].velocity_limiting}',
                     ntr=len(a[2]) - 2), a[2][0].shape)

    calls = capture_kernel_inputs(model, s, delt1)
    expect = expected_launches(model.par, arctic=model.grid.arctic)
    ok_all = (all(len(calls[k]) == sum(expect[k].values()) for k in calls)
              and len(calls['cppm_sweep']) > 0
              and len(calls['momtum_uv']) > 0)
    for name, cl in calls.items():
        for a, kw in cl:
            out = _flat(kernel[name](*a, **kw))
            ref = _flat(plain(name, a, kw))
            torch.cuda.synchronize()
            err = max((float((o - r).abs().max()) for o, r in zip(out, ref)
                       if r.numel()), default=0.)
            info, shape = describe(name, a, kw)
            rec = dict(kernel=name, path=path, shape=list(shape),
                       dtype=str(out[0].dtype)[6:], max_abs_err=err,
                       ok=err == 0. and len(out) == len(ref) and all(
                           bool(torch.isfinite(o).all()) for o in out),
                       **info)
            emit('runner_kernels', **rec)
            results.append(rec)
            ok_all &= rec['ok']
    return ok_all


def kernel_summary(results, paths, tracer_results, tripolar_results,
                   short_results=(), runner_results=()):
    """The kernels line: one entry per kernel, with its variants.  A
    kernel's `launches` is the sum of its wrapper's counts on every path.
    A variant's `launches` are per path.  K2's variants are its three
    limiters: a K2 launch counts once for each limiter it runs, on the
    tracers or on the velocities, so its variants' launches can add up to
    more than the kernel's; `instantiations` gives them per (tracer,
    velocity) pair.  `tracer_counts` names the tracer counts the kernel
    met (CPPM: fields after h, nt; K2: tracers besides T and S, ntr):
    those checked against its plain version, each path's launches by the
    count they carried in its run ({count: launches}, observe_carried),
    and the tracer paths' own inputs with their times
    (tracer_results).  `tripolar` holds the kernel's checks and times on
    the tripolar path's inputs (tripolar_results); `short_periods` its
    checks where an axis is shorter than its stencil (short_results);
    `runner` its checks on the inputs of the runner's compsets
    (runner_results); the momentum core's entry also gives its fold
    pre-pass's launches per path."""
    from blom_tpu_torch.dynamics.ale import LIMITERS
    from blom_tpu_torch.dynamics.momtum import MOMMTHS
    out = []
    for name, src, replaces, main_variant, names in (
            ('cppm_sweep', 'blom_tpu_torch/csrc/cppm_sweep.cu',
             'blom_tpu/dynamics/cppm_pallas.py:181',
             'full/non_oscillatory', [f'{c}/{lim}' for c, lim
                                      in CPPM_VARIANTS]),
            ('momtum_uv', 'blom_tpu_torch/csrc/momtum_uv.cu',
             'blom_tpu/dynamics/momtum_pallas.py:74', 'enscon', MOMMTHS),
            ('ale_regrid', 'blom_tpu_torch/csrc/ale_regrid.cu',
             'blom_tpu/dynamics/ale_pallas.py:50', 'non_oscillatory',
             LIMITERS),
            ('ale_remap', 'blom_tpu_torch/csrc/ale_remap.cu',
             'blom_tpu/dynamics/ale_pallas.py:89',
             'non_oscillatory/non_oscillatory', LIMITERS)):
        recs = [r for r in results if r['kernel'] == name]

        def runs(key, v):
            return v in key.split('/') if name == 'ale_remap' else key == v
        variants = []
        for v in names:
            vrecs = [r for r in recs if runs(r['variant'], v)]
            timed = next(r for r in vrecs if 'ms' in r)
            variants.append({
                'name': v,
                'launches': {p: sum(n for k, n in c[name].items()
                                    if runs(k, v))
                             for p, c in paths.items()},
                'max_abs_err': max(r['max_abs_err'] for r in vrecs
                                   if r['dtype'] == 'float32'),
                'max_abs_err_f64': max(r['max_abs_err'] for r in vrecs
                                       if r['dtype'] == 'float64'),
                'ms': timed['ms'], 'plain_ms': timed['plain_ms'],
                'bound_ms': timed['bound_ms'],
                'bound_by': timed['bound_by']})
        main = next(r for r in recs
                    if r['variant'] == main_variant and 'ms' in r)
        entry = {
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces,
            'launches': sum(sum(c[name].values()) for c in paths.values()),
            'max_abs_err': max(r['max_abs_err'] for r in recs
                               if r['dtype'] == 'float32'),
            'ms': main['ms'], 'plain_ms': main['plain_ms'],
            'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
            'library_ms': None, 'variants': variants}
        if name in TRACER_COUNT_KEYS:
            key = TRACER_COUNT_KEYS[name]
            trecs = [r for r in tracer_results if r['kernel'] == name]
            entry['tracer_counts'] = {
                key: sorted({r.get(key, NT) for r in recs}
                            | {r[key] for r in trecs}),
                'paths': {p: c['carried'][name] for p, c in paths.items()
                          if c['carried'][name]},
                'tracer_paths': [{k: r[k] for k in (
                    'path', key, 'ax', 'variant', 'n_cells_dp_zero', 'ok',
                    'f32_max_abs_err', 'f64_max_abs_err', 'ms', 'plain_ms',
                    'bound_ms', 'bound_by') if k in r} for r in trecs]}
        trip = [r for r in tripolar_results if r['kernel'] == name]
        if trip:
            entry['tripolar'] = [{k: r[k] for k in (
                'ax', 'shape', 'variant', 'ok', 'f32_max_abs_err',
                'f64_max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'profiler_ms', 'fold_profiler_ms') if k in r} for r in trip]
        short = [r for r in short_results if r['kernel'] == name]
        if short:
            entry['short_periods'] = {
                'max_abs_err': max(r['max_abs_err'] for r in short),
                'checks': len(short),
                'shapes': sorted({tuple(r['shape']) for r in short}),
                'timed_1x1': [{k: r[k] for k in (
                    'variant', 'dtype', 'shape', 'ax', 'ms', 'plain_ms',
                    'bound_ms', 'bound_by') if k in r}
                    for r in short if 'ms' in r]}
        runner = [r for r in runner_results if r['kernel'] == name]
        if runner:
            entry['runner'] = {
                'max_abs_err': max(r['max_abs_err'] for r in runner),
                'checks': len(runner),
                'paths': sorted({r['path'] for r in runner}),
                'shapes': sorted({tuple(r['shape']) for r in runner})}
        if name == 'momtum_uv':
            entry['fold_prepass_launches'] = {
                p: c['momtum_fold'] for p, c in paths.items()
                if any(c['momtum_fold'].values())}
        if name in ALE_KERNELS:
            entry['dynamic_smem'] = ale_smem(name)
        if name == 'ale_remap':
            entry['instantiations'] = {
                k: {p: c[name][k] for p, c in paths.items()}
                for k in next(iter(paths.values()))[name]
                if any(c[name][k] for c in paths.values())}
        out.append(entry)
    return out


# {kernel: the record key of its tracer count}: the CPPM sweep carries T,
# S and the tracers (nt), K2 remaps the tracers besides T and S (ntr)
TRACER_COUNT_KEYS = {'cppm_sweep': 'nt', 'ale_remap': 'ntr'}


# ------------------------------------------------------------------- main

def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    try:
        from blom_tpu_torch import cuda_build
    except ImportError as exc:
        print(f'chip_smoke: blom_tpu_torch not importable: {exc}',
              file=sys.stderr)
        return 3
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit('card', nvidia_smi=card, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = cuda_build.build_all()
    ptxas = {k: ptxas_summary(v['ptxas']) for k, v in info.items()}
    frames = frames_ok(ptxas)
    emit('build', seconds=time.perf_counter() - t0,
         nvcc_seconds={k: v['seconds'] for k, v in info.items()},
         ptxas=ptxas, no_stack_no_spills=frames,
         dynamic_smem={'cppm_sweep': cppm_smem(),
                       'momtum_uv': momentum_smem(),
                       **{k: ale_smem(k) for k in ALE_KERNELS}})

    results, tracer_results, tripolar_results = [], [], []
    ok = all(frames.values())
    ok &= check_cppm(dev, results)
    ok &= check_momtum(dev, results)
    ok &= check_ale(dev, results)
    paths, syncs = {}, {}
    observe_carried()
    ok &= run_slice(dev, paths, syncs)
    ok &= run_parity(dev)
    ok &= run_isopyc(dev, paths, syncs)
    ok &= run_isopyc_parity(dev)
    ok &= run_tracers(dev, paths, syncs, tracer_results)
    ok &= run_tracers(dev, paths, syncs, tracer_results, isopyc=True)
    ok &= run_tracers_parity(dev)
    ok &= run_tracers(dev, paths, syncs, tracer_results, ciso=True)
    ok &= run_ciso_budget(dev)
    ok &= run_ciso_parity(dev)
    ok &= run_sediment(dev)
    ok &= run_tripolar(dev, paths, syncs, tripolar_results)
    ok &= run_tripolar_symmetry(dev)
    ok &= run_tripolar_parity(dev)
    ok &= run_kpp(dev, paths, syncs)
    ok &= run_kpp_parity(dev)
    ok &= run_tke(dev, paths, syncs, tracer_results)
    ok &= run_tke_parity(dev)
    ok &= run_highorder(dev, paths)
    ok &= run_highorder_parity(dev)
    ok &= run_transport(dev, paths)
    ok &= run_transport_parity(dev)
    final = {}
    ok &= run_surface(dev, paths, final)
    ok &= run_surface_parity(dev)
    ok &= run_ben02(dev, final['restoring'])
    for expcnf in DECK_RUNS:
        for name in DECKS:
            ok &= run_deck(dev, name, expcnf, paths)
    models = {}
    ok &= run_diagnostics(dev, paths, syncs, models)
    ok &= run_dia_parity(dev)
    ok &= run_restart(dev, paths, models)
    ok &= run_run_case(dev, paths)
    short_results, runner_results = [], []
    ok &= run_coupled(dev, paths, syncs)
    ok &= run_coupled_parity(dev)
    ok &= run_single_column(dev, paths, short_results)
    ok &= run_testsuite(dev, paths, runner_results)
    ok &= run_sharded_barotp(dev, paths)

    kernels = kernel_summary(results, paths, tracer_results,
                             tripolar_results, short_results,
                             runner_results)
    print(json.dumps({'kernels': kernels}), flush=True)
    emit('total', seconds=time.perf_counter() - t_start)
    unlaunched = [f"{k['name']}:{v['name']}" for k in kernels
                  for v in k['variants'] if not any(v['launches'].values())]
    if unlaunched:
        print(f'chip_smoke: never launched: {unlaunched}', file=sys.stderr)
        ok = False
    if not ok:
        print('chip_smoke: a phase failed', file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
