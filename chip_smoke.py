#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blom_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # on cuda:0

Phases, each reported as one JSON line; any failure exits nonzero:

1. the card: name and power limit from nvidia-smi;
2. build: the four CUDA kernels compiled by nvcc for sm_90a from the
   sources under blom_tpu_torch/csrc (one nvcc each, all at once), with
   ptxas registers, stack frames and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (kk=53, J=360, I=384; two CPPM tracers; the
   ALE remap with ntr 0 and 5), in f64 (rtol = atol = 1e-12) and in f32
   (max |err| <= F32_REL * max |ref| per output); median time of the
   kernel and of the plain version from CUDA events, the bound from the
   bytes each call must move and the operations its loops do, and the
   device time of each momentum stage from torch.profiler;
4. slice: the full fuk95 step (ALE regrid/remap, lateral and vertical
   mixing) with bench.py's physics at 384x360x53 in f32 through
   build_fuk95 and run, for 10 and for 11 steps after a warm-up: finite
   fields, mass drift, salinity near 35 (SALN_DEV_ALE), launch counts
   (CPPM 2, momentum 3 stage launches, ALE regrid 1 and ALE remap 1 per
   step), the eddy-transport limiter's host syncs per step, seconds per
   step and grid-points/s; then the device time of each phase of the step, from
   the events blom_step records; then the adiabatic core alone
   (par._replace(ale=None, vmix=None, difest=None)) for a few steps;
5. parity: the full step at 24x8x8 in f64 on the card against the CPU,
   one step at each time-level parity (gated), and 4 driver steps
   (reported);
6. the kernels summary line, then the device line last.

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
F32_REL = 1e-4          # f32 kernel tolerance, relative to max |ref|
STEP_REL = 1e-5         # whole-step parity tolerance (see tests)
# salinity over water stays within these of its uniform 35: the adiabatic
# core keeps it to rounding; the ALE remap integrates each column from
# its top, and in f32 the difference of two such integrals over a thin
# destination layer loses ~1e-5 of 35 per step (blom_tpu's jnp ALE in
# f32 gives the same 2.4e-4 after one step at 96x32x53)
SALN_DEV = 1e-4
SALN_DEV_ALE = 5e-3
NTR_CHECK = (0, 5)      # tracer counts of the ALE remap check
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores


def emit(phase, **kw):
    print(json.dumps({'phase': phase, **kw}), flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(log):
    """{kernel: {'registers': n, 'stack_frame': b, 'spill_stores': b,
    'spill_loads': b}} from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            out.setdefault(name, {})['spill_stores'] = int(m.group(1))
            out[name]['spill_loads'] = int(m.group(2))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out.setdefault(name, {})['registers'] = int(m.group(1))
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

def cppm_inputs(ax, periodic, dtype, dev):
    import numpy as np
    import torch
    from blom_tpu_torch.dynamics.cppm import init_cppm_coeffs
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
    co = init_cppm_coeffs(ip, dx, axis=ax, periodic=periodic, dtype=dtype,
                          device=dev)
    h = rng.uniform(.2, 2., (KK, JJ, II))
    p = np.concatenate([np.zeros((1, JJ, II)), np.cumsum(h, 0)])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)
    args = (t(h), t(rng.uniform(1., 4., (NT, KK, JJ, II))),
            t(rng.uniform(-.3, .3, (KK, JJ, II))),
            t(rng.uniform(5., 12., (JJ, II))), t(p[:-1]), t(p[1:]),
            t(1. / rng.uniform(.8, 1.2, (JJ, II))))
    div = t(rng.uniform(-.1, .1, (KK, JJ, II)))
    return co, args, div


def cppm_bytes(dtype, has_div):
    import torch
    es = torch.finfo(dtype).bits // 8
    n3 = 4 + int(has_div) + NT + 2 + 2 * NT   # inputs + outputs, 3-D
    n2 = 2 + 4 + 3 + 36                       # db, ai, hevc, ssc/scc/d2m, tmc
    return es * (n3 * KK * JJ * II + n2 * JJ * II) + 4 * JJ * II


# arithmetic operations per cell of the CPPM kernel on its longest branch
# (counted from csrc/cppm_sweep.cu): ~210 for the thickness part and the
# compatible-edge LU solve, ~170 per tracer
CPPM_OPS_PER_CELL = 210 + 170 * NT
# per point of the momentum kernel, its three stages with the recomputed
# stencils (counted from csrc/momtum_uv.cu)
MOMTUM_OPS_PER_POINT = 1500


def bound(nbytes, nops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F32_FLOPS * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def check_cppm(dev, results):
    import torch
    from blom_tpu_torch.dynamics import cppm, cppm_cuda
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for ax in (-1, -2):
            for periodic in (False, True):
                co, args, div = cppm_inputs(ax, periodic, dtype, dev)
                for d in (None, div):
                    ref = cppm._cppm_sweep_body(*args, co, periodic, d, ax)
                    out = cppm_cuda.cppm_sweep_cuda(*args, co, periodic,
                                                    div_corr=d, ax=ax)
                    torch.cuda.synchronize()
                    ok, eabs, erel = compare(out, ref, dtype)
                    rec = dict(kernel='cppm_sweep', dtype=str(dtype)[6:],
                               ax=ax, periodic=periodic,
                               div_corr=d is not None, ok=ok,
                               max_abs_err=eabs, max_rel_err=erel)
                    if dtype == torch.float32 and periodic == (ax == -2):
                        # the main path's sweeps: fuk95 is closed in i and
                        # periodic in j
                        rec['ms'] = time_ms(lambda: cppm_cuda.cppm_sweep_cuda(
                            *args, co, periodic, div_corr=d, ax=ax))
                        rec['plain_ms'] = time_ms(
                            lambda: cppm._cppm_sweep_body(
                                *args, co, periodic, d, ax), reps=5, warm=1)
                        b, by = bound(cppm_bytes(dtype, d is not None),
                                      CPPM_OPS_PER_CELL * KK * JJ * II)
                        rec['bound_ms'], rec['bound_by'] = b, by
                    emit('kernel_check', **rec)
                    results.append(rec)
                    ok_all &= ok
    return ok_all


def momtum_inputs(periodic_i, dtype, dev):
    import numpy as np
    import torch
    from blom_tpu_torch.core.grid import finish_grid
    from blom_tpu_torch.dynamics.momtum import Momtum2DIn, MomtumKIn
    rng = np.random.default_rng(SEED)
    depths = np.where(rng.uniform(size=(JJ, II)) < .9, 200., 0.)
    if not periodic_i:
        depths[:, 0] = depths[:, -1] = 0.
    ones = np.ones((JJ, II))
    gs = 650.
    grid = finish_grid(
        scpx=ones * gs, scpy=ones * gs, scux=ones * gs, scuy=ones * gs,
        scvx=ones * gs, scvy=ones * gs, scqx=ones * gs, scqy=ones * gs,
        plon=ones, plat=ones * 45., depths=depths,
        corioq=ones * 1e-4, coriop=ones * 1e-4, betafp=ones * 1e-11,
        periodic_i=periodic_i, periodic_j=True, kk=KK, baclin=180.,
        dtype=dtype, device=dev)
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


def momtum_bytes(dtype):
    import torch
    es = torch.finfo(dtype).bits // 8
    return es * ((17 + 2) * KK * JJ * II + (12 + 21) * JJ * II)


def stage_ms(call, reps=5):
    """Device milliseconds per call of each momentum stage kernel, from
    torch.profiler (empty if the profiler sees no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r'momtum_stage(\d)', ev.key)
        if m and ev.device_time_total > 0:
            out[f'stage{m.group(1)}'] = ev.device_time_total / 1e3 / reps
    return dict(sorted(out.items()))


def check_momtum(dev, results):
    import torch
    from blom_tpu_torch.dynamics import momtum, momtum_cuda
    # the main path's parameters, plus nonzero biharmonic and background
    # viscosities so that every term of the body is exercised
    par = momtum.MomtumParams(mommth='enscon', mdv2hi=2., mdv2lo=1.,
                              vsc4hi=.1, vsc4lo=.05)
    tsfac, delt1 = 6. / 360., 360.
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for periodic_i in (False, True):
            grid, f, d2 = momtum_inputs(periodic_i, dtype, dev)
            ref = momtum._uv_body(grid, par, f, d2, tsfac, delt1)
            out = momtum_cuda.momtum_uv_cuda(grid, par, f, d2, tsfac, delt1)
            torch.cuda.synchronize()
            ok, eabs, erel = compare(out, ref, dtype)
            rec = dict(kernel='momtum_uv', dtype=str(dtype)[6:],
                       periodic_i=periodic_i, ok=ok, max_abs_err=eabs,
                       max_rel_err=erel)
            if dtype == torch.float32 and not periodic_i:
                rec['ms'] = time_ms(lambda: momtum_cuda.momtum_uv_cuda(
                    grid, par, f, d2, tsfac, delt1))
                rec['plain_ms'] = time_ms(lambda: momtum._uv_body(
                    grid, par, f, d2, tsfac, delt1), reps=5, warm=1)
                b, by = bound(momtum_bytes(dtype),
                              MOMTUM_OPS_PER_POINT * KK * JJ * II)
                rec['bound_ms'], rec['bound_by'] = b, by
                rec['stage_ms'] = stage_ms(lambda: momtum_cuda.momtum_uv_cuda(
                    grid, par, f, d2, tsfac, delt1))
            emit('kernel_check', **rec)
            results.append(rec)
            ok_all &= ok
    return ok_all


def ale_inputs(dtype, dev, ntr=0):
    """Columns as in tests/test_ale_pallas.py at the main path's shape:
    interfaces, T, S, target densities, tracers, velocities on their own
    interfaces and destination grids from the plain regrid."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    H3 = (KK, JJ, II)

    def cum(dp):
        return np.concatenate([np.zeros((1, JJ, II)), np.cumsum(dp, 0)])

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


# arithmetic operations per column, counted from the loops of
# csrc/ale_regrid.cu and csrc/ale_remap.cu (with csrc/ppm_column.cuh):
# ~90 per edge for the weights, 7 per edge and field for the edge value,
# ~20 per cell and field for the limiter tests and the coefficients, ~40
# per cell for the two densities, ~10 per interface for the regime
# choice and the clamp; in K2 ~6 per cell for the prefix sum and ~15 per
# destination edge.  The data-dependent branches (the slope clamp and
# parabola limit where they apply, the search for the transition
# interface, the isopycnal nudge) are not counted, so these counts and
# the bounds from them are lower bounds.
def ale_regrid_ops():
    return (KK + 1) * (90 + 2 * 7) + KK * (2 * 20 + 40 + 10)


def ale_remap_ops(ntr):
    per_field = (KK + 1) * 7 + KK * (20 + 6) + (KK + 1) * 15
    return 3 * (KK + 1) * 90 + (2 + ntr + 2) * per_field


def ale_bytes(dtype, kind, ntr=0):
    import torch
    es = torch.finfo(dtype).bits // 8
    if kind == 'regrid':      # p_src, temp, saln, sigmar -> p_dst, sfac
        levels = 3 * (KK + 1) + 3 * KK
    else:                     # 6 interface fields, tracers + u, v in/out
        levels = 6 * (KK + 1) + 2 * (2 + ntr + 2) * KK
    return es * levels * JJ * II


def check_ale(dev, results):
    import torch
    from blom_tpu_torch.core import eos
    from blom_tpu_torch.dynamics import ale, ale_cuda
    e = eos.init_eos(pref=0., expcnf='fuk95')
    par = ale.make_ale_params(KK)
    delt1 = 360.
    ok_all = True
    for dtype in (torch.float64, torch.float32):
        for ntr in NTR_CHECK:
            x = ale_inputs(dtype, dev, ntr)
            rargs = (e, par, x['p'], x['temp'], x['saln'], x['sigmar'],
                     delt1)
            ref = ale.regrid_plain(*rargs)
            if ntr == 0:
                out = ale_cuda.regrid_cuda(*rargs)
                torch.cuda.synchronize()
                ok, eabs, erel = compare(out, ref, dtype)
                rec = dict(kernel='ale_regrid', dtype=str(dtype)[6:], ok=ok,
                           max_abs_err=eabs, max_rel_err=erel)
                if dtype == torch.float32:
                    rec['ms'] = time_ms(lambda: ale_cuda.regrid_cuda(*rargs))
                    rec['plain_ms'] = time_ms(
                        lambda: ale.regrid_plain(*rargs), reps=5, warm=1)
                    b, by = bound(ale_bytes(dtype, 'regrid'),
                                  ale_regrid_ops() * JJ * II)
                    rec['bound_ms'], rec['bound_by'] = b, by
                emit('kernel_check', **rec)
                results.append(rec)
                ok_all &= ok
            p_dst = ref[0]
            margs = (par, x['p'], [x['temp'], x['saln']] + x['trc'],
                     x['pu'], x['u'], x['pv'], x['v'], p_dst, p_dst * .98,
                     p_dst * .97)
            mref = ale.remap_plain(*margs)
            mout = ale_cuda.remap_cuda(*margs)
            torch.cuda.synchronize()
            ok, eabs, erel = compare(
                list(mout[0]) + [mout[1], mout[2]],
                list(mref[0]) + [mref[1], mref[2]], dtype)
            rec = dict(kernel='ale_remap', dtype=str(dtype)[6:], ntr=ntr,
                       ok=ok, max_abs_err=eabs, max_rel_err=erel)
            if dtype == torch.float32 and ntr == 0:
                # the main path's configuration: fuk95 carries no tracers
                rec['ms'] = time_ms(lambda: ale_cuda.remap_cuda(*margs))
                rec['plain_ms'] = time_ms(lambda: ale.remap_plain(*margs),
                                          reps=5, warm=1)
                b, by = bound(ale_bytes(dtype, 'remap', ntr),
                              ale_remap_ops(ntr) * JJ * II)
                rec['bound_ms'], rec['bound_by'] = b, by
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


def counters():
    """The launch counts of every kernel wrapper and the host syncs of
    the eddy-transport limiter."""
    from blom_tpu_torch.dynamics import ale_cuda, cppm_cuda, eddtra
    from blom_tpu_torch.dynamics import momtum_cuda
    return {'cppm_sweep': cppm_cuda.launches,
            'momtum_uv': momtum_cuda.launches,
            'ale_regrid': ale_cuda.regrid_launches,
            'ale_remap': ale_cuda.remap_launches,
            'host_syncs': eddtra.host_syncs}


def zero_counters():
    from blom_tpu_torch.dynamics import ale_cuda, cppm_cuda, eddtra
    from blom_tpu_torch.dynamics import momtum_cuda
    cppm_cuda.launches = momtum_cuda.launches = 0
    ale_cuda.regrid_launches = ale_cuda.remap_launches = 0
    eddtra.host_syncs = 0


def run_slice(dev):
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
    launches = None
    per_step = {'cppm_sweep': 2, 'momtum_uv': 3, 'ale_regrid': 1,
                'ale_remap': 1}
    for nsteps in (10, 11):
        zero_counters()
        t0 = time.perf_counter()
        s, _ = standalone.run(model, nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counters()
        syncs = counts.pop('host_syncs')
        if launches is None:
            launches = counts
        ok, rec = slice_gates(model, s, nsteps, mass0)
        ok &= all(counts[k] == n * nsteps for k, n in per_step.items())
        emit('slice', steps=nsteps, ok=ok, **rec, launches=counts,
             host_syncs_per_step=syncs / nsteps,
             seconds_per_step=wall / nsteps,
             gridpoints_per_s=II * JJ * KK * nsteps / wall)
        ok_all &= ok
    profile_phases(model)
    ok_all &= run_core(model, mass0)
    return ok_all, launches


def slice_gates(model, s, nsteps, mass0):
    """Finite fields, mass drift <= 1e-5, salinity within SALN_DEV of 35
    (SALN_DEV_ALE with the ALE remap on)."""
    import torch
    new = 1 if nsteps % 2 == 0 else 0      # slot of the newest level
    finite = all(bool(torch.isfinite(getattr(s, f)).all())
                 for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
    drift = (mass(model, s.dp[new]) - mass0) / mass0
    saln_dev = float(((s.saln[new] - 35.) * model.grid.ip).abs().max())
    saln_tol = SALN_DEV if model.par.ale is None else SALN_DEV_ALE
    ok = finite and abs(drift) <= 1e-5 and saln_dev <= saln_tol
    return ok, dict(finite=finite, rel_mass_drift=drift,
                    max_saln_dev=saln_dev, max_abs_v=float(s.v.abs().max()))


def run_core(model, mass0, nsteps=4):
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
    ok, rec = slice_gates(core, s, nsteps, mass0)
    ok &= (counts['cppm_sweep'] == 2 * nsteps
           and counts['momtum_uv'] == 3 * nsteps
           and counts['ale_regrid'] == counts['ale_remap'] == 0)
    emit('slice_adiabatic_core', steps=nsteps, ok=ok, **rec,
         launches=counts, seconds_per_step=wall / nsteps)
    return ok


def profile_phases(model, nsteps=4):
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
    emit('phase_profile', steps=nsteps,
         step_ms=marks[0][1].elapsed_time(marks[-1][1]) / nsteps,
         phase_ms=dict(sorted(ms.items(), key=lambda kv: -kv[1])))


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
    from blom_tpu_torch.dynamics import step
    from blom_tpu_torch.dynamics.difest import DifestParams
    models = {}
    for d in (dev, 'cpu'):
        m = standalone.build_fuk95(dtype=torch.float64, itdm=24, jtdm=8,
                                   kdm=8, device=d)
        m.par = m.par._replace(difest=DifestParams(**BENCH_DIFEST))
        models[d] = m

    def worst(a, b):
        w = ('', 0.0)
        for name in ('u', 'v', 'dp', 'temp', 'saln', 'pb', 'ubflx',
                     'vbflx', 'pgfx', 'pgfy', 'uflx', 'vflx'):
            x = getattr(a, name)
            y = getattr(b, name).cpu()
            r = float((x - y).abs().max()
                      / x.abs().max().clamp_min(1e-300))
            if r > w[1]:
                w = (name, r)
        return w

    one_step = {}
    for m_, n_ in ((0, 1), (1, 0)):
        out = {}
        for d, mo in models.items():
            out[d], _ = step.blom_step(
                mo.grid, mo.e, mo.par, mo.coeffs_i, mo.coeffs_j,
                mo.state.clone(), mo.forcing, mo.dfl, m_, n_,
                mo.clock.delt1, mo.swabs)
        one_step[f'm{m_}n{n_}'] = worst(out['cpu'], out[dev])
    per_step = []
    for k in range(1, nsteps + 1):
        out = {d: standalone.run(mo, k)[0] for d, mo in models.items()}
        per_step.append(worst(out['cpu'], out[dev]))
    ok = all(r <= STEP_REL for _, r in one_step.values())
    emit('parity_cuda_vs_cpu', ok=ok, tolerance=STEP_REL,
         one_step=one_step, driver_steps=nsteps,
         driver_worst_per_step=per_step)
    return ok


# ------------------------------------------------------------------- main

def main():
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
    emit('build', seconds=time.perf_counter() - t0,
         nvcc_seconds={k: v['seconds'] for k, v in info.items()},
         ptxas={k: ptxas_summary(v['ptxas']) for k, v in info.items()})

    results = []
    ok = check_cppm(dev, results)
    ok &= check_momtum(dev, results)
    ok &= check_ale(dev, results)
    ok_slice, launches = run_slice(dev)
    ok &= ok_slice
    ok &= run_parity(dev)

    def pick(name, key):
        recs = [r for r in results
                if r['kernel'] == name and r['dtype'] == 'float32']
        return max(r[key] for r in recs)

    def timed(name):
        return [r for r in results if r['kernel'] == name and 'ms' in r]

    kernels = []
    for name, src, replaces in (
            ('cppm_sweep', 'blom_tpu_torch/csrc/cppm_sweep.cu',
             'blom_tpu/dynamics/cppm_pallas.py:181'),
            ('momtum_uv', 'blom_tpu_torch/csrc/momtum_uv.cu',
             'blom_tpu/dynamics/momtum_pallas.py:74'),
            ('ale_regrid', 'blom_tpu_torch/csrc/ale_regrid.cu',
             'blom_tpu/dynamics/ale_pallas.py:50'),
            ('ale_remap', 'blom_tpu_torch/csrc/ale_remap.cu',
             'blom_tpu/dynamics/ale_pallas.py:89')):
        rec = timed(name)[0]   # the main path's first configuration
        kernels.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': pick(name, 'max_abs_err'),
            'ms': rec['ms'], 'plain_ms': rec['plain_ms'],
            'bound_ms': rec['bound_ms'], 'bound_by': rec['bound_by'],
            'library_ms': None})
    print(json.dumps({'kernels': kernels}), flush=True)
    if any(k['launches'] == 0 for k in kernels):
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
