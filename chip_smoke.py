#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blom_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # on cuda:0

Phases, each reported as one JSON line; any failure exits nonzero:

1. the card: name and power limit from nvidia-smi;
2. build: both CUDA kernels compiled by nvcc for sm_90a from the sources
   under blom_tpu_torch/csrc, with ptxas registers and spills;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes (kk=53, J=360, I=384, two tracers), in f64
   (rtol = atol = 1e-12) and in f32 (max |err| <= F32_REL * max |ref|
   per output); median time of the kernel and of the plain version from
   CUDA events, the bound from the bytes each call must move, and the
   device time of each momentum stage from torch.profiler;
4. slice: the fuk95 adiabatic dynamical core at 384x360x53 in f32 through
   build_fuk95 and run, for 10 and for 11 steps: finite fields, mass
   drift, uniform salinity, launch counts (CPPM 2 per step, momentum 3
   stage launches per step), seconds per step and grid-points/s after a
   warm-up; then the device time of each phase of the step, from the
   events blom_step records;
5. parity: a 24x8x8 f64 run of 4 steps on the card against the same run
   on the CPU;
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


# ------------------------------------------------------------------ slice

def mass(model, dp):
    g = model.grid
    return float((dp.double().sum(0) * g.scp2.double()
                  * g.ip.double()).sum())


def run_slice(dev):
    import torch
    from blom_tpu_torch.drivers import standalone
    from blom_tpu_torch.dynamics import cppm_cuda, momtum_cuda
    t0 = time.perf_counter()
    model = standalone.build_fuk95(dtype=torch.float32, itdm=II, jtdm=JJ,
                                   kdm=KK, device=dev)
    torch.cuda.synchronize()
    emit('slice_build', seconds=time.perf_counter() - t0)
    mass0 = mass(model, model.state.dp[1])

    standalone.run(model, 2)      # warm-up: allocator, first launches
    torch.cuda.synchronize()
    ok_all = True
    launches = None
    for nsteps in (10, 11):
        cppm_cuda.launches = 0
        momtum_cuda.launches = 0
        t0 = time.perf_counter()
        s, _ = standalone.run(model, nsteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {'cppm_sweep': cppm_cuda.launches,
                  'momtum_uv': momtum_cuda.launches}
        if launches is None:
            launches = counts
        new = 1 if nsteps % 2 == 0 else 0      # slot of the newest level
        ip = model.grid.ip
        finite = all(bool(torch.isfinite(getattr(s, f)).all())
                     for f in ('dp', 'temp', 'saln', 'u', 'v', 'pb'))
        drift = (mass(model, s.dp[new]) - mass0) / mass0
        saln_dev = float(((s.saln[new] - 35.) * ip).abs().max())
        ok = (finite and abs(drift) <= 1e-5 and saln_dev <= 1e-4
              and counts['cppm_sweep'] == 2 * nsteps
              and counts['momtum_uv'] == 3 * nsteps)
        emit('slice', steps=nsteps, ok=ok, finite=finite,
             rel_mass_drift=drift, max_saln_dev=saln_dev, launches=counts,
             seconds_per_step=wall / nsteps,
             gridpoints_per_s=II * JJ * KK * nsteps / wall,
             max_abs_v=float(s.v.abs().max()))
        ok_all &= ok
    profile_phases(model)
    return ok_all, launches


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


def run_parity(dev):
    import torch
    from blom_tpu_torch.drivers import standalone
    worst = ('', 0.0)
    out = {}
    for d in (dev, 'cpu'):
        m = standalone.build_fuk95(dtype=torch.float64, itdm=24, jtdm=8,
                                   kdm=8, device=d)
        out[d], _ = standalone.run(m, 4)
    for name in ('u', 'v', 'dp', 'temp', 'saln', 'pb', 'ubflx', 'vbflx',
                 'pgfx', 'pgfy', 'uflx', 'vflx'):
        a = getattr(out['cpu'], name)
        b = getattr(out[dev], name).cpu()
        r = float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))
        if r > worst[1]:
            worst = (name, r)
    ok = worst[1] <= STEP_REL
    emit('parity_cuda_vs_cpu', ok=ok, steps=4, worst_field=worst[0],
         worst_rel_err=worst[1], tolerance=STEP_REL)
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
             'blom_tpu/dynamics/momtum_pallas.py:74')):
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
