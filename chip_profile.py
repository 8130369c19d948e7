#!/usr/bin/env python
"""Where the time of the port's two paths goes, on one CUDA card.

Runs the bench.py case of chip_smoke.py (T21/L19 + 2 x 64x64x160,
adaptive) with each LES closure: the main path (Deardorff TKE, through
the CUDA stage kernel) and the Smagorinsky path (the split stage, through
the scalar and momentum kernels):
  1. per closure, 1 + STEADY coupled steps, each split into the GCM first
     half and coupling (``_pre``), the LES evolve and the GCM second half
     (``_post``), timed by the host clock around torch.cuda.synchronize();
  2. per closure, one more steady step under torch.profiler: the union of
     its device kernel intervals is the device busy time; busy per
     substep against the median wall per substep of the unprofiled steady
     steps gives the device's idle share; per-kernel device totals are
     listed, the port's own kernels (PORT_KERNELS) always;
  3. CUDA-event times (median of 20) per call of the stage kernel, the
     pressure projection and one whole substep of each closure at
     64x64x160, n = 1;
  4. the stage kernel alone at 64x64x160, n = 1 and 2: device time per
     call split by launch (torch.profiler, mean of 20 calls), CUDA-event
     time per call, and its share of the bound
     (sp_coupler_tpu_torch/ops/bounds.py, stage_bound);
     then the device time per call of k_stage at several levels per
     z-chunk (TZ_SWEEP; the default geometry's marked);
  5. the scalar (lesflat) and momentum (lesmom) kernels alone at
     64x64x160, n = 1 and 2: device time per call (torch.profiler, mean of
     20 calls), CUDA-event time per call, and their share of the bound
     (chip_smoke.tensor_bytes); then their device time at several levels
     per z-chunk (SPLIT_TZ_SWEEP; the default geometry's marked);
  7. (mode tl639 only) the TL639 jet run of runtime/tl639.py stepped one
     step at a time for each of TL639_PROBES: per step max|u| and the
     level and latitude where it sits, the largest vertical Courant
     number of the explicit vertical advection (|eta-dot| x 2 dt over the
     layer's thickness, from the state the step starts from) and where,
     the temperature extrema and the non-finite counts of u, v, T, lnps;
     the run stops at its first non-finite step.
  8. (mode sass only) the static SASS of each built kernel (cuobjdump
     -sass of the .so phase_build made): per device function, the count
     of each float32 opcode (FFMA, FADD, FMUL, FMNMX, FSETP, FSEL, MUFU,
     ...) and of all instructions; the share of multiplies and adds that
     the compiler fused (FFMA against FADD + FMUL) reads against the
     data sheet's 67 TFLOP/s of ops/bounds.py, which counts an FFMA as
     two operations.
  6. (mode t159 only) the T159 regional case of chip_smoke.py (T159/L19
     SL GCM + 64 x 64x64x160, evolve_chunks 8): after a shared Euler-start
     step, one first=False coupled step with the fleet batched and one
     with it serial, from the same state, each timed by phase and by
     evolve chunk; then the first chunk's evolve again from the same
     state under torch.profiler (device kernels only): its device busy
     time against that chunk's unprofiled wall gives the idle share.
Prints a summary with the card's name and power limit and writes
chiprun_out/profile.json (profile_<mode>.json for one mode).

Run: python3 chip_profile.py   (needs a CUDA card, nvcc and this checkout)
     python3 chip_profile.py path    (phases 1-3 only)
     python3 chip_profile.py stage   (phase 4 only)
     python3 chip_profile.py split   (phase 5 only)
     python3 chip_profile.py t159    (phase 6 only; not part of "all")
     python3 chip_profile.py tl639   (phase 7 only; not part of "all")
     python3 chip_profile.py sass    (phase 8 only; not part of "all")
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from sp_coupler_tpu_torch.ops import bounds

STEADY = 5
TOP = 15
TZ_SWEEP = (4, 5, 8, 10, 14, 18, 20, 27, 40, 80, 160)
SPLIT_TZ_SWEEP = (2, 3, 4, 5, 6, 7, 8, 10, 14, 20, 40, 160)
# the device kernels of csrc/ (their names in torch.profiler), listed after
# each profiled step whatever their rank
PORT_KERNELS = ("k_stage", "k_means", "k_scalar", "k_momentum")
# the jet runs of phase 7: (trunc, nlev, dt, split_phases, SL
# interpolation method, steps): the config-5 run in both phase modes,
# with JAX's TPU interpolation (the window, which clamps displacements),
# at half the step, and at T255
TL639_PROBES = ((639, 60, 720.0, True, "gather", 25),
                (639, 60, 720.0, False, "gather", 25),
                (639, 60, 720.0, True, "window", 25),
                (639, 60, 360.0, True, "gather", 60),
                (255, 60, 720.0, False, "gather", 60))


def timed_step(fn, gs, les, prof, rain, first):
    """One coupled step as CoupledStepFn.__call__, timed by phase."""
    t = [time.time()]
    gs, les, forcing, conv, cprof, pre = fn._pre(gs, les, prof, 0, first)
    torch.cuda.synchronize()
    t.append(time.time())
    les, n_sub, n_clamp = fn._evolve_to(les, forcing, fn.core.cfg.dt)
    torch.cuda.synchronize()
    t.append(time.time())
    gs, les, prof, rain, diag = fn._post(gs, les, conv, cprof, rain, n_sub,
                                         n_clamp, pre, first)
    torch.cuda.synchronize()
    t.append(time.time())
    nsub = [int(x) for x in fn.unpack_diag(diag)["n_substeps"]]
    rec = dict(first=first, pre_s=t[1] - t[0], evolve_s=t[2] - t[1],
               post_s=t[3] - t[2], wall_s=t[3] - t[0], substeps=nsub)
    return (gs, les, prof, rain), rec


def busy_us(events):
    """Length of the union of the events' time intervals (us)."""
    total, end = 0, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or s >= end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def kernel_totals(kern):
    """(the TOP kernels by device time, the port's own kernels), each a
    list of (name, (ms, calls))."""
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() * 1e-3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port = [kv for kv in top if any(k in kv[0] for k in PORT_KERNELS)]
    return top[:TOP], port


def log_kernels(top, port, busy_s):
    for name, (ms, cnt) in top:
        cs.log("  %10.1f ms %7d  %.3f ms/call  %s"
               % (ms, cnt, ms / cnt, name[:100]))
    for name, (ms, cnt) in port:
        cs.log("  port kernel %s: %.1f ms in %d calls, %.4f ms/call (%.1f %% "
               "of busy)" % (name[:60], ms, cnt, ms / cnt,
                             100 * ms / (1e3 * busy_s)))


def phase_steps(card, subgrid="tke"):
    fn, carry = cs.main_path_case(subgrid)
    steps = []
    for i in range(1 + STEADY):
        carry, rec = timed_step(fn, *carry, first=(i == 0))
        steps.append(rec)
        cs.log("%s step %d (first=%s): wall %.3f s = pre %.3f + evolve %.3f "
               "+ post %.3f; substeps %s; %.3f ms per substep on %s"
               % (subgrid, i, rec["first"], rec["wall_s"], rec["pre_s"],
                  rec["evolve_s"], rec["post_s"], rec["substeps"],
                  1e3 * rec["wall_s"] / sum(rec["substeps"]), card))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        carry, rec = timed_step(fn, *carry, first=False)
    kern = [e for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        raise RuntimeError("the profiler saw no device kernels")
    nsub = sum(rec["substeps"])
    busy = busy_us(kern) * 1e-6
    wall_per_sub = statistics.median(s["wall_s"] / sum(s["substeps"])
                                     for s in steps[1:])
    idle = 1.0 - busy / nsub / wall_per_sub
    top, port = kernel_totals(kern)
    cs.log("%s profiled step: substeps %s, device busy %.3f s (%.3f ms per "
           "substep); unprofiled steady steps: median %.3f ms per substep, "
           "so the device is idle %.1f %% of a step on %s"
           % (subgrid, rec["substeps"], busy, 1e3 * busy / nsub,
              1e3 * wall_per_sub, 100 * idle, card))
    log_kernels(top, port, busy)
    return dict(steps=steps, profiled=dict(
        substeps=rec["substeps"], busy_s=busy, idle_share=idle,
        wall_per_substep_s=wall_per_sub,
        kernels=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in top],
        port_kernels=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in port]))


def phase_calls(card):
    """Per-call times at 64x64x160, n = 1."""
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, poisson,
                                                 step as lstep)
    from sp_coupler_tpu_torch.ops import lesstage
    grid = lgrid.LESGrid()
    phys = lstep.LESPhysics()
    smag = lstep.LESPhysics(subgrid="smagorinsky")
    cur, base, frc, dt = cs.stage_inputs(grid, 1, 8)
    solver = poisson.build_solver(grid, cur.rhobf, cur.rhobh)
    fdt = (0.5 * dt)[:, None, None, None]
    ms = dict(
        stage=cs.cuda_ms(lambda: lesstage.stage_fused(
            grid, phys, cur, base, frc, 0.5, dt)),
        projection=cs.cuda_ms(lambda: poisson.project(
            grid, cur.rhobf, cur.rhobh, cur.u, cur.v, cur.w, fdt,
            solver=solver)),
        substep=cs.cuda_ms(lambda: lstep.substep(
            grid, phys, cur, frc, dt, solver=solver)),
        smagorinsky_tendencies=cs.cuda_ms(lambda: lstep.tendencies(
            grid, smag, cur, frc, dt)),
        smagorinsky_substep=cs.cuda_ms(lambda: lstep.substep(
            grid, smag, cur, frc, dt, solver=solver)))
    cs.log("per call at 64x64x160, n=1 (CUDA events, median of 20): %s on %s"
           % (", ".join("%s %.3f ms" % kv for kv in ms.items()), card))
    return ms


def launch_of(name):
    """Which launch of the stage a device kernel is: k_means, k_stage, or
    other (the wrapper's zeroing of aux)."""
    return next((k for k in ("k_means", "k_stage") if k in name), "other")


def phase_stage(card):
    """The stage kernel alone at 64x64x160: device time by launch, CUDA
    events, bound share; then levels per chunk."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    grid, phys = lgrid.LESGrid(), lstep.LESPhysics()
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    res = dict(calls={}, sweep=[])
    for n in (1, 2):
        cur, base, frc, dt = cs.stage_inputs(grid, n, 7 + n)
        call = lambda **kw: lesstage.stage_fused_cuda(
            grid, phys, cur, base, frc, 0.5, dt, **kw)
        by = {}
        for name, us in cs.device_us(
                call, expect=cs.DEVICE_KERNELS["lesstage"]).items():
            by[launch_of(name)] = by.get(launch_of(name), 0.0) + us
        stage_us = by.get("k_means", 0.0) + by.get("k_stage", 0.0)
        b_ms, bound_by = bounds.bound_ms(*bounds.stage_bound(n, nz, ny,
                                                             nx))
        ev = cs.cuda_ms(call)
        geom = lesstage.stage_geometry(n, nz, ny, nx)
        res["calls"][n] = dict(device_us_by_launch=by, device_us=stage_us,
                               cuda_event_ms=ev, bound_us=1e3 * b_ms,
                               bound_by=bound_by, geometry=geom._asdict())
        cs.log("stage 64x64x160 n=%d (tile %dx%d, tz %d, %d blocks, %d B "
               "shared): device %.1f us per call (k_means %.1f, k_stage "
               "%.1f, other %.1f); CUDA events %.3f ms; bound %.1f us (%s), "
               "%.1f %% of it, on %s"
               % (n, geom.tx, geom.ty, geom.tz, geom.blocks, geom.smem,
                  stage_us, by.get("k_means", 0.0), by.get("k_stage", 0.0),
                  by.get("other", 0.0), ev, 1e3 * b_ms, bound_by,
                  100 * 1e3 * b_ms / stage_us, card))
        for tz in TZ_SWEEP:
            g = lesstage.stage_geometry(n, nz, ny, nx, tz)
            us = sum(v for k, v in cs.device_us(
                lambda: call(tz=tz), reps=10,
                expect=cs.DEVICE_KERNELS["lesstage"]).items()
                if launch_of(k) == "k_stage")
            res["sweep"].append(dict(n=n, tz=tz, blocks=g.blocks,
                                     k_stage_us=us))
            cs.log("  sweep n=%d tz %3d: %4d blocks, k_stage %.1f us%s"
                   % (n, tz, g.blocks, us,
                      " (default)" if tz == geom.tz else ""))
    return res


def phase_split(card):
    """The scalar and momentum kernels alone at 64x64x160: device time,
    CUDA events, bound share; then levels per chunk."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    grid = lgrid.LESGrid()
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    res = dict(calls={}, sweep=[])
    for name, launch, _, args_of, _, geom_of in cs.split_kernels()[:2]:
        for n in (1, 2):
            args = args_of(cs.split_inputs(grid, n, 11 + n), grid)
            call = lambda **kw: launch(*args, **kw)
            us = sum(cs.device_us(
                call, expect=cs.DEVICE_KERNELS[name]).values())
            ev = cs.cuda_ms(call)
            b_ms, bound_by = bounds.bound_ms(
                cs.tensor_bytes(args, call()),
                bounds.KERNEL_OPS[name] * n * nz * ny * nx)
            geom = geom_of(args, None)
            res["calls"]["%s n=%d" % (name, n)] = dict(
                device_us=us, cuda_event_ms=ev, bound_us=1e3 * b_ms,
                bound_by=bound_by, geometry=geom._asdict())
            cs.log("%s 64x64x160 n=%d (tile %dx%d, tz %d, %d blocks, %d B "
                   "shared): device %.1f us per call; CUDA events %.3f ms; "
                   "bound %.1f us (%s), %.1f %% of it, on %s"
                   % (name, n, geom.tx, geom.ty, geom.tz, geom.blocks,
                      geom.smem, us, ev, 1e3 * b_ms, bound_by,
                      100 * 1e3 * b_ms / us, card))
            for tz in SPLIT_TZ_SWEEP:
                g = geom_of(args, tz)
                t = sum(cs.device_us(lambda: call(tz=tz), reps=10,
                                     expect=cs.DEVICE_KERNELS[name]).values())
                res["sweep"].append(dict(kernel=name, n=n, tz=tz,
                                         blocks=g.blocks, device_us=t))
                cs.log("  sweep %s n=%d tz %3d: %4d blocks, %.1f us%s"
                       % (name, n, tz, g.blocks, t,
                          " (default)" if tz == geom.tz else ""))
    return res


def t159_step(fn, carry, step_idx):
    """One first=False coupled step of a chunked case, timed by phase and
    by evolve chunk (host clock around torch.cuda.synchronize())."""
    gs, les, prof, rain = carry
    k = fn.evolve_chunks
    t0 = time.time()
    gs, les, forcing, conv, cprof, pre = fn._pre(gs, les, prof, step_idx,
                                                 False)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    chunks, n_sub, n_clamp = [], 0, 0
    for _ in range(k):
        t0 = time.time()
        les, ns, nc = fn._evolve_to(les, forcing, fn.core.cfg.dt / k)
        torch.cuda.synchronize()
        chunks.append(dict(wall_s=time.time() - t0,
                           substeps=[int(x) for x in ns]))
        n_sub, n_clamp = n_sub + ns, n_clamp + nc
    t0 = time.time()
    fn._post(gs, les, conv, cprof, rain, n_sub, n_clamp, pre, False)
    torch.cuda.synchronize()
    t_post = time.time() - t0
    evolve = sum(c["wall_s"] for c in chunks)
    return dict(pre_s=t_pre, post_s=t_post, chunks=chunks, evolve_s=evolve,
                wall_s=t_pre + evolve + t_post,
                instance_substeps=sum(sum(c["substeps"]) for c in chunks))


def first_chunk_kernels(fn, carry, step_idx):
    """The device kernel events of the first evolve chunk of the step
    t159_step times, from the same state, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    gs, les, prof, _ = carry
    _, les, forcing = fn._pre(gs, les, prof, step_idx, False)[:3]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn._evolve_to(les, forcing, fn.core.cfg.dt / fn.evolve_chunks)
        torch.cuda.synchronize()
    return [e for e in p.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_t159(card):
    """The T159 case's steady step, batched against serial pacing."""
    from sp_coupler_tpu_torch.runtime import t159bench
    fn, carry = t159bench.case(torch.device("cuda"), "batched")
    carry = fn(*carry, 0, first=True)[:4]
    torch.cuda.synchronize()
    grid = fn.grid
    pts = grid.nx * grid.ny * grid.nz
    out = {}
    for sched in ("batched", "serial"):
        fn.serial_evolve = sched
        rec = t159_step(fn, carry, 1)
        kern = first_chunk_kernels(fn, carry, 1)
        if not kern:
            raise RuntimeError("the profiler saw no device kernels")
        busy = busy_us(kern) * 1e-6
        top, port = kernel_totals(kern)
        c0 = rec["chunks"][0]
        rec.update(chunk0_busy_s=busy, chunk0_kernels=len(kern),
                   chunk0_idle_share=1.0 - busy / c0["wall_s"],
                   gridpoint_updates_per_s=pts * rec["instance_substeps"]
                   / rec["wall_s"],
                   chunk0_top=[dict(name=n, ms=ms, calls=c)
                               for n, (ms, c) in top + port])
        out[sched] = rec
        cs.log("t159 %s: step wall %.3f s = pre %.3f + evolve %.3f + post "
               "%.3f; %d instance-substeps, %.4g LES gridpoint-updates/s; "
               "chunk 0: wall %.3f s, device busy %.3f s (%d kernels), idle "
               "%.1f %% on %s"
               % (sched, rec["wall_s"], rec["pre_s"], rec["evolve_s"],
                  rec["post_s"], rec["instance_substeps"],
                  rec["gridpoint_updates_per_s"], c0["wall_s"], busy,
                  len(kern), 100 * rec["chunk0_idle_share"], card))
        log_kernels(top, port, busy)
    return out


def tl639_row(core, state, dt, lat):
    """The probe's numbers of one step of the jet run: the step from
    state, and the vertical Courant numbers of the state it starts
    from."""
    from sp_coupler_tpu_torch.models.gcm import semilag
    from sp_coupler_tpu_torch.runtime import tl639
    m = semilag.sl_mid_grid(core.sht.whole, core.vc, core.slg, state.now)
    sd = m["sdot"].abs()
    cz = dt * (sd[1:] + sd[:-1]) / m["dpt_full"]     # 2 dt x mean |eta-dot|
    cz = cz.expand(core.cfg.nlev, core.nlat, core.nlon)
    del m, sd
    state = core.step(tl639.strip(state))
    g = state.grid
    bad = {k: int((~torch.isfinite(getattr(g, k))).sum())
           for k in ("u", "v", "T", "lnps")}
    ua = g.u.abs().nan_to_num(0.0)
    iu = np.unravel_index(int(ua.argmax()), tuple(ua.shape))
    iz = np.unravel_index(int(cz.nan_to_num(0.0).argmax()), tuple(cz.shape))
    row = dict(umax=float(ua.max()), u_level=int(iu[0]),
               u_lat=float(lat[iu[1]]), courant_z=float(cz.max()),
               courant_level=int(iz[0]), courant_lat=float(lat[iz[1]]),
               Tmin=float(g.T.min()), Tmax=float(g.T.max()), nonfinite=bad)
    return state, row


def phase_tl639(card):
    """The jet run of runtime/tl639.py, step by step (TL639_PROBES)."""
    from sp_coupler_tpu_torch.models.gcm import semilag
    from sp_coupler_tpu_torch.runtime import tl639
    out = []
    for trunc, nlev, dt, split, method, steps in TL639_PROBES:
        core = tl639.build(trunc, nlev, dt, split_phases=split,
                           device="cuda")
        if method != core.slg.method:
            kc = core.slg.k_chunk
            core.slg = semilag.SLGrid(core.sht, method=method, dt=dt)
            core.slg.k_chunk = kc
        lat = np.degrees(np.arcsin(core.sht.mu.cpu().numpy()))
        state = core.step(tl639.start(core, 60.0), first=True)
        rows = []
        t0 = time.time()
        for i in range(steps):
            state, row = tl639_row(core, state, dt, lat)
            rows.append(dict(step=i + 1, **row))
            cs.log("tl639 T%d/L%d dt %g split %s %s step %d: max|u| %.1f "
                   "(level %d, lat %.1f), vertical Courant %.3g (level %d, "
                   "lat %.1f), T %.1f..%.1f, non-finite %s"
                   % (trunc, nlev, dt, split, method, i + 1, row["umax"],
                      row["u_level"], row["u_lat"], row["courant_z"],
                      row["courant_level"], row["courant_lat"], row["Tmin"],
                      row["Tmax"], row["nonfinite"]))
            if any(row["nonfinite"].values()):
                break
        torch.cuda.synchronize()
        out.append(dict(trunc=trunc, nlev=nlev, dt=dt, split_phases=split,
                        method=method, steps_run=len(rows),
                        wall_s=time.time() - t0, rows=rows))
        del state, core
        torch.cuda.empty_cache()
    cs.log("tl639 probes on %s: %s" % (card, [
        (p["trunc"], p["dt"], p["split_phases"], p["method"], p["steps_run"],
         any(any(r["nonfinite"].values()) for r in p["rows"]))
        for p in out]))
    return out


# float32 opcodes of the SASS histogram (phase 8)
F32_OPCODES = ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSET", "FSEL",
               "FCHK", "MUFU")
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def sass_counts(text):
    """{device function: {opcode: count}} of cuobjdump -sass output."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = {}
            continue
        m = SASS_LINE.search(line)
        if fn is not None and m:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return out


def phase_sass(card):
    """Phase 8: the float32 opcodes of each kernel's static SASS."""
    from sp_coupler_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    res = {}
    for name in cs.BUILDS:
        text = subprocess.run([tool, "-sass", _build.build(name)[0]],
                              check=True, capture_output=True,
                              text=True).stdout
        for fn, ops in sass_counts(text).items():
            f32 = {k: ops.get(k, 0) for k in F32_OPCODES}
            mad = f32["FFMA"] + f32["FADD"] + f32["FMUL"]
            res[fn] = dict(source=name, instructions=sum(ops.values()),
                           f32=f32, f32_total=sum(f32.values()),
                           ffma_share=f32["FFMA"] / max(mad, 1))
            print("sass %s %s: %d instructions, %d float32 (%s); FFMA %.3f "
                  "of FFMA + FADD + FMUL" % (
                      name, fn, res[fn]["instructions"],
                      res[fn]["f32_total"],
                      " ".join("%s %d" % kv for kv in f32.items() if kv[1]),
                      res[fn]["ffma_share"]), flush=True)
    print("sass on %s" % card, flush=True)
    return res


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode not in ("all", "path", "stage", "split", "t159", "tl639",
                    "sass"):
        raise SystemExit("usage: chip_profile.py [path | stage | split | "
                         "t159 | tl639 | sass]")
    card = cs.phase_env()
    cs.phase_build()
    out = dict(card=card)
    if mode in ("all", "path"):
        out.update(paths={g: phase_steps(card, g)
                          for g in ("tke", "smagorinsky")},
                   per_call_ms=phase_calls(card))
    if mode in ("all", "stage"):
        out.update(stage=phase_stage(card))
    if mode in ("all", "split"):
        out.update(split=phase_split(card))
    if mode == "t159":
        out.update(t159=phase_t159(card))
    if mode == "tl639":
        out.update(tl639=phase_tl639(card))
    if mode == "sass":
        out.update(sass=phase_sass(card))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    name = "profile.json" if mode == "all" else "profile_%s.json" % mode
    with open(os.path.join(cs.OUT_DIR, name), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
