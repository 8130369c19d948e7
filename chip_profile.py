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
     step at a time for each of TL639_PROBES: per step the row of
     verify/tl639_rows.py (max|u| and its level, the largest vertical
     Courant number of the explicit vertical advection, |eta-dot| x 2 dt
     over the layer's thickness, from the state the step starts from,
     and its level, the temperature extrema, which fields are finite);
     the run stops at its first non-finite step.
  8. (mode sass only) the static SASS of each built kernel (cuobjdump
     -sass of the .so phase_build made): per device function, the count
     of each float32 opcode (FFMA, FADD, FMUL, FMNMX, FSETP, FSEL, MUFU,
     ...) and of all instructions; the share of multiplies and adds that
     the compiler fused (FFMA against FADD + FMUL) reads against the
     data sheet's 67 TFLOP/s of ops/bounds.py, which counts an FFMA as
     two operations.
  9. (mode tl639cpu only) the TL639 jet run's GCM in float32 on the card
     and on the port's CPU, each against the same core in float64 on the
     card (tl639_rows.as_double: the float32 core's coefficients, float64
     arithmetic). Part "float64": the card's run in float32, in float64
     and in float32 without spharm.card_sums (plain_sums, the card's
     path before the TL639 repair), each to its first non-finite step,
     their rows against the committed CPU rows and against each other.
     Part "sums": the card's analysis against float64 beside the CPU's,
     with and without card_sums. Part "steps": from the card's states
     after TL639_FROM_STEPS leapfrog steps, one step of each core, the
     grid view's u, v, T and lnps as max|err| / max against the float64
     step (and the card's step from the state moved by one rounding
     against its own); then each SL stage of that step
     (semilag.SL_STAGES), each from the CPU's inputs, on the card in
     float32 and in float64, the CPU's and the card's float32 stages
     against the float64 ones.
  10. (mode gemms only) the GCM's float32 products beyond TL639: at
     T159/L60 and T255/L60 (GEMM_TRUNCS) the SL core's analysis of the
     jet's Euler state, with and without card_sums, and its step and
     every SL stage from the card's states after GEMM_FROM_STEPS (phase
     9's "sums" and "steps" at that truncation), and the Eulerian core's
     synthesis, explicit tendencies, semi-implicit solve and whole step
     (euler_gemms), each on the card and on the CPU in float32 against
     float64 on the card; every stage whose card error exceeds
     GEMM_RATIO x the CPU's is listed.
  11. (mode save only) one les slot of BASELINE config 4 on one card:
     the first 64 of chip_smoke.py's config-4 columns (64 x 128x128x160,
     T255/L19, batched, 2 coupled steps) through the CLI without a mesh,
     its step walls and peak of device memory, its checkpoint
     (restart.save, members stored) timed, then np.savez_compressed of
     the same fleet leaves (the JAX package's save) timed: each file's
     bytes and rate, and the temporary directory's free space (the files
     are removed). A fleet of 4 slots is 4 x these bytes.
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
     python3 chip_profile.py tl639cpu [float64] [steps] [sums]
                                     (phase 9 only; not part of "all";
                                      float64 and steps by default)
     python3 chip_profile.py gemms   (phase 10 only; not part of "all")
     python3 chip_profile.py save    (phase 11 only; not part of "all")
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

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


def phase_tl639(card):
    """The jet run of runtime/tl639.py, step by step (TL639_PROBES)."""
    from sp_coupler_tpu_torch.models.gcm import semilag
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    out = []
    for trunc, nlev, dt, split, method, steps in TL639_PROBES:
        core = tl639.build(trunc, nlev, dt, split_phases=split,
                           device="cuda")
        if method != core.slg.method:
            kc = core.slg.k_chunk
            core.slg = semilag.SLGrid(core.sht, method=method, dt=dt)
            core.slg.k_chunk = kc
        state = core.step(tl639.start(core, 60.0), first=True)
        rows = []
        t0 = time.time()
        for i in range(steps):
            state, row = tl639_rows.step(core, state, dt, i + 1)
            rows.append(row)
            cs.log("tl639 T%d/L%d dt %g split %s %s step %d: max|u| %.1f "
                   "(level %d), vertical Courant %.3g (level %d), T "
                   "%.1f..%.1f, finite %s"
                   % (trunc, nlev, dt, split, method, i + 1, row["umax"],
                      row["u_level"], row["courant_z"],
                      row["courant_level"], row["Tmin"], row["Tmax"],
                      row["finite_by_field"]))
            if not row["finite"]:
                break
        torch.cuda.synchronize()
        out.append(dict(trunc=trunc, nlev=nlev, dt=dt, split_phases=split,
                        method=method, steps_run=len(rows),
                        wall_s=time.time() - t0, rows=rows))
        del state, core
        torch.cuda.empty_cache()
    cs.log("tl639 probes on %s: %s" % (card, [
        (p["trunc"], p["dt"], p["split_phases"], p["method"], p["steps_run"],
         not p["rows"][-1]["finite"]) for p in out]))
    return out


def moved(x, device, dtype=None):
    """A copy of a state or a tree of stages (NamedTuples, dicts, tuples,
    tensors, None) on device; with dtype, its float32 tensors as dtype."""
    if isinstance(x, torch.Tensor):
        if dtype is not None and x.dtype == torch.float32:
            return x.to(device, dtype, copy=True)
        return x.to(device, copy=True)
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return type(x)(**{k: moved(v, device, dtype)
                          for k, v in x._asdict().items()})
    if isinstance(x, (tuple, list)):
        return type(x)(moved(v, device, dtype) for v in x)
    if isinstance(x, dict):
        return {k: moved(v, device, dtype) for k, v in x.items()}
    return x


# where phase 9 computes its differences
DIFFS_ON = "cuda"


def tree_diffs(got, ref, path="", device=None):
    """{path: (tl639_rows.max_diff's fraction, index of the largest
    difference)} over the tensors of two trees of one structure."""
    from sp_coupler_tpu_torch.verify import tl639_rows
    if isinstance(ref, torch.Tensor):
        frac, idx = tl639_rows.max_diff(got, ref, device)
        return {path: (frac, list(idx))}
    if isinstance(ref, tuple) and hasattr(ref, "_asdict"):
        got, ref = got._asdict(), ref._asdict()
    if isinstance(ref, (tuple, list)):
        got, ref = dict(enumerate(got)), dict(enumerate(ref))
    out = {}
    if isinstance(ref, dict):
        for k in ref:
            out.update(tree_diffs(got[k], ref[k], "%s/%s" % (path, k),
                                  device))
    return out


def grid_diffs(got, ref):
    """max_diff of the grid view's u, v, T and lnps, each with the level
    of the largest difference (None for lnps)."""
    from sp_coupler_tpu_torch.verify import tl639_rows
    out = {}
    for k in ("u", "v", "T", "lnps"):
        frac, idx = tl639_rows.max_diff(getattr(got.grid, k),
                                        getattr(ref.grid, k), DIFFS_ON)
        out[k] = (frac, idx[0] if k != "lnps" else None)
    return out


class OnDevice(dict):
    """A stage mapping for semilag.sl_step's keep: each stage is stored as
    a copy on device (as dtype)."""

    def __init__(self, device, dtype=None):
        super().__init__()
        self.device, self.dtype = device, dtype

    def __setitem__(self, k, v):
        super().__setitem__(k, moved(v, self.device, self.dtype))


class Given:
    """A stage mapping for semilag.sl_step's given: each stage of src,
    moved to device as dtype when it is read (the last one cached)."""

    def __init__(self, src, device, dtype=None):
        self.src, self.device, self.dtype = src, device, dtype
        self.key = self.value = None

    def __getitem__(self, k):
        if k != self.key:
            self.key = None
            self.value = moved(self.src[k], self.device, self.dtype)
            self.key = k
        return self.value


class Compared:
    """A stage mapping for semilag.sl_step's keep: each stage is held,
    when it is made, against each run of refs ({name: stages}); the
    results gather in .diffs[name][stage path]."""

    def __init__(self, refs):
        self.refs, self.diffs = refs, {name: {} for name in refs}

    def __setitem__(self, k, v):
        for name, ref in self.refs.items():
            self.diffs[name].update(tree_diffs(v, ref[k], "/" + k,
                                               DIFFS_ON))


def step_kept(core, state, keep=None, given=None):
    """A leapfrog step of core from state whose SL stages go to keep, each
    from given's inputs where given is set (semilag.sl_step)."""
    return core.phase_b(core.phase_cloud(core.phase_a(state, keep=keep,
                                                      given=given)))


def ulp_perturbed(state, seed=0):
    """state with every spectral coefficient of now and prev moved by one
    float32 rounding (x (1 +- 2^-24), the sign from a seeded CPU
    generator)."""
    gen = torch.Generator().manual_seed(seed)

    def nudge(s):
        return type(s)(**{
            k: v * (1.0 + 2.0 ** -24 * (2.0 * torch.randint(
                0, 2, v.shape, generator=gen) - 1.0)).to(v.device, v.dtype)
            for k, v in s._asdict().items()})
    now = nudge(state.now)
    return state._replace(now=now, prev=nudge(state.prev), new=now)


# phase 9's "steps": the card's states the three cores step once from,
# by the leapfrog steps taken (0: the Euler state); the vertical Courant
# number passes 1 at step 12
TL639_FROM_STEPS = (0, 12, 14)


@contextlib.contextmanager
def plain_sums():
    """spharm.card_sums replaced by the plain float32 einsum: the card's
    path before the TL639 repair."""
    from sp_coupler_tpu_torch.models.gcm import spharm
    kept = spharm.card_sums
    spharm.card_sums = lambda eq, x, table: torch.einsum(eq, x, table)
    try:
        yield
    finally:
        spharm.card_sums = kept


def tl639_sums(card, dev):
    """The card's TL639 analysis of the jet run's Euler state against
    float64 beside the CPU's (tl639_rows.analysis_vs_float64), with
    spharm.card_sums and with the plain float32 einsums (plain_sums)."""
    from sp_coupler_tpu_torch.models.gcm import spharm
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    g = dev.step(tl639.start(dev, 60.0), first=True).grid
    cpu = spharm.SpectralTransform(dev.cfg.trunc, device="cpu")
    out = dict(card_sums=tl639_rows.analysis_vs_float64(dev.sht, cpu, g.u,
                                                        g.v, g.T))
    with plain_sums():
        out["float32"] = tl639_rows.analysis_vs_float64(dev.sht, cpu, g.u,
                                                        g.v, g.T)
    for name, res in out.items():
        cs.log("tl639cpu: analysis against float64 (max err / max) with "
               "%s, card / CPU: %s on %s" % (name, "; ".join(
                   "%s %.3g / %.3g" % (k, r["device"], r["cpu"])
                   for k, r in res.items()), card))
    return out


def tl639_float64(card, dev, dev64):
    """The jet run on the card in float32 and in float64
    (tl639_rows.as_double), each
    to its first non-finite step, and each against the committed CPU rows
    and against the other (tl639_rows.parted at chip_smoke's
    TL639_ROW_TOL): the per-step row differences and the first step past
    the tolerance."""
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    with open(tl639_rows.REF) as f:
        ref = json.load(f)["rows"]
    runs = {}
    for name, core in (("card32", dev), ("card64", dev64),
                       ("card32_plain", dev)):
        start = moved(tl639.start(dev, 60.0), "cuda",
                      torch.float64 if core is dev64 else None)
        with (plain_sums() if name == "card32_plain"
              else contextlib.nullcontext()):
            runs[name] = tl639_rows.rows(core, 40, start=start)
        del start
        torch.cuda.empty_cache()
    out = dict(rows=runs)
    for a, b in (("cpu", "card64"), ("cpu", "card32"),
                 ("card64", "card32"), ("cpu", "card32_plain"),
                 ("card64", "card32_plain")):
        diffs, first = tl639_rows.parted(ref if a == "cpu" else runs[a],
                                         runs[b], cs.TL639_ROW_TOL)
        out["%s_vs_%s" % (b, a)] = dict(diffs=diffs, parted=first)
        cs.log("tl639cpu: rows %s against %s: row difference by step %s; "
               "past %g from step %s" % (b, a, " ".join(
                   "%.3g" % d for d in diffs), cs.TL639_ROW_TOL, first))
    out["first_nonfinite"] = dict(cpu=next(
        (r["step"] for r in ref if not r["finite"]), None), **{
        k: next((r["step"] for r in v if not r["finite"]), None)
        for k, v in runs.items()})
    cs.log("tl639cpu: first non-finite steps %s; max|u| by step, float64 "
           "%s on %s" % (out["first_nonfinite"], " ".join(
               "%.4g" % r["umax"] for r in runs["card64"]), card))
    return out


def tl639_onestep(card, dev, dev64, cpu, state, n):
    """One leapfrog step from the card's state after step n on the card
    (float32), on the card in float64 and on the CPU (float32): the grid
    view's u, v, T and lnps of each float32 step against the float64 one
    and against each other, the card's step from the state moved by one
    rounding against its own; then every SL stage (semilag.SL_STAGES),
    each from the CPU's inputs, on the card in float32 and in float64,
    and the CPU's and the card's float32 stages against the float64
    ones."""
    st_cpu = {}
    l_cpu = step_kept(cpu, moved(state, "cpu"), keep=st_cpu)
    l_dev = dev.step(state)
    l_64 = dev64.step(moved(state, "cuda", torch.float64))
    out = dict(from_step=n, step={
        "card32_vs_card64": grid_diffs(l_dev, l_64),
        "cpu32_vs_card64": grid_diffs(l_cpu, l_64),
        "card32_vs_cpu32": grid_diffs(l_dev, l_cpu),
        "card32_ulp_vs_card32": grid_diffs(dev.step(ulp_perturbed(state)),
                                           l_dev)})
    del l_cpu, l_dev, l_64
    torch.cuda.empty_cache()
    cs.log("tl639cpu: one step from the card's state after step %d, "
           "against the card's float64 step (max err / max, level): card "
           "%s; CPU %s; card against CPU %s; the card's step from the "
           "state moved by one rounding against its own %s"
           % (n, out["step"]["card32_vs_card64"],
              out["step"]["cpu32_vs_card64"],
              out["step"]["card32_vs_cpu32"],
              out["step"]["card32_ulp_vs_card32"]))
    st_64 = OnDevice("cpu")
    step_kept(dev64, moved(state, "cuda", torch.float64), keep=st_64,
              given=Given(st_cpu, "cuda", torch.float64))
    torch.cuda.empty_cache()
    card = Compared(dict(cpu32=st_cpu, card64=st_64))
    step_kept(dev, state, keep=card, given=Given(st_cpu, "cuda"))
    torch.cuda.empty_cache()
    out["stages"] = dict(card32_vs_cpu32=card.diffs["cpu32"],
                         card32_vs_card64=card.diffs["card64"],
                         cpu32_vs_card64=tree_diffs(st_cpu, st_64, "",
                                                    DIFFS_ON))
    del st_cpu, st_64
    for k in sorted(out["stages"]["card32_vs_card64"]):
        cs.log("tl639cpu: from step %d, stage %s from the CPU's inputs, "
               "against float64: card %.3g, CPU %.3g; card against CPU "
               "%.3g" % (n, k, out["stages"]["card32_vs_card64"][k][0],
                         out["stages"]["cpu32_vs_card64"][k][0],
                         out["stages"]["card32_vs_cpu32"][k][0]))
    return out


def phase_tl639_cpu(card, parts=("float64", "steps"), trunc=639, nlev=60,
                    dt=720.0, from_steps=TL639_FROM_STEPS):
    """Phase 9: the TL639 jet run's GCM on the card (float32), on the card
    in float64 (tl639_rows.as_double) and on the port's CPU (float32).
    parts: "float64" (tl639_float64), "steps" (tl639_onestep from the
    card's states after from_steps) and "sums" (tl639_sums). trunc, nlev
    and dt set the core (phase 10 runs it at T159 and T255)."""
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    dev = tl639.build(trunc, nlev, dt, device="cuda")
    out = dict(card=card, trunc=trunc, nlev=nlev, dt=dt)
    if "sums" in parts:
        out["sums"] = tl639_sums(card, dev)
    if not {"float64", "steps"} & set(parts):
        return out
    dev64 = tl639_rows.as_double(tl639.build(trunc, nlev, dt, device="cuda"))
    if "float64" in parts:
        out["float64"] = tl639_float64(card, dev, dev64)
    if "steps" in parts:
        cpu = tl639.build(trunc, nlev, dt, device="cpu")
        out.update(threads=torch.get_num_threads(), steps=[])
        state = dev.step(tl639.start(dev, 60.0), first=True)
        for n in range(max(from_steps) + 1):
            if n:
                state = dev.step(tl639.strip(state))
            if n in from_steps:
                state = tl639.strip(state)
                out["steps"].append(tl639_onestep(card, dev, dev64, cpu,
                                                  state, n))
    return out


# phase 10: the truncations, levels and steps (s) of the GCM's float32
# products held against float64 beyond TL639: gcmscale's L60 rows at
# T159 and T255, the SL core at their dt (1800 s), the Eulerian core at
# GEMM_EULER_DT (an advective Courant number below 0.4 for the 60 m/s
# jets on the T255 grid's 0.47 degrees); the SL stages from the card's
# states after GEMM_FROM_STEPS leapfrog steps; a card stage more than
# GEMM_RATIO x the CPU's error off float64 is at fault
GEMM_TRUNCS = (159, 255)
GEMM_NLEV = 60
GEMM_SL_DT = 1800.0
GEMM_EULER_DT = 300.0
GEMM_FROM_STEPS = (0, 12)
GEMM_RATIO = 3.0


def euler_gemms(card, trunc, nlev, dt):
    """The Eulerian core's float32 products at trunc/nlev on the card and
    on the CPU against the same core in float64 on the card, from the
    card's state after the jet run's Euler step (tl639.start): the
    synthesis of the state (dycore.to_grid), the explicit tendencies
    (dycore.tendencies: synthesis, gradients and the analysis of the
    nonlinear terms), the semi-implicit solve (dycore.semi_implicit_step,
    from the CPU's tendencies) and one whole leapfrog step. Returns
    {stage: {"card", "cpu": (max|err| / max, index)}} for every tensor of
    each stage's output."""
    from sp_coupler_tpu_torch.models.gcm import dycore, model as gm
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    cfg = gm.GCMConfig(trunc=trunc, nlev=nlev, dt=dt, hybrid=True,
                       advection="eulerian")
    cores = dict(card=gm.GCMCore(cfg, device="cuda"),
                 cpu=gm.GCMCore(cfg, device="cpu"))
    c64 = tl639_rows.as_double(gm.GCMCore(cfg, device="cuda"))
    state = tl639.strip(cores["card"].step(
        tl639.start(cores["card"], 60.0), first=True))
    s64 = moved(state, "cuda", torch.float64)
    ref = dict(to_grid=dycore.to_grid(c64.sht, c64.vc, s64.now),
               tendencies=dycore.tendencies(c64.sht, c64.vc, s64.now,
                                            c64.fcor)[0])
    st = {name: moved(state, "cuda" if name == "card" else "cpu")
          for name in cores}
    N_cpu = dycore.tendencies(cores["cpu"].sht, cores["cpu"].vc,
                              st["cpu"].now, cores["cpu"].fcor)[0]
    ref["semi_implicit"] = dycore.semi_implicit_step(
        c64.sht, c64.vc, s64.now, s64.prev, moved(N_cpu, "cuda",
                                                  torch.float64), 2 * dt)
    ref["step"] = c64.step(s64).grid
    out = {k: {} for k in ref}
    for name, core in cores.items():
        s, d = st[name], core.device
        got = dict(to_grid=dycore.to_grid(core.sht, core.vc, s.now),
                   tendencies=dycore.tendencies(core.sht, core.vc, s.now,
                                                core.fcor)[0],
                   semi_implicit=dycore.semi_implicit_step(
                       core.sht, core.vc, s.now, s.prev, moved(N_cpu, d),
                       2 * dt),
                   step=core.step(s).grid)
        for k in ref:
            for path, r in tree_diffs(got[k], ref[k], "", DIFFS_ON).items():
                out[k].setdefault(path, {})[name] = r
        del got
        torch.cuda.empty_cache()
    for k, paths in out.items():
        for path, r in sorted(paths.items()):
            cs.log("gemms T%d/L%d eulerian %s%s against float64: card %.3g, "
                   "CPU %.3g on %s" % (trunc, nlev, k, path, r["card"][0],
                                       r["cpu"][0], card))
    return out


def gemm_verdicts(res):
    """[(where, card err, CPU err)] of every stage of phase 10's results
    whose card error off float64 exceeds GEMM_RATIO x the CPU's."""
    rows = []
    for trunc, r in res.items():
        for k, paths in r["eulerian"].items():
            for path, e in paths.items():
                rows.append(("T%s eulerian %s%s" % (trunc, k, path),
                             e["card"][0], e["cpu"][0]))
        for name, a in r["sl"]["sums"]["card_sums"].items():
            rows.append(("T%s analysis %s" % (trunc, name), a["device"],
                         a["cpu"]))
        for st in r["sl"]["steps"]:
            for k, e in st["step"]["card32_vs_card64"].items():
                rows.append(("T%s sl step from %d %s" % (trunc, st["from_step"],
                                                         k), e[0],
                             st["step"]["cpu32_vs_card64"][k][0]))
            for k, e in st["stages"]["card32_vs_card64"].items():
                rows.append(("T%s sl stage from %d %s" % (
                    trunc, st["from_step"], k), e[0],
                    st["stages"]["cpu32_vs_card64"][k][0]))
    return [x for x in rows
            if x[1] == x[1] and x[1] > GEMM_RATIO * max(x[2], 1e-12)]


def phase_gemms(card):
    """Phase 10: the GCM's float32 products (the analysis, the synthesis,
    the Eulerian tendencies, the semi-implicit solves, every SL stage) at
    GEMM_TRUNCS/L60 on the card and on the CPU against float64 on the
    card: the SL core's analysis of the jet's Euler state and its steps
    and stages from the card's states after GEMM_FROM_STEPS
    (phase_tl639_cpu's "sums" and "steps"), and the Eulerian core's
    stages (euler_gemms). Lists every stage whose card error exceeds
    GEMM_RATIO x the CPU's."""
    res = {}
    for trunc in GEMM_TRUNCS:
        t0 = time.time()
        res[trunc] = dict(
            sl=phase_tl639_cpu(card, ("sums", "steps"), trunc, GEMM_NLEV,
                               GEMM_SL_DT, GEMM_FROM_STEPS),
            eulerian=euler_gemms(card, trunc, GEMM_NLEV, GEMM_EULER_DT))
        res[trunc]["wall_s"] = time.time() - t0
        cs.log("gemms T%d/L%d: %.1f s" % (trunc, GEMM_NLEV,
                                          res[trunc]["wall_s"]))
    bad = gemm_verdicts(res)
    cs.log("gemms: stages whose card error off float64 exceeds %g x the "
           "CPU's: %s on %s" % (GEMM_RATIO, bad or "none", card))
    return dict(results={str(k): v for k, v in res.items()}, at_fault=bad)


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


SAVE_SLOT = 64      # instances of one les slot of config 4 (256 / 4)


def phase_save(card):
    """(mode save) one slot of config 4 through the CLI on one card, its
    checkpoint stored and the same leaves deflated, each timed."""
    import shutil
    import tempfile
    import numpy as np
    from sp_coupler_tpu_torch.io import restart
    from sp_coupler_tpu_torch.utils import tree
    res = dict(card=card, instances=SAVE_SLOT)
    save_s, save = [], restart.save

    def timed_save(runner):
        t0 = time.time()
        save(runner)
        save_s.append(time.time() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        res["tmp_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        res["shm_free_gb"] = shutil.disk_usage("/dev/shm").free / 1e9
        print("save: %s has %.1f GB free, /dev/shm %.1f GB" % (
            tmp, res["tmp_free_gb"], res["shm_free_gb"]), flush=True)
        conf = os.path.join(tmp, "config4.json")
        with open(conf, "w") as f:
            json.dump(cs.CONFIG4_CONF, f)
        odir = os.path.join(tmp, "run")
        _, argv = cs.config4_argv(odir, conf, SAVE_SLOT, mesh=False)
        torch.cuda.reset_peak_memory_stats()
        restart.save = timed_save
        try:
            runner, walls, launches = cs.cli_leg(argv, None)
        finally:
            restart.save = save
        path = os.path.join(odir, restart.FNAME)
        res.update(walls=walls, launches=launches,
                   substeps=runner.substeps,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   stored_s=save_s[0], stored_bytes=os.path.getsize(path))
        os.remove(path)
        leaves = {"les_%d" % i: x.cpu().numpy()
                  for i, x in enumerate(tree.flatten(runner.fleet.state)[0])}
        del runner
        torch.cuda.empty_cache()
        path = os.path.join(tmp, "deflated.npz")
        t0 = time.time()
        np.savez_compressed(path, **leaves)
        res.update(deflated_s=time.time() - t0,
                   deflated_bytes=os.path.getsize(path),
                   leaf_bytes=sum(a.nbytes for a in leaves.values()))
        os.remove(path)
    res["stored_mb_s"] = res["stored_bytes"] / 1e6 / res["stored_s"]
    res["deflated_mb_s"] = res["leaf_bytes"] / 1e6 / res["deflated_s"]
    fleet_mb = 4 * res["leaf_bytes"] / 1e6
    print("save: %d x 128x128x160 through the CLI on one card: step walls "
          "%s s, substeps %s..., peak %.2f GiB; the fleet leaves %d bytes; "
          "the checkpoint (GCM and fleet) stored %d bytes in %.2f s (%.1f "
          "MB/s), the fleet leaves through np.savez_compressed %d bytes in "
          "%.2f s (%.1f MB/s of input); 4 slots' leaves at those rates: "
          "%.1f s stored, %.1f s deflated, on %s" % (
              SAVE_SLOT, ["%.2f" % w for w in res["walls"]],
              res["substeps"][0][:4], res["peak_gib"], res["leaf_bytes"],
              res["stored_bytes"], res["stored_s"], res["stored_mb_s"],
              res["deflated_bytes"], res["deflated_s"], res["deflated_mb_s"],
              fleet_mb / res["stored_mb_s"], fleet_mb / res["deflated_mb_s"],
              card), flush=True)
    return res


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode not in ("all", "path", "stage", "split", "t159", "tl639",
                    "sass", "tl639cpu", "gemms", "save"):
        raise SystemExit("usage: chip_profile.py [path | stage | split | "
                         "t159 | tl639 | sass | tl639cpu | gemms | save]")
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
    if mode == "tl639cpu":
        out.update(tl639cpu=phase_tl639_cpu(card, sys.argv[2:]
                                            or ("float64", "steps")))
    if mode == "gemms":
        out.update(gemms=phase_gemms(card))
    if mode == "save":
        out.update(save=phase_save(card))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    name = "profile.json" if mode == "all" else "profile_%s.json" % mode
    with open(os.path.join(cs.OUT_DIR, name), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
