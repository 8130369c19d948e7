#!/usr/bin/env python
"""Where the time of the port's main path goes, on one CUDA card.

Runs the bench.py case of chip_smoke.py (T21/L19 + 2 x 64x64x160,
adaptive, through the CUDA stage kernel):
  1. 1 + STEADY coupled steps, each split into the GCM first half and
     coupling (``_pre``), the LES evolve and the GCM second half
     (``_post``), timed by the host clock around torch.cuda.synchronize();
  2. one more steady step under torch.profiler: the union of its device
     kernel intervals is the device busy time; busy per substep against
     the median wall per substep of the unprofiled steady steps gives the
     device's idle share; per-kernel device totals are listed;
  3. CUDA-event times (median of 20) per call of the stage kernel, the
     pressure projection and one whole substep at 64x64x160, n = 1.
Prints a summary with the card's name and power limit and writes
chiprun_out/profile.json.

Run: python3 chip_profile.py   (needs a CUDA card, nvcc and this checkout)
"""

import json
import os
import statistics
import sys
import time

import torch

import chip_smoke as cs

STEADY = 5
TOP = 15


def timed_step(fn, gs, les, prof, rain, first):
    """One coupled step as CoupledStepFn.__call__, timed by phase."""
    t = [time.time()]
    gs, les, forcing, conv, cprof, pre = fn._pre(gs, les, prof, first)
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


def phase_steps(card):
    fn, carry = cs.main_path_case()
    steps = []
    for i in range(1 + STEADY):
        carry, rec = timed_step(fn, *carry, first=(i == 0))
        steps.append(rec)
        cs.log("step %d (first=%s): wall %.3f s = pre %.3f + evolve %.3f + "
               "post %.3f; substeps %s; %.3f ms per substep on %s"
               % (i, rec["first"], rec["wall_s"], rec["pre_s"],
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
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() * 1e-3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    cs.log("profiled step: substeps %s, device busy %.3f s (%.3f ms per "
           "substep); unprofiled steady steps: median %.3f ms per substep, "
           "so the device is idle %.1f %% of a step on %s"
           % (rec["substeps"], busy, 1e3 * busy / nsub, 1e3 * wall_per_sub,
              100 * idle, card))
    for name, (ms, cnt) in top:
        cs.log("  %10.1f ms %7d  %.3f ms/call  %s"
               % (ms, cnt, ms / cnt, name[:100]))
    return dict(steps=steps, profiled=dict(
        substeps=rec["substeps"], busy_s=busy, idle_share=idle,
        wall_per_substep_s=wall_per_sub,
        kernels=[dict(name=n, ms=ms, calls=c) for n, (ms, c) in top]))


def phase_calls(card):
    """Per-call times at 64x64x160, n = 1."""
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, poisson,
                                                 step as lstep)
    from sp_coupler_tpu_torch.ops import lesstage
    grid = lgrid.LESGrid()
    phys = lstep.LESPhysics()
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
            grid, phys, cur, frc, dt, solver=solver)))
    cs.log("per call at 64x64x160, n=1 (CUDA events, median of 20): %s on %s"
           % (", ".join("%s %.3f ms" % kv for kv in ms.items()), card))
    return ms


def main():
    card = cs.phase_env()
    cs.phase_build()
    out = dict(card=card, **phase_steps(card), per_call_ms=phase_calls(card))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
