"""Benchmark: the reference T21 + 2-LES case, one card.

Port of the JAX package's root ``bench.py``. Metric: LES grid-point
updates per second on the coupled configuration of run_T21_sockets.sh,
T21/L19 GCM (900 s steps) coupled to 2 LES instances of 64 x 64 x 160
(the dales-input RICO case), CFL/Peclet-adaptive with dt_les 15 s, the
LES started from the GCM's columns 1208 and 1272 with seed 42.

Baseline (BASELINE.md): the reference does ~470 s per coupled step on a
quad-core i7-4790, with each DALES instance taking ~15 adaptive substeps
per 900 s GCM step => 2 * 64*64*160 * 15 / 470 s ~= 4.18e4 grid-point
updates/s. vs_baseline is measured throughput over that number.

Two warm steps (first=True, then first=False), then --timed steps, each
ending in a device synchronise; then the phase breakdown
(``phase_breakdown``). Prints ONE JSON line: metric, value, unit,
vs_baseline, phase_ms, phase_method, hbm_gbs, hbm_frac, f32_op_frac,
op_model. Runs on the card unless --device cpu is given, and raises where
there is no card; the size flags exist for runs at a small size.

    python -m sp_coupler_tpu_torch.bench [--timed 3] [--nscan 50]
        [--reps 3] [--trunc 21 --nlev 19 --nx 64 --ny 64 --nz 160]
        [--cols 1208 1272] [--device cpu]
"""

import argparse
import json
import sys

import numpy as np
import torch

from . import clock, default_device, device_name
from .coupling.coupler import CoupledStepFn
from .models.gcm import model as gcm_model
from .models.les import diag as ldiag, grid as lgrid, poisson
from .models.les import step as lstep
from .ops import bounds
from .runtime import batchbench, schedulebench
from .runtime.t255bench import seed_les

REF_GRIDPOINTS_PER_S = 2 * 64 * 64 * 160 * 15 / 470.0  # ~41.8e3


def run(args, device):
    """The bench at args on device. Returns (the JSON line, extras):
    extras holds the final profiles and the substeps of every part of the
    run (``warm``, ``timed``, ``breakdown``), each substep being 3 stages."""
    core = gcm_model.GCMCore(gcm_model.GCMConfig(
        trunc=args.trunc, nlev=args.nlev, dt=900.0), device=device)
    grid = lgrid.LESGrid(nx=args.nx, ny=args.ny, nz=args.nz)
    phys = lstep.LESPhysics()
    print("bench: initializing states on %s ..." % device_name(device),
          file=sys.stderr, flush=True)
    gcm_state = core.initial_state(seed=0)
    cols = list(args.cols)
    les_state = seed_les(core, gcm_state, grid, cols)
    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0,
                            n_substeps=0)
    prof = ldiag.slab_profiles(grid, les_state)
    rain = torch.zeros(len(cols), device=core.device)

    def nsub(diag):
        return int(np.sum(step_fn.unpack_diag(diag)["n_substeps"]))

    # first=True and first=False are different steps (the leapfrog's Euler
    # start): run one of each before the timed window
    print("bench: first coupled steps ...", file=sys.stderr, flush=True)
    t0 = clock(device)
    warm_sub = 0
    for s in (0, 1):
        gcm_state, les_state, prof, rain, d0 = step_fn(
            gcm_state, les_state, prof, rain, s, first=s == 0)
        warm_sub += nsub(d0)
    warm = clock(device) - t0
    print("bench: warmup %.0fs, %s substeps" % (
        warm, step_fn.unpack_diag(d0)["n_substeps"]), file=sys.stderr,
        flush=True)

    total_sub = 0
    t0 = clock(device)
    for s in range(2, args.timed + 2):
        gcm_state, les_state, prof, rain, diag = step_fn(
            gcm_state, les_state, prof, rain, s, first=False)
        total_sub += nsub(diag)
        clock(device)
    elapsed = clock(device) - t0

    if not bool(torch.isfinite(prof["THL"]).all()):
        raise FloatingPointError("NaN in coupled state")

    phase, phase_sub = phase_breakdown(grid, phys, les_state, args.nscan,
                                       args.reps)

    updates = grid.nx * grid.ny * grid.nz * total_sub
    gps = updates / elapsed
    line = {
        "metric": "les_gridpoint_updates_per_s_per_chip",
        "value": gps,
        "unit": "gridpoint-updates/s (T%d+%dxLES %dx%dx%d coupled, "
                "adaptive dt, %d total substeps; step %.2fs, warmup %.0fs)"
                % (args.trunc, len(cols), grid.nx, grid.ny, grid.nz,
                   total_sub, elapsed / args.timed, warm),
        "vs_baseline": gps / REF_GRIDPOINTS_PER_S,
        **phase,
    }
    print(json.dumps(line), flush=True)
    return line, dict(prof=prof, substeps=dict(
        warm=warm_sub, timed=total_sub, breakdown=phase_sub))


def phase_breakdown(grid, phys, les_state, nscan=50, reps=3):
    """Self-consistent substep phase accounting.

    Both numbers come from the same loop of nscan fixed-dt substeps of 3 s
    (``runtime/batchbench.py``'s ``go``, with the benches' surface
    forcing): the full substep is timed, then re-timed with the pressure
    projection skipped (``substep(..., skip_projection=True)``); the
    difference is the cost in context of the 3 projections and the
    remainder is the 3 fused stages and the glue, so stage_x3 +
    projection_x3 == substep whenever the full substep is the slower.
    Each loop runs once to warm up, then reps times, each ending in a
    device synchronise.

    Also gives the achieved HBM bandwidth of the traffic model of a
    substep (n instances of [nz, ny, nx] float32: the fused stage reads
    u, v, w and 4 scalars with ~1.5x z-halo amplification, 7 base reads
    and 7 writes; the projection ~34 field passes) against the H100's
    3.35 TB/s, and the stage's float32 operations (``ops/bounds.py``,
    KERNEL_OPS) over the card's 67 TFLOP/s of float32. Returns (the
    line's phase keys, the substeps run).
    """
    device = les_state.u.device
    n = les_state.thl.shape[0]
    fld_mb = grid.nx * grid.ny * grid.nz * 4 / 1e6
    forcing = schedulebench.surface_forcing(n, grid.nz, device)
    solver = poisson.build_solver(grid, les_state.rhobf, les_state.rhobh)

    def scan(skip):
        batchbench.go(grid, phys, les_state, forcing, solver, nscan,
                      skip_projection=skip)
        clock(device)

    def scan_time(skip):
        scan(skip)
        t0 = clock(device)
        for _ in range(reps):
            scan(skip)
        return (clock(device) - t0) / reps / nscan

    t_full = scan_time(False)
    t_noproj = scan_time(True)
    t_proj3 = max(t_full - t_noproj, 0.0)

    pts = n * grid.nx * grid.ny * grid.nz
    ops = bounds.KERNEL_OPS["lesstage"]
    # 3 fused stages run in t_noproj
    op_rate = 3 * pts * ops / max(t_noproj, 1e-9)
    sub_mb = n * fld_mb * 3 * ((7 * 1.5 + 7 + 7) + (4 + 12 + 15 + 3))
    gbs = sub_mb / 1e3 / t_full
    out = {
        "phase_ms": {
            "substep": t_full * 1e3,
            "stage_x3": t_noproj * 1e3,
            "projection_x3": t_proj3 * 1e3,
        },
        "phase_method": "in-context differential: the same substep loop "
                        "with and without the projection; stage_x3 + "
                        "projection_x3 == substep when the full substep "
                        "is the slower",
        "hbm_gbs": gbs,
        "hbm_frac": gbs * 1e9 / bounds.HBM_BYTES_PER_S,
        "f32_op_frac": op_rate / bounds.F32_OPS_PER_S,
        "op_model": "%d float32 ops/point/stage (ops/bounds.py KERNEL_OPS) "
                    "vs %.1f TFLOP/s float32 (H100 SXM data sheet)" % (
                        ops, bounds.F32_OPS_PER_S / 1e12),
    }
    return out, 2 * (1 + reps) * nscan


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timed", type=int, default=3,
                    help="timed coupled steps after the 2 warm ones")
    ap.add_argument("--nscan", type=int, default=50,
                    help="substeps of each phase-breakdown loop")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs of each phase-breakdown loop")
    ap.add_argument("--trunc", type=int, default=21)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--cols", type=int, nargs="+", default=[1208, 1272],
                    help="the GCM columns of the LES instances")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return run(args, default_device(args.device))[0]


if __name__ == "__main__":
    main()
    sys.exit(0)
