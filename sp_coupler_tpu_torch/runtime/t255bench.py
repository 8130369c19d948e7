"""BASELINE config 4: the T255 GCM and fleets of 128x128x160 LES instances.

Port of ``scripts/bench_t255.py``. The target is "T255 + 256 LES
(128x128x160)"; this runs the coupled program on one card with as many
full-size (128x128x160) instances as asked (default 32) and records the
step time and the LES gridpoint-updates/s. The case is the script's:
T255/L19 on hybrid levels with semi-Lagrangian dynamics (dt 900 s), the
LES grid 128x128x160 at 100 m x 100 m x 25 m with the TKE closure, the
script's columns (16 longitudes on each of the rows of |lat| < 15 deg
taken at a stride), dt_les 15 s, evolve_chunks 8. One warm step with
first=True, then --steps timed steps with first=False. The JSON line has
the script's keys plus ``les_schedule`` and ``peak_gib`` (the peak of
device memory over the run, on the card).

Added to the script: --les_schedule (the fleet's pacing; the script
passes "serial"), and size flags (--trunc --nlev --nx --ny --nz) for runs
at a small size. Dropped: the v5p HBM fit and the throughput
extrapolation of the script's report (TPU figures). --fit N [N ...]
tries each fleet size N batched, one warm and one timed step each in
this process after the run, and records its peak of device memory or
that it ran out of memory. --report writes
sp_coupler_tpu_torch/verify/T255_H100.md: the measured row, the peak of
device memory, the fleet sizes tried with --fit (the largest that fit
and the smallest that did not) and the card's name and power limit; the
file's section on four cards (the whole config through the CLI,
chip_smoke.py --cards 4) is kept.

Every clock is read after a device synchronise. Runs on the card unless
--device cpu is given, and raises where there is no card.

    python -m sp_coupler_tpu_torch.runtime.t255bench [--n 32] [--steps 2]
        [--chunks 8] [--les_schedule serial|batched|auto] [--report]
        [--fit N [N ...]]
        [--trunc 255 --nlev 19 --nx 128 --ny 128 --nz 160] [--device cpu]
"""

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

from .. import card_line, clock, default_device
from ..coupling import convert
from ..coupling.coupler import CoupledStepFn
from ..models.gcm import model as gcm_model
from ..models.les import diag as ldiag, grid as lgrid, state as lstate
from ..models.les import step as lstep

REPORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "verify", "T255_H100.md")
# the report's section on four cards (chip_smoke.py --cards 4, phase (g)),
# which --report keeps
CARDS_SECTION = "\n## On four cards"


def columns(core, n):
    """scripts/bench_t255.py:90-96: 16 longitudes on each of the rows of
    |lat| < 15 deg taken at a stride of len(rows) // 16; the first n."""
    lats = np.asarray(core.sht.latitudes_deg())
    rows = np.where(np.abs(lats) < 15.0)[0]
    cols = []
    for r in rows[:: max(1, len(rows) // 16)]:
        for k in range(16):
            cols.append(int(r * core.nlon + (k * core.nlon) // 16))
    cols = cols[:n]
    if len(cols) != n:
        raise ValueError("%d columns at |lat| < 15 deg, asked for %d"
                         % (len(cols), n))
    return cols


def seed_les(core, gs, grid, cols):
    """LES fleet started from the GCM column state (bench.py:49-61), its
    noise from a generator of seed 42 on the core's device."""
    dev = core.device
    prof0 = core.column_profiles(gs, torch.as_tensor(cols, device=dev))
    conv0 = convert.convert_profiles(prof0, grid.zf(dev))
    gen = torch.Generator(device=dev).manual_seed(42)
    return lstate.init_state(grid, conv0.u, conv0.v, conv0.thl, conv0.qt,
                             conv0.ps, gen)


def run(args, device):
    """The bench at args on device. Returns (the JSON row, extras): extras
    holds the final slab profiles, the warm step's wall, the memory after
    the GCM's set-up (``base_gib``) and the fleet's columns."""
    n_les = args.n
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gcfg = gcm_model.GCMConfig(trunc=args.trunc, nlev=args.nlev, dt=900.0,
                               hybrid=True, advection="sl")
    core = gcm_model.GCMCore(gcfg, device=device)
    grid = lgrid.LESGrid(nx=args.nx, ny=args.ny, nz=args.nz, dx=100.0,
                         dy=100.0, dz=25.0)
    print("device:", device, " T%d grid:" % args.trunc, core.nlat, "x",
          core.nlon, " n_les:", n_les, " schedule:", args.les_schedule,
          flush=True)
    gcm_state = core.initial_state(seed=0)
    base_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
    cols = columns(core, n_les)
    les_state = seed_les(core, gcm_state, grid, cols)
    step_fn = CoupledStepFn(core, grid, lstep.LESPhysics(), cols,
                            dt_les=15.0, n_substeps=0,
                            evolve_chunks=args.chunks,
                            serial_evolve=args.les_schedule)
    prof = ldiag.slab_profiles(grid, les_state)
    rain = torch.zeros(n_les, device=device)

    t0 = clock(device)
    gcm_state, les_state, prof, rain, d = step_fn(
        gcm_state, les_state, prof, rain, 0, first=True)
    warm_s = clock(device) - t0
    print("warm step %.1f s (the kernels' build included)" % warm_s,
          flush=True)

    total_sub = 0
    t0 = clock(device)
    for s in range(1, args.steps + 1):
        gcm_state, les_state, prof, rain, d = step_fn(
            gcm_state, les_state, prof, rain, s, first=False)
        total_sub += int(np.sum(step_fn.unpack_diag(d)["n_substeps"]))
    el = clock(device) - t0
    if not bool(torch.isfinite(prof["THL"]).all()):
        raise FloatingPointError("non-finite THL profiles")
    ups = grid.nx * grid.ny * grid.nz * total_sub / el
    row = {
        "bench": "t255_config4", "backend": device.type,
        "n_les": n_les, "les_grid": [grid.nx, grid.ny, grid.nz],
        "step_s": el / args.steps, "substeps": total_sub,
        "les_updates_per_s": ups, "les_schedule": args.les_schedule,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if device.type == "cuda" else None),
    }
    print(json.dumps(row), flush=True)
    return row, dict(prof=prof, warm_s=warm_s, base_gib=base_gib, cols=cols)


def fits(args, device, sizes):
    """Each fleet size of sizes at batched pacing, a warm and a timed step:
    [(n, peak GiB, or None on the CPU; or "out of memory")]. Memory the
    attempts and the run before them held is freed before each."""
    res = []
    for n in sizes:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            row, _ = run(argparse.Namespace(**dict(
                vars(args), n=n, steps=1, les_schedule="batched")), device)
            res.append((n, row["peak_gib"]))
        except torch.OutOfMemoryError:
            res.append((n, "out of memory"))
            print("n = %d: out of memory" % n, flush=True)
    return res


def fit_text(tried):
    """The report's sentence on the fleet sizes tried with --fit."""
    if not tried:
        return "not tried (--fit)"
    ok = [n for n, p in tried if p != "out of memory"]
    bad = [n for n, p in tried if p == "out of memory"]
    each = "; ".join(
        "n = %d %s" % (n, "ran out of memory" if p == "out of memory"
                       else "fits" if p is None
                       else "fits (peak %.2f GiB)" % p)
        for n, p in tried)
    return "%s: the largest that fit is %s, %s" % (
        each, "n = %d" % max(ok) if ok else "none",
        "the smallest that did not n = %d" % min(bad) if bad
        else "none ran out of memory")


def write_report(path, args, row, extras, device, tried=()):
    total_gib = (torch.cuda.get_device_properties(device).total_memory
                 / 2 ** 30 if device.type == "cuda" else None)
    peak = ("not measured (no card)" if row["peak_gib"] is None
            else "%.2f GiB of %.2f GiB (the GCM's set-up %.2f GiB)"
            % (row["peak_gib"], total_gib, extras["base_gib"]))
    lines = [
        "# BASELINE config 4 on the H100: T255 + 128 x 128 x 160 LES",
        "",
        "Card: %s." % (card_line(device) if device.type == "cuda"
                       else device.type),
        "",
        "T%d/L%d (hybrid, semi-Lagrangian, dt 900 s) coupled to %d "
        "instances of %dx%dx%d (100 m x 100 m x 25 m, TKE), dt_les 15 s, "
        "evolve_chunks %d, %s pacing: **%.2f s a coupled step** over %d "
        "steps after a warm step of %.1f s (%d adaptive substeps in all, "
        "%.4g LES gridpoint-updates/s)."
        % (args.trunc, args.nlev, row["n_les"], *row["les_grid"],
           args.chunks, args.les_schedule, row["step_s"], args.steps,
           extras["warm_s"], row["substeps"], row["les_updates_per_s"]),
        "",
        "Peak device memory: %s." % peak,
        "",
        "Fleets of %dx%dx%d tried at batched pacing, a warm and a timed "
        "step each (--fit): %s." % (*row["les_grid"], fit_text(tried)),
        "",
        "```",
        json.dumps(row),
        "```",
    ]
    kept = ""
    if os.path.exists(path):
        with open(path) as f:
            old = f.read()
        if CARDS_SECTION in old:
            kept = old[old.index(CARDS_SECTION):]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + kept)
    print("wrote", path, flush=True)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32, help="LES instances")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--les_schedule", default="serial",
                    choices=["serial", "batched", "auto"])
    ap.add_argument("--trunc", type=int, default=255)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--report", nargs="?", const=REPORT, default=None,
                    help="write the report (default path: "
                         "sp_coupler_tpu_torch/verify/T255_H100.md)")
    ap.add_argument("--fit", type=int, nargs="+", default=[],
                    help="fleet sizes to try batched after the run")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = default_device(args.device)
    row, extras = run(args, device)
    del extras["prof"]
    tried = fits(args, device, args.fit)
    if args.report:
        write_report(args.report, args, row, extras, device, tried)
    return row


if __name__ == "__main__":
    main()
    sys.exit(0)
