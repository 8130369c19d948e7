"""Columns-axis scaling: the coupled step at O(1000) SP columns.

Port of ``scripts/bench_columns.py``. The reference's design point is
"one LES per selected GCM column, up to thousands". This harness runs
the whole driver (the fused coupled step, the diag pack, the spifs.nc
writer, timing.txt) over a growing fleet (default 64 -> 256 -> 1024
columns) and records per-step wall clock, host I/O time, diag-bundle
size, spifs.nc size, RSS and, on the card, the peak of device memory.
The flags, defaults and row keys are the script's; --device (the card
unless asked for the CPU) and --les_schedule are added. On the card
every host clock read follows a device synchronise; without a card and
without --device cpu it raises.

    python -m sp_coupler_tpu_torch.runtime.columnbench [--sizes 64,256]
        [--nx 64 --ny 64 --nz 160] [--les_schedule batched] [--steps 3]
        [--trunc 63] [--device cpu] [--workdir DIR] [--out OUT.md]
"""

import argparse
import json
import logging
import os
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from .. import default_device
from ..config import SPConfig
from ..models.gcm import spharm
from ..utils import geometry
from .driver import SPRunner


def pick_points(trunc, n):
    """n distinct GCM columns spread over the globe (|lat| < 60)."""
    sht = spharm.SpectralTransform(trunc, device="cpu")
    lats = np.asarray(sht.latitudes_deg())
    lons = np.asarray(sht.longitudes_deg())
    rows = np.where(np.abs(lats) < 60.0)[0]
    # row-major strided selection: n distinct (row, col) pairs
    npairs = len(rows) * len(lons)
    if n > npairs:
        raise SystemExit("n=%d exceeds %d available columns" % (n, npairs))
    idx = (np.arange(n, dtype=np.int64) * npairs) // n
    pts = []
    for i in idx:
        r = rows[i // len(lons)]
        c = int(i % len(lons))
        pts.append((float(lons[c]), float(lats[r])))
    return pts


def _clock(device):
    """The host clock after the card's queue has drained."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def host_io(path):
    """The host-I/O column (the last) of timing.txt's step rows."""
    io_s = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            # data rows start with the fractional unix start time (the
            # sp-column index line after the header has bare integers)
            if (not ln.startswith("#") and len(parts) >= 7
                    and "." in parts[0]):
                io_s.append(float(parts[-1]))
    return io_s


def run_size(args, n, device):
    odir = os.path.join(args.workdir, "cols_%04d" % n)
    cfg = SPConfig(
        output_dir=odir, gcm_type="sptpu", les_type="sptpu",
        gcm_truncation=args.trunc, gcm_levels=args.nlev,
        gcm_dt=args.gcm_dt,
        les_itot=args.nx, les_jtot=args.ny, les_ktot=args.nz,
        les_xsize=args.dx * args.nx, les_ysize=args.dx * args.ny,
        les_dz=args.dz, les_dt=args.les_dt,
        les_nsubsteps=args.nsubsteps,
        les_evolve_chunks=args.evolve_chunks,
        les_schedule=args.les_schedule,
        mesh_les=args.mesh_les, timing_phases=0,
        gcm_steps=args.steps)
    pts = [geometry.Point(p) for p in pick_points(args.trunc, n)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = _clock(device)
    r = SPRunner(cfg, pts, device=device)
    r.initialize()
    n_cols = len(r.sp_cols)
    t1 = _clock(device)
    r.run(1)                      # includes the kernels' build
    t2 = _clock(device)
    r.run(args.steps - 1)
    t3 = _clock(device)
    r.finalize(save_restart=False)
    t_init, t_first, t_rest = t1 - t0, t2 - t1, t3 - t2
    step_s = t_rest / max(args.steps - 1, 1)
    diag_bytes = 0
    if r.coupled is not None and r.coupled._diag_spec is not None:
        _, shapes, _ = r.coupled._diag_spec
        diag_bytes = int(sum(int(np.prod(s)) if s else 1
                             for s in shapes)) * 4
    io_s = host_io(os.path.join(odir, "timing.txt"))
    spifs_mb = os.path.getsize(os.path.join(odir, "spifs.nc")) / 1e6
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    updates = n_cols * args.nx * args.ny * args.nz
    row = {
        "n_cols": n_cols, "init_s": round(t_init, 1),
        "first_step_s": round(t_first, 1), "step_s": round(step_s, 2),
        "io_s_mean": round(float(np.mean(io_s)), 3) if io_s else None,
        "diag_pack_mb": round(diag_bytes / 1e6, 2),
        "spifs_mb": round(spifs_mb, 1), "rss_gb": round(rss_gb, 2),
        "gridpoints": updates,
        "peak_gib": (round(torch.cuda.max_memory_allocated(device) / 2 ** 30,
                           2) if device.type == "cuda" else None),
    }
    print(json.dumps(row), flush=True)
    return row


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="64,256,1024")
    ap.add_argument("--trunc", type=int, default=63)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--gcm_dt", type=float, default=900.0)
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--nz", type=int, default=32)
    ap.add_argument("--dx", type=float, default=200.0)
    ap.add_argument("--dz", type=float, default=100.0)
    ap.add_argument("--les_dt", type=float, default=-1.0)
    ap.add_argument("--nsubsteps", type=int, default=0)
    ap.add_argument("--evolve_chunks", type=int, default=1)
    ap.add_argument("--mesh_les", type=int, default=1)
    ap.add_argument("--les_schedule", default="auto",
                    choices=["auto", "serial", "batched"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "bench_columns"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = default_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print("device:", name, flush=True)
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        rows.append(run_size(args, n, device))

    if args.out:
        with open(args.out, "w") as f:
            f.write("# Columns-axis scaling (%s)\n\n" % name)
            f.write("T%d/L%d GCM, %dx%dx%d LES per column (%s), %d coupled "
                    "steps per size; full driver (fused step + diag "
                    "pack + spifs writer).\n\n" % (
                        args.trunc, args.nlev, args.nx, args.ny, args.nz,
                        args.les_schedule, args.steps))
            f.write("| columns | step (s) | host IO (s) | diag pack (MB)"
                    " | spifs.nc (MB) | RSS (GB) | peak (GiB) |\n"
                    "|---|---|---|---|---|---|---|\n")
            for r in rows:
                f.write("| %d | %.2f | %.3f | %.2f | %.1f | %.2f | %s |\n" % (
                    r["n_cols"], r["step_s"], r["io_s_mean"] or 0.0,
                    r["diag_pack_mb"], r["spifs_mb"], r["rss_gb"],
                    "n/a" if r["peak_gib"] is None else
                    "%.2f" % r["peak_gib"]))
        print("wrote", args.out)
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING)
    main()
    sys.exit(0)
