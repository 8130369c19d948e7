"""BASELINE's north-star case: the T159 regional SP with 64 LES columns.

Port of ``scripts/bench_t159.py``: T159/L19 coupled to 64 LES instances
of 64x64x160 (RICO, TKE) on one card, full coupled steps; reports the
step wall and the LES gridpoint-updates/s. The case is the script's
(``:17-54``): the GCM started from seed 0, 64 columns in a tropical band
(``columns``), the LES started from the GCM's columns with seed 42
(``t255bench.seed_les``), dt_les 15 s, evolve_chunks 8, the fleet paced
by the schedule argument. The GCM runs semi-Lagrangian, as the driver's
``gcm_advection="auto"`` picks from T63 (the script's ``GCMConfig``
leaves ``advection`` at its Eulerian default). Two warm steps (first=True,
then first=False), then --steps timed ones; the script's lines and its
JSON keys (``backend`` is the torch device's type).

The schedule (default ``auto``, as in the script) is the fleet's pacing:
``serial`` one instance at a time, ``batched`` the whole fleet together
(instances that have reached the step's end drop out of the batch),
``auto`` the rule ``models/les/step.py::serial_fleet_default``, which
picks serial pacing at 64x64x160.

Every clock is read after a device synchronise. Runs on the card unless
--device cpu is given, and raises where there is no card. The size flags
exist for runs at a small size.

    python -m sp_coupler_tpu_torch.runtime.t159bench [auto|serial|batched]
        [--n 64] [--steps 2]
        [--trunc 159 --nlev 19 --nx 64 --ny 64 --nz 160] [--device cpu]
"""

import argparse
import json
import sys

import numpy as np
import torch

from .. import clock, default_device
from ..coupling.coupler import CoupledStepFn
from ..models.gcm import model as gcm_model
from ..models.les import diag as ldiag, grid as lgrid, step as lstep
from .t255bench import seed_les

N_LES = 64
WARM_STEPS = 2


def columns(core, n=N_LES):
    """scripts/bench_t159.py:31-39: 8 longitudes on each of the rows of
    |lat| < 15 deg taken at a stride of len(rows) // 8; the first n."""
    lats = np.asarray(core.sht.latitudes_deg())
    rows = np.where(np.abs(lats) < 15.0)[0]
    cols = []
    for r in rows[:: max(1, len(rows) // 8)]:
        for k in range(8):
            cols.append(int(r * core.nlon + (k * core.nlon) // 8))
    cols = cols[:n]
    if len(cols) != n:
        raise ValueError("%d columns at |lat| < 15 deg, asked for %d"
                         % (len(cols), n))
    return cols


def case(device, schedule="auto", n=N_LES, trunc=159, nlev=19, nx=64,
         ny=64, nz=160):
    """The step function and its start (gcm state, LES fleet, profiles,
    rain) on device."""
    core = gcm_model.GCMCore(gcm_model.GCMConfig(
        trunc=trunc, nlev=nlev, dt=900.0, advection="sl"), device=device)
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    cols = columns(core, n)
    gs = core.initial_state(seed=0)
    les = seed_les(core, gs, grid, cols)
    fn = CoupledStepFn(core, grid, lstep.LESPhysics(), cols, dt_les=15.0,
                       n_substeps=0, evolve_chunks=8,
                       serial_evolve=schedule)
    prof = ldiag.slab_profiles(grid, les)
    return fn, (gs, les, prof, torch.zeros(n, device=core.device))


def run(args, device):
    """The bench at args on device. Returns (the JSON row, extras): extras
    holds every step's record (first, wall_s, per-instance substeps), the
    first step's profiles and the final GCM state and profiles."""
    fn, (gs, les, prof, rain) = case(device, args.schedule, args.n,
                                     args.trunc, args.nlev, args.nx, args.ny,
                                     args.nz)
    core, grid = fn.core, fn.grid
    print("backend:", device.type, " T%d grid:" % args.trunc, core.nlat, "x",
          core.nlon, flush=True)
    print("schedule:", args.schedule, flush=True)
    steps = []
    first_prof = None

    def step(s):
        nonlocal gs, les, prof, rain, first_prof
        t0 = clock(device)
        gs, les, prof, rain, d = fn(gs, les, prof, rain, s, first=s == 0)
        wall = clock(device) - t0
        nsub = [int(x) for x in fn.unpack_diag(d)["n_substeps"]]
        steps.append(dict(first=s == 0, wall_s=wall, substeps=nsub))
        if s == 0:
            first_prof = {k: v.cpu().numpy() for k, v in prof.items()}
        return wall, sum(nsub)

    print("warm-up ...", flush=True)
    warm = sum(step(s)[0] for s in range(WARM_STEPS))
    print("warmup %.0fs" % warm, flush=True)
    el, total_sub = 0.0, 0
    for s in range(WARM_STEPS, WARM_STEPS + args.steps):
        wall, nsub = step(s)
        el += wall
        total_sub += nsub
    if not bool(torch.isfinite(prof["THL"]).all()):
        raise FloatingPointError("non-finite THL profiles")
    ups = grid.nx * grid.ny * grid.nz * total_sub / el
    print("T%d + %d LES: %.2f s/coupled-step, %d substeps, %.3e "
          "LES updates/s/chip" % (args.trunc, args.n, el / args.steps,
                                  total_sub, ups), flush=True)
    row = {"bench": "t159_64les", "schedule": args.schedule,
           "backend": device.type, "step_s": el / args.steps,
           "substeps": total_sub, "les_updates_per_s": ups}
    print(json.dumps(row), flush=True)
    return row, dict(steps=steps, first_prof=first_prof, prof=prof, gcm=gs,
                     cols=fn.cols.tolist())


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("schedule", nargs="?", default="auto",
                    choices=["auto", "serial", "batched"],
                    help="the fleet's pacing (default auto, which picks "
                         "serial pacing at 64x64x160)")
    ap.add_argument("--n", type=int, default=N_LES, help="LES instances")
    ap.add_argument("--steps", type=int, default=2,
                    help="timed steps after the %d warm ones" % WARM_STEPS)
    ap.add_argument("--trunc", type=int, default=159)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return run(args, default_device(args.device))[0]


if __name__ == "__main__":
    main()
    sys.exit(0)
