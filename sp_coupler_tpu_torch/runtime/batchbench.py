"""LES fleet throughput against batch size on one card.

Port of ``scripts/bench_batch.py``. BASELINE.md targets T159 regional SP
with ~64 batched LES columns a card; this measures gridpoint-updates/s
of the 64x64x160 case at n_les = 2 .. 64: N_SUB fixed-dt substeps of 3 s
of the whole fleet in one batch through the stage kernel. The fleet: u 5
m/s, v -3 m/s, thl 298 K + 6 K/km, qt 16 g/kg decaying over 2.5 km, ps
1015 hPa, instance i's noise from the CPU generator keyed (0, i) (as
``LESFleet`` draws it); surface fluxes 0.01 K m/s and 1e-5 m/s
(``schedulebench.fleet`` with a wind of 5 m/s throughout). The
pressure solver is built once a fleet, outside the timed window (it runs
once a coupled step of ~560 substeps). One warm call, then 2 timed ones,
each ending in a device synchronise; the script's line for each n, with
"compile" the warm call's time.

Runs on the card unless --device cpu is given, and raises where there is
no card. The size flags exist for runs at a small size.

    python -m sp_coupler_tpu_torch.runtime.batchbench [--sizes 2 8 16 32 64]
        [--nsub 20] [--nx 64 --ny 64 --nz 160] [--device cpu]
"""

import argparse
import sys

import torch

from .. import clock, default_device, device_name
from ..models.les import grid as lgrid, poisson, step as lstep
from . import schedulebench

SIZES = (2, 8, 16, 32, 64)
N_SUB = 20
REPS = 2


def go(grid, phys, state, forcing, solver, n_sub=N_SUB,
       skip_projection=False):
    """n_sub substeps of 3 s of the whole fleet (skip_projection: without
    the pressure projection, for the bench's phase breakdown only)."""
    dt = torch.full_like(state.ps, 3.0)
    for _ in range(n_sub):
        state = lstep.substep(grid, phys, state, forcing, dt, solver=solver,
                              skip_projection=skip_projection)[0]
    return state


def measure(grid, state, forcing, phys=None, n_sub=N_SUB, reps=REPS):
    """The fleet's row: dict(n_les, ms_per_substep, updates_per_s,
    compile_s), and the last timed call's output state."""
    phys = lstep.LESPhysics() if phys is None else phys
    device = state.u.device
    n = state.u.shape[0]
    solver = poisson.build_solver(grid, state.rhobf, state.rhobh)
    t0 = clock(device)
    go(grid, phys, state, forcing, solver, n_sub)
    compile_s = clock(device) - t0
    t0 = clock(device)
    for _ in range(reps):
        out = go(grid, phys, state, forcing, solver, n_sub)
        clock(device)
    dtw = (clock(device) - t0) / reps
    ups = n * grid.nx * grid.ny * grid.nz * n_sub / dtw
    print("n_les=%3d  %8.2f ms/substep-fleet  %10.3e updates/s  "
          "(compile %.0fs)" % (n, dtw / n_sub * 1e3, ups, compile_s),
          flush=True)
    return dict(n_les=n, ms_per_substep=dtw / n_sub * 1e3,
                updates_per_s=ups, compile_s=compile_s), out


def run(grid, device, sizes=SIZES, n_sub=N_SUB, reps=REPS):
    """Each fleet size of sizes in turn: the rows, and the last fleet's
    output state."""
    rows = []
    for n in sizes:
        state, forcing = schedulebench.fleet(grid, device,
                                             torch.full((n,), 5.0))
        row, out = measure(grid, state, forcing, n_sub=n_sub, reps=reps)
        rows.append(row)
    return rows, out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES))
    ap.add_argument("--nsub", type=int, default=N_SUB)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = default_device(args.device)
    print("backend:", device_name(device), flush=True)
    grid = lgrid.LESGrid(nx=args.nx, ny=args.ny, nz=args.nz)
    return run(grid, device, args.sizes, args.nsub)[0]


if __name__ == "__main__":
    main()
    sys.exit(0)
