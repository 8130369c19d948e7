"""Straggler decoupling: serial against batched pacing of an LES fleet.

Port of ``scripts/bench_schedule.py``. Builds a heterogeneous fleet of
N_LES instances of 64x64x160 with different wind speeds (3 to 24 m/s, v
-3 m/s, thl 298 K + 6 K/km, qt 16 g/kg decaying over 2.5 km, ps 1015
hPa), so CFL gives them different substep counts, and times
``step.evolve_adaptive`` over SPAN seconds under both schedules through
``step.map_fleet``: batched (the whole fleet in one loop; an instance
that has reached the end drops out of the batch) and serial (one
instance at a time, each its own loop). Each schedule runs once to warm
up, then --reps times from the start with thl + 1e-4 (r + 1), each
ending in a device synchronise. Instance i's start draws its noise from the CPU
generator keyed (0, i), as ``LESFleet`` does, so the card and the CPU
start from the same fleet. Surface fluxes 0.01 K m/s and 1e-5 m/s, no
other forcing.

Runs on the card unless --device cpu is given, and raises where there is
no card. The size flags exist for runs at a small size.

    python -m sp_coupler_tpu_torch.runtime.schedulebench [--reps 3]
        [--nx 64 --ny 64 --nz 160] [--device cpu]
"""

import argparse
import sys

import torch

from .. import clock, default_device, device_name, generator
from ..models.les import grid as lgrid, state as lstate, step as lstep
from ..models.les.state import LESForcing

N_LES = 4
SPAN = 60.0


def fleet(grid, device, winds=None):
    """(state, forcing) of the script's fleet on device, one instance a
    wind speed of winds (m/s; default the script's heterogeneous fleet)."""
    zf = grid.zf("cpu")
    nz = grid.nz
    # wind 3 .. 24 m/s across the fleet: ~4x substep-count spread
    winds = torch.linspace(3.0, 24.0, N_LES) if winds is None else winds
    n = len(winds)
    prof = lambda p: p[None]
    parts = [lstate.init_state(
        grid, prof(torch.full((nz,), float(winds[i]))),
        prof(torch.full((nz,), -3.0)), prof(298.0 + 6e-3 * zf),
        prof(16e-3 * torch.exp(-zf / 2500.0)), torch.tensor([101500.0]),
        generator(0, i)) for i in range(n)]
    state = lstate.LESState(*[torch.cat(f, dim=0).to(device)
                              for f in zip(*parts)])
    return state, surface_forcing(n, nz, device)


def surface_forcing(n, nz, device):
    """The benches' forcing of n instances: surface fluxes 0.01 K m/s and
    1e-5 m/s, roughness lengths 0.1 and 0.02 m, nothing else (root
    bench.py's phase breakdown, bench_schedule.py, bench_batch.py)."""
    zs = torch.zeros(n, device=device)
    return LESForcing.zeros(n, nz, device)._replace(
        wthl=zs + 0.01, wqt=zs + 1e-5, z0m=zs + 0.1, z0h=zs + 0.02)


def run(grid, state, forcing, phys=None, reps=3, span=SPAN):
    """Both schedules on the fleet (state, forcing). Returns {"batched":
    ..., "serial": ...}, each dict(s=seconds a rep, substeps=[per
    instance], state=the last rep's output, start=its input), and
    "speedup" (batched seconds over serial)."""
    phys = lstep.LESPhysics() if phys is None else phys
    device = state.u.device
    one = lambda s, f: lstep.evolve_adaptive(grid, phys, s, f,
                                             s.time + span, dt_max=15.0)
    sts = [state._replace(thl=state.thl + 1e-4 * (r + 1))
           for r in range(reps)]
    results = {}
    for serial in (False, True):
        lstep.map_fleet(one, state, forcing, serial)
        t0 = clock(device)
        for r in range(reps):
            out = lstep.map_fleet(one, sts[r], forcing, serial)
            clock(device)
        el = (clock(device) - t0) / reps
        nsub = out[1].cpu().numpy()
        name = "serial" if serial else "batched"
        results[name] = dict(s=el, substeps=[int(x) for x in nsub],
                             state=out[0], start=sts[-1])
        print("%-8s %8.3f s  substeps per instance %s (sum %d, max %d)"
              % (name, el, nsub, nsub.sum(), nsub.max()), flush=True)
    results["speedup"] = results["batched"]["s"] / results["serial"]["s"]
    print("serial speedup on heterogeneous fleet: %.2fx"
          % results["speedup"], flush=True)
    return results


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = default_device(args.device)
    grid = lgrid.LESGrid(nx=args.nx, ny=args.ny, nz=args.nz)
    print("backend:", device_name(device), " n_les:", N_LES, flush=True)
    state, forcing = fleet(grid, device)
    res = run(grid, state, forcing, reps=args.reps)
    return {k: (v if k == "speedup" else dict(s=v["s"],
                                              substeps=v["substeps"]))
            for k, v in res.items()}


if __name__ == "__main__":
    main()
    sys.exit(0)
