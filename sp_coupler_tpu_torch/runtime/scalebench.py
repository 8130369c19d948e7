"""Scaling-efficiency harness over torch.distributed ranks.

Port of ``sp_coupler_tpu/runtime/scalebench.py``. Runs the same per-rank
LES workload (instances of a fixed grid, a fixed number of fixed-dt
substeps) on growing groups of ranks, the first m ranks of the world for
size m, and reports

    efficiency(m) = (updates/s on m ranks / m) / (updates/s on 1 rank)

(mode "weak", the default on the card). Each rank evolves its block
through ``coupling.coupler.evolve_fleet``, the local evolve of the
coupled step under a les mesh, so the measured program is the production
one. A size's time runs from a barrier of its group to the next, after a
device synchronise on every rank.

Mode "fixed" (the default on the CPU) holds the total work fixed (per_dev
x max(sizes) instances split over m ranks) and compares each size with
its own ideal: the slowest rank's evolve timed alone, without the
group's barriers, on the same ranks. Ranks that share a host's cores or a
card contend for them, so on one card or one CPU the numbers are
structural: they bound the synchronisation overhead, not the scaling of
separate cards.

Run under torchrun (one rank a slot):
    torchrun --nproc_per_node 2 -m sp_coupler_tpu_torch.runtime.scalebench
        --sizes 1,2 [--nx 32] [--nz 64] [--per-dev 2] [--substeps 12]
        [--reps 3] [--mode weak|fixed] [--device cpu] [--out FILE.json]
"""

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device, generator
from ..coupling.coupler import evolve_fleet
from ..models.les import grid as lgrid, state as lstate, step as lstep
from ..models.les.state import LESForcing
from ..parallel import mesh as pmesh, sharding as shd


def _fleet(grid, positions, device):
    """The scaling case's instances at the given fleet positions, each
    drawn from its own generator (7, position), and their forcing."""
    zf = grid.zf("cpu").numpy()
    prof = lambda a: torch.as_tensor(np.asarray(a, np.float32))[None]
    thl = prof(297.9 + np.maximum(zf - 740.0, 0) * 19.1 / 3260.0)
    qt = prof(16e-3 * np.exp(-zf / 2500.0))
    u0 = prof(-9.9 + 2e-3 * zf)
    v0 = prof(np.full(grid.nz, -3.8))
    ps = torch.full((1,), 1.0e5)
    parts = [lstate.init_state(grid, u0, v0, thl, qt, ps, generator(7, i))
             for i in positions]
    state = lstate.LESState(*[torch.cat(f).to(device) for f in zip(*parts)])
    f0 = LESForcing.zeros(len(positions), grid.nz, device=device)
    full = lambda v: torch.full((len(positions),), v, device=device)
    return state, f0._replace(wthl=full(0.01), wqt=full(5e-5),
                              z0m=full(0.1), z0h=full(0.02))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(sizes=None, per_dev=2, nx=32, ny=32, nz=64, substeps=12,
            reps=3, verbose=True, mode=None, device=None):
    """Scaling sweep over the first m ranks for m in sizes; returns
    {"sizes", "updates_per_s", "efficiency", ...} (the JAX package's
    keys), the same dict on every rank. A collective: every rank of the
    world calls it. Without a process group the world is this process."""
    device = default_device(device)
    world, rank = pmesh.world_size(), pmesh.rank()
    sizes = sizes or [s for s in (1, 2, 4, 8, 16, 32, 64, 128) if s <= world]
    if max(sizes) > world:
        raise ValueError("sizes %s on %d ranks" % (sizes, world))
    if mode is None:
        mode = "weak" if device.type == "cuda" else "fixed"
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz, dx=200.0, dy=200.0, dz=25.0)
    phys = lstep.LESPhysics(use_kernel=device.type == "cuda")
    serial = lstep.serial_fleet_default(grid)
    dt = 2.0
    pts = nx * ny * nz * substeps

    ups, ups_ideal = {}, {}
    for m in sizes:
        # new_group is a collective of the whole world, members or not
        group = dist.new_group(list(range(m))) if world > 1 else None
        if rank >= m:
            continue
        mesh = pmesh.LesMesh(m, rank, group)
        n_les = per_dev * (max(sizes) if mode == "fixed" else m)
        state, forcing = _fleet(grid, mesh.positions(n_les), device)

        def evolve(s):
            return evolve_fleet(grid, phys, s, forcing, dt * substeps, serial,
                                n_substeps=substeps)[0]

        def barrier():
            if group is not None:
                pmesh.barrier(group)

        out = evolve(state)              # builds the kernels, warms up
        _sync(device)
        el_min, local_min = None, None
        for _ in range(reps):
            barrier()
            t0 = time.time()
            out = evolve(out)
            _sync(device)
            local = time.time() - t0
            barrier()
            el = time.time() - t0
            el_min = el if el_min is None else min(el_min, el)
            local_min = local if local_min is None else min(local_min, local)
        # the ideal of a size: its slowest rank's own evolve
        t_local = torch.tensor([local_min], dtype=torch.float64,
                               device=device)
        slowest = (float(shd.all_rows(t_local, mesh).max())
                   if group is not None else local_min)
        ups[m] = n_les * pts / el_min
        ups_ideal[m] = n_les * pts / slowest
        if verbose and rank == 0:
            print("les ranks=%3d: %d instances, %.3e updates/s (%.3e a rank)"
                  "  (ideal %.3e)" % (m, n_les, ups[m], ups[m] / m,
                                      ups_ideal[m]), flush=True)

    result = None
    if rank == 0:
        if mode == "weak":
            base = ups[sizes[0]] / sizes[0]
            eff = {m: (ups[m] / m) / base for m in sizes}
        else:
            eff = {m: ups[m] / ups_ideal[m] for m in sizes}
        result = {
            "bench": "scaling_efficiency",
            "mode": mode,
            "backend": device.type,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "ranks": world,
            "grid": [nx, ny, nz], "per_device_instances": per_dev,
            "substeps": substeps,
            "sizes": sizes,
            "updates_per_s": {str(m): round(ups[m], 1) for m in sizes},
            "efficiency": {str(m): round(eff[m], 4) for m in sizes},
        }
    if world > 1:
        box = [result]
        dist.broadcast_object_list(box, src=0)
        result = box[0]
    if verbose and rank == 0:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--per-dev", type=int, default=2)
    ap.add_argument("--substeps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=["weak", "fixed"], default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",") if s] or None
    device = default_device(args.device)
    try:
        pmesh.init_distributed(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        r = measure(sizes=sizes, per_dev=args.per_dev, nx=args.nx,
                    ny=args.nx, nz=args.nz, substeps=args.substeps,
                    reps=args.reps, mode=args.mode, device=device)
        if args.out and pmesh.rank() == 0:
            with open(args.out, "w") as f:
                json.dump(r, f, indent=1)
            print("wrote", args.out)
    finally:
        pmesh.shutdown()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
