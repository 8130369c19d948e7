"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

Launched as ``python tests/torch_mp_worker.py MODE ARGS...``, once a rank,
with SPTPU_DIST_COORD (a file:// store), SPTPU_DIST_NPROCS and
SPTPU_DIST_PROC_ID set (or none of them: one process). Imports torch and
the port, never JAX. One thread a process, so that every run reduces in
the same order.

Modes:
  evolve IN.npz OUT.npz   the les-axis evolve of IN's fleet (each rank its
                          block, serial, 20 s at dt_max 5 s); rank 0
                          writes the gathered fleet to OUT
  cli REPORT ARGV...      spmaster.build_runner(ARGV) + drive; each rank
                          writes REPORT.<rank>.json (what it held and
                          wrote)
  misc ODIR REPORT        scalebench.measure(sizes=[1, 2]) and a driver run
                          of 3 instances with --mesh_les 2 (unsharded);
                          each rank writes REPORT.<rank>.json
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from sp_coupler_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def evolve(inp, out):
    from sp_coupler_tpu_torch.coupling.coupler import evolve_fleet
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.models.les.state import LESState, LESForcing
    from sp_coupler_tpu_torch.parallel import sharding
    pmesh.init_distributed("cpu")
    data = np.load(inp)
    grid = lgrid.LESGrid(*[int(x) for x in data["grid_n"]],
                         *[float(x) for x in data["grid_d"]])
    state = LESState(*[torch.as_tensor(data["s_" + k])
                       for k in LESState._fields])
    forcing = LESForcing(*[torch.as_tensor(data["f_" + k])
                           for k in LESForcing._fields])
    mesh = pmesh.make_mesh()
    n = state.u.shape[0]
    local = pmesh.shard_fleet(state, mesh)
    local_f = sharding.local_rows(forcing, mesh, n)
    got, nsub, _ = evolve_fleet(grid, lstep.LESPhysics(), local, local_f,
                                20.0, True, dt_max=5.0)
    whole = sharding.gather_rows(dict(state=got, nsub=nsub), mesh, n)
    if pmesh.rank() == 0:
        np.savez(out, nsub=whole["nsub"].numpy(),
                 **{k: v.numpy() for k, v in zip(LESState._fields,
                                                  whole["state"])})
    pmesh.shutdown()


def cli(report, argv):
    from sp_coupler_tpu_torch import spmaster
    runner = spmaster.build_runner(argv)
    try:
        rc = spmaster.drive(runner)
        if hasattr(runner.gcm, "state"):
            pmesh.replicate(runner.gcm.state, pmesh.make_mesh())
        fleet = runner.fleet
        rep = dict(
            rc=rc, rank=pmesh.rank(), world=pmesh.world_size(),
            io_proc=runner.io_proc, mesh=runner.mesh is not None,
            writer=type(runner.writer).__name__,
            timing_header=runner._timing_header_done,
            positions=fleet.positions, sp_cols=runner.sp_cols,
            held=int(fleet.state.u.shape[0]),
            cross=sorted(runner.crossio.writers) if runner.crossio else [],
            substeps=runner.substeps, gcm_replicated=True)
    finally:
        pmesh.shutdown()
    with open("%s.%d.json" % (report, rep["rank"]), "w") as f:
        json.dump(rep, f)
    return rc


def misc(odir, report):
    import logging
    from sp_coupler_tpu_torch.config import SPConfig
    from sp_coupler_tpu_torch.runtime import scalebench
    from sp_coupler_tpu_torch.runtime.driver import SPRunner
    from sp_coupler_tpu_torch.utils import geometry
    pmesh.init_distributed("cpu")
    rank = pmesh.rank()
    bench = scalebench.measure(sizes=[1, 2], per_dev=1, nx=8, ny=8, nz=12,
                               substeps=2, reps=2, verbose=False,
                               device="cpu")
    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logging.getLogger("sp_coupler_tpu_torch").addHandler(Keep())
    cfg = SPConfig(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
                   les_itot=8, les_jtot=8, les_ktot=12, les_xsize=1600.0,
                   les_ysize=1600.0, les_dz=100.0, les_dt=5.0,
                   max_num_les=3, mesh_les=2, output_dir=odir)
    r = SPRunner(cfg, [geometry.Point((300.0, 15.0))], device="cpu")
    r.initialize()
    r.run(1)
    r.finalize()
    world = pmesh.make_mesh()
    pmesh.replicate(r.gcm.state, world)
    try:
        pmesh.replicate({"x": torch.tensor([float(rank)])}, world)
        differs = "not detected"
    except RuntimeError as e:
        differs = str(e)
    rep = dict(rank=rank, bench=bench, warnings=warnings,
               replicate_gcm="ok", replicate_rank=differs,
               mesh=r.mesh is not None, held=int(r.fleet.state.u.shape[0]),
               n=r.fleet.n, substeps=r.substeps)
    pmesh.shutdown()
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)


def main():
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "evolve":
        return evolve(*args)
    if mode == "cli":
        return cli(args[0], args[1:])
    if mode == "misc":
        return misc(*args)
    raise SystemExit("unknown mode %s" % mode)


if __name__ == "__main__":
    sys.exit(main() or 0)
