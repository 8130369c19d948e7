"""One rank of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_spatial.py, tests/test_torch_bands.py).

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
  spatial IN.npz OUT      on 4 ranks: the Plane's halo, reductions and
                          gathers on the meshes (les, x, y) = (1, 2, 2) and
                          (1, 4, 1), the projection on 2 x 2 blocks, IN's
                          fleet evolved on (1, 2, 2) and (2, 2, 1), IN's
                          Smagorinsky fleet (a plane outside the TPU's
                          lane rule) evolved on (2, 2, 1) with the split
                          path's kernel wrappers counted, and IN's
                          coupled case (T10 + one instance) stepped on
                          (1, 2, 2); rank 0 writes OUT.npz, each rank
                          OUT.<rank>.json
  bands IN.pt OUT         on 4 ranks, the GCM on latitude bands: IN's
                          spectral coefficients through the T21 transforms
                          on the mesh (1, 2, 2); IN's T10/L8 starts stepped
                          twice (Eulerian on (2, 2, 1), SL with each
                          interpolation method on (4, 1, 1)); Eulerian and
                          SL steps on hybrid levels beside one process's,
                          from the port's start; the column gather and
                          scatter, the whole/band state round trip and
                          the SL clamp statistics against one process's;
                          each rank writes OUT.<rank>.npz (its states, the
                          gathered grids) and OUT.<rank>.json
"""

import contextlib
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
        core = getattr(runner.gcm, "core", None)
        if core is not None:
            pmesh.replicate(core.replicated(runner.gcm.state),
                            pmesh.make_mesh())
        fleet = runner.fleet
        state = getattr(fleet, "state", None)
        rep = dict(
            rc=rc, rank=pmesh.rank(), world=pmesh.world_size(),
            io_proc=runner.io_proc, mesh=runner.mesh is not None,
            writer=type(runner.writer).__name__,
            timing_header=runner._timing_header_done,
            positions=getattr(fleet, "positions", None),
            sp_cols=runner.sp_cols,
            held=None if state is None else int(state.u.shape[0]),
            shape=None if state is None else list(state.u.shape),
            gcm_bands=(None if core is None or core.bands is None
                       else [core.bands.P, core.bands.r0, core.bands.r1]),
            gcm_rows=(None if core is None
                      else int(runner.gcm.state.grid.T.shape[-2])),
            mesh_shape=runner.mesh.shape if runner.mesh is not None else None,
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


def _plane_checks(mesh, gen_seed=5):
    """The Plane of mesh on a 16 x 16 plane against the whole plane: halo
    (h = 3, two fields of different depths in one exchange), gather, mean,
    amax, std and argmax_take."""
    from sp_coupler_tpu_torch.parallel import plane as pplane
    gen = torch.Generator().manual_seed(gen_seed)
    x = torch.randn((2, 5, 16, 16), generator=gen)
    x2 = torch.randn((2, 6, 16, 16), generator=gen)
    pl = pplane.for_mesh(mesh, 16, 16)
    b, b2 = pl.block(x), pl.block(x2)
    h, h2 = pl.halo([b, b2], 3)
    want = x.double().mean(dim=(2, 3)).float()
    key = torch.randn((2, 5, 16, 16), generator=gen)
    got_take = pl.argmax_take(pl.block(key), b, b2[:, :5])
    want_take = pplane.WHOLE.argmax_take(key, x, x2[:, :5])
    return dict(
        block=[pl.y0, pl.by, pl.x0, pl.bx],
        halo=bool(torch.equal(h, pl.block(x, 3))
                  and torch.equal(h2, pl.block(x2, 3))),
        gather=bool(torch.equal(pl.gather(b), x)),
        mean_err=float((pl.mean(b) - want).abs().max()),
        amax=bool(torch.equal(pl.amax(b), torch.amax(x, dim=(1, 2, 3)))),
        std_err=float((pl.std(b) - torch.std(x, dim=(2, 3), unbiased=False))
                      .abs().max()),
        argmax=all(bool(torch.equal(g, w))
                   for g, w in zip(got_take, want_take)))


@contextlib.contextmanager
def split_calls():
    """Counts of the split path's kernel wrappers (lesflat, lesmom) called
    inside the block."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom
    calls = dict(lesflat=0, lesmom=0)
    saved = [(lesflat, "advect_diffuse_scalars", "lesflat"),
             (lesmom, "momentum_tendencies", "lesmom")]
    saved = [(m, f, getattr(m, f), name) for m, f, name in saved]
    for mod, fn, orig, name in saved:
        def wrap(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        setattr(mod, fn, wrap)
    try:
        yield calls
    finally:
        for mod, fn, orig, _ in saved:
            setattr(mod, fn, orig)


def spatial(inp, out):
    from sp_coupler_tpu_torch.coupling.coupler import (CoupledStepFn,
                                                       evolve_fleet)
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import (grid as lgrid,
                                                 step as lstep, poisson,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.models.les.state import LESState, LESForcing
    from sp_coupler_tpu_torch.parallel import plane as pplane, sharding
    pmesh.init_distributed("cpu")
    rank = pmesh.rank()
    data = np.load(inp)
    rep = {"rank": rank}
    m22 = pmesh.make_mesh(1, 2, 2)
    rep["plane_2x2"] = _plane_checks(m22)
    rep["plane_4x1"] = _plane_checks(pmesh.make_mesh(1, 4, 1))
    res = {}

    # the projection on 2 x 2 blocks against the whole plane's
    grid = lgrid.LESGrid(*[int(x) for x in data["grid_n"]],
                         *[float(x) for x in data["grid_d"]])
    state = LESState(*[torch.as_tensor(data["s_" + k])
                       for k in LESState._fields])
    forcing = LESForcing(*[torch.as_tensor(data["f_" + k])
                           for k in LESForcing._fields])
    pl = pplane.for_mesh(m22, grid.ny, grid.nx)
    gen = torch.Generator().manual_seed(9)
    u, v, w = (torch.randn(f.shape, generator=gen)
               for f in (state.u, state.v, state.w))
    w[:, 0] = w[:, -1] = 0.0
    solver = poisson.build_solver(grid, state.rhobf, state.rhobh)
    whole = poisson.project(grid, state.rhobf, state.rhobh, u, v, w, 2.0,
                            solver=solver)
    blk = poisson.project(grid, state.rhobf, state.rhobh, pl.block(u),
                          pl.block(v), pl.block(w), 2.0, solver=solver,
                          plane=pl)
    got = [pl.gather(x) for x in blk]
    rep["project_bitwise"] = all(bool(torch.equal(a, b))
                                 for a, b in zip(got, whole))
    rep["project_err"] = max(float((a - b).abs().max())
                             for a, b in zip(got, whole))

    # the evolve of the fleet on (1, 2, 2) and (2, 2, 1)
    phys = lstep.LESPhysics()
    n = state.u.shape[0]
    for name, mesh in (("evolve_122", m22),
                       ("evolve_221", pmesh.make_mesh(2, 2, 1))):
        p = pplane.for_mesh(mesh, grid.ny, grid.nx)
        local = pmesh.shard_fleet(state, mesh, p)
        got, nsub, _ = evolve_fleet(
            grid, phys, local, sharding.local_rows(forcing, mesh, n), 20.0,
            True, dt_max=5.0, plane=p)
        whole = sharding.gather_rows(dict(state=p.gather_fields(got),
                                          nsub=nsub), mesh, n)
        for k, x in zip(LESState._fields, whole["state"]):
            res["%s_%s" % (name, k)] = x.numpy()
        res[name + "_nsub"] = whole["nsub"].numpy()

    # the Smagorinsky fleet on (2, 2, 1): the split path on 2 x 1 blocks
    mg = lgrid.LESGrid(*[int(x) for x in data["m_grid_n"]],
                       *[float(x) for x in data["m_grid_d"]])
    mst = LESState(*[torch.as_tensor(data["m_s_" + k])
                     for k in LESState._fields])
    mfrc = LESForcing(*[torch.as_tensor(data["m_f_" + k])
                        for k in LESForcing._fields])
    mesh = pmesh.make_mesh(2, 2, 1)
    p = pplane.for_mesh(mesh, mg.ny, mg.nx)
    with split_calls() as calls:
        got, nsub, _ = evolve_fleet(
            mg, lstep.LESPhysics(subgrid="smagorinsky"),
            pmesh.shard_fleet(mst, mesh, p),
            sharding.local_rows(mfrc, mesh, mst.u.shape[0]), 20.0, True,
            dt_max=5.0, plane=p)
    rep["smag_calls"] = dict(calls, nsub=[int(x) for x in nsub])
    whole = sharding.gather_rows(dict(state=p.gather_fields(got), nsub=nsub),
                                 mesh, mst.u.shape[0])
    for k, x in zip(LESState._fields, whole["state"]):
        res["smag_221_" + k] = x.numpy()
    res["smag_221_nsub"] = whole["nsub"].numpy()

    # the fused coupled step on (1, 2, 2)
    cg = lgrid.LESGrid(*[int(x) for x in data["c_grid_n"]],
                       *[float(x) for x in data["c_grid_d"]])
    cst = LESState(*[torch.as_tensor(data["c_" + k])
                     for k in LESState._fields])
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8, dt=60.0),
                             device="cpu")
    gs = core.initial_state(seed=0)
    fn = CoupledStepFn(core, cg, phys, [100], 15.0, 0, mesh=m22)
    prof0 = ldiag.slab_profiles(cg, cst)
    cp = fn.plane
    gs, les, prof, _, diag = fn(gs, cp.block_fields(cst), prof0,
                                np.zeros(1, np.float32), 0, first=True)
    pmesh.replicate(gs, m22)
    res["coupled_THL"] = prof["THL"].numpy()
    res["coupled_thl"] = cp.gather(les.thl).numpy()
    res["coupled_nsub"] = fn.unpack_diag(diag)["n_substeps"]
    if rank == 0:
        np.savez(out + ".npz", **res)
    pmesh.shutdown()
    with open("%s.%d.json" % (out, rank), "w") as f:
        json.dump(rep, f)


def bands(inp, out):
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model, spharm
    from sp_coupler_tpu_torch.parallel import bands as pbands
    from sp_coupler_tpu_torch.utils import tree
    pmesh.init_distributed("cpu")
    rank = pmesh.rank()
    data = torch.load(inp, weights_only=False)
    arrays, rep = {}, {"rank": rank}

    def keep(name, state):
        for i, leaf in enumerate(tree.flatten(state)[0]):
            arrays["%s_%d" % (name, i)] = leaf.numpy()

    # the T21 transforms on (1, 2, 2)
    sht = spharm.SpectralTransform(21, device="cpu")
    b = pbands.for_mesh(pmesh.make_mesh(1, 2, 2), sht.nlat)
    bt = spharm.SpectralTransform(21, device="cpu", bands=b)
    g = bt.synthesize(data["spec"])
    arrays["t21_grid"] = b.gather(g).numpy()
    arrays["t21_spec"] = bt.analyze(g).numpy()
    rep["t21_rows"] = [b.r0, b.r1]
    rep["t21_syn_bitwise"] = bool(torch.equal(
        g, b.cut(sht.synthesize(data["spec"]))))

    # the T10/L8 steps, each from IN's start carried in whole
    for name, mesh, adv, method in (
            ("eul", pmesh.make_mesh(2, 2, 1), "eulerian", None),
            ("sl_gather", pmesh.make_mesh(), "sl", "gather"),
            ("sl_window", pmesh.make_mesh(), "sl", "window")):
        cfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0, advection=adv)
        core = gcm_model.GCMCore(cfg, device="cpu", bands=pbands.for_mesh(
            mesh, 16))
        if method:
            core.slg.method = method
        s = core.band_state(data[adv])
        for step in range(2):
            s = core.step(s, first=step == 0)
            keep("%s_%d" % (name, step), core.replicated(s))
            arrays["%s_%d_gridT" % (name, step)] = core.whole_state(
                s).grid.T.numpy()
        rep[name + "_rows"] = int(s.grid.T.shape[-2])
        if adv == "sl":
            lam, phi = data["targets"]
            st = core.slg.clamp_stats(core.slg.arrival(lam),
                                      core.slg.arrival(phi))
            arrays[name + "_clamp"] = torch.stack([st["lon"], st["lat"]]
                                                  ).numpy()

    # hybrid levels: the bands beside one process, from the port's start
    for name, adv in (("eul_hybrid", "eulerian"), ("sl_hybrid", "sl")):
        cfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0, advection=adv,
                                  hybrid=True)
        one = gcm_model.GCMCore(cfg, device="cpu")
        core = gcm_model.GCMCore(cfg, device="cpu", bands=pbands.for_mesh(
            pmesh.make_mesh(), 16))
        w = one.initial_state(seed=0)
        s = core.band_state(w)
        for step in range(2):
            w = one.step(w, first=step == 0)
            s = core.step(s, first=step == 0)
            for k in ("vort", "div", "T", "q"):
                arrays["%s_%d_%s" % (name, step, k)] = getattr(s.now,
                                                               k).numpy()
                arrays["%s_%d_%s_one" % (name, step, k)] = getattr(
                    w.now, k).numpy()
            arrays["%s_%d_gridT" % (name, step)] = core.whole_state(
                s).grid.T.numpy()
            arrays["%s_%d_gridT_one" % (name, step)] = w.grid.T.numpy()

    # columns from the bands against one process's, from the same grid
    cfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0)
    one = gcm_model.GCMCore(cfg, device="cpu")
    core = gcm_model.GCMCore(cfg, device="cpu", bands=pbands.for_mesh(
        pmesh.make_mesh(), 16))
    whole = one.step(data["eulerian"], first=True)
    band = core.band_state(whole)
    cols = data["cols"]
    same = lambda a, b: all(bool(torch.equal(a[k], b[k])) for k in a)
    rep["profiles_bitwise"] = same(core.column_profiles(band, cols),
                                   one.column_profiles(whole, cols))
    rep["surface_bitwise"] = same(core.surface_fields(band, cols),
                                  one.surface_fields(whole, cols))
    tend = data["tend"]
    got = core.with_sp_tendencies(band, cols, tend).sp_tend
    want = core.band_state(one.with_sp_tendencies(whole, cols, tend)).sp_tend
    rep["scatter_bitwise"] = same(got, want)
    rep["roundtrip_bitwise"] = all(
        bool(torch.equal(x, y)) for x, y in zip(
            tree.flatten(core.whole_state(band))[0],
            tree.flatten(whole)[0]))
    pmesh.shutdown()
    np.savez("%s.%d.npz" % (out, rank), **arrays)
    with open("%s.%d.json" % (out, rank), "w") as f:
        json.dump(rep, f)


def main():
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "evolve":
        return evolve(*args)
    if mode == "cli":
        return cli(args[0], args[1:])
    if mode == "misc":
        return misc(*args)
    if mode == "spatial":
        return spatial(*args)
    if mode == "bands":
        return bands(*args)
    raise SystemExit("unknown mode %s" % mode)


if __name__ == "__main__":
    sys.exit(main() or 0)
