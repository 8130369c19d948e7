"""The port's instance parallelism over torch.distributed ranks, against
the JAX package on the CPU.

- The block rule: a rank's fleet positions (``parallel/mesh.py``) are
  the slice its les slot holds in the JAX package's GSPMD layout
  (``NamedSharding(mesh, P("les"))`` on conftest's virtual devices) and
  in JAX's ``local_les_positions`` for splits GSPMD cannot lay out.
- The les-axis evolve: 2 gloo ranks, each evolving its block of JAX's
  ``_tiny_fleet(4)`` (tests/test_parallel.py:24-38, 16x16x16), equal
  bit for bit the port's unsharded serial evolve, and agree with JAX's
  les-sharded evolve (``_evolve``, run as test_les_axis_sharding runs it)
  within atol 5e-4, rtol 1e-4: the bound test_parallel.py:67 puts on a
  sharded run against an unsharded one.
- The CLI (``python -m sp_coupler_tpu_torch.spmaster``) on 2 ranks
  against 1 process, on tests/mp_worker.py's case (T10/L8 + 2 x 16x16x24,
  mesh_les 2, cross sections on, 2 coupled steps; serial pacing, so every
  instance steps alone on both sides): spifs.nc, cross.nc and the
  checkpoint are bitwise equal, rank 0 alone writes spifs.nc,
  timing.txt and the checkpoint, each rank writes its own instances'
  cross.nc, the GCM state is the same on both ranks, and a checkpoint
  resumes on 1 or 2 ranks whichever wrote it.
- The refusals and warnings of the driver, the backend rule, the
  scaling harness's keys, and the interp helpers against JAX's
  (templates tests/test_utils.py:68-130, their tolerances).

Every rank is a subprocess (tests/torch_mp_worker.py, one thread each)
with a timeout; the ranks meet through a file store in tmp_path.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sp_coupler_tpu.models.les import step as jstep
from sp_coupler_tpu.parallel import mesh as jmesh
from sp_coupler_tpu.utils import interp as jinterp
from sp_coupler_tpu_torch import spmaster
from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.io import h5nc, spnc
from sp_coupler_tpu_torch.parallel import mesh as pmesh
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.utils import geometry, interp
from test_parallel import _evolve, _tiny_fleet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
TIMEOUT = 300          # seconds a run of ranks may take
# tests/mp_worker.py's case through the CLI, 2 coupled steps
CONF = dict(les_itot=16, les_jtot=16, les_ktot=24, les_xsize=3200.0,
            les_ysize=3200.0, les_dz=100.0, les_cross=True,
            les_cross_heights=[2, 10], les_cross_dtav=60.0,
            les_schedule="serial")
ARGS = ["--trunc", "10", "--levels", "8", "--gcm_dt", "600", "--les_dt",
        "5", "--numles", "2", "--points", "15", "300", "--steps", "1",
        "--device", "cpu"]
# a small LES for the settings that are a no-op in one process
NO_OP_CONF = dict(les_itot=8, les_jtot=8, les_ktot=12, les_xsize=1600.0,
                  les_ysize=1600.0, les_dz=100.0)


def run_ranks(store, nprocs, *args):
    """Run the worker with args on nprocs ranks (1: one plain process);
    every process must exit 0 within TIMEOUT."""
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for k in ("SPTPU_DIST_COORD", "SPTPU_DIST_NPROCS",
                  "SPTPU_DIST_PROC_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
            env.pop(k, None)
        if nprocs > 1:
            env.update(SPTPU_DIST_COORD="file://" + str(store),
                       SPTPU_DIST_NPROCS=str(nprocs),
                       SPTPU_DIST_PROC_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER] + [str(a) for a in args], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "rank failed:\n" + out[-4000:]
    return outs


def read_spifs(path):
    ds = h5nc.Dataset(path, "r")
    try:
        out = {"Time": np.asarray(ds.variables["Time"][:])}
        for gname, grp in ds.groups.items():
            for vname, v in grp.variables.items():
                out["%s/%s" % (gname, vname)] = np.asarray(v[...])
        return out
    finally:
        ds.close()


def assert_same_records(a, b):
    assert sorted(a) == sorted(b)
    diff = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not diff, "records differ bitwise: %s" % diff


def reports(prefix, nprocs):
    out = []
    for r in range(nprocs):
        with open("%s.%d.json" % (prefix, r)) as f:
            out.append(json.load(f))
    return out


# ---- the block rule --------------------------------------------------------

@pytest.mark.parametrize("n, L", [(2, 2), (4, 2), (6, 3), (8, 4), (8, 8),
                                  (16, 8)])
def test_block_rule_matches_gspmd(n, L):
    jm = jmesh.make_mesh(n_les=L, devices=jax.devices()[:L])
    x = jax.device_put(np.zeros((n, 3), np.float32),
                       NamedSharding(jm, P("les")))
    slots = {s.device.id: s.index[0] for s in x.addressable_shards}
    for slot, dev in enumerate(jm.devices.reshape(L)):
        mesh = pmesh.LesMesh(L, slot)
        want = slots[dev.id]
        assert mesh.block(n) == slice(want.start, want.stop)
        assert pmesh.local_les_positions(mesh, n) == list(
            range(want.start, want.stop))
        got = pmesh.shard_fleet({"u": torch.arange(n)}, mesh)["u"]
        assert got.tolist() == list(range(want.start, want.stop))


@pytest.mark.parametrize("n, L", [(3, 2), (5, 2), (6, 4), (9, 4)])
def test_uneven_block_rule_matches_jax(n, L):
    """Splits GSPMD's device_put refuses: JAX's local_les_positions
    (ceil(n / L) a slot) with slot s on this process alone."""
    for slot in range(L):
        devs = np.array([SimpleNamespace(process_index=0 if s == slot else 1)
                         for s in range(L)])
        fake = SimpleNamespace(shape={"les": L}, devices=devs)
        want = jmesh.local_les_positions(fake, n)
        assert pmesh.LesMesh(L, slot).positions(n) == want


def test_uneven_fleet_refused_by_the_coupled_step():
    """The coupled step and gather_rows take equal blocks only (the driver
    keeps an indivisible fleet whole; GSPMD refuses such a layout too)."""
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    from sp_coupler_tpu_torch.models.gcm import model as tmodel
    from sp_coupler_tpu_torch.models.les import grid as tgrid, step as tstep
    from sp_coupler_tpu_torch.parallel import sharding
    core = tmodel.GCMCore(tmodel.GCMConfig(trunc=10, nlev=8, dt=600.0),
                          device="cpu")
    with pytest.raises(ValueError, match="3 columns on a les mesh of 2"):
        CoupledStepFn(core, tgrid.LESGrid(nx=8, ny=8, nz=12),
                      tstep.LESPhysics(), [100, 200, 300], 15.0, 0,
                      mesh=pmesh.LesMesh(2, 0))
    with pytest.raises(ValueError, match="equal blocks"):
        sharding.gather_rows({"x": torch.zeros(2)}, pmesh.LesMesh(2, 0), 3)


# ---- the les-axis evolve ---------------------------------------------------

@pytest.fixture(scope="module")
def les_axis(tmp_path_factory):
    """JAX's tiny fleet of 4: JAX's les-sharded evolve on 2 devices, the
    port's on 2 gloo ranks, and the port's unsharded serial evolve."""
    tmp = tmp_path_factory.mktemp("les_axis")
    g, st, frc = _tiny_fleet(4)
    jm = jmesh.make_mesh(n_les=2, devices=jax.devices()[:2])
    with jax.set_mesh(jm):
        jout, jsub = _evolve(g, jstep.LESPhysics(), jm)(
            jmesh.shard_fleet(st, jm), frc)
    inp = tmp / "fleet.npz"
    np.savez(inp, grid_n=[g.nx, g.ny, g.nz], grid_d=[g.dx, g.dy, g.dz],
             **{"s_" + k: np.asarray(v) for k, v in st._asdict().items()},
             **{"f_" + k: np.asarray(v) for k, v in frc._asdict().items()})
    run_ranks(tmp / "store", 2, "evolve", inp, tmp / "ranks.npz")
    run_ranks(tmp / "store1", 1, "evolve", inp, tmp / "single.npz")
    return dict(jax=dict(jax.tree.map(np.asarray, jout._asdict()),
                         nsub=np.asarray(jsub)),
                ranks=dict(np.load(tmp / "ranks.npz")),
                single=dict(np.load(tmp / "single.npz")))


def test_les_axis_evolve_equals_unsharded(les_axis):
    ranks, single = les_axis["ranks"], les_axis["single"]
    assert sorted(ranks) == sorted(single)
    for k in ranks:
        assert np.array_equal(ranks[k], single[k]), k


def test_les_axis_evolve_matches_jax(les_axis):
    ref, got = les_axis["jax"], les_axis["ranks"]
    assert np.array_equal(got["nsub"], ref["nsub"])
    for k in ("u", "v", "w", "thl", "qt", "e12"):
        assert np.all(np.isfinite(got[k])), k
        np.testing.assert_allclose(got[k], ref[k], atol=5e-4, rtol=1e-4,
                                   err_msg=k)


# ---- the CLI on 2 ranks against 1 process ---------------------------------

def _cli(tmp, name, nprocs, odir, *extra):
    prefix = tmp / ("report_" + name)
    run_ranks(tmp / ("store_" + name), nprocs, "cli", prefix, *ARGS,
              "--conf", tmp / "conf.json", "--odir", odir, *extra)
    return reports(prefix, nprocs)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """1 process and 2 ranks (--mesh_les 2), then each checkpoint resumed
    on the other count and the single run's on 1 process again."""
    tmp = tmp_path_factory.mktemp("cli")
    with open(tmp / "conf.json", "w") as f:
        json.dump(CONF, f)
    out = {"tmp": tmp}
    out["single"] = _cli(tmp, "single", 1, tmp / "single")
    out["dual"] = _cli(tmp, "dual", 2, tmp / "dual", "--mesh_les", "2")
    for name, src, nprocs in (("s_to_1", "single", 1), ("d_to_1", "dual", 1),
                              ("s_to_2", "single", 2)):
        shutil.copytree(tmp / src, tmp / name)
        extra = ["--restart"] + (["--mesh_les", "2"] if nprocs > 1 else [])
        out[name] = _cli(tmp, name, nprocs, tmp / name, *extra)
    return out


def test_cli_records_bitwise(cli_runs):
    tmp = cli_runs["tmp"]
    a = read_spifs(str(tmp / "single" / "spifs.nc"))
    b = read_spifs(str(tmp / "dual" / "spifs.nc"))
    assert len(a["Time"]) == 2
    assert_same_records(a, b)


def test_cli_rank0_owns_the_files(cli_runs):
    tmp = cli_runs["tmp"]
    r0, r1 = cli_runs["dual"]
    assert (r0["io_proc"], r1["io_proc"]) == (True, False)
    assert r0["writer"] == "SpifsWriter" and r1["writer"] == "NullWriter"
    assert r0["timing_header"] and not r1["timing_header"]
    assert r0["mesh"] and r1["mesh"] and r0["world"] == 2
    with open(tmp / "dual" / "timing.txt") as f:
        rows = [ln for ln in f.read().splitlines() if not ln.startswith("#")]
    assert len(rows) == 3          # the column list and one row a step
    a = np.load(tmp / "single" / "restart.npz")
    b = np.load(tmp / "dual" / "restart.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_cli_gcm_replicated(cli_runs):
    assert all(r["gcm_replicated"] for r in cli_runs["dual"])


def test_cli_shard_local_cross(cli_runs):
    tmp = cli_runs["tmp"]
    (single,), dual = cli_runs["single"], cli_runs["dual"]
    cols = single["sp_cols"]
    assert len(cols) == 2 and single["cross"] == [0, 1]
    for r in dual:
        assert r["held"] == 1 and r["positions"] == [r["rank"]]
        assert r["cross"] == r["positions"]
    for col in cols:
        d1, _ = spnc.read_cdf(str(tmp / "single" / ("les-work-%d" % col)
                                  / "cross.nc"))
        d2, _ = spnc.read_cdf(str(tmp / "dual" / ("les-work-%d" % col)
                                  / "cross.nc"))
        assert d1["time"].shape == (2,) and sorted(d1) == sorted(d2)
        for k in d1:
            assert np.array_equal(d1[k], d2[k]), (col, k)


@pytest.mark.parametrize("name", ["d_to_1", "s_to_2"])
def test_checkpoint_resumes_across_rank_counts(cli_runs, name):
    """A checkpoint of 2 ranks resumed in 1 process, and one of 1 process
    on 2 ranks: the same records as the 1-process checkpoint resumed in
    1 process (3 records: the restarted run appends one)."""
    tmp = cli_runs["tmp"]
    ref = read_spifs(str(tmp / "s_to_1" / "spifs.nc"))
    got = read_spifs(str(tmp / name / "spifs.nc"))
    assert len(ref["Time"]) == 3
    assert_same_records(got, ref)


# spinup, the variability nudge, the Smagorinsky closure (the split path)
# and the driver's generic path (the dummy GCM) on 2 ranks: their
# collectives (the fleet getters, the nudge's write-back) against 1
# process, at 8x8x12
GENERIC = dict(les_itot=8, les_jtot=8, les_ktot=12, les_xsize=1600.0,
               les_ysize=1600.0, les_dz=100.0, les_schedule="serial",
               qt_forcing="variance", les_subgrid="smagorinsky",
               les_cross=True)


@pytest.mark.parametrize("gcm", ["sptpu", "dummy"])
def test_spinup_nudge_generic_on_two_ranks(tmp_path, gcm):
    with open(tmp_path / "conf.json", "w") as f:
        json.dump(GENERIC, f)
    extra = ["--gcmtype", gcm, "--spinup", "120", "--spinup_steps", "2"]
    for name, nprocs in (("single", 1), ("dual", 2)):
        _cli(tmp_path, name, nprocs, tmp_path / name, *extra,
             *(["--mesh_les", "2"] if nprocs > 1 else []))
    a = read_spifs(str(tmp_path / "single" / "spifs.nc"))
    b = read_spifs(str(tmp_path / "dual" / "spifs.nc"))
    assert len(a["Time"]) == 4        # 2 spinup records, 2 steps
    assert_same_records(a, b)


# ---- refusals, warnings, the backend rule ----------------------------------

@pytest.mark.parametrize("flags", [["--lesprocs", "4"], ["--gcmprocs", "2"]])
def test_cli_spatial_flags_raise(tmp_path, flags, caplog):
    """The spatial flags in one process, both ported. --lesprocs
    (tests/test_torch_spatial.py runs it on 4 ranks): its mesh does not
    fit, so the CLI warns and runs unsharded. --gcmprocs
    (tests/test_torch_bands.py runs it on 2 and 4 ranks): with no mesh it
    has no effect, as in the JAX driver; the run's records equal those of
    the run without it bit for bit."""
    if "--gcmprocs" in flags:
        # one coupled step (--steps 0) of 2 x 8x8x12
        with open(tmp_path / "conf.json", "w") as f:
            json.dump(NO_OP_CONF, f)
        small = ARGS + ["--steps", "0", "--conf", str(tmp_path / "conf.json")]
        runner = spmaster.build_runner(
            small + ["--odir", str(tmp_path / "out")] + flags)
        with caplog.at_level(logging.INFO):
            assert spmaster.drive(runner) == 0
        assert "--gcmprocs 2: no mesh, the GCM runs whole" in caplog.text
        assert runner.mesh is None and runner.gcm.core.bands is None
        plain = spmaster.build_runner(small + ["--odir",
                                               str(tmp_path / "plain")])
        assert spmaster.drive(plain) == 0
        assert runner.substeps == plain.substeps
        assert_same_records(read_spifs(str(tmp_path / "out" / "spifs.nc")),
                            read_spifs(str(tmp_path / "plain" / "spifs.nc")))
        return
    runner = spmaster.build_runner(
        ARGS + ["--odir", str(tmp_path / "out")] + flags)
    with caplog.at_level(logging.WARNING):
        runner.initialize()
    assert ("mesh (les=1, x=2, y=2) does not fit 1 devices; running "
            "unsharded") in caplog.text
    assert runner.mesh is None and runner.fleet.plane is None
    assert runner.fleet.state.u.shape[0] == 2


@pytest.mark.parametrize("kw", [dict(mesh_x=2), dict(mesh_y=2)])
def test_spatial_mesh_raises(tmp_path, kw, caplog):
    """mesh_x and mesh_y are ported: in one process a mesh of 2 ranks
    does not fit, so the run warns and goes on unsharded."""
    r = SPRunner(SPConfig(output_dir=str(tmp_path / "out"), **kw),
                 [geometry.Point((300.0, 15.0))], device="cpu")
    with caplog.at_level(logging.WARNING):
        r.initialize()
    assert ("mesh (les=1, x=%d, y=%d) does not fit 1 devices; running "
            "unsharded" % (kw.get("mesh_x", 1), kw.get("mesh_y", 1))
            in caplog.text)
    assert r.mesh is None


@pytest.mark.parametrize("args, want", [
    (("cpu", None, 2, 0), "gloo"),
    (("cpu", "gloo", 4, 0), "gloo"),
    (("cuda", None, 1, 1), "nccl"),
    (("cuda", None, 4, 4), "nccl"),
    (("cuda", "gloo", 2, 1), "gloo"),
    (("cuda", None, 2, 1), ValueError),       # nccl: more ranks than cards
    (("cuda", "nccl", 8, 4), ValueError),
    (("cpu", "nccl", 2, 0), ValueError),
    (("cuda", "mpi", 1, 1), ValueError),
])
def test_backend_rule(args, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            pmesh.pick_backend(*args)
    else:
        assert pmesh.pick_backend(*args) == want


def test_mesh_larger_than_world_runs_unsharded(tmp_path, caplog):
    """--mesh_les 2 in one process: the JAX driver's warning, and the run
    goes on unsharded."""
    cfg = SPConfig(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
                   les_itot=8, les_jtot=8, les_ktot=12, les_xsize=1600.0,
                   les_ysize=1600.0, les_dz=100.0, les_dt=5.0,
                   max_num_les=2, mesh_les=2,
                   output_dir=str(tmp_path / "out"))
    r = SPRunner(cfg, [geometry.Point((300.0, 15.0))], device="cpu")
    with caplog.at_level(logging.WARNING):
        r.initialize()
    assert ("mesh (les=2, x=1, y=1) does not fit 1 devices; running "
            "unsharded") in caplog.text
    assert r.mesh is None and r.coupled.mesh is None
    r.run(1)
    r.finalize()
    assert r.fleet.state.u.shape[0] == 2 and len(r.substeps) == 1


@pytest.fixture(scope="module")
def misc_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("misc")
    run_ranks(tmp / "store", 2, "misc", tmp / "out", tmp / "report")
    return reports(tmp / "report", 2)


def test_indivisible_fleet_stays_unsharded(misc_ranks):
    """3 instances on --mesh_les 2: the JAX driver's warning on every
    rank, and every rank holds the whole fleet."""
    for r in misc_ranks:
        assert ("3 LES instances not divisible by mesh les=2; fleet stays "
                "unsharded") in r["warnings"]
        assert not r["mesh"] and r["held"] == r["n"] == 3
    assert misc_ranks[0]["substeps"] == misc_ranks[1]["substeps"]


def test_replicate_check(misc_ranks):
    """replicate passes on the replicated GCM state and names a tensor
    that differs between the ranks."""
    for r in misc_ranks:
        assert r["replicate_gcm"] == "ok"
        assert "differs between slot 0 and slot 1" in r["replicate_rank"]


def test_scalebench_keys(misc_ranks):
    """scalebench.measure(sizes=[1, 2]) on 2 gloo ranks: the JAX
    package's keys (scalebench.py:165-175), the same on both ranks."""
    a, b = misc_ranks[0]["bench"], misc_ranks[1]["bench"]
    assert a == b
    assert {"bench", "mode", "backend", "grid", "per_device_instances",
            "substeps", "sizes", "updates_per_s", "efficiency"} <= set(a)
    assert a["sizes"] == [1, 2] and a["mode"] == "fixed"
    assert a["backend"] == "cpu" and a["grid"] == [8, 8, 12]
    for key in ("updates_per_s", "efficiency"):
        assert sorted(a[key]) == ["1", "2"]
        assert all(v > 0 for v in a[key].values())


# ---- the interp helpers (tests/test_utils.py:68-130 on both packages) -----

def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted(side):
    a = np.array([0.0, 1.0, 1.0, 3.0, 6.0], np.float32)
    v = np.array([-1.0, 0.0, 1.0, 2.5, 6.0, 7.0], np.float32)
    got = interp.searchsorted(_t(a), _t(v), side=side).numpy()
    want = np.asarray(jinterp.searchsorted(jnp.asarray(a), jnp.asarray(v),
                                           side=side))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("a, b, w", [(0.0, 4.0, None), (0.5, 2.5, None),
                                     (2.5, 0.5, None), (0.0, 4.0, "w"),
                                     (0.7, 3.1, "w")])
def test_integral(a, b, w):
    z = np.array([0.0, 1.0, 2.0, 4.0], np.float32)
    q = np.array([1.0, 2.0, 3.0], np.float32)
    wt = np.array([1.0, 3.0, 0.5], np.float32) if w else None
    got = float(interp.integral(a, b, _t(z), _t(q),
                                None if wt is None else _t(wt)))
    want = float(jinterp.integral(a, b, jnp.asarray(z), jnp.asarray(q),
                                  None if wt is None else jnp.asarray(wt)))
    assert np.isclose(got, want, rtol=1e-6)
    if w is None and (a, b) == (0.0, 4.0):
        assert np.isclose(got, 9.0)
    if w is None and (a, b) == (0.5, 2.5):
        assert np.isclose(got, 4.0)


def test_interp_c_matches_jax_and_conserves():
    nz = 40
    zh = np.linspace(0.0, 4000.0, nz + 1).astype(np.float32)
    rho = np.exp(-0.5 * (zh[:-1] + zh[1:]) / 2.0 / 8000.0).astype(np.float32)
    q = np.random.default_rng(0).uniform(0.0, 1.0, nz).astype(np.float32)
    Zh = np.array([3800.0, 3000.0, 1700.0, 800.0, 0.0], np.float32)
    got = interp.interp_c(_t(Zh), _t(zh), _t(q), _t(rho)).numpy()
    want = np.asarray(jinterp.interp_c(jnp.asarray(Zh), jnp.asarray(zh),
                                       jnp.asarray(q), jnp.asarray(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for i in range(len(Zh) - 1):
        ref = float(interp.integral(float(Zh[i + 1]), float(Zh[i]), _t(zh),
                                    _t(q), _t(rho)))
        assert np.isclose(got[i], ref, rtol=1e-5), i


def test_interp_c_batched_zero_above_top_and_constant():
    """Two columns at once: one with cells above the LES top (zero rows),
    one inside it (a constant is kept)."""
    zh = np.linspace(0.0, 4000.0, 11).astype(np.float32)
    rho = np.exp(-np.linspace(0, 0.5, 10)).astype(np.float32)
    q = np.full(10, 7.0, np.float32)
    Zh = np.array([[9000.0, 5000.0, 3000.0, 0.0],
                   [3500.0, 2000.0, 500.0, 0.0]], np.float32)
    got = interp.interp_c(_t(Zh), _t(zh), _t(np.stack([q, q])),
                          _t(np.stack([rho, rho]))).numpy()
    want = np.stack([np.asarray(jinterp.interp_c(
        jnp.asarray(Z), jnp.asarray(zh), jnp.asarray(q), jnp.asarray(rho)))
        for Z in Zh])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0] == 0.0 and got[0, 1] == 0.0
    np.testing.assert_allclose(got[0, 2], 7.0, rtol=1e-6)
    np.testing.assert_allclose(got[1], 7.0, rtol=1e-6)


def test_interp_rho_matches_jax():
    zh = np.linspace(0.0, 4000.0, 41).astype(np.float32)
    rho = (1.2 * np.exp(-0.5 * (zh[:-1] + zh[1:]) / 8000.0)).astype(
        np.float32)
    Zh = np.array([9000.0, 3800.0, 3000.0, 1700.0, 800.0, 0.0], np.float32)
    got = interp.interp_rho(_t(Zh), _t(zh), _t(rho)).numpy()
    want = np.asarray(jinterp.interp_rho(jnp.asarray(Zh), jnp.asarray(zh),
                                         jnp.asarray(rho)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] == 0.0 and np.all(got[1:] > 0.0)
