"""The port's intra-LES spatial decomposition (the x and y mesh axes,
--lesprocs) over torch.distributed ranks, against the JAX package and
against the port's own whole-plane runs, on the CPU.

- The block rule: a rank's block of the plane (``parallel/plane.py``) is
  the shard the JAX package's ``NamedSharding(make_mesh(l, x, y),
  P("les", None, "y", "x"))`` gives its device, on conftest's virtual
  devices.
- The Plane on 4 gloo ranks (2 x 2 and 4 x 1): the halo at h = 3 equals
  the rolled slices of the whole plane bit for bit, corners included;
  the gather is the whole plane; amax and argmax equal the whole plane's;
  the float64-summed mean and the two-pass std lie within float32
  rounding (1e-6 abs, on values of order 1) of the whole plane's.
- The projection on 2 x 2 blocks equals the whole-plane ``project`` bit
  for bit: each block's divergence is the whole plane's, point for point,
  and the gathered solve is one process's solve of the same right-hand
  side.
- The evolve of JAX's ``_tiny_fleet(2)`` (tests/test_parallel.py:24-47)
  on (les, x, y) = (1, 2, 2) and (2, 2, 1): the same substep counts as,
  and within atol 5e-4, rtol 1e-4 (the bound test_parallel.py:67 puts on
  a sharded run against an unsharded one) of, JAX's unsharded ``_evolve``
  and the port's whole-plane evolve. The same for a Smagorinsky fleet on
  a 16x12 plane (outside the TPU's lane rule) on (2, 2, 1): 2 x 1 blocks
  of 8x12, which take the split path's kernel branch (3 wrapper calls a
  substep each) as the whole plane does.
- The fused coupled step with spatial blocks (test_parallel.py:231-267) at
  T10 and one 16x16x32 instance against the unsharded step: the THL
  profile at atol 5e-3, rtol 1e-4 and ``les.thl`` at atol 5e-3, rtol 1e-3
  (test_parallel.py:262-267); the GCM state the same on every rank.
- The CLI on tests/mp_worker.py's case (T10/L8 + 2 x 16x16x24, 2 coupled
  steps, cross sections on) with --lesprocs 4 and with --mesh_les 2
  --lesprocs 2 on 4 ranks, against 1 process: the same substep counts,
  every record within verify/parity.py's PROFILE_TOL of max|ref| for its
  step (the largest difference is printed), rank 0 alone writes spifs.nc,
  each cross.nc within the same bound; checkpoints resume across
  decompositions.
- The settings: --gcmprocs 2 in one process is a no-op (no mesh, as in
  the JAX driver), a plane the mesh does not divide raises ValueError, a
  world other than les * x * y warns and runs unsharded.

Every rank is a subprocess of tests/torch_mp_worker.py (one thread each),
at most 4 ranks, meeting through a file store in tmp_path.
"""

import json
import logging
import os
import shutil

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sp_coupler_tpu.models.les import step as jstep
from sp_coupler_tpu.parallel import mesh as jmesh
from sp_coupler_tpu_torch import spmaster
from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn, evolve_fleet
from sp_coupler_tpu_torch.io import spnc
from sp_coupler_tpu_torch.models.gcm import model as gcm_model
from sp_coupler_tpu_torch.models.les import (grid as lgrid, state as lstate,
                                             step as lstep, diag as ldiag,
                                             model as les_model)
from sp_coupler_tpu_torch.models.les.state import LESState, LESForcing
from sp_coupler_tpu_torch.parallel import mesh as pmesh, plane as pplane
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.utils import geometry, tree
from sp_coupler_tpu_torch.verify.parity import PROFILE_TOL
from test_parallel import _evolve, _tiny_fleet
from test_torch_split_grids import count_split_calls
from test_torch_parallel import (ARGS, CONF, NO_OP_CONF, read_spifs, reports,
                                 run_ranks)

torch.set_num_threads(2)

EVOLVE_TOL = dict(atol=5e-4, rtol=1e-4)          # test_parallel.py:67
PROF_TOL = dict(atol=5e-3, rtol=1e-4)            # test_parallel.py:262-264
THL_TOL = dict(atol=5e-3, rtol=1e-3)             # test_parallel.py:265-267
# the coupled case: one instance at column 100 (tests/test_parallel.py's
# _one_instance profiles) on a 16x16x32 grid of 200 m x 100 m
C_GRID = lgrid.LESGrid(nx=16, ny=16, nz=32, dx=200.0, dy=200.0, dz=100.0)
# f_thl = (THL_gcm - <thl>_les) / dt, the LES thl forcing, is a difference
# of two ~300 K float32 values over dt; on blocks <thl> is a float64 sum
# over the ranks, in one process a float32 one, so the two differ by a
# float32 spacing or two of 300 K (3.05e-5 K) over the record's dt, which
# is most of a small f_thl. Beside PROFILE_TOL of max|ref| it may differ
# by F_ULPS spacings of max|thl| over dt
F_ULPS = 8


# ---- the block rule --------------------------------------------------------

@pytest.mark.parametrize("L, X, Y", [(1, 2, 2), (2, 2, 1), (2, 1, 2),
                                     (1, 4, 1)])
def test_block_rule_matches_gspmd(L, X, Y):
    n, nz, ny, nx = 2 * L, 3, 16, 32
    jm = jmesh.make_mesh(L, X, Y, devices=jax.devices()[:L * X * Y])
    arr = jax.device_put(np.zeros((n, nz, ny, nx), np.float32),
                         NamedSharding(jm, P("les", None, "y", "x")))
    index = {s.device.id: s.index for s in arr.addressable_shards}
    for rank, dev in enumerate(np.asarray(jm.devices).reshape(-1)):
        mesh = pmesh.LesMesh(L, rank, x=X, y=Y)
        plane = pplane.for_mesh(mesh, ny, nx)
        rows, _, ys, xs = index[dev.id]
        assert mesh.block(n) == slice(rows.start or 0, rows.stop or n)
        assert (plane.y0, plane.y0 + plane.by) == (ys.start or 0,
                                                   ys.stop or ny)
        assert (plane.x0, plane.x0 + plane.bx) == (xs.start or 0,
                                                   xs.stop or nx)
        assert pmesh.local_les_positions(mesh, n) == list(
            range(rows.start or 0, rows.stop or n))


def test_uneven_split_raises():
    """Blocks are equal: a plane the mesh does not divide raises, naming
    the extents (GSPMD would pad instead, ROADMAP.md section 3)."""
    with pytest.raises(ValueError, match="ny x nx = 16 x 15"):
        pplane.for_mesh(pmesh.LesMesh(1, 0, x=2, y=2), 16, 15)
    fleet = les_model.LESFleet(lgrid.LESGrid(nx=15, ny=16, nz=8),
                               lstep.LESPhysics(), 2, 5.0, device="cpu")
    with pytest.raises(ValueError, match="does not split into 2 x 2"):
        fleet.shard(pmesh.LesMesh(1, 0, x=2, y=2))
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0),
                             device="cpu")
    with pytest.raises(ValueError, match="equal blocks"):
        CoupledStepFn(core, lgrid.LESGrid(nx=16, ny=18, nz=8),
                      lstep.LESPhysics(), [100], 15.0, 0,
                      mesh=pmesh.LesMesh(1, 0, x=1, y=4))


# ---- the Plane, the projection, the evolve and the coupled step ------------

# the Smagorinsky case's plane, outside the lane rule (ny*nx = 192)
M_GRID = dict(nx=16, ny=12, nz=16, dx=200.0, dy=200.0, dz=100.0)


def _smag_fleet(n):
    """_tiny_fleet's profiles and keys on M_GRID."""
    from sp_coupler_tpu.models.les import grid as jgrid, state as jstate
    g = jgrid.LESGrid(**M_GRID)
    zf = np.asarray(g.zf())
    f32 = lambda a: jax.numpy.asarray(a, np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(42), i))(jax.numpy.arange(n))
    st = jax.vmap(lambda k: jstate.init_state(
        g, f32(-8.0 + 1e-3 * zf), f32(np.full(g.nz, -4.0)),
        f32(298.0 + 0.006 * zf), f32(14e-3 * np.exp(-zf / 2500.0)), 1.0e5,
        k))(keys)
    frc = jax.vmap(lambda _: jstate.LESForcing.zeros(g.nz))(
        jax.numpy.arange(n))
    return g, st, frc


def _torch_fleet(st, frc):
    return (LESState(*[torch.as_tensor(np.array(getattr(st, k)))
                       for k in LESState._fields]),
            LESForcing(*[torch.as_tensor(np.array(getattr(frc, k)))
                         for k in LESForcing._fields]))


def _coupled_start():
    """The coupled case's LES start: test_parallel.py's _one_instance
    profiles on C_GRID, the port's own draws."""
    zf = C_GRID.zf("cpu")
    thl0 = 297.9 + torch.clamp_min(zf - 740.0, 0.0) * 19.1 / 3260.0
    qt0 = 16e-3 * torch.exp(-zf / 2500.0)
    u0 = -9.9 + 2e-3 * zf
    v0 = torch.full_like(zf, -3.8)
    return lstate.init_state(C_GRID, u0[None], v0[None], thl0[None],
                             qt0[None], 1.0e5, torch.Generator().manual_seed(3))


def _coupled_step(state):
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8, dt=60.0),
                             device="cpu")
    gs = core.initial_state(seed=0)
    fn = CoupledStepFn(core, C_GRID, lstep.LESPhysics(), [100], 15.0, 0)
    prof0 = ldiag.slab_profiles(C_GRID, state)
    _, les, prof, _, diag = fn(gs, state, prof0, np.zeros(1, np.float32), 0,
                               first=True)
    return prof["THL"].numpy(), les.thl.numpy(), \
        fn.unpack_diag(diag)["n_substeps"]


@pytest.fixture(scope="module")
def spatial_ranks(tmp_path_factory):
    """The worker's spatial mode on 4 ranks, JAX's unsharded evolve of
    its tiny fleet, and the port's whole-plane evolve and coupled step."""
    tmp = tmp_path_factory.mktemp("spatial")
    g, st, frc = _tiny_fleet(2)
    jout, jsub = _evolve(g, jstep.LESPhysics(), None)(st, frc)
    mg, mst, mfrc = _smag_fleet(2)
    smag = jstep.LESPhysics(subgrid="smagorinsky")
    mout, msub = _evolve(mg, smag, None)(mst, mfrc)
    cst = _coupled_start()
    inp = tmp / "fleet.npz"
    np.savez(inp, grid_n=[g.nx, g.ny, g.nz], grid_d=[g.dx, g.dy, g.dz],
             m_grid_n=[mg.nx, mg.ny, mg.nz], m_grid_d=[mg.dx, mg.dy, mg.dz],
             c_grid_n=[C_GRID.nx, C_GRID.ny, C_GRID.nz],
             c_grid_d=[C_GRID.dx, C_GRID.dy, C_GRID.dz],
             **{"s_" + k: np.asarray(v) for k, v in st._asdict().items()},
             **{"f_" + k: np.asarray(v) for k, v in frc._asdict().items()},
             **{"m_s_" + k: np.asarray(v) for k, v in mst._asdict().items()},
             **{"m_f_" + k: np.asarray(v)
                for k, v in mfrc._asdict().items()},
             **{"c_" + k: v.numpy() for k, v in cst._asdict().items()})
    run_ranks(tmp / "store", 4, "spatial", inp, tmp / "out")
    whole, wsub, _ = evolve_fleet(lgrid.LESGrid(g.nx, g.ny, g.nz, g.dx, g.dy,
                                                g.dz),
                                  lstep.LESPhysics(), *_torch_fleet(st, frc),
                                  20.0, True, dt_max=5.0)
    with pytest.MonkeyPatch.context() as mp:
        calls = count_split_calls(mp)
        mwhole, mwsub, _ = evolve_fleet(
            lgrid.LESGrid(**M_GRID), lstep.LESPhysics(subgrid="smagorinsky"),
            *_torch_fleet(mst, mfrc), 20.0, True, dt_max=5.0)
    as_np = lambda s, n: dict({k: v.numpy() for k, v in s._asdict().items()},
                              nsub=n.numpy())
    return dict(ranks=reports(tmp / "out", 4),
                got=dict(np.load(tmp / "out.npz")),
                jax=dict(jax.tree.map(np.asarray, jout._asdict()),
                         nsub=np.asarray(jsub)),
                whole=as_np(whole, wsub),
                jax_smag=dict(jax.tree.map(np.asarray, mout._asdict()),
                              nsub=np.asarray(msub)),
                whole_smag=dict(as_np(mwhole, mwsub), calls=calls),
                coupled=_coupled_step(cst))


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_plane_halo_and_reductions(spatial_ranks, mesh):
    for r in spatial_ranks["ranks"]:
        c = r["plane_" + mesh]
        assert c["halo"] and c["gather"] and c["amax"] and c["argmax"], c
        assert c["mean_err"] <= 1e-6 and c["std_err"] <= 1e-6, c
    blocks = sorted(tuple(r["plane_" + mesh]["block"])
                    for r in spatial_ranks["ranks"])
    want = ([(0, 8, 0, 8), (0, 8, 8, 8), (8, 8, 0, 8), (8, 8, 8, 8)]
            if mesh == "2x2" else [(0, 16, x, 4) for x in (0, 4, 8, 12)])
    assert blocks == want


def test_projection_on_blocks_is_bitwise(spatial_ranks):
    for r in spatial_ranks["ranks"]:
        assert r["project_bitwise"], r["project_err"]


@pytest.mark.parametrize("name", ["evolve_122", "evolve_221", "smag_221"])
@pytest.mark.parametrize("ref", ["jax", "whole"])
def test_blocked_evolve_matches(spatial_ranks, name, ref):
    smag = name.startswith("smag")
    got = spatial_ranks["got"]
    want = spatial_ranks[ref + "_smag" if smag else ref]
    assert np.array_equal(got[name + "_nsub"], want["nsub"])
    if smag:
        # the kernel branch on the blocks and on the whole plane: each
        # wrapper 3 x the substeps of each instance's serial loop
        whole = spatial_ranks["whole_smag"]
        total = 3 * int(whole["nsub"].sum())
        assert whole["calls"] == dict(lesflat=total, lesmom=total)
        for r in spatial_ranks["ranks"]:
            c = r["smag_calls"]
            assert c["lesflat"] == c["lesmom"] == 3 * sum(c["nsub"]) > 0, r
    for k in ("u", "v", "w", "thl", "qt", "e12"):
        a = got["%s_%s" % (name, k)]
        assert np.all(np.isfinite(a)), k
        np.testing.assert_allclose(a, want[k], err_msg=k, **EVOLVE_TOL)


def test_fused_coupled_step_on_blocks(spatial_ranks):
    THL, thl, nsub = spatial_ranks["coupled"]
    got = spatial_ranks["got"]
    assert np.array_equal(got["coupled_nsub"], nsub)
    np.testing.assert_allclose(got["coupled_THL"], THL, **PROF_TOL)
    np.testing.assert_allclose(got["coupled_thl"], thl, **THL_TOL)


# ---- the CLI with --lesprocs on 4 ranks ------------------------------------

def _cli(tmp, name, nprocs, odir, *extra):
    prefix = tmp / ("report_" + name)
    run_ranks(tmp / ("store_" + name), nprocs, "cli", prefix, *ARGS,
              "--conf", tmp / "conf.json", "--odir", odir, *extra)
    return reports(prefix, nprocs)


LP4 = ["--lesprocs", "4"]
L2P2 = ["--mesh_les", "2", "--lesprocs", "2"]


@pytest.fixture(scope="module")
def cli_spatial(tmp_path_factory):
    """1 process, --lesprocs 4 and --mesh_les 2 --lesprocs 2 on 4 ranks;
    then the single run's checkpoint resumed in 1 process and under
    --mesh_les 2 --lesprocs 2, and the --lesprocs 4 run's in 1 process."""
    tmp = tmp_path_factory.mktemp("cli_spatial")
    with open(tmp / "conf.json", "w") as f:
        json.dump(CONF, f)
    out = {"tmp": tmp}
    out["single"] = _cli(tmp, "single", 1, tmp / "single")
    out["lp4"] = _cli(tmp, "lp4", 4, tmp / "lp4", *LP4)
    out["l2p2"] = _cli(tmp, "l2p2", 4, tmp / "l2p2", *L2P2)
    for name, src, nprocs, extra in (("s_to_1", "single", 1, []),
                                     ("lp4_to_1", "lp4", 1, []),
                                     ("s_to_l2p2", "single", 4, L2P2)):
        shutil.copytree(tmp / src, tmp / name)
        out[name] = _cli(tmp, name, nprocs, tmp / name, "--restart",
                         *extra)
    return out


def record_diffs(ref, got):
    """{variable: max over records t of max|got_t - ref_t| / max|ref_t|};
    raises where a record lies beyond PROFILE_TOL of its step (f_thl: plus
    F_ULPS float32 spacings of the slab-mean thl over the record's dt), or
    the variables or records differ. Returns the largest (variable,
    diff)."""
    assert sorted(ref) == sorted(got)
    assert np.array_equal(ref["Time"], got["Time"])
    n_rec = len(ref["Time"])
    worst, bad = ("", 0.0), []
    for k in sorted(ref):
        a, b = np.asarray(ref[k], np.float64), np.asarray(got[k], np.float64)
        assert a.shape == b.shape, k
        recs = range(n_rec) if a.ndim and a.shape[0] == n_rec else [None]
        for t in recs:
            at, bt = (a, b) if t is None else (a[t], b[t])
            scale = np.max(np.abs(at)) + 1e-12 if at.size else 1.0
            err = float(np.max(np.abs(bt - at))) if at.size else 0.0
            d = err / scale
            tol = PROFILE_TOL[min(t or 0, len(PROFILE_TOL) - 1)] * scale
            if k.endswith("/f_thl") and t is not None:
                dt = ref["Time"][t] - (ref["Time"][t - 1] if t else 0.0)
                thl = np.max(np.abs(ref[k[:-len("f_thl")] + "thl"][t]))
                tol += F_ULPS * float(np.spacing(np.float32(thl))) / dt
            if err > tol:
                bad.append((k, t, d))
            if d > worst[1]:
                worst = (k, d)
    assert not bad, "records beyond PROFILE_TOL: %s" % bad
    return worst


@pytest.mark.parametrize("name", ["lp4", "l2p2"])
def test_cli_spatial_records(cli_spatial, name):
    tmp = cli_spatial["tmp"]
    (single,) = cli_spatial["single"]
    ranks = cli_spatial[name]
    want_shape = ({"les": 1, "x": 2, "y": 2} if name == "lp4"
                  else {"les": 2, "x": 1, "y": 2})
    for r in ranks:
        assert r["mesh"] and r["mesh_shape"] == want_shape
        assert r["substeps"] == single["substeps"]
        assert r["gcm_replicated"]
    a = read_spifs(str(tmp / "single" / "spifs.nc"))
    b = read_spifs(str(tmp / name / "spifs.nc"))
    assert len(a["Time"]) == 2
    worst = record_diffs(a, b)
    print("%s: largest record difference %s %.3g of max|ref|"
          % (name, worst[0], worst[1]))


def test_cli_spatial_blocks_and_files(cli_spatial):
    tmp = cli_spatial["tmp"]
    for name in ("lp4", "l2p2"):
        ranks = cli_spatial[name]
        assert [r["io_proc"] for r in ranks] == [True, False, False, False]
        assert [r["writer"] for r in ranks] == (
            ["SpifsWriter"] + ["NullWriter"] * 3)
        assert ranks[0]["timing_header"]
        assert not any(r["timing_header"] for r in ranks[1:])
    # --lesprocs 4: both instances on every rank, an 8 x 8 block each;
    # --mesh_les 2 --lesprocs 2 (x 1, y 2): one instance, 8 rows x 16
    assert [r["shape"] for r in cli_spatial["lp4"]] == [[2, 24, 8, 8]] * 4
    assert [r["shape"] for r in cli_spatial["l2p2"]] == [[1, 24, 8, 16]] * 4
    assert [r["positions"] for r in cli_spatial["l2p2"]] == [[0], [0], [1],
                                                              [1]]
    # the first rank of each plane writes its instances' cross.nc
    assert [r["cross"] for r in cli_spatial["lp4"]] == [[0, 1], [], [], []]
    assert [r["cross"] for r in cli_spatial["l2p2"]] == [[0], [], [1], []]
    names = sorted(os.listdir(tmp / "lp4"))
    assert "spifs.nc" in names and "restart.npz" in names


@pytest.mark.parametrize("name", ["lp4", "l2p2"])
def test_cli_spatial_cross(cli_spatial, name):
    tmp = cli_spatial["tmp"]
    for col in cli_spatial["single"][0]["sp_cols"]:
        path = os.path.join("les-work-%d" % col, "cross.nc")
        d1, _ = spnc.read_cdf(str(tmp / "single" / path))
        d2, _ = spnc.read_cdf(str(tmp / name / path))
        assert sorted(d1) == sorted(d2) and d1["time"].shape == (2,)
        assert np.array_equal(d1["time"], d2["time"])
        for k in d1:
            for t in range(2):
                a, b = d1[k][t].astype(np.float64), d2[k][t].astype(
                    np.float64)
                d = np.max(np.abs(b - a)) / (np.max(np.abs(a)) + 1e-12)
                assert d <= PROFILE_TOL[t], (col, k, t, d)


@pytest.mark.parametrize("name", ["lp4_to_1", "s_to_l2p2"])
def test_checkpoint_resumes_across_decompositions(cli_spatial, name):
    """A checkpoint of --lesprocs 4 resumed in 1 process, and one of 1
    process under --mesh_les 2 --lesprocs 2: 3 records, the restarted
    run's within PROFILE_TOL of the 1-process checkpoint resumed in 1
    process."""
    tmp = cli_spatial["tmp"]
    ref = read_spifs(str(tmp / "s_to_1" / "spifs.nc"))
    got = read_spifs(str(tmp / name / "spifs.nc"))
    assert len(ref["Time"]) == 3
    record_diffs(ref, got)


# spinup, the variability nudge on blocks, the Smagorinsky closure (the
# split path in halo mode) and the driver's generic path (the dummy GCM:
# the fleet's getters gather whole planes) with --lesprocs 4 against 1
# process, at 8x8x12 (blocks of 4 x 4)
@pytest.mark.parametrize("gcm", ["sptpu", "dummy"])
def test_spinup_nudge_generic_on_blocks(tmp_path, gcm):
    from test_torch_parallel import GENERIC
    with open(tmp_path / "conf.json", "w") as f:
        json.dump(GENERIC, f)
    extra = ["--gcmtype", gcm, "--spinup", "120", "--spinup_steps", "2"]
    for name, nprocs in (("single", 1), ("blocks", 4)):
        _cli(tmp_path, name, nprocs, tmp_path / name, *extra,
             *(LP4 if nprocs > 1 else []))
    a = read_spifs(str(tmp_path / "single" / "spifs.nc"))
    b = read_spifs(str(tmp_path / "blocks" / "spifs.nc"))
    assert len(a["Time"]) == 4        # 2 spinup records, 2 steps
    record_diffs(a, b)


# ---- settings: --lesprocs in one process, --gcmprocs -------------------------

def test_gcmprocs_is_a_noop_in_one_process(tmp_path):
    """--gcmprocs no longer raises: in one process there is no mesh to
    band the GCM over, so it has no effect (the JAX driver's semantics)
    and the run equals the run without it bit for bit, the GCM state and
    the LES fleet after the steps included (tests/test_torch_bands.py
    runs it banded)."""
    with open(tmp_path / "conf.json", "w") as f:
        json.dump(NO_OP_CONF, f)
    runs = []
    for name, extra in (("out", ["--gcmprocs", "2"]), ("plain", [])):
        runner = spmaster.build_runner(
            ARGS + ["--steps", "0", "--conf", str(tmp_path / "conf.json"),
                    "--odir", str(tmp_path / name)] + extra)
        assert spmaster.drive(runner) == 0
        runs.append(runner)
    a, b = runs
    assert a.gcm.state.grid.T.shape == b.gcm.state.grid.T.shape
    assert a.substeps == b.substeps
    for name in ("gcm", "fleet"):
        xs = tree.flatten(getattr(a, name).state)[0]
        ys = tree.flatten(getattr(b, name).state)[0]
        assert len(xs) == len(ys)
        assert all(torch.equal(x, y) for x, y in zip(xs, ys)), name


@pytest.mark.parametrize("kw, shape", [
    (dict(les_num_procs=4), (1, 2, 2)), (dict(les_num_procs=6), (1, 2, 3)),
    (dict(mesh_x=2, mesh_y=2, mesh_les=2), (2, 2, 2))])
def test_world_other_than_mesh_warns_and_runs_unsharded(tmp_path, caplog,
                                                         kw, shape):
    """In one process a mesh of les * x * y > 1 ranks does not fit: the
    JAX driver's warning (--lesprocs N as JAX maps it onto x * y), and the
    run goes on unsharded."""
    cfg = SPConfig(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
                   les_itot=8, les_jtot=12, les_ktot=12, les_xsize=1600.0,
                   les_ysize=2400.0, les_dz=100.0, les_dt=5.0,
                   max_num_les=2, timing_phases=0,
                   output_dir=str(tmp_path / "out"), **kw)
    r = SPRunner(cfg, [geometry.Point((300.0, 15.0))], device="cpu")
    with caplog.at_level(logging.WARNING):
        r.initialize()
    assert ("mesh (les=%d, x=%d, y=%d) does not fit 1 devices; running "
            "unsharded" % shape) in caplog.text
    assert r.mesh is None and r.fleet.plane is None
    r.run(1)
    r.finalize()
    assert r.fleet.state.u.shape == (2, 12, 12, 8) and len(r.substeps) == 1


# ---- the kernels' halo mode: plain versions and argument checks ------------

@pytest.mark.parametrize("kernel", ["lesflat", "lesmom"])
def test_plain_halo_mode_is_the_whole_planes_block(kernel):
    """On a CPU tensor a kernel wrapper in halo mode runs its plain version
    on the padded block and keeps the interior: bit for bit the block of
    the whole plane's plain version (the same operations, point for
    point)."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom
    g = lgrid.LESGrid(nx=16, ny=16, nz=16)
    gen = torch.Generator().manual_seed(4)
    r = lambda *shp: torch.rand(shp, generator=gen)
    n = 2
    u, v, w = r(n, 16, 16, 16), r(n, 16, 16, 16), r(n, 17, 16, 16)
    K, S = r(n, 4, 16, 16, 16), r(n, 4, 16, 16, 16)
    rhobf, rhobh = 1.0 + r(n, 16), 1.0 + r(n, 17)
    sp = (g.dx, g.dy, g.dz)
    if kernel == "lesflat":
        fn = lesflat.advect_diffuse_scalars
        fields, rest = (u, v, w, K, S), (rhobf, rhobh) + sp
    else:
        fn = lesmom.momentum_tendencies
        fields, rest = (u, v, w, K[:, 0]), (rhobf, rhobh) + sp
    whole = fn(*fields, *rest)
    whole = whole if isinstance(whole, tuple) else (whole,)
    for mesh in (pmesh.LesMesh(1, 3, x=2, y=2), pmesh.LesMesh(1, 1, x=4)):
        p = pplane.for_mesh(mesh, 16, 16)
        got = fn(*[p.block(f, 3) for f in fields], *rest, halo=3)
        got = got if isinstance(got, tuple) else (got,)
        for a, b in zip(got, whole):
            assert torch.equal(a, p.block(b))


def test_halo_mode_needs_three_points():
    """The kernels' halo mode reads 3 points off the block: a smaller halo
    raises before any launch."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom
    z = torch.zeros((1, 4, 10, 10))
    with pytest.raises(ValueError, match="at least 3 points"):
        lesflat.launch_scalars("lesflat_tend", z, z, z, z[:, None],
                               z[:, None], z[:, 0], z[:, 0], 1.0, 1.0, 1.0,
                               halo=2)
    with pytest.raises(ValueError, match="at least 3 points"):
        lesmom.momentum_tendencies_cuda(z, z, z, z, z[:, 0], z[:, 0], 1.0,
                                        1.0, 1.0, halo=1)
