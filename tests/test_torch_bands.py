"""The port's latitude bands of the GCM (--gcmprocs) over torch.distributed
ranks, against the JAX package and against one process, on the CPU.

- The band rule: rank r's rows (``parallel/bands.py``) are the shard the
  JAX package's ``NamedSharding(make_mesh(l, x, y), P(None, ("les", "x",
  "y"), None))`` gives device r on conftest's virtual devices; a rank
  count that does not divide nlat raises ValueError.
- The transforms at T21 on 4 ranks (mesh (1, 2, 2)) against JAX's banded
  ``SpectralTransform(21, mesh=, axis="les")`` at atol/rtol 1e-5
  (tests/test_parallel.py:91-106); a band's synthesis equals the rows of
  the whole grid's bit for bit.
- The Eulerian step at T10/L8 on 4 ranks (mesh (2, 2, 1)) from JAX's start
  (``interop.gcm_state``), the first step and one leapfrog step, against
  JAX's core banded over 8 devices (``GCMCore(cfg, mesh=, shard_axis=
  "les")``) and JAX's unbanded core: spectral vort, div, T, q at atol
  2e-4, rtol 1e-3 and grid T at atol 5e-3, rtol 1e-4
  (test_parallel.py:116-128); the spectral state the same on every rank,
  bit for bit.
- The SL step at T10/L8 on 4 ranks, two steps, with the gather and the
  window interpolation, against JAX's unbanded SL core at the same
  tolerances (JAX's own banded SL check is marked slow); the window
  method's clamp statistics summed over the bands equal one process's.
- Hybrid levels, Eulerian and SL: two steps on 4 ranks against one
  process's, from the port's start, at the same tolerances.
- Columns: profiles and surface fields gathered from the bands equal one
  process's extraction from the same grid bit for bit, the tendencies the
  ranks scatter equal one process's cut to the bands, and a state taken
  to the bands and back is the same state.
- The CLI on tests/mp_worker.py's case (T10/L8 + 2 x 16x16x24, 2 coupled
  steps) with --mesh_les 2 --gcmprocs 2 on 2 ranks and --lesprocs 4
  --gcmprocs 4 on 4 ranks, against 1 process: the same substeps, records
  within verify/parity.py's PROFILE_TOL, each rank's grid nlat / P rows;
  checkpoints of a banded run resume in 1 process and the reverse; with
  a dummy LES fleet the fleet declines the mesh and the GCM stays banded.
- BASELINE config 4's layout at a small size (T21/L19 SL hybrid, 32 rows
  in 4 bands of 8, + 4 x 16x16x32, batched, evolve_chunks 2, --mesh_les 4
  --gcmprocs 4, one instance a rank): rank 0's checkpoint equals, key by
  key, in order and bit for bit, the one restart.save writes in one
  process from the state every rank held as it saved; ranks 1-3 are
  given no fleet rows by sharding.rows_to_root, rank 0 every leaf whole.
  (A 1-process run of the same case is no reference bit for bit: the
  bands' analysis sums and the batch of 4 against 1 round apart.)

Every rank is a subprocess of tests/torch_mp_worker.py (one thread each),
meeting through a file store in tmp_path.
"""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sp_coupler_tpu.models.gcm import model as jgcm, spharm as jspharm
from sp_coupler_tpu.parallel import mesh as jmesh
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.io import restart
from sp_coupler_tpu_torch.models.gcm import model as gcm_model, spharm
from sp_coupler_tpu_torch.parallel import bands as pbands, mesh as pmesh
from test_torch_parallel import CONF, read_spifs, reports, run_ranks
from test_torch_spatial import _cli, record_diffs

torch.set_num_threads(2)

SPEC_TOL = dict(atol=2e-4, rtol=1e-3)        # test_parallel.py:121-124
GRID_TOL = dict(atol=5e-3, rtol=1e-4)        # test_parallel.py:125-128
SHT_TOL = dict(atol=1e-5, rtol=1e-5)         # test_parallel.py:103-106
RANKS = 4
# columns in every band of T10's 16 x 32 grid on 4 ranks (4 rows each)
COLS = [5, 100, 130, 200, 300, 301, 450, 511]


# ---- the band rule ---------------------------------------------------------

@pytest.mark.parametrize("L, X, Y", [(1, 2, 2), (2, 2, 1), (2, 1, 1)])
def test_band_rule_matches_gspmd(L, X, Y):
    nlat, nlon = 32, 64
    jm = jmesh.make_mesh(L, X, Y, devices=jax.devices()[:L * X * Y])
    arr = jax.device_put(np.zeros((3, nlat, nlon), np.float32),
                         NamedSharding(jm, P(None, ("les", "x", "y"), None)))
    index = {s.device.id: s.index for s in arr.addressable_shards}
    for rank, dev in enumerate(np.asarray(jm.devices).reshape(-1)):
        b = pbands.for_mesh(pmesh.LesMesh(L, rank, x=X, y=Y), nlat)
        rows = index[dev.id][1]
        assert (b.r0, b.r1) == (rows.start or 0, rows.stop or nlat)
        assert b.cut(torch.zeros(3, nlat, nlon)).shape == (3, b.nb, nlon)


def test_uneven_bands_raise():
    """Bands are equal: a rank count that does not divide nlat raises,
    naming both (GSPMD would pad instead, ROADMAP.md section 3)."""
    with pytest.raises(ValueError, match="nlat = 32 .* P = 3"):
        pbands.for_mesh(pmesh.LesMesh(3, 0), 32)
    with pytest.raises(ValueError, match="nlat = 240 .* P = 7"):
        pbands.Bands(240, 7, 0)
    assert pbands.for_mesh(None, 32) is None
    assert pbands.for_mesh(pmesh.LesMesh(1, 0), 32) is None
    for P_ in (2, 3, 4, 5, 6, 8):          # T159's 240 rows
        assert pbands.Bands(240, P_, P_ - 1).r1 == 240


# ---- the worker's bands mode on 4 ranks ------------------------------------

def _jax_start(adv):
    cfg = jgcm.GCMConfig(trunc=10, nlev=8, dt=600.0, advection=adv)
    core = jgcm.GCMCore(cfg)
    s0 = core.initial_state(seed=0)
    steps = [core.step(s0, first=True)]
    steps.append(core.step(steps[0]))
    return cfg, s0, steps


@pytest.fixture(scope="module")
def band_ranks(tmp_path_factory):
    """The worker's bands mode on 4 ranks and the JAX references: the
    T21 transforms banded over 8 devices, the T10/L8 Eulerian steps
    unbanded and banded over 8 devices, the SL steps unbanded."""
    tmp = tmp_path_factory.mktemp("bands")
    ref = jspharm.SpectralTransform(21)
    rng = np.random.default_rng(0)
    s = (jnp.asarray(rng.normal(size=(3, ref.M, ref.N, 2)), jnp.float32)
         * ref.mask[..., None])
    mesh = jmesh.make_mesh(n_les=8)
    sh = jspharm.SpectralTransform(21, mesh=mesh, axis="les")
    with jax.set_mesh(mesh):
        g_sh = jax.jit(sh.synthesize)(s)
        a_sh = jax.jit(sh.analyze)(g_sh)
    out = dict(sht=(np.asarray(g_sh), np.asarray(a_sh)))
    data = dict(spec=torch.as_tensor(np.array(s)))
    for adv in ("eulerian", "sl"):
        cfg, s0, steps = _jax_start(adv)
        data[adv] = interop.gcm_state(jax.tree.map(np.asarray, s0), "cpu")
        out[adv] = [jax.tree.map(np.asarray, x) for x in steps]
    cfg = jgcm.GCMConfig(trunc=10, nlev=8, dt=600.0)
    core_sh = jgcm.GCMCore(cfg, mesh=mesh, shard_axis="les")
    with jax.set_mesh(mesh):
        first = core_sh.step(core_sh.initial_state(seed=0), first=True)
        second = core_sh.step(first)
    out["eulerian_banded"] = [jax.tree.map(np.asarray, x)
                              for x in (first, second)]
    # the window's clamp statistics at targets displaced at random from
    # the grid points (some beyond the window), one process
    one = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0,
                                                advection="sl"), device="cpu")
    gen = torch.Generator().manual_seed(2)
    lam0, phi0 = one.slg._angles(one.slg.r)
    lam = torch.remainder(lam0 + 0.5 * torch.randn((8,) + lam0.shape,
                                                   generator=gen),
                          2.0 * np.pi)
    phi = torch.clamp(phi0 + 0.3 * torch.randn((8,) + phi0.shape,
                                               generator=gen),
                      -np.pi / 2, np.pi / 2)
    data["targets"] = (lam, phi)
    st = one.slg.clamp_stats(lam, phi)
    out["clamp"] = torch.stack([st["lon"], st["lat"]]).numpy()
    data["cols"] = torch.as_tensor(COLS)
    data["tend"] = {k: torch.randn((len(COLS), 8), generator=gen)
                    for k in gcm_model.SP_TEND_KEYS}
    torch.save(data, tmp / "in.pt")
    run_ranks(tmp / "store", RANKS, "bands", tmp / "in.pt", tmp / "out")
    out["ranks"] = reports(tmp / "out", RANKS)
    out["arrays"] = [dict(np.load("%s.%d.npz" % (tmp / "out", r)))
                     for r in range(RANKS)]
    return out


def test_transforms_match_jax_banded(band_ranks):
    g_ref, a_ref = band_ranks["sht"]
    for r, rep in enumerate(band_ranks["ranks"]):
        assert rep["t21_rows"] == [8 * r, 8 * r + 8]
        assert rep["t21_syn_bitwise"]
        got = band_ranks["arrays"][r]
        np.testing.assert_allclose(got["t21_grid"], g_ref, **SHT_TOL)
        np.testing.assert_allclose(got["t21_spec"], a_ref, **SHT_TOL)
        assert np.array_equal(got["t21_spec"],
                              band_ranks["arrays"][0]["t21_spec"])


def _spectral(arrays, name, step):
    """{field: [now's leaf]} of the replicated dict a rank kept (its
    leaves: new, now, prev (each SpectralState), time)."""
    leaves = [arrays["%s_%d_%d" % (name, step, i)]
              for i in range(3 * 8 + 1)]
    now = leaves[8:16]
    return dict(zip(("vort", "div", "T", "lnps", "q", "ql", "qi", "a"),
                    now))


@pytest.mark.parametrize("name", ["eul", "sl_gather", "sl_window"])
def test_banded_steps_match_jax(band_ranks, name):
    adv = "eulerian" if name == "eul" else "sl"
    refs = [(band_ranks[adv], "unbanded")]
    if name == "eul":
        refs.append((band_ranks["eulerian_banded"], "banded over 8"))
    arrays = band_ranks["arrays"]
    for rep in band_ranks["ranks"]:
        assert rep[name + "_rows"] == 4
    for step in range(2):
        got = _spectral(arrays[0], name, step)
        for ref, what in refs:
            for k in ("vort", "div", "T", "q"):
                np.testing.assert_allclose(
                    got[k], getattr(ref[step].now, k),
                    err_msg="%s step %d %s (JAX %s)" % (name, step, k, what),
                    **SPEC_TOL)
            np.testing.assert_allclose(
                arrays[0]["%s_%d_gridT" % (name, step)],
                ref[step].grid.T, err_msg="%s step %d grid T" % (name, step),
                **GRID_TOL)
        # the spectral state and the gathered grid: the same on every rank
        for a in arrays[1:]:
            for key in arrays[0]:
                if key.startswith("%s_%d" % (name, step)):
                    assert np.array_equal(a[key], arrays[0][key]), key


@pytest.mark.parametrize("name", ["eul_hybrid", "sl_hybrid"])
def test_banded_hybrid_steps_match_one_process(band_ranks, name):
    """Hybrid levels (the hybrid geopotential's analysis in the Eulerian
    tendencies, the SL midpoint terms' on the whole grid): two steps on
    the bands against one process's, from the port's start, at the JAX
    tests' tolerances; the same on every rank."""
    arrays = band_ranks["arrays"]
    for step in range(2):
        for k in ("vort", "div", "T", "q"):
            key = "%s_%d_%s" % (name, step, k)
            np.testing.assert_allclose(arrays[0][key], arrays[0][key + "_one"],
                                       err_msg=key, **SPEC_TOL)
        key = "%s_%d_gridT" % (name, step)
        np.testing.assert_allclose(arrays[0][key], arrays[0][key + "_one"],
                                   err_msg=key, **GRID_TOL)
        for a in arrays[1:]:
            for key in arrays[0]:
                if key.startswith("%s_%d" % (name, step)) and \
                        not key.endswith("_one"):
                    assert np.array_equal(a[key], arrays[0][key]), key


def test_sl_methods_agree_and_clamp_stats(band_ranks):
    """The window and gather interpolations on bands agree as in one
    process (the same taps); the window's clamp statistics summed over the
    bands equal one process's."""
    a = band_ranks["arrays"][0]
    for step in range(2):
        np.testing.assert_allclose(a["sl_window_%d_gridT" % step],
                                   a["sl_gather_%d_gridT" % step],
                                   **GRID_TOL)
    want = band_ranks["clamp"]
    assert np.all(want > 0)
    for rank in band_ranks["arrays"]:
        for name in ("sl_gather", "sl_window"):
            assert np.array_equal(rank[name + "_clamp"], want), name


@pytest.mark.parametrize("check", ["profiles", "surface", "scatter",
                                   "roundtrip"])
def test_columns_from_bands_are_bitwise(band_ranks, check):
    for rep in band_ranks["ranks"]:
        assert rep[check + "_bitwise"], (rep["rank"], check)


def test_band_synthesis_needs_no_exchange():
    """A banded transform is built and synthesizes without a process
    group: each band's rows equal the whole grid's bit for bit, and its
    grid-space tables are its rows (the folded tables at mirror rows)."""
    whole = spharm.SpectralTransform(10, device="cpu")
    rng = np.random.default_rng(1)
    s = torch.as_tensor(rng.normal(size=(2, whole.M, whole.N, 2)),
                        dtype=torch.float32)
    g = whole.synthesize(s)
    parts = []
    for r in range(4):
        bt = spharm.SpectralTransform(10, device="cpu",
                                      bands=pbands.Bands(whole.nlat, 4, r))
        assert bt.whole.bands is None and bt.whole.whole is bt.whole
        assert torch.equal(bt.mu, whole.mu[4 * r:4 * r + 4])
        parts.append(bt.synthesize(s))
        assert np.allclose(bt.latitudes_deg(), whole.latitudes_deg())
    assert torch.equal(torch.cat(parts, dim=-2), g)


# ---- the CLI ----------------------------------------------------------------

ML2G2 = ["--mesh_les", "2", "--gcmprocs", "2"]
LP4G4 = ["--lesprocs", "4", "--gcmprocs", "4"]


def _cli_sets(tmp, runs):
    """{name: reports} of the runs (name, nprocs, *flags), all at once."""
    with ThreadPoolExecutor(len(runs)) as pool:
        futs = {r[0]: pool.submit(_cli, tmp, r[0], r[1], tmp / r[0], *r[2:])
                for r in runs}
        return {name: f.result() for name, f in futs.items()}


# config 4's layout, small: a column in each band of T21's 32 rows
C4_CONF = dict(les_itot=16, les_jtot=16, les_ktot=32, les_xsize=3200.0,
               les_ysize=3200.0, les_dz=100.0, gcm_hybrid=True,
               gcm_advection="sl", les_schedule="batched",
               les_evolve_chunks=2)
C4_COLS = [3 * 64 + 5, 11 * 64 + 20, 19 * 64 + 40, 27 * 64 + 60]
C4_MESH = ["--mesh_les", "4", "--gcmprocs", "4"]


def _config4_small(tmp):
    """The ckpt mode of the worker on 4 ranks, C4_CONF at C4_COLS."""
    with open(tmp / "c4.json", "w") as f:
        json.dump(C4_CONF, f)
    sht = spharm.SpectralTransform(21, device="cpu")
    lats, lons = sht.latitudes_deg(), sht.longitudes_deg()
    pts = []
    for c in C4_COLS:
        pts += ["%.6f" % lats[c // 64], "%.6f" % lons[c % 64]]
    prefix = tmp / "report_c4"
    run_ranks(tmp / "store_c4", RANKS, "ckpt", prefix, "--trunc", "21",
              "--levels", "19", "--gcm_dt", "900", "--les_dt", "15",
              "--steps", "1", "--device", "cpu", "--points", *pts,
              "--conf", tmp / "c4.json", "--odir", tmp / "c4", *C4_MESH)
    return reports(prefix, RANKS)


@pytest.fixture(scope="module")
def cli_bands(tmp_path_factory):
    """1 process, --mesh_les 2 --gcmprocs 2 on 2 ranks, --lesprocs 4
    --gcmprocs 4 on 4 ranks, the dummy LES fleet in 1 process and banded
    on 2 ranks, config 4's layout on 4 ranks (_config4_small); then the
    single run's checkpoint resumed in 1 process (the reference) and
    banded on 2 ranks, the banded run's in 1 process. The runs of each
    group at once, one thread a rank."""
    tmp = tmp_path_factory.mktemp("cli_bands")
    with open(tmp / "conf.json", "w") as f:
        json.dump(CONF, f)
    dummy = ["--lestype", "dummy"]
    out = {"tmp": tmp}
    with ThreadPoolExecutor(1) as pool:
        config4 = pool.submit(_config4_small, tmp)
        out.update(_cli_sets(tmp, [
            ("single", 1), ("ml2g2", 2, *ML2G2), ("lp4g4", 4, *LP4G4),
            ("dummy_1", 1, *dummy), ("dummy_b", 2, *dummy, *ML2G2)]))
        out["config4"] = config4.result()
    resumes = [("s_to_1", "single", 1), ("b_to_1", "ml2g2", 1),
               ("s_to_b", "single", 2, *ML2G2)]
    for name, src, *_ in resumes:
        shutil.copytree(tmp / src, tmp / name)
    out.update(_cli_sets(tmp, [(name, n, "--restart", *extra)
                               for name, _, n, *extra in resumes]))
    return out


@pytest.mark.parametrize("name, P", [("ml2g2", 2), ("lp4g4", 4)])
def test_cli_banded_records(cli_bands, name, P):
    tmp = cli_bands["tmp"]
    (single,) = cli_bands["single"]
    assert single["gcm_bands"] is None and single["gcm_rows"] == 16
    for r, rep in enumerate(cli_bands[name]):
        assert rep["mesh"] and rep["substeps"] == single["substeps"]
        assert rep["gcm_bands"] == [P, 16 // P * r, 16 // P * (r + 1)]
        assert rep["gcm_rows"] == 16 // P
        assert rep["gcm_replicated"]
    a = read_spifs(str(tmp / "single" / "spifs.nc"))
    b = read_spifs(str(tmp / name / "spifs.nc"))
    assert len(a["Time"]) == 2
    worst = record_diffs(a, b)
    print("%s: largest record difference %s %.3g of max|ref|"
          % (name, worst[0], worst[1]))


def test_banded_checkpoint_is_whole(cli_bands):
    """A banded run's checkpoint holds the whole grid, as one process's."""
    tmp = cli_bands["tmp"]
    with np.load(tmp / "single" / "restart.npz") as a, \
            np.load(tmp / "ml2g2" / "restart.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k


@pytest.mark.parametrize("name", ["b_to_1", "s_to_b"])
def test_checkpoint_resumes_across_bands(cli_bands, name):
    """The banded run's checkpoint resumed in 1 process, and one process's
    resumed on 2 banded ranks: 3 records, within PROFILE_TOL of the
    1-process checkpoint resumed in 1 process."""
    tmp = cli_bands["tmp"]
    if name == "s_to_b":
        assert [r["gcm_rows"] for r in cli_bands[name]] == [8, 8]
    ref = read_spifs(str(tmp / "s_to_1" / "spifs.nc"))
    got = read_spifs(str(tmp / name / "spifs.nc"))
    assert len(ref["Time"]) == 3
    record_diffs(ref, got)


def test_dummy_fleet_declines_the_mesh_bands_stay(cli_bands):
    """--gcmprocs 2 with a dummy LES fleet: the fleet declines the mesh
    (the run goes on without one), the GCM stays banded, as in the JAX
    driver, which builds the GCM from the mesh first; the records within
    PROFILE_TOL of one process's."""
    tmp = cli_bands["tmp"]
    for r, rep in enumerate(cli_bands["dummy_b"]):
        assert not rep["mesh"]
        assert rep["gcm_bands"] == [2, 8 * r, 8 * r + 8]
        assert rep["gcm_rows"] == 8
    a = read_spifs(str(tmp / "dummy_1" / "spifs.nc"))
    b = read_spifs(str(tmp / "dummy_b" / "spifs.nc"))
    record_diffs(a, b)


def _one_process_checkpoint(kept, reps, odir):
    """restart.save in this process (no process group) of the state the
    ranks held as they saved (the worker's ckpt mode): the fleet's rows
    of every rank in position order, rank 0's whole GCM state, profiles
    and scalars."""
    from types import SimpleNamespace
    r0 = kept[0]
    order = np.argsort(np.concatenate([k["positions"] for k in kept]))

    def leaves(prefix, whole):
        """{"000": leaf 0, ...}: the tree of one process's state, its
        leaves in the checkpoint's order."""
        n = sum(1 for k in r0 if k.startswith(prefix + "_"))
        return {"%03d" % i: torch.as_tensor(whole("%s_%d" % (prefix, i)))
                for i in range(n)}

    fleet = leaves("les", lambda k: np.concatenate(
        [kp[k] for kp in kept])[order])
    runner = SimpleNamespace(
        gcm=SimpleNamespace(state=leaves("gcm", r0.__getitem__),
                            get_model_time=lambda: float(r0["time_gcm"]),
                            step_count=int(r0["step_gcm"])),
        fleet=SimpleNamespace(state=fleet, time=float(r0["time_fleet"]),
                              n=len(order)),
        prev_profiles=(leaves("prof", r0.__getitem__)
                       if r0["has_profiles"] else None),
        rain_last=r0["rain_last"],
        sp_cols=reps[0]["sp_cols"],
        cfg=SimpleNamespace(output_dir=str(odir)))
    odir.mkdir()
    restart.save(runner)


def test_config4_checkpoint_equals_one_process(cli_bands):
    tmp = cli_bands["tmp"]
    reps = cli_bands["config4"]
    assert all(r["rc"] == 0 for r in reps)
    kept = [dict(np.load(tmp / ("report_c4.%d.npz" % r)))
            for r in range(RANKS)]
    _one_process_checkpoint(kept, reps, tmp / "c4_one")
    with np.load(tmp / "c4" / "restart.npz") as a, \
            np.load(tmp / "c4_one" / "restart.npz") as b:
        assert a.files == b.files              # the keys, in order
        assert any(k.startswith("les_") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    with open(tmp / "c4" / "restart.json") as f, \
            open(tmp / "c4_one" / "restart.json") as g:
        assert json.load(f) == json.load(g)


def test_config4_rows_reach_rank0_alone(cli_bands):
    """sharding.rows_to_root gives rank 0 every fleet leaf of all 4
    instances and ranks 1-3 nothing; each rank holds its own instance and
    its band of 8 rows."""
    reps = cli_bands["config4"]
    given = reps[0]["rows_to_root"]
    assert len(given) == 15 and all(g[0] == 4 for g in given)  # LESState
    for r, rep in enumerate(reps):
        assert rep["positions"] == [r] and rep["held"] == 1
        assert rep["gcm_bands"] == [RANKS, 8 * r, 8 * r + 8]
        assert rep["sp_cols"] == C4_COLS
        if r:
            assert rep["rows_to_root"] == [None] * len(given)
