"""The port's run driver and CLI (``runtime/driver.py::SPRunner``,
``spmaster``) against the JAX package's.

The dummy-model tests mirror tests/test_driver.py on the port. The native
runs are T10/L8 + one 16x16x24 LES column as in tests/test_driver.py: the
JAX SPRunner and the port's start from the same state (the JAX runner's,
carried over with ``interop``) and each takes 2 coupled steps; their
spifs.nc records agree variable by variable within 2e-3 of max|ref| plus
2e-3 |ref|, the bounds of test_torch_coupling.py (f_thl 5e-2, its stated
bound there). A JAX checkpoint resumes in the port, and the port's in
JAX.
"""

import json
import os
import shutil

import numpy as np
import jax
import pytest
import torch

from sp_coupler_tpu.config import SPConfig as JConfig
from sp_coupler_tpu.io import spifs as jspifs
from sp_coupler_tpu.runtime.driver import SPRunner as JRunner
from sp_coupler_tpu.utils import geometry as jgeom
from sp_coupler_tpu_torch import interop, spmaster
from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.io import restart as trestart
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.utils import geometry, tree

torch.set_num_threads(2)

SMALL = dict(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
             les_itot=16, les_jtot=16, les_ktot=24, les_xsize=3200.0,
             les_ysize=3200.0, les_dz=100.0, les_dt=5.0, timing_phases=0)
POINT = (300.0, 15.0)
LOOSE = {"f_thl": 5e-2}


def dummy_cfg(tmp_path, **kw):
    base = dict(gcm_type="dummy", les_type="dummy",
                output_dir=str(tmp_path / "out"))
    base.update(kw)
    return SPConfig(**base)


def read_spifs(path):
    """{group: {var: array}} and the Time axis of a spifs.nc, through the
    JAX package's reader."""
    ds = jspifs.open_reader(path)
    try:
        groups = {name: {k: np.asarray(v[...])
                         for k, v in g.variables.items()}
                  for name, g in ds.groups.items()}
        return groups, np.asarray(ds.variables["Time"][:])
    finally:
        ds.close()


def assert_records_close(got, ref, records=slice(None)):
    """Every variable of every group of ref in got, within the bounds of
    the module docstring, over the given records."""
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert sorted(got[name]) == sorted(ref[name]), name
        for var, b in ref[name].items():
            a = got[name][var]
            assert a.shape == b.shape, (name, var)
            if a.ndim:
                a, b = a[records], b[records]
            assert np.all(np.isfinite(a)), (name, var)
            scale = max(float(np.max(np.abs(b), initial=0.0)), 1e-12)
            np.testing.assert_allclose(
                a, b, rtol=2e-3, atol=LOOSE.get(var, 2e-3) * scale,
                err_msg="%s/%s" % (name, var))


# ---- dummy models (tests/test_driver.py:59-127 on the port) ---------------

class TestDummyLoop:
    def test_initialize_run_finalize(self, tmp_path):
        cfg = dummy_cfg(tmp_path)
        geoms = [geometry.Point((45.0, 10.0)), geometry.Point((90.0, -30.0))]
        r = SPRunner(cfg, geoms, device="cpu")
        r.initialize()
        assert len(r.sp_cols) == 2
        r.run(5)
        r.finalize()
        groups, times = read_spifs(cfg.output_path)
        assert len(times) == 5
        for col in r.sp_cols:
            g = groups[str(col)]
            assert g["T"].shape == (5, 20)
            assert np.all(np.isfinite(g["T"][1:]))
            assert g["thl"].shape[1] == 20
            assert g["f_U"].shape == (5, 20)
        lines = open(os.path.join(cfg.output_dir, "timing.txt")).readlines()
        assert lines[0].startswith("# LES grid points")
        assert len([ln for ln in lines if not ln.startswith("#")]) == 5 + 1

    def test_output_columns(self, tmp_path):
        cfg = dummy_cfg(tmp_path)
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))],
                     [geometry.Point((200.0, 40.0))], device="cpu")
        r.initialize()
        assert len(r.output_cols) == 1
        r.run(2)
        r.finalize()
        g = read_spifs(cfg.output_path)[0][str(r.output_cols[0])]
        assert "T" in g and "thl" not in g
        assert np.isfinite(g["T"][1]).all()

    def test_existing_output_dir_rejected(self, tmp_path):
        cfg = dummy_cfg(tmp_path)
        os.makedirs(cfg.output_dir)
        with open(os.path.join(cfg.output_dir, "old.nc"), "w") as f:
            f.write("x")
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))], device="cpu")
        with pytest.raises(RuntimeError):
            r.initialize()

    def test_dryrun(self, tmp_path):
        cfg = dummy_cfg(tmp_path, dryrun=True)
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))], device="cpu")
        r.initialize()
        pts = np.loadtxt(os.path.join(cfg.output_dir, "gridpoints.txt"))
        assert pts.shape == (800, 2)

    def test_no_sp_columns(self, tmp_path):
        cfg = dummy_cfg(tmp_path)
        r = SPRunner(cfg, [], device="cpu")
        r.initialize()
        r.run(2)
        r.finalize()

    def test_write_every_two(self, tmp_path):
        cfg = dummy_cfg(tmp_path, write_every=2)
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))], device="cpu")
        r.initialize()
        r.run(4)
        r.finalize(save_restart=False)
        assert len(read_spifs(cfg.output_path)[1]) == 2

    def test_periodic_restart(self, tmp_path):
        """restart_steps=1 writes a checkpoint after every step; a resumed
        run starts from the last one (the dummy models keep only the
        fleet clock, the LES profiles and the rain)."""
        cfg = dummy_cfg(tmp_path, restart_steps=1)
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))], device="cpu")
        r.initialize()
        r.run(1)
        path = os.path.join(cfg.output_dir, trestart.FNAME)
        assert os.path.exists(path)
        r.run(1)
        r.finalize(save_restart=False)
        meta = json.load(open(os.path.join(cfg.output_dir, trestart.META)))
        assert meta["fleet_time"] == r.fleet.time == 1200.0
        r2 = SPRunner(cfg.replace(restart=True),
                      [geometry.Point((45.0, 10.0))], device="cpu")
        r2.initialize()
        assert r2.fleet.time == 1200.0
        np.testing.assert_array_equal(r2.rain_last, r.rain_last)
        np.testing.assert_array_equal(r2.prev_profiles["THL"],
                                      r.prev_profiles["THL"])
        r2.finalize(save_restart=False)

    def test_profile_writes_a_trace(self, tmp_path):
        """jax_profile (--profile) traces the second step with
        torch.profiler into ODIR/torch_trace.json."""
        cfg = dummy_cfg(tmp_path, jax_profile=True)
        r = SPRunner(cfg, [geometry.Point((45.0, 10.0))], device="cpu")
        r.initialize()
        r.run(2)
        r.finalize(save_restart=False)
        with open(os.path.join(cfg.output_dir, "torch_trace.json")) as f:
            assert "traceEvents" in json.load(f)

    def test_dummy_records_match_jax(self, tmp_path):
        """The generic path of both drivers on the dummy models writes the
        same records (the models are the same numpy code)."""
        out = {}
        for name, cfg_cls, runner, geom in (
                ("jax", JConfig, JRunner, jgeom),
                ("port", SPConfig, SPRunner, geometry)):
            cfg = cfg_cls(gcm_type="dummy", les_type="dummy", cplsurf=True,
                          output_dir=str(tmp_path / name))
            kw = {"device": "cpu"} if name == "port" else {}
            r = runner(cfg, [geom.Point((45.0, 10.0))],
                       [geom.Point((200.0, 40.0))], **kw)
            r.initialize()
            r.run(3)
            r.finalize(save_restart=False)
            out[name] = read_spifs(cfg.output_path)
        assert np.array_equal(out["port"][1], out["jax"][1])
        assert_records_close(out["port"][0], out["jax"][0])


class TestFailureDetection:
    def test_check_finite_profiles_raises_and_names_column(self, tmp_path):
        r = SPRunner(SPConfig(output_dir=str(tmp_path / "out")),
                     device="cpu")
        r.sp_cols = [3, 17]
        prof = {"THL": np.array([[300.0, 301.0], [300.0, np.nan]])}
        with pytest.raises(FloatingPointError, match="17"):
            r._check_finite_profiles(prof)

    def test_check_finite_disabled(self, tmp_path):
        r = SPRunner(SPConfig(output_dir=str(tmp_path / "out"),
                              check_finite=False), device="cpu")
        r.sp_cols = [3]
        r._check_finite_profiles({"THL": np.array([[np.nan]])})


# ---- the CLI ---------------------------------------------------------------

def test_spmaster_main_dummy(tmp_path):
    odir = str(tmp_path / "out")
    rc = spmaster.main(["--gcmtype", "dummy", "--lestype", "dummy",
                        "--steps", "2", "--points", "10", "45",
                        "--device", "cpu", "--odir", odir])
    assert rc == 0
    groups, times = read_spifs(os.path.join(odir, "spifs.nc"))
    assert len(times) == 3 and len(groups) == 1      # steps + 1 (overlap)
    for f in ("timing.txt", "restart.npz", "restart.json"):
        assert os.path.exists(os.path.join(odir, f)), f


def test_device_defaults_to_the_card(tmp_path):
    """No device named: the card, or a RuntimeError where there is none
    (the CLI the same, before anything runs)."""
    cfg = dummy_cfg(tmp_path)
    argv = ["--gcmtype", "dummy", "--lestype", "dummy", "--odir",
            str(tmp_path / "cli")]
    if torch.cuda.is_available():
        assert SPRunner(cfg).device.type == "cuda"
        assert spmaster.build_runner(argv).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cpu"):
            SPRunner(cfg)
        with pytest.raises(RuntimeError, match="cpu"):
            spmaster.main(argv)
        assert not os.path.exists(str(tmp_path / "cli"))


@pytest.mark.parametrize("kw, entry", [
    (dict(mesh_les=2), "multi-device and multi-process"),
    (dict(les_num_procs=4), "multi-device and multi-process"),
    (dict(gcm_num_procs=2), "multi-device and multi-process"),
])
def test_unported_settings_raise(tmp_path, kw, entry):
    base = dict(SMALL, output_dir=str(tmp_path / "out"))
    base.update(kw)
    r = SPRunner(SPConfig(**base), [geometry.Point(POINT)], device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, open items: " + entry):
        r.initialize()


@pytest.mark.parametrize("kw, advection", [
    (dict(gcm_advection="sl"), "sl"),
    (dict(gcm_truncation=63), "sl"),          # auto -> SL at T >= 63
    (dict(gcm_hybrid=True), "eulerian"),
])
def test_gcm_settings_run_in_driver(tmp_path, kw, advection):
    """The GCM settings the port once refused run through SPRunner: 2
    coupled steps with the dummy LES from the JAX runner's start state,
    whose spifs.nc records match the JAX driver's (the bounds of the
    module docstring). At T63 the GCM has 4 levels, the fewest that keep
    the two runs inside ~30 s."""
    cfg = dict(SMALL, les_type="dummy", **kw)
    if "gcm_truncation" in kw:
        cfg["gcm_levels"] = 4
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jr = JRunner(JConfig(output_dir=jdir, **cfg), [jgeom.Point(POINT)])
    jr.initialize()
    start = _np(jr.gcm.state)
    jr.run(2)
    jr.finalize()
    r = SPRunner(SPConfig(output_dir=tdir, **cfg), [geometry.Point(POINT)],
                 device="cpu")
    r.initialize()
    assert r.gcm.cfg.advection == jr.gcm.cfg.advection == advection
    assert r.gcm.cfg.hybrid == jr.gcm.cfg.hybrid == cfg.get("gcm_hybrid",
                                                            False)
    assert r.sp_cols == jr.sp_cols
    r.gcm.state = interop.gcm_state(start, "cpu")
    r.run(2)
    r.finalize()
    got, t_got = read_spifs(os.path.join(tdir, "spifs.nc"))
    ref, t_ref = read_spifs(os.path.join(jdir, "spifs.nc"))
    assert len(t_ref) == 2 and np.array_equal(t_got, t_ref)
    assert_records_close(got, ref)


# ---- native runs against the JAX driver -----------------------------------

def _np(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX driver: initialize, 2 coupled steps, finalize with a
    checkpoint. Keeps the state it started the steps from."""
    d = str(tmp_path_factory.mktemp("jax") / "run")
    cfg = JConfig(output_dir=d, **SMALL)
    r = JRunner(cfg, [jgeom.Point(POINT)])
    r.initialize()
    start = dict(gcm=_np(r.gcm.state), les=_np(r.fleet.state))
    r.run(2)
    r.finalize(save_restart=True)
    return dict(dir=d, start=start, cols=r.sp_cols, cfg=cfg)


def _port_run(jax_run, d, generic=False, **kw):
    """The port's driver from the JAX runner's start state: initialize,
    carry the state over, 2 coupled steps (through the generic path where
    asked), finalize with a checkpoint."""
    r = SPRunner(SPConfig(output_dir=d, **dict(SMALL, **kw)),
                 [geometry.Point(POINT)], device="cpu")
    r.initialize()
    r.gcm.state = interop.gcm_state(jax_run["start"]["gcm"], "cpu")
    r.fleet.state = interop.les_state(jax_run["start"]["les"], "cpu")
    if generic:
        r.coupled = None
    r.run(2)
    r.finalize(save_restart=True)
    return r


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port") / "run")
    r = _port_run(jax_run, d)
    return dict(dir=d, runner=r)


def test_native_run_matches_jax(jax_run, port_run):
    assert port_run["runner"].sp_cols == jax_run["cols"]
    got, t_got = read_spifs(os.path.join(port_run["dir"], "spifs.nc"))
    ref, t_ref = read_spifs(os.path.join(jax_run["dir"], "spifs.nc"))
    assert len(t_ref) == 2 and np.array_equal(t_got, t_ref)
    assert_records_close(got, ref)
    thl = ref[str(jax_run["cols"][0])]["thl"]
    assert thl.shape == (2, 24) and np.all((thl > 200) & (thl < 400))


def test_timing_phases_same_trajectory(jax_run, port_run, tmp_path):
    """timing_phases=1 runs step 1 through call_phased: the same records
    as timing_phases=0, and phase columns on that step's timing line."""
    d = str(tmp_path / "phased")
    _port_run(jax_run, d, timing_phases=1)
    a, _ = read_spifs(os.path.join(d, "spifs.nc"))
    b, _ = read_spifs(os.path.join(port_run["dir"], "spifs.nc"))
    for name in b:
        for var in b[name]:
            np.testing.assert_array_equal(a[name][var], b[name][var],
                                          err_msg=var)
    rows = [ln.split() for ln in open(os.path.join(d, "timing.txt"))
            if not ln.startswith("#")][1:]
    assert len(rows) == 2
    assert float(rows[0][1]) == 0.0 and float(rows[0][5]) == 0.0
    assert float(rows[1][1]) > 0.0 and float(rows[1][5]) > 0.0


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """JAX writes restart.npz; the port resumes from it as JAX does: one
    overlap step written nowhere, then one record that matches JAX's."""
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(jax_run["dir"], d)
    rj = JRunner(jax_run["cfg"].replace(restart=True, output_dir=dirs["jax"]),
                 [jgeom.Point(POINT)])
    rj.initialize()
    rj.run(2)
    rj.finalize(save_restart=False)
    rt = SPRunner(SPConfig(restart=True, output_dir=dirs["port"], **SMALL),
                  [geometry.Point(POINT)], device="cpu")
    rt.initialize()
    meta = json.load(open(os.path.join(dirs["port"], trestart.META)))
    assert rt.gcm.get_model_time() == meta["gcm_time"] == 1200.0
    assert rt.gcm.step_count == meta["gcm_step"] == 2
    assert not rt.gcm._first and rt.fleet.time == meta["fleet_time"]
    rt.run(2)
    # a second load finds the fleet state in place (restart.py's
    # fleet.state-is-not-None branch) and puts the checkpoint back
    trestart.load(rt)
    with np.load(os.path.join(dirs["port"], trestart.FNAME)) as data:
        leaves = tree.flatten(rt.fleet.state)[0]
        for i, leaf in enumerate(leaves):
            np.testing.assert_array_equal(leaf.numpy(), data["les_%d" % i])
    rt.finalize(save_restart=False)
    got, t_got = read_spifs(os.path.join(dirs["port"], "spifs.nc"))
    ref, t_ref = read_spifs(os.path.join(dirs["jax"], "spifs.nc"))
    assert len(t_ref) == 3 and np.array_equal(t_got, t_ref)
    assert_records_close(got, ref)


def test_port_checkpoint_resumes_in_jax(port_run, tmp_path):
    """The port's restart.npz loads into the JAX driver: every leaf of the
    GCM and LES state lands where the port had it."""
    d = str(tmp_path / "jax")
    shutil.copytree(port_run["dir"], d)
    rj = JRunner(JConfig(restart=True, output_dir=d, **SMALL),
                 [jgeom.Point(POINT)])
    rj.initialize()
    rt = port_run["runner"]
    assert rj.gcm.get_model_time() == rt.gcm.get_model_time()
    assert rj.gcm.step_count == rt.gcm.step_count
    for j_state, t_state in ((rj.gcm.state, rt.gcm.state),
                             (rj.fleet.state, rt.fleet.state)):
        j_leaves = jax.tree.leaves(j_state)
        t_leaves = [x.numpy() for x in tree.flatten(t_state)[0]]
        assert len(j_leaves) == len(t_leaves)
        for a, b in zip(j_leaves, t_leaves):
            np.testing.assert_array_equal(np.asarray(a), b)
    rj.finalize(save_restart=False)


def test_generic_path_matches_fused(jax_run, tmp_path):
    """The generic path (the models' duck-typed calls, as dummy and mixed
    model types run) with the native models gives the fused path's
    records, with surface coupling and the nudge on (tests/test_driver.py
    ::TestFusedVsGeneric on the port, at its 5e-3 of max|ref|)."""
    out = {}
    for generic in (False, True):
        d = str(tmp_path / ("generic" if generic else "fused"))
        _port_run(jax_run, d, generic=generic, cplsurf=True,
                  qt_forcing="variance")
        out[generic] = read_spifs(os.path.join(d, "spifs.nc"))[0]
    col = str(jax_run["cols"][0])
    fus, gen = out[False][col], out[True][col]
    for var in ("thl", "qt", "f_T", "f_SH", "f_u", "f_thl", "A_d", "z0m",
                "wthl", "wqt", "SHflux", "TSflux", "qt_alpha", "qt_beta",
                "qt_std"):
        a, b = gen[var], fus[var]
        assert a.shape == b.shape and np.all(np.isfinite(a)), var
        scale = max(np.abs(a).max(), np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() <= 5e-3 * scale + 1e-9, var
    assert np.all(fus["wthl"] != 0.0)
    assert np.all(fus["qt_beta"][1] != 0.0)    # the nudge ran on step 2


def test_spinup_then_fused(tmp_path):
    """les_spinup: the fleet is nudged toward the frozen GCM state in
    spinup_steps records before the first coupled step."""
    cfg = SPConfig(output_dir=str(tmp_path / "out"), les_spinup=60.0,
                   les_spinup_steps=2, **SMALL)
    r = SPRunner(cfg, [geometry.Point(POINT)], device="cpu")
    r.initialize()
    assert r.fleet.time == 0.0
    r.run(1)
    r.finalize(save_restart=False)
    groups, times = read_spifs(cfg.output_path)
    assert len(times) == 3 and np.all(np.diff(times) > 0)
    assert np.all(np.isfinite(groups[str(r.sp_cols[0])]["thl"]))


def test_cold_start_from_prof(tmp_path):
    """init_les_state=False + a DALES deck: the fleet starts from prof.inp
    (tests/test_decks.py::test_driver_cold_start_from_prof)."""
    from test_decks import write_case
    les, _ = write_case(tmp_path)
    cfg = SPConfig(output_dir=str(tmp_path / "out"), init_les_state=False,
                   les_input_dir=les, **SMALL)
    r = SPRunner(cfg, [geometry.Point(POINT)], device="cpu")
    r.initialize()
    thl = r.fleet.get_profiles()["THL"].numpy()
    z = np.arange(48) * 50.0 + 25.0
    ref = np.interp(r.fleet.get_zf(), z, 298.0 + 0.006 * z)
    np.testing.assert_allclose(thl[0], ref, atol=0.2)


# ---- chip_smoke.py's CLI phase: the parts that run on the CPU ------------

def test_memory_writer_keeps_the_records(tmp_path):
    """chip_smoke.MemoryWriter (the CLI phase's writer where h5py is
    missing) holds what spifs.nc holds, a restarted run appending."""
    import types
    import chip_smoke as cs
    out = {}
    for name, writer in (("file", None), ("memory", cs.MemoryWriter)):
        cfg = dummy_cfg(tmp_path / name, cplsurf=True)
        for restart in (False, True):
            r = SPRunner(cfg.replace(restart=restart),
                         [geometry.Point((45.0, 10.0))], device="cpu",
                         writer=writer)
            r.initialize()
            r.run(2)
            r.finalize()
        out[name] = (cs.read_records(cfg.output_path) if writer
                     else read_spifs(cfg.output_path)[::-1])
    (t_mem, g_mem), (t_file, g_file) = out["memory"], out["file"]
    assert t_mem == list(t_file) and len(t_mem) == 3
    col = r.sp_cols[0]
    assert sorted(g_mem) == [col]
    for var, a in g_mem[col].items():
        np.testing.assert_array_equal(a, g_file[str(col)][var], err_msg=var)
    # launches are 3 x substeps: summed over a serial fleet's instances,
    # the slowest instance's for a batched one
    run = lambda serial: types.SimpleNamespace(
        fleet=types.SimpleNamespace(serial=serial),
        substeps=[[3, 2], [4, 4]])
    ok = dict(lesstage=0, lesflat=21, lesmom=21, advect=0)
    cs.check_leg_launches("t", run(False), ok, ("lesflat", "lesmom"))
    cs.check_leg_launches("t", run(True), dict(ok, lesflat=39, lesmom=39),
                          ("lesflat", "lesmom"))
    with pytest.raises(AssertionError, match="want 39"):
        cs.check_leg_launches("t", run(True), ok, ("lesflat", "lesmom"))
