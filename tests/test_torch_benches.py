"""The port's last entry points against the JAX package's, on the CPU:
``substep(skip_projection=)``, ``sp_coupler_tpu_torch/bench.py`` (root
``bench.py``), ``runtime/schedulebench.py`` (``scripts/bench_schedule.py``),
``runtime/batchbench.py`` (``scripts/bench_batch.py``) and
``runtime/t159bench.py`` (``scripts/bench_t159.py``), and the bounds of
``ops/bounds.py``. The scripts' starts, loops and column picks are their
own lines, cut from the files and run as they are; their JSON keys are
read from the files' syntax trees. LES at 16x16x32 (the bench's GCM at
T10/L8, t159bench's at T21/L8); ~70 s with 2 threads, most of it the
bench's three coupled steps, the fleet loops and JAX's compiles of them.
"""

import ast
import importlib.util
import json
import os
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.models.gcm import spharm as jsph
from sp_coupler_tpu.models.les import (grid as jgrid, poisson as jpois,
                                       state as jstate, step as jstep)
from sp_coupler_tpu.models.les.state import LESForcing as JForcing
from sp_coupler_tpu_torch import bench, interop
from sp_coupler_tpu_torch.models.gcm import spharm as tsph
from sp_coupler_tpu_torch.models.les import grid as tgrid, step as tstep
from sp_coupler_tpu_torch.ops import bounds
from sp_coupler_tpu_torch.runtime import batchbench, schedulebench, t159bench

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NZ = 32
JG = jgrid.LESGrid(nx=16, ny=16, nz=NZ)
TG = tgrid.LESGrid(nx=16, ny=16, nz=NZ)
# fields after an evolve or a run of substeps: 2e-3 of max|ref| plus rtol
# 2e-3 (tests/test_torch_les.py::test_evolve_adaptive_substep_counts,
# JAX's own fused-against-split check, tests/test_ops.py:228-232)
FIELD_FRAC = 2e-3
# kmax of the last stage: rtol 1e-3 (tests/test_ops.py:233). Under
# Smagorinsky it is held against JAX's substep run in float64 from the
# same state: Km = max(...) sqrt(1 - Ri/Ri_c) is steep near its clip, where
# the unprojected winds of the skipped run leave Ri, and JAX's float32 kmax
# is 2.0e-3 off its own float64 run there (the port's 2.2e-4), while the
# two packages' float64 runs agree to 2e-7 (test_substep_skip_projection_
# float64_matches_jax)
KMAX_RTOL = 1e-3
# the float64 runs of both packages: kmax and the fields (the grid's
# heights are float32 in both)
F64_RTOL = 1e-5


def source(path):
    return open(os.path.join(ROOT, path)).read()


def script_lines(path, first, last):
    """The statements of the script from the line holding first to the
    next line holding last, dedented."""
    lines = source(path).splitlines()
    i0 = next(i for i, ln in enumerate(lines) if first in ln)
    i1 = next(i for i, ln in enumerate(lines) if i >= i0 and last in ln)
    return textwrap.dedent("\n".join(lines[i0:i1 + 1]))


def run_lines(path, first, last, **ns):
    """script_lines run in the namespace ns; returns the namespace."""
    exec(compile(script_lines(path, first, last), path, "exec"), ns)
    return ns


def close_fields(got, ref, names=("u", "v", "w", "thl", "qt", "qr", "e12",
                                  "time")):
    """Port LESState got against JAX LESState ref (fleet or one instance)
    at FIELD_FRAC of each field's max|ref|."""
    for f in names:
        b = np.asarray(getattr(ref, f))
        a = getattr(got, f).numpy().reshape(b.shape)
        scale = max(float(np.max(np.abs(b))), 1e-12)
        np.testing.assert_allclose(a, b, atol=FIELD_FRAC * scale,
                                   rtol=FIELD_FRAC, err_msg=f)


def to_port(state, forcing):
    return (interop.les_state(jax.tree.map(np.asarray, state), "cpu"),
            interop.les_forcing(jax.tree.map(np.asarray, forcing), "cpu"))


# ---- substep(skip_projection=) -------------------------------------------

@pytest.fixture(scope="module")
def one_instance():
    """A JAX state (u 4, v -2 m/s; w, qr, e12 perturbed) and forcing."""
    rng = np.random.default_rng(13)
    st = jstate.init_state(
        JG, jnp.full(NZ, 4.0), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(3))
    st = st._replace(
        w=st.w.at[1:-1].set(jnp.asarray(
            rng.normal(0, 0.1, (NZ - 1, JG.ny, JG.nx)), jnp.float32)),
        qr=jnp.asarray(rng.uniform(0, 1e-4, (NZ, JG.ny, JG.nx)),
                       jnp.float32),
        e12=jnp.asarray(rng.uniform(0.05, 0.3, (NZ, JG.ny, JG.nx)),
                        jnp.float32))
    frc = JForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        z0m=jnp.asarray(0.1), z0h=jnp.asarray(0.02))
    return st, frc


# (subgrid, kernel): the fused branch (the port's stage kernel module, its
# plain version here; JAX's Pallas stage in interpret mode) and the split
# branch with Smagorinsky, through the kernel modules and without them
BRANCHES = [("tke", True), ("smagorinsky", True), ("smagorinsky", False)]


def as_f64(tree):
    """A JAX state or forcing with its float32 leaves in float64 (under
    jax.enable_x64)."""
    return jax.tree.map(
        lambda a: (jnp.asarray(np.asarray(a), jnp.float64)
                   if np.asarray(a).dtype == np.float32 else a), tree)


def jax_skip64(st, frc, subgrid, kernel, dt):
    """JAX's substep(skip_projection=True) in float64 from st, frc."""
    with jax.enable_x64(True):
        ref, kmax = jstep.substep(
            JG, jstep.LESPhysics(subgrid=subgrid, use_pallas=kernel),
            as_f64(st), as_f64(frc), jnp.float64(dt), skip_projection=True)
        return jax.tree.map(np.asarray, ref), float(kmax)


@pytest.mark.parametrize("subgrid, kernel", BRANCHES)
def test_substep_skip_projection_matches_jax(one_instance, subgrid, kernel):
    """substep(skip_projection=True) == JAX's from one state: the fields,
    rain and ustar at FIELD_FRAC of max|ref|, kmax at KMAX_RTOL (under
    Smagorinsky against JAX's float64 run); w keeps its nz + 1 faces."""
    st, frc = one_instance
    dt = 2.0
    ref, k_ref = jstep.substep(
        JG, jstep.LESPhysics(subgrid=subgrid, use_pallas=kernel), st, frc,
        dt, skip_projection=True)
    ts, tf = to_port(st, frc)
    got, k_got = tstep.substep(
        TG, tstep.LESPhysics(subgrid=subgrid, use_kernel=kernel), ts, tf,
        torch.tensor([dt]), skip_projection=True)
    assert tuple(got.w.shape) == (1, NZ + 1, 16, 16)
    close_fields(got, ref, ("u", "v", "w", "thl", "qt", "qr", "e12", "rain",
                            "ustar", "time"))
    if subgrid == "smagorinsky":
        k_ref = jax_skip64(st, frc, subgrid, kernel, dt)[1]
    assert float(k_ref) > 0
    np.testing.assert_allclose(k_got.numpy(), [float(k_ref)],
                               rtol=KMAX_RTOL)


@pytest.mark.parametrize("kernel", [True, False])
def test_substep_skip_projection_float64_matches_jax(one_instance, kernel):
    """The Smagorinsky branch in float64 in both packages from one state:
    kmax and the fields at F64_RTOL, so the float32 runs' kmax gap (JAX's
    2.0e-3, the port's 2.2e-4 from float64) is rounding."""
    st, frc = one_instance
    dt = 2.0
    ref, k_ref = jax_skip64(st, frc, "smagorinsky", kernel, dt)
    ts, tf = to_port(st, frc)
    f64 = lambda t: t._replace(**{
        f: v.double() for f, v in t._asdict().items()
        if torch.is_tensor(v) and v.dtype == torch.float32})
    got, k_got = tstep.substep(
        TG, tstep.LESPhysics(subgrid="smagorinsky", use_kernel=kernel),
        f64(ts), f64(tf), torch.tensor([dt], dtype=torch.float64),
        skip_projection=True)
    assert got.u.dtype == torch.float64 and ref.u.dtype == np.float64
    np.testing.assert_allclose(k_got.numpy(), [k_ref], rtol=F64_RTOL)
    for f in ("u", "v", "w", "thl", "qt", "qr", "e12"):
        b = getattr(ref, f)
        np.testing.assert_allclose(
            getattr(got, f).numpy().reshape(b.shape), b, rtol=F64_RTOL,
            atol=F64_RTOL * float(np.max(np.abs(b))), err_msg=f)


@pytest.mark.parametrize("subgrid, kernel", BRANCHES)
def test_substep_default_keeps_the_projection(one_instance, subgrid,
                                              kernel):
    """skip_projection=False is the default call bit for bit; it projects
    (the divergence falls far below the skipped run's) and skipping
    changes only the winds, by the pressure correction."""
    from sp_coupler_tpu_torch.models.les import advect
    st, frc = one_instance
    ts, tf = to_port(st, frc)
    phys = tstep.LESPhysics(subgrid=subgrid, use_kernel=kernel)
    dt = torch.tensor([2.0])
    plain, k_plain = tstep.substep(TG, phys, ts, tf, dt)
    off, k_off = tstep.substep(TG, phys, ts, tf, dt, skip_projection=False)
    skip, _ = tstep.substep(TG, phys, ts, tf, dt, skip_projection=True)
    for a, b in zip(plain, off):
        assert torch.equal(a, b)
    assert torch.equal(k_plain, k_off)
    div = lambda s: float(advect.divergence(TG, s.rhobf, s.rhobh, s.u, s.v,
                                            s.w).abs().max())
    assert div(plain) < 1e-3 * div(skip)
    assert not torch.equal(plain.u, skip.u)
    assert torch.equal(plain.time, skip.time)


# ---- bench.py ------------------------------------------------------------

# the one key renamed from the script's: "VPU" names a TPU unit; the port
# gives the stage's float32 operations against the H100's float32 peak
RENAMED = {"vpu_util_est": "f32_op_frac", "vpu_model": "op_model"}


def jax_bench_keys():
    """The keys of bench.py's JSON line: its json.dumps dict's own keys,
    then phase_breakdown's ``out`` (renamed by RENAMED); and the keys of
    ``phase_ms``."""
    tree = ast.parse(source("bench.py"))
    line = out = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            line = [k.value for k in node.args[0].keys if k is not None]
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["out"]):
            out = node.value
    phase_ms = next(v for k, v in zip(out.keys, out.values)
                    if k.value == "phase_ms")
    return (line + [RENAMED.get(k.value, k.value) for k in out.keys],
            [k.value for k in phase_ms.keys])


def jax_bench_module():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_line_has_the_scripts_keys(capsys):
    """Two warm and one timed coupled step at T10/L8 + 2 x 16x16x32 (two
    tropical columns) and a phase breakdown of 2 substeps: one printed
    JSON line with bench.py's keys, finite profiles, the substeps of every
    part counted."""
    args = bench.parser().parse_args(
        ["--timed", "1", "--nscan", "2", "--reps", "1", "--trunc", "10",
         "--nlev", "8", "--cols", "248", "280", "--nx", "16", "--ny", "16",
         "--nz", "32", "--device", "cpu"])
    line, extras = bench.run(args, torch.device("cpu"))
    keys, phase_keys = jax_bench_keys()
    assert list(line) == keys
    assert list(line["phase_ms"]) == phase_keys
    assert line["metric"] == "les_gridpoint_updates_per_s_per_chip"
    assert line["value"] > 0
    assert bench.REF_GRIDPOINTS_PER_S == jax_bench_module(
        ).REF_GRIDPOINTS_PER_S
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / bench.REF_GRIDPOINTS_PER_S)
    sub = extras["substeps"]
    assert sub["warm"] >= 2 and sub["timed"] >= 2
    assert sub["breakdown"] == 2 * (1 + 1) * 2
    assert "%d total substeps" % sub["timed"] in line["unit"]
    assert line["unit"].startswith("gridpoint-updates/s (T10+2xLES 16x16x32")
    assert line["value"] == pytest.approx(
        16 * 16 * 32 * sub["timed"] / float(
            line["unit"].split("step ")[1].split("s,")[0]), rel=1e-2)
    ph = line["phase_ms"]
    if ph["substep"] >= ph["stage_x3"]:
        assert ph["stage_x3"] + ph["projection_x3"] == pytest.approx(
            ph["substep"], rel=1e-12)
    else:
        assert ph["projection_x3"] == 0.0
    assert "1160" in line["op_model"]
    port_src = source("sp_coupler_tpu_torch/bench.py")
    assert "819" not in port_src and "VPU" not in port_src
    for k in ("THL", "QT"):
        p = extras["prof"][k]
        assert tuple(p.shape) == (2, 32) and bool(torch.isfinite(p).all())
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == [json.dumps(line)]


@pytest.mark.parametrize("full, skip", [(1.0, 0.6), (1.0, 1.2)])
def test_phase_breakdown_differential(monkeypatch, full, skip):
    """With a substep that costs `full` seconds and `skip` seconds without
    the projection (a fake clock): substep = full, stage_x3 = skip, and
    projection_x3 = full - skip, or 0 where skipping is the slower; the
    two loops run (1 warm + reps) x nscan substeps each."""
    now = [0.0]
    seen = []

    def fake_substep(grid, phys, s, f, dt, solver=None, plane=None,
                     skip_projection=False):
        seen.append(skip_projection)
        now[0] += skip if skip_projection else full
        return s, None

    monkeypatch.setattr(bench, "clock", lambda device: now[0])
    monkeypatch.setattr(bench.lstep, "substep", fake_substep)
    state, _ = schedulebench.fleet(TG, "cpu", torch.tensor([3.0, 5.0]))
    out, n = bench.phase_breakdown(TG, tstep.LESPhysics(), state, nscan=4,
                                   reps=3)
    assert n == len(seen) == 2 * 4 * 4
    assert seen == [False] * 16 + [True] * 16
    ph = out["phase_ms"]
    assert ph["substep"] == pytest.approx(1e3 * full)
    assert ph["stage_x3"] == pytest.approx(1e3 * skip)
    assert ph["projection_x3"] == pytest.approx(1e3 * max(full - skip, 0))
    pts = 2 * 16 * 16 * 32
    assert out["f32_op_frac"] == pytest.approx(
        3 * pts * 1160 / skip / 67e12)
    sub_gb = 2 * 16 * 16 * 32 * 4 / 1e9 * 3 * (7 * 1.5 + 14 + 34)
    assert out["hbm_gbs"] == pytest.approx(sub_gb / full)
    assert out["hbm_frac"] == pytest.approx(sub_gb / full * 1e9 / 3.35e12)


# ---- bench_schedule.py ---------------------------------------------------

@pytest.fixture(scope="module")
def schedule_fleet():
    """The script's fleet (its own lines) at 16x16x32, JAX-built."""
    ns = run_lines("scripts/bench_schedule.py", "keys = jax.random.split",
                   "z0h=zs + 0.02)", jax=jax, jnp=jnp, lstate=jstate,
                   LESForcing=JForcing, grid=JG, N_LES=4)
    return ns["st"], ns["forcing"]


def test_schedulebench_matches_jax(schedule_fleet):
    """Both schedules from JAX's start (one rep: thl + 1e-4): the
    substeps of each instance equal JAX's map_fleet(evolve_adaptive),
    run by the script's lines, in both; the fields at FIELD_FRAC of
    max|ref|; a spread of substeps across the fleet."""
    st, frc = schedule_fleet
    ts, tf = to_port(st, frc)
    res = schedulebench.run(TG, ts, tf, reps=1)
    start = st._replace(thl=st.thl + 1e-4)
    for serial in (False, True):
        ns = run_lines("scripts/bench_schedule.py",
                       "one = lambda s, f: lstep.evolve_adaptive(",
                       "fn = jax.jit(", jax=jax, lstep=jstep, grid=JG,
                       phys=jstep.LESPhysics(), SPAN=schedulebench.SPAN,
                       serial=serial)
        s_j, n_j, _ = ns["fn"](start, frc)
        got = res["serial" if serial else "batched"]
        assert got["substeps"] == np.asarray(n_j).tolist()
        close_fields(got["state"], s_j)
    nsub = res["batched"]["substeps"]
    assert max(nsub) >= 2 * min(nsub)
    assert res["speedup"] == pytest.approx(
        res["batched"]["s"] / res["serial"]["s"])


def test_schedulebench_start_is_the_same_on_every_device():
    """The fleet's start comes from CPU generators keyed (0, i): each
    instance's start is that of a fleet of one, drawn alone."""
    st4, f4 = schedulebench.fleet(TG, "cpu")
    assert tuple(st4.u.shape) == (4, NZ, 16, 16)
    np.testing.assert_allclose(st4.u.mean(dim=(1, 2, 3)).numpy(),
                               np.linspace(3, 24, 4), atol=0.05)
    assert float(f4.wthl[0]) == pytest.approx(0.01)
    gen = schedulebench.generator(0, 2)
    r = torch.rand((1, NZ, 16, 16), generator=gen)
    assert torch.equal(st4.u[2:3], 17.0 + 0.5 * (2 * r - 1))


# ---- bench_batch.py ------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_batchbench_matches_jax(n):
    """N_SUB = 2 fixed-dt substeps of the fleet from JAX's start (the
    script's lines) == the script's vmap(scan(substep)) (its own go), at
    FIELD_FRAC of max|ref|."""
    ns = run_lines("scripts/bench_batch.py", "keys = jax.random.split",
                   "return jax.vmap(one)(st, forcing, solver)", jax=jax,
                   jnp=jnp, lstate=jstate, lstep=jstep, poisson=jpois,
                   LESForcing=JForcing, grid=JG, phys=jstep.LESPhysics(),
                   zf=JG.zf(), nz=NZ, n=n, N_SUB=2)
    ref = ns["go"](ns["st"], ns["solver"])
    ts, tf = to_port(ns["st"], ns["forcing"])
    row, got = batchbench.measure(TG, ts, tf, n_sub=2, reps=1)
    close_fields(got, ref)
    assert row["n_les"] == n and row["updates_per_s"] > 0
    assert row["ms_per_substep"] > 0 and row["compile_s"] >= 0


def test_batchbench_rows():
    rows, out = batchbench.run(TG, torch.device("cpu"), sizes=(2, 3),
                               n_sub=1, reps=1)
    assert [r["n_les"] for r in rows] == [2, 3]
    assert tuple(out.u.shape) == (3, NZ, 16, 16)
    assert bool(torch.isfinite(out.thl).all())


# ---- bench_t159.py -------------------------------------------------------

class Core:
    """The part of a GCM core the column picks read."""

    def __init__(self, sht):
        self.sht, self.nlon = sht, sht.nlon


@pytest.fixture(scope="module")
def t159_cores():
    return (Core(jsph.SpectralTransform(159)),
            Core(tsph.SpectralTransform(159, device="cpu")))


@pytest.mark.parametrize("n", [1, 8, 64])
def test_t159_columns_match_the_script(t159_cores, n):
    jc, tc = t159_cores
    ns = run_lines("scripts/bench_t159.py",
                   "lats = np.asarray(core.sht.latitudes_deg())",
                   "assert len(cols) == n_les", np=np, core=jc, n_les=n)
    got = t159bench.columns(tc, n)
    assert got == ns["cols"].tolist()
    assert len(set(got)) == n


def test_t159_columns_raise_beyond_the_rows(t159_cores):
    with pytest.raises(ValueError):
        t159bench.columns(t159_cores[1], 10 ** 4)


def jax_t159_keys():
    tree = ast.parse(source("scripts/bench_t159.py"))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no JSON line in bench_t159.py")


def test_t159bench_row(capsys):
    """Two warm steps and one timed at T21/L8 + 2 x 8x8x16: the script's
    keys, finite profiles, the step records."""
    args = t159bench.parser().parse_args(
        ["batched", "--n", "2", "--steps", "1", "--trunc", "21", "--nlev",
         "8", "--nx", "8", "--ny", "8", "--nz", "16", "--device", "cpu"])
    row, extras = t159bench.run(args, torch.device("cpu"))
    assert list(row) == jax_t159_keys()
    assert row["schedule"] == "batched" and row["backend"] == "cpu"
    steps = extras["steps"]
    assert [s["first"] for s in steps] == [True, False, False]
    assert row["substeps"] == sum(steps[-1]["substeps"])
    assert row["les_updates_per_s"] == pytest.approx(
        8 * 8 * 16 * row["substeps"] / row["step_s"])
    assert bool(torch.isfinite(extras["prof"]["THL"]).all())
    assert extras["first_prof"]["THL"].shape == (2, 16)
    assert extras["cols"] == t159bench.columns(
        Core(tsph.SpectralTransform(21, device="cpu")), 2)
    out = capsys.readouterr().out
    assert "T21 + 2 LES:" in out and "schedule: batched" in out


# ---- defaults, the card rule, the bounds ----------------------------------

def test_defaults_are_the_scripts():
    a = bench.parser().parse_args([])
    assert (a.timed, a.nscan, a.reps, a.trunc, a.nlev, a.cols) == (
        3, 50, 3, 21, 19, [1208, 1272])
    assert (a.nx, a.ny, a.nz, a.device) == (64, 64, 160, None)
    a = t159bench.parser().parse_args([])
    assert (a.schedule, a.n, a.steps, a.trunc, a.nlev) == (
        "auto", 64, 2, 159, 19)
    assert (a.nx, a.ny, a.nz) == (64, 64, 160)
    a = schedulebench.parser().parse_args([])
    assert (a.reps, a.nx, a.ny, a.nz) == (3, 64, 64, 160)
    assert (schedulebench.N_LES, schedulebench.SPAN) == (4, 60.0)
    a = batchbench.parser().parse_args([])
    assert (a.sizes, a.nsub) == ([2, 8, 16, 32, 64], 20)
    assert batchbench.REPS == 2
    assert "serial pacing at 64x64x160" in " ".join(
        t159bench.parser().format_help().split())


@pytest.mark.parametrize("main", [bench.main, t159bench.main,
                                  schedulebench.main, batchbench.main],
                         ids=["bench", "t159bench", "schedulebench",
                              "batchbench"])
def test_entry_points_need_the_card_or_cpu(main):
    """Without --device each entry point takes the card, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main([])


def test_stage_bound_at_the_main_path():
    """The stage at 64x64x160, n = 1: 16.4 us, bound by bytes (55.1 MB at
    3.35 TB/s), before its 0.76 G float32 operations' 11.4 us at 67
    TFLOP/s (PERF.md §6); chip_smoke.py reads the same counts."""
    b_ms, by = bounds.bound_ms(*bounds.stage_bound(1, 160, 64, 64))
    assert by == "bytes"
    assert 1e3 * b_ms == pytest.approx(16.4, abs=0.05)
    nbytes, ops = bounds.stage_bound(1, 160, 64, 64)
    assert nbytes / 1e6 == pytest.approx(55.1, abs=0.05)
    assert 1e6 * ops / bounds.F32_OPS_PER_S == pytest.approx(11.35, abs=0.01)
    import chip_smoke
    assert chip_smoke.KERNEL_OPS is bounds.KERNEL_OPS
    assert chip_smoke.bound_ms is bounds.bound_ms
