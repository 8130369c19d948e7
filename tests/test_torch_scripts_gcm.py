"""The port's GCM scripts against the JAX package's: ``runtime/tl639.py``
(``scripts/tl639_endurance.py``), ``runtime/gcmscale.py``
(``scripts/bench_gcm_scale.py``), ``verify/held_suarez.py``,
``verify/hs_bisect.py`` and ``verify/moist_endurance.py`` (the scripts
of the same names), at T21/L19 or smaller on the CPU. The JAX scripts
are loaded from ``scripts/`` as modules and run unchanged.

Tolerances. The jets' vorticity is host float64 numpy on both sides and
must be equal bit for bit. The injection and the endurance steps start
from JAX's state carried over with ``interop.gcm_state`` and are held at
``tests/test_torch_semilag.py``'s tolerances (spectral fields 1e-4 of
max|ref|; grid fields rtol 1e-4 plus 1e-4 of max|ref|). The climate runs
(2 model days, 96 SL steps) start from JAX's initial state too; their
time-mean zonal means are held at ZONAL_TOL of max|ref| (float32
transforms summed in another order, through 96 steps; measured <= 1.1e-5
for u and <= 2.4e-7 for T), and the moist run's printed jets and daily
extrema, which the JAX script rounds to 0.1 (qmax to 1e-5), at one
rounding step.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sp_coupler_tpu.models.gcm import model as jmodel, physics as jphys
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.gcm import model as tmodel
from sp_coupler_tpu_torch.runtime import gcmscale, tl639
from sp_coupler_tpu_torch.verify import held_suarez, hs_bisect, \
    moist_endurance

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZONAL_TOL = 1e-4


def script(name):
    """scripts/<name>.py as a module."""
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(got, ref, rtol, atol_frac, msg=""):
    ref = np.asarray(ref)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


def host(tree):
    return jax.tree.map(np.asarray, tree)


# ---- TL639 endurance (at T21/L19) -------------------------------------------

TL = dict(trunc=21, nlev=19, dt=720.0)


@pytest.fixture(scope="module")
def tl_pair():
    """JAX's and the port's endurance cores at T21/L19, split_phases
    forced (the TL639 mode), and JAX's initial state of seed 1."""
    jc = jmodel.GCMCore(jmodel.GCMConfig(hybrid=True, advection="sl",
                                         split_phases=True, **TL))
    tc = tl639.build(split_phases=True, device="cpu", **TL)
    assert tc.cfg.split_phases and tc.slg.k_chunk == jc.slg.k_chunk == 1
    return jc, tc, jc.initial_state(seed=1)


def test_split_phases_from_t400():
    assert not tl639.build(trunc=10, nlev=5, device="cpu").cfg.split_phases


def test_jet_zeta_bit_for_bit(tl_pair):
    jc, tc, _ = tl_pair
    ref = script("tl639_endurance")._jet_zeta(jc, 60.0)
    got = tl639._jet_zeta(tc, 60.0)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def injected(tl_pair):
    """JAX's state with the jets injected by the JAX script's _inject, and
    the port's from the same start."""
    jc, tc, js = tl_pair
    mod = script("tl639_endurance")
    zeta = mod._jet_zeta(jc, 60.0)
    j_inj = jc.apply(mod._inject, js, jnp.asarray(zeta, jnp.float32)[..., None])
    t_inj = tl639.start(tc, 60.0, interop.gcm_state(host(js), "cpu"))
    return j_inj, t_inj


def test_inject_matches_jax(injected):
    j_inj, t_inj = injected
    for slot in ("now", "prev", "new"):
        close(getattr(t_inj, slot).vort, getattr(j_inj, slot).vort, 0.0,
              1e-4, slot)
    assert t_inj.prev is t_inj.now and t_inj.new is t_inj.now
    assert t_inj.grid is None and t_inj.sfc is None


def test_endurance_steps_match_jax(tl_pair, injected):
    """tl639.run (the Euler start, then 3 steps, each after strip) against
    the JAX script's loop on JAX's core from the same injected state."""
    jc, tc, _ = tl_pair
    j_inj, t_inj = injected
    res = tl639.run(tc, t_inj, 3)
    assert res["crash"] is None and res["bad_at"] is None
    assert [r["step"] for r in res["hist"]] == [1, 2, 3]
    strip = lambda s: s._replace(grid=None, sfc=None)
    s = jc.step(strip(j_inj), first=True)
    for _ in range(3):
        s = jc.step(strip(s))
    g = host(s.grid)
    for k in ("u", "v", "T", "q", "lnps"):
        close(getattr(res["state"].grid, k), getattr(g, k), 1e-4, 1e-4, k)
    last = res["hist"][-1]
    assert abs(last["umax"] - round(float(np.abs(g.u).max()), 1)) <= 0.1
    assert abs(last["Tmin"] - round(float(g.T.min()), 1)) <= 0.1
    assert tl639.passed(res)


def test_main_line_and_report(tmp_path, capsys):
    line = tl639.main(["--trunc", "10", "--nlev", "5", "--steps", "2",
                       "--device", "cpu", "--out", str(tmp_path / "t.md")])
    keys = ["bench", "backend", "trunc", "nlev", "dt_s", "steps", "step_s",
            "cfl_2dt", "ok"]
    assert list(line) == keys + ["init_s", "peak_gib"]
    assert line["steps"] == 2 and line["backend"] == "cpu"
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{"')]
    assert printed == [line]
    assert "**Verdict: %s**" % ("PASS" if line["ok"] else "FAIL") in \
        open(tmp_path / "t.md").read()


# ---- the GCM-scale table -----------------------------------------------------

def jax_row_keys():
    """The keys of the row dict bench_gcm_scale.bench_trunc returns."""
    src = open(os.path.join(ROOT, "scripts", "bench_gcm_scale.py")).read()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return [k.value for k in node.value.keys]
    raise AssertionError("no row dict in bench_gcm_scale.py")


def test_gcmscale_rows(capsys):
    mod = script("bench_gcm_scale")
    assert gcmscale.NLEV == mod.NLEV and gcmscale.DT == mod.DT
    rows = gcmscale.main(["10", "--nlev", "8", "--repeats", "2",
                          "--device", "cpu"])
    assert [r["trunc"] for r in rows] == [10]
    row = rows[0]
    assert list(row) == jax_row_keys() + ["init_s", "peak_gib"]
    assert row["nlev"] == 8 and row["grid"] == [16, 32]
    assert row["dt_s"] == 900.0 and row["peak_gib"] is None
    assert row["step_ms"] > 0 and row["spectral_roundtrip_ms"] > 0
    assert row["init_s"] >= 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == {"backend": "cpu", "device": "cpu",
                                   "rows": rows}


def test_gcmscale_row_at_its_table_levels():
    """Without --nlev a truncation takes NLEV's levels (60 by default)."""
    row = gcmscale.bench_trunc(10, repeats=1, device="cpu")
    assert row["nlev"] == 60 and np.isfinite(row["step_ms"])


# ---- Held-Suarez and the moist run (T21/L19, 2 days) -------------------------

HS = dict(trunc=21, days=2, spinup_days=1, dt=3600.0)


def hs_start():
    """JAX's initial state of the HS94 run's configuration (seed 3)."""
    cfg = jmodel.GCMConfig(trunc=21, nlev=19, dt=3600.0, hybrid=True,
                           advection="sl",
                           phys=jphys.PhysicsParams(**held_suarez.HS94),
                           sl_decenter=0.1)
    return host(jmodel.GCMCore(cfg).initial_state(seed=3))


def test_held_suarez_matches_jax():
    mod = script("held_suarez")
    assert held_suarez.GATES == mod.GATES
    ref = mod.run(chunk=1, **HS)
    got = held_suarez.run(device="cpu",
                          state=interop.gcm_state(hs_start(), "cpu"), **HS)
    for k in ("ubar", "Tbar"):
        close(got[k], ref[k], 0.0, ZONAL_TOL, k)
    np.testing.assert_array_equal(got["lat"], ref["lat"])
    np.testing.assert_array_equal(got["sigma"], ref["sigma"])
    for k in ("finite", "days", "spinup_days", "trunc", "nlev", "dt",
              "steps"):
        assert got[k] == ref[k], k
    a, b = held_suarez.analyze(got), mod.analyze(ref)
    for k in a:
        if k != "wall_s":
            assert a[k] == pytest.approx(b[k], abs=0.1), k
    assert held_suarez.check(a) == mod.check(b)


def test_held_suarez_report(tmp_path, capsys):
    line = held_suarez.main(["--trunc", "10", "--days", "1",
                             "--spinup_days", "0", "--dt", "3600",
                             "--device", "cpu", "--out",
                             str(tmp_path / "hs.md")])
    text = open(tmp_path / "hs.md").read()
    assert "T10/L19, dt=3600 s, 1 days (0 spinup), 24 steps" in text
    assert "**Verdict: %s**" % ("PASS" if line["held_suarez_ok"] else
                                "FAIL") in text
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == line


def test_moist_endurance_matches_jax(tmp_path):
    mod = script("moist_endurance")
    assert moist_endurance.GATES == mod.GATES
    argv = ["--trunc", "21", "--days", "2", "--dt", "3600"]
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["moist_endurance.py"] + argv + ["--out",
                                                str(tmp_path / "j.md")]
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = saved
    lines = buf.getvalue().splitlines()
    jline = json.loads(lines[-2])
    jrow = ast.literal_eval(lines[-3])
    start = host(jmodel.GCMCore(jmodel.GCMConfig(
        trunc=21, nlev=19, dt=3600.0, hybrid=True,
        advection="sl")).initial_state(seed=3))
    hist, ubar, core, _, bad_at = moist_endurance.run(
        21, 19, 3600.0, 2, device="cpu",
        state=interop.gcm_state(start, "cpu"), log=lambda row: None)
    assert bad_at is None and [h["day"] for h in hist] == [1.0, 2.0]
    jet_nh, jet_sh = moist_endurance.jets(core, ubar)
    assert jet_nh == pytest.approx(jline["jet_nh_ms"], abs=0.1)
    assert jet_sh == pytest.approx(jline["jet_sh_ms"], abs=0.1)
    for k, v in jrow.items():
        step = 1e-5 if k == "qmax" else 0.1
        assert hist[-1][k] == pytest.approx(v, abs=step), k
    ok = moist_endurance.passed(hist, jet_nh, jet_sh, bad_at)
    assert ok == jline["ok"] and rc == (0 if ok else 1)


def test_moist_main_line_and_report(tmp_path):
    line = moist_endurance.main(["--trunc", "10", "--days", "1", "--dt",
                                 "3600", "--device", "cpu", "--out",
                                 str(tmp_path / "m.md")])
    assert list(line) == ["bench", "backend", "trunc", "nlev", "dt_s",
                          "days", "wall_s", "jet_nh_ms", "jet_sh_ms", "ok"]
    text = open(tmp_path / "m.md").read()
    assert "| 1.0 |" in text and "**Verdict:" in text


# ---- the bisection harness ---------------------------------------------------

def poison_after(step, t_bad):
    """A GCMCore.step that sets u at (level 3, row 5, column 7) and T at
    (level 2, row 6, column 1) to NaN once the state's time reaches
    t_bad (works under jit and eagerly)."""
    def step_fn(self, state, first=False):
        s = step(self, state, first)
        g = s.grid
        if isinstance(g.u, torch.Tensor):
            if float(s.time) >= t_bad:
                u, T = g.u.clone(), g.T.clone()
                u[3, 5, 7] = np.nan
                T[2, 6, 1] = np.nan
                s = s._replace(grid=g._replace(u=u, T=T))
            return s
        bad = s.time >= t_bad
        u = g.u.at[3, 5, 7].set(jnp.where(bad, jnp.nan, g.u[3, 5, 7]))
        T = g.T.at[2, 6, 1].set(jnp.where(bad, jnp.nan, g.T[2, 6, 1]))
        return s._replace(grid=g._replace(u=u, T=T))
    return step_fn


def test_bisect_first_bad_day_matches_jax(monkeypatch):
    """Both harnesses on a T10/L8 run whose state is made non-finite on
    day 2: the daily rows stop there, with the same first bad u and T."""
    argv = ["--trunc", "10", "--nlev", "8", "--dt", "7200", "--days", "4"]
    t_bad = 2 * 86400.0 + 7200.0 - 1.0    # the last step of day 2
    monkeypatch.setattr(jmodel.GCMCore, "step",
                        poison_after(jmodel.GCMCore.step, t_bad))
    monkeypatch.setattr(tmodel.GCMCore, "step",
                        poison_after(tmodel.GCMCore.step, t_bad))
    mod = script("hs_bisect")
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["hs_bisect.py"] + argv)
    with contextlib.redirect_stdout(buf):
        mod.main()
    jlines = buf.getvalue().splitlines()[:-1]          # without the wall
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = hs_bisect.main(argv + ["--device", "cpu"])
    tlines = buf.getvalue().splitlines()[:-1]
    assert [r["day"] for r in rows] == [1, 2]
    assert [r["finite"] for r in rows] == [True, False]
    jrows = [json.loads(ln) for ln in jlines if ln.startswith("{")]
    assert [(r["day"], r["finite"]) for r in jrows] == [(1, True),
                                                        (2, False)]
    report = [ln for ln in tlines if not ln.startswith("{")]
    assert report[:2] == [ln for ln in jlines if ln.startswith("first")]
    assert report[0].startswith("first bad u at level 3/8, lat ")
    assert report[0].endswith(", lon idx 7")
    assert report[1].startswith("first bad T at level 2/8, lat ")
    assert report[2].startswith("previous day: umax ")


def test_first_bad_locates_the_first_nan():
    mu = np.sin(np.radians([60.0, 20.0, -20.0, -60.0]))
    u = np.zeros((3, 4, 5))
    T = np.full((3, 4, 5), 250.0)
    u[2, 1, 3] = np.inf
    u[2, 3, 0] = np.nan
    assert hs_bisect.first_bad(u, T, mu, 3) == [
        "first bad u at level 2/3, lat 20.0 deg, lon idx 3"]
    row = hs_bisect.day_row(4, u, T, np.zeros((4, 5)))
    assert row["day"] == 4 and not row["finite"]
    assert row["ps_min"] == row["ps_max"] == 1000.0
