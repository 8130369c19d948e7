"""tests/jet_blowup_witness.py (the TL639 jet run of both packages side
by side from one injected state) at T10/L5 for 2 steps: each step's row
has both packages' max|u|, finite, and their u and T within 1e-3 of
JAX's max (the endurance test of test_torch_scripts_gcm.py holds them
at 1e-4 at T21; this guards the script, not the numerics).

Its ``onestep`` mode at T10/L5: both packages one step from each state
the port's run saved (``verify/tl639_rows.py``), with and without split
phases (k_chunk 1 at L5), within 1e-3 of JAX's max. And the committed
rows of the port's TL639/L60 jet run on the CPU
(``verify/ref/tl639_rows_cpu.json``): well formed, 60 levels a row,
finite up to the first non-finite step, which ends them."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.runtime import tl639
from sp_coupler_tpu_torch.verify import tl639_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _witness():
    path = os.path.join(ROOT, "tests", "jet_blowup_witness.py")
    spec = importlib.util.spec_from_file_location("jet_blowup_witness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_witness_steps_both_packages_from_one_state(capsys):
    rows = _witness().main(["10", "5", "720", "2"])
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert r["jax"]["finite"] and r["port"]["finite"]
        assert abs(r["port"]["umax"] - r["jax"]["umax"]) <= (
            1e-3 * r["jax"]["umax"])
        assert r["du"] <= 1e-3 and r["dT"] <= 1e-3
        assert r["courant_z"] >= 0.0
    out = capsys.readouterr().out
    assert "T10/L5 dt 720 s, jets +-60 m/s, split_phases False" in out


@pytest.mark.parametrize("split", [False, True])
def test_onestep_from_saved_port_states(tmp_path, split):
    """The port's run saves its state after steps 1 and 2; from each, JAX
    and the port step once and agree within 1e-3 of JAX's max, and the
    port's step from the loaded state is the run's next step."""
    torch.set_num_threads(1)
    core = tl639.build(10, 5, 720.0, split_phases=split, device="cpu")
    paths = {}

    def save(state, row):
        if row["step"] in (1, 2):
            paths[row["step"]] = str(tmp_path / ("tl639_state_%d.pt"
                                                 % row["step"]))
            tl639_rows.save_state(core, state, paths[row["step"]])

    rows = tl639_rows.rows(core, 3, on_row=save)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(r["finite"] and len(r["level_umax"]) == 5 for r in rows)
    witness = _witness()
    for k, path in sorted(paths.items()):
        r = witness.onestep(path, split)
        assert (r["step"], r["from_step"], r["split_phases"]) == (
            k + 1, k, split)
        assert r["k_chunk"] == (1 if split else None)
        assert r["jax"]["finite"] and r["port"]["finite"]
        for key in ("du", "dT", "dlnps"):
            assert r[key] <= 1e-3, (k, key, r[key])
        np.testing.assert_allclose(r["port"]["umax"], rows[k]["umax"],
                                   rtol=1e-6)


def test_save_load_round_trip(tmp_path):
    """load_state(save_state(state)) steps as the state itself does, bit
    for bit; a state of another size is refused."""
    core = tl639.build(10, 5, 720.0, device="cpu")
    state = core.step(tl639.start(core, 60.0), first=True)
    path = str(tmp_path / "s.pt")
    tl639_rows.save_state(core, state, path)
    a = core.step(tl639.strip(state)).grid
    b = core.step(tl639_rows.load_state(core, path)).grid
    for k in ("u", "v", "T", "lnps"):
        torch.testing.assert_close(getattr(b, k), getattr(a, k), rtol=0,
                                   atol=0)
    other = tl639.build(10, 4, 720.0, device="cpu")
    with pytest.raises(ValueError, match="holds T10/L5"):
        tl639_rows.load_state(other, path)


def test_rows_part_where_they_differ():
    """parted: the first step whose rows differ by more than tol."""
    def row(n, u, finite=True, v=40.0, lnps=-0.2):
        return dict(step=n, umax=u, vmax=v, Tmin=200.0, Tmax=300.0,
                    lnps_min=lnps, lnps_max=0.05, finite=finite,
                    level_umax=[u / 2, u], level_vmax=[v / 2, v])

    ref = [row(1, 60.0), row(2, 70.0), row(3, 90.0), row(4, 0.0, False)]
    got = [row(1, 60.0), row(2, 70.0 * (1 + 1e-6)), row(3, 91.0),
           row(4, 1e3)]
    diffs, first = tl639_rows.parted(ref, got, 1e-5)
    assert diffs[0] == 0.0 and 0 < diffs[1] <= 1e-5
    assert first == 3 and diffs[3] == float("inf")
    assert tl639_rows.parted(ref[:2], got[:2], 1e-5)[1] is None
    # v and lnps count as u does: max|v| by 2e-4 of itself, lnps's range
    # by 1e-3 of its largest end
    for other, frac in ((row(1, 60.0, v=40.0 * (1 + 2e-4)), 2e-4),
                        (row(1, 60.0, lnps=-0.2 + 2e-4), 1e-3)):
        np.testing.assert_allclose(tl639_rows.row_diff(ref[0], other),
                                   frac, rtol=1e-6)


def test_max_diff():
    """max_diff: max|got - ref| / max|ref| in float64, NaNs left out, with
    the index of the largest difference; of arrays or tensors."""
    ref = np.zeros((3, 4, 5), np.float32)
    ref[1, 2, 3] = -4.0
    got = ref.copy()
    got[2, 1, 0] = 1.0
    got[0, 0, 0] = np.nan
    frac, idx = tl639_rows.max_diff(torch.as_tensor(got), ref)
    assert frac == 0.25 and idx == (2, 1, 0)
    assert tl639_rows.max_diff(ref, ref) == (0.0, (0, 0, 0))
    assert tl639_rows.max_diff(np.ones(2), np.zeros(2))[0] == 1.0


def test_sl_stages_kept_and_given():
    """semilag.sl_step's keep receives every stage (SL_STAGES); given
    its own stages the step is the same bit for bit, and given another
    run's each stage takes that run's inputs. tl639_rows.as_double
    steps the same core in float64 within 1e-4 of the float32 step."""
    import chip_profile
    from sp_coupler_tpu_torch.models.gcm import semilag
    torch.set_num_threads(1)
    core = tl639.build(10, 5, 720.0, split_phases=True, device="cpu")
    state = tl639.strip(core.step(tl639.start(core, 60.0), first=True))
    kept = {}
    a = core.phase_a(state, keep=kept)
    assert sorted(kept) == sorted(semilag.SL_STAGES)
    b = core.phase_a(state, given=kept)
    for k in ("u", "v", "T", "lnps"):
        torch.testing.assert_close(getattr(b.grid, k), getattr(a.grid, k),
                                   rtol=0, atol=0)
    # from another state given the first one's stages: the first stage
    # reads the state, every later one the given stages
    other, kept_other = tl639.strip(core.step(state)), {}
    core.phase_a(other, keep=kept_other, given=kept)
    assert not torch.equal(kept_other["mg"]["u"], kept["mg"]["u"])
    for x, y in zip(kept_other["arr"], kept["arr"]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    core64 = tl639_rows.as_double(core)
    assert core64.sht.whole is core64.sht and core.sht.Pe.dtype == (
        torch.float32)
    s64 = core64.step(chip_profile.moved(state, "cpu", torch.float64))
    s32 = core.step(state)
    for k in ("u", "v", "T", "lnps"):
        assert getattr(s64.grid, k).dtype == torch.float64
        frac, _ = tl639_rows.max_diff(getattr(s32.grid, k),
                                      getattr(s64.grid, k))
        assert 0.0 < frac <= 1e-4, (k, frac)


def test_committed_tl639_rows():
    """verify/ref/tl639_rows_cpu.json, the port's TL639/L60 jet run on the
    CPU (dt 720 s, +-60 m/s jets, split phases, k_chunk 4): one row a
    step from 1, finite with 60 levels of max|u| and of max|v| a row up
    to the last row, which is its first non-finite step; the vertical
    Courant number passes 1 at step 12; chip_smoke.py holds the card
    through an earlier step."""
    import chip_smoke
    with open(tl639_rows.REF) as f:
        ref = json.load(f)
    assert (ref["trunc"], ref["nlev"], ref["dt"], ref["jet"],
            ref["split_phases"], ref["k_chunk"], ref["device"]) == (
                639, 60, 720.0, 60.0, True, 4, "cpu")
    rows = ref["rows"]
    assert [r["step"] for r in rows] == list(range(1, len(rows) + 1))
    assert ref["first_nonfinite"] == rows[-1]["step"] == 23
    assert not rows[-1]["finite"]
    for r in rows[:-1]:
        assert r["finite"] and all(r["finite_by_field"].values())
        lev = np.asarray(r["level_umax"])
        assert lev.shape == (60,) and np.all(np.isfinite(lev))
        assert r["umax"] == lev.max() and r["u_level"] == lev.argmax()
        levv = np.asarray(r["level_vmax"])
        assert levv.shape == (60,) and r["vmax"] == levv.max()
        assert r["Tmin"] < r["Tmax"] and r["lnps_min"] < r["lnps_max"]
        assert np.isfinite(r["courant_z"]) and 0 <= r["courant_level"] < 60
        if r["step"] <= 12:     # physical until the Courant number is 1
            assert 150.0 < r["Tmin"] and r["Tmax"] < 340.0
            assert 10.0 < r["umax"] < 150.0
    assert next(r["step"] for r in rows if r["courant_z"] > 1.0) == 12
    assert 0 < chip_smoke.TL639_AGREE_STEP < ref["first_nonfinite"]
    assert 0 < chip_smoke.TL639_ROW_TOL < 1e-2


def test_committed_tl639_onestep_rows():
    """verify/ref/tl639_onestep_jax.json: JAX's step and the port's from
    the port's TL639 CPU states after steps 1, 6, 12 and 18, finite and
    within 1e-3 of JAX's max, the port's max|u| that of the committed
    run's next row."""
    path = os.path.join(os.path.dirname(tl639_rows.REF),
                        "tl639_onestep_jax.json")
    with open(path) as f:
        rows = json.load(f)["rows"]
    with open(tl639_rows.REF) as f:
        run = {r["step"]: r for r in json.load(f)["rows"]}
    assert [r["from_step"] for r in rows] == [1, 6, 12, 18]
    for r in rows:
        assert (r["trunc"], r["nlev"], r["dt"], r["split_phases"],
                r["k_chunk"], r["step"]) == (639, 60, 720.0, True, 4,
                                             r["from_step"] + 1)
        assert r["jax"]["finite"] and r["port"]["finite"]
        for key in ("du", "dT", "dlnps"):
            assert 0.0 < r[key] <= 1e-3, (r["from_step"], key)
        np.testing.assert_allclose(r["port"]["umax"],
                                   run[r["step"]]["umax"], rtol=1e-5)
        np.testing.assert_allclose(r["jax"]["umax"], r["port"]["umax"],
                                   rtol=1e-4)
