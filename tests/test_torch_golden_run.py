"""The port's recording harness (sp_coupler_tpu_torch/verify/golden.py) on
the CPU, at a small size: T10/L8 + the 4 columns config 2's polygon takes
there, of 8x8x16 LES.

- ``record`` in legs of 2 steps (the second leg through --restart, both
  --restart_overlap) holds the records of a straight 4-step run bit for
  bit, every Time row included; it refuses a directory in tests/golden/.
- ``replay`` passes on the harness's own recording and fails when one
  recorded tendency is moved by 1e-3 of its scale.
- ``compare``'s distance uses each variable's scale over the whole run,
  so a field that starts near zero gives finite distances; ``--exact``
  and the ensemble's holds find what they should, and a window that a
  recording does not cover whole is not held.
- Under --restart_overlap a resumed run hands on the rain of the record
  a checkpoint left pending, as the uninterrupted run's next flush does;
  a plain --restart keeps the checkpoint's rain_last, as the JAX
  package's resume does.
"""

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.io import h5nc
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.verify import golden

SMALL = dict(gcm_truncation=10, gcm_levels=8, gcm_dt=300.0, les_itot=8,
             les_jtot=8, les_ktot=16, les_xsize=1600.0, les_ysize=1600.0,
             les_dz=100.0, les_dt=10.0, timing_phases=0)
STEPS = 4


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """The harness's straight run (one leg of 4 steps) and its legs of 2,
    recorded at once, each leg a spmaster process of 2 threads."""
    base = tmp_path_factory.mktemp("golden")
    keep = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        with ThreadPoolExecutor(2) as pool:
            runs = {name: pool.submit(
                golden.record, str(base / name), STEPS, leg, 42, "config2",
                "cpu", SMALL, name == "legs", 600)
                for name, leg in (("straight", STEPS), ("legs", 2))}
            out = {k: (str(base / k), f.result()) for k, f in runs.items()}
    finally:
        if keep is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = keep
    return out


def test_legs_equal_straight(recordings):
    straight, legs = (golden.read_recording(recordings[k][0])
                      for k in ("straight", "legs"))
    dt = SMALL["gcm_dt"]
    for times, _ in (straight, legs):
        assert times.tolist() == (dt * np.arange(1, STEPS + 2)).tolist()
    assert sorted(straight[1]) == sorted(legs[1]) and len(legs[1]) == 4
    assert golden.exact_diffs(legs, straight) == []
    assert golden.exact_diffs(straight, legs) == []
    res = golden.compare([recordings[k][0] for k in ("straight", "legs")],
                         exact=True)
    assert res["failures"] == []
    assert all(v == 0.0 for v in res["pairs"][0]["mean"].values())


def test_record_keeps_what_it_ran(recordings):
    path, rec = recordings["legs"]
    assert [leg["steps"] for leg in rec["legs"]] == [2, 2]
    assert "--restart" not in rec["legs"][0]["argv"]
    assert "--restart" in rec["legs"][1]["argv"]
    # the first leg writes 3 records, the second 2 after its overlap step
    assert [len(leg["substeps"]) for leg in rec["legs"]] == [3, 2]
    assert [len(leg["overlap_substeps"]) for leg in rec["legs"]] == [0, 1]
    for leg in rec["legs"]:
        assert len(leg["clamped"]) == len(leg["substeps"])
        assert len(leg["step_walls"]) == leg["steps"] + 1
        assert leg["launches"]["lesstage"] == 0     # the CPU: no kernel
        assert leg["peak_rss_mb"] > 0 and leg["card_peak_gib"] is None
    with open(os.path.join(path, "golden_meta.json")) as f:
        meta = json.load(f)
    assert meta["steps"] == STEPS and meta["gcm_dt_s"] == SMALL["gcm_dt"]
    assert len(meta["columns"]) == 4
    assert meta["les_grid"] == [8, 8, 16]
    assert (meta["platform"], meta["device"]) == ("cpu", "cpu")
    assert meta["poly_lat_lon"] == golden.POLY and meta["legs"] == [2, 2]
    # the last checkpoint is kept where asked, at the step before the end
    with open(os.path.join(path, "restart.json")) as f:
        assert json.load(f)["gcm_step"] == STEPS
    assert not os.path.exists(os.path.join(recordings["straight"][0],
                                           "restart.npz"))
    assert sorted(os.listdir(os.path.join(path, "legs"))) == [
        "leg0.log", "leg1.log"]
    lines = golden.summary(rec)
    assert len(lines) == 2 + STEPS + 1 + 1
    assert lines[0].startswith("leg 0 (--steps 2)")
    assert lines[-2].startswith("record %d: substeps [" % (STEPS + 1))
    assert lines[-1].startswith("run: %d records" % (STEPS + 1))
    assert lines[-1].endswith("recomputes: [True]")


def test_replay_passes_on_own_recording(recordings):
    res = golden.replay(recordings["legs"][0])
    assert res["columns"] == 4 and res["steps"] == STEPS
    assert res["comparisons"] == len(golden.TENDENCIES) * 4 * STEPS
    assert max(res["worst_rel"].values()) <= golden.REPLAY_TOL


def test_replay_fails_on_a_moved_tendency(recordings, tmp_path):
    moved = tmp_path / "moved"
    shutil.copytree(recordings["straight"][0], moved)
    times, groups = golden.read_recording(str(moved), ("f_T",))
    scale = max(float(np.max(np.abs(g["f_T"]))) for g in groups.values())
    col = sorted(groups)[1]
    ds = h5nc.Dataset(str(moved / "spifs.nc"), "a")
    try:
        var = ds.groups[str(col)].variables["f_T"]
        rec = np.array(var[2])
        rec[3] += 1e-3 * scale
        var[2] = rec
    finally:
        ds.close()
    assert golden.read_recording(str(moved), ("f_T",))[1][col]["f_T"][2][3] \
        == pytest.approx(rec[3])
    with pytest.raises(AssertionError, match="f_T"):
        golden.replay(str(moved))


def test_compare_near_zero_field():
    """U grows from 1e-9 to 10: its distance is over the whole run's
    scale, so the first steps' are small and finite, not ~1."""
    times = np.array([900.0, 1800.0, 2700.0])
    u = np.array([1e-9, 1.0, 10.0])[:, None] * np.ones((3, 5))
    a = (times, {1: {"U": u, "T": 300.0 + u}, 2: {"U": u, "T": 300.0 + u}})
    b = (times, {1: {"U": u * 2, "T": 301.0 + u},
                 2: {"U": u * 2, "T": 301.0 + u}})
    t, d = golden.distances(a, b, ("U", "T", "QL"))
    assert t.tolist() == times.tolist() and set(d) == {"U", "T"}
    # the scale is b's largest |U|, 20: a - b is -u
    np.testing.assert_allclose(d["U"], [5e-11, 0.05, 0.5], rtol=1e-6)
    np.testing.assert_allclose(d["T"], [1.0 / 311.0] * 3, rtol=1e-6)
    assert np.all(np.isfinite(d["U"]))
    # records matched by Time: b without the middle record
    b2 = (times[[0, 2]], {c: {k: v[[0, 2]] for k, v in g.items()}
                          for c, g in b[1].items()})
    t2, d2 = golden.distances(a, b2, ("U",))
    assert t2.tolist() == [900.0, 2700.0]
    np.testing.assert_allclose(d2["U"], [5e-11, 0.5], rtol=1e-6)


def test_exact_diffs_finds_one_value():
    times = np.array([900.0, 1800.0])
    a = (times, {7: {"thl": np.ones((2, 4), np.float32)}})
    b = (times, {7: {"thl": np.ones((2, 4), np.float32)}})
    assert golden.exact_diffs(a, b) == []
    b[1][7]["thl"][1, 2] = np.nextafter(np.float32(1), np.float32(2))
    assert golden.exact_diffs(a, b) == [(1800.0, 7, "thl")]


def test_seed_hold():
    """The window hold's verdict: the median of the members' distances to
    the reference (recording 0) against the factor x the widest member
    pair; one member far off moves the median only as far as its rank."""
    def pair(i, j, d):
        return dict(i=i, j=j, mean={v: d for v in golden.HOLD_VARS})

    pairs = [pair(0, 1, 0.03), pair(0, 2, 0.039), pair(0, 3, 0.5),
             pair(1, 2, 0.02), pair(1, 3, 0.01), pair(2, 3, 0.015)]
    hold = golden.seed_hold(pairs, 2.0)
    assert set(hold) == set(golden.HOLD_VARS)
    assert all(h["ok"] and h["seed_spread"] == 0.02 and h["d_ref"] == 0.039
               and h["d_members"] == [0.03, 0.039, 0.5]
               for h in hold.values())
    pairs[1] = pair(0, 2, 0.041)
    assert not any(h["ok"] for h in golden.seed_hold(pairs, 2.0).values())


def test_ensemble_records_and_stops(tmp_path, monkeypatch):
    """``golden ensemble``: a seed that ends in time leaves its exit code 0
    and its recording shrunk beside it; one still running at the timeout
    is stopped (-9) and leaves no recording."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    args = ["--steps", "1", "--leg", "1", "--device", "cpu", "--conf",
            json.dumps(SMALL)]
    assert golden.ensemble(str(tmp_path / "a"), [7], args) == {7: 0}
    times, groups = golden.read_recording(str(tmp_path / "a" / "seed7.npz"))
    assert times.tolist() == [300.0, 600.0] and len(groups) == 4
    assert golden.ensemble(str(tmp_path / "b"), [7, 8], args,
                           timeout=0.0) == {7: -9, 8: -9}
    assert sorted(os.listdir(tmp_path / "b")) == ["seed7.log", "seed8.log"]


def test_record_refuses_the_golden_directory(tmp_path):
    for path in (golden.GOLDEN_DIR, os.path.join(golden.GOLDEN_DIR, "x")):
        with pytest.raises(ValueError, match="tests/golden"):
            golden.record(path, 2, 1, device="cpu")
    link = tmp_path / "link"
    os.symlink(golden.GOLDEN_DIR, link)
    with pytest.raises(ValueError, match="tests/golden"):
        golden.record(str(link / "run"), 2, 1, device="cpu")
    assert golden.leg_plan(100, 25) == [25] * 4
    assert golden.leg_plan(5, 2) == [2, 2, 1]


@pytest.mark.parametrize("overlap", [True, False])
def test_pending_rain_carries_across_a_checkpoint(tmp_path, overlap):
    """Under --restart_overlap the rain of a record left pending at a
    checkpoint is rain_last after the resumed run's first flush, as after
    the uninterrupted run's. Without it the checkpoint keeps no pending
    rain and an unwritten record leaves rain_last as saved, as the JAX
    package's resume does."""
    from sp_coupler_tpu_torch.io import restart
    r = SPRunner(SPConfig(output_dir=str(tmp_path), gcm_type="dummy",
                          les_type="dummy"), device="cpu",
                 restart_overlap=overlap)
    r._pending_record = dict(write=False, rain=np.array([1.5, 2.5]))
    np.testing.assert_array_equal(r.pending_rain(), [1.5, 2.5])
    r.rain_last = np.zeros(2)
    r._flush_pending()
    np.testing.assert_array_equal(r.rain_last,
                                  [1.5, 2.5] if overlap else [0.0, 0.0])
    assert r.pending_rain() is None
    # save keeps it, load puts it back as a record that is not written
    from types import SimpleNamespace
    runner = SimpleNamespace(
        gcm=SimpleNamespace(get_model_time=lambda: 600.0, step_count=2),
        fleet=SimpleNamespace(state=None, time=600.0, n=2),
        prev_profiles=None, rain_last=np.zeros(2), sp_cols=[3, 7],
        cfg=SimpleNamespace(output_dir=str(tmp_path)),
        pending_rain=lambda: np.array([0.25, 0.5]),
        restart_overlap=overlap)
    restart.save(runner)
    with open(tmp_path / restart.META) as f:
        assert json.load(f).get("rain_pending") == (
            [0.25, 0.5] if overlap else None)
    back = SimpleNamespace(gcm=SimpleNamespace(), fleet=SimpleNamespace(),
                           prev_profiles=None, cfg=runner.cfg,
                           restart_overlap=overlap)
    restart.load(back)
    if overlap:
        assert back._pending_record["write"] is False
        np.testing.assert_array_equal(back._pending_record["rain"],
                                      [0.25, 0.5])
    else:
        assert not hasattr(back, "_pending_record")
    assert back.restart_load["bytes_read"] == 0


def test_replay_takes_the_recorded_heights():
    """The replayed GCM gives the driver the heights it recorded
    (ReplayGCM.get_heights), bit for bit. Back through the geopotential
    (Zgfull = Zf * grav, as get_profile_fields serves it, then a float32
    division by grav in convert_profiles) some heights do not return:
    three a card's config-2 run recorded, 1 ulp off each."""
    import torch
    from sp_coupler_tpu_torch.coupling import convert
    from sp_coupler_tpu_torch.models import ncreplay
    gcm = ncreplay.ReplayGCM(os.path.join(golden.GOLDEN_DIR, "spifs.nc"))
    try:
        cols = list(range(16))
        zf, zh = gcm.get_heights(cols)
        rec = [gcm._group(k).variables for k in cols]
        assert np.array_equal(zf, np.stack([np.asarray(v["Zf"][0])
                                            for v in rec]))
        assert np.array_equal(zh[:, 1:], np.stack([np.asarray(v["Zh"][0])
                                                   for v in rec]))
    finally:
        gcm.cleanup_code()
    z = np.array([[27786.484375, 7952.7412109375, 3830.030029296875]],
                 np.float32)
    h = np.concatenate([z * 1.02, np.zeros((1, 1), np.float32)], 1)
    prof = {k: torch.full((1, 3), v) for k, v in (
        ("U", 1.0), ("V", 1.0), ("T", 280.0), ("SH", 1e-3), ("QL", 0.0),
        ("QI", 0.0), ("Pfull", 7e4))}
    prof["Phalf"] = torch.full((1, 4), 7e4)
    from sp_coupler_tpu_torch import constants as c
    prof["Zgfull"] = torch.as_tensor(z * c.grav)
    prof["Zghalf"] = torch.as_tensor(h * c.grav)
    zles = torch.linspace(12.5, 3987.5, 160)
    back = convert.convert_profiles(prof, zles)
    taken = convert.convert_profiles(prof, zles, (torch.as_tensor(z),
                                                  torch.as_tensor(h)))
    assert np.all(back.Zf.numpy() != z)
    assert np.all(np.abs(back.Zf.numpy() - z) <= np.spacing(z))
    assert np.array_equal(taken.Zf.numpy(), z)
    assert np.array_equal(taken.Zh.numpy(), h)


# ---- the ensemble's holds, on tiny synthetic recordings ---------------------

GCM_L, LES_Z, N_REC = 3, 4, 12
COLS = (5, 9)


def write_recording(path, fields, dt=900.0, n_rec=N_REC):
    """A spifs.nc through the port's writer (io/spifs.py): the first n_rec
    records at Time dt, 2 dt, ...; fields {column: {var: [N_REC,
    levels]}}."""
    from sp_coupler_tpu_torch.io import spifs
    os.makedirs(path)
    w = spifs.SpifsWriter(os.path.join(path, "spifs.nc"), GCM_L, les_info=dict(
        x=np.arange(2.0), y=np.arange(2.0), zf=np.arange(LES_Z) + 0.5),
        start_time=0)
    for c in COLS:
        w.add_les_column(c, 10.0, 20.0)
    for k in range(n_rec):
        w.update_time(dt * (k + 1))
        for c in COLS:
            w.write_column(c, **{v: a[k] for v, a in fields[c].items()})
    w.close()
    return path


def synthetic(seed):
    """Fields of a member: a smooth base plus noise of 0.1 from the seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, c in enumerate(COLS):
        g = lambda base, L: base + 0.1 * rng.normal(size=(N_REC, L))
        out[c] = dict(
            T=g(250.0 + i, GCM_L), SH=g(1.0, GCM_L), U=g(3.0, GCM_L),
            V=g(-2.0, GCM_L), QL=g(1.0, GCM_L), A=g(0.5, GCM_L),
            thl=g(300.0, LES_Z), qt=g(2.0, LES_Z), ql=g(1.0, LES_Z),
            f_T=g(0.0, GCM_L), f_U=g(0.0, GCM_L))
    return out


def averaged(fields, offset=0.0, late_offset=0.0, ql_scale=1.0):
    """The members' mean fields (inside every envelope): offset added to
    every record of T, late_offset to records 7-12 of T, the LES ql times
    ql_scale."""
    late = np.where(np.arange(N_REC) >= 6, late_offset, 0.0)[:, None]
    out = {c: {v: np.mean([f[c][v] for f in fields], axis=0)
               for v in fields[0][c]} for c in COLS}
    for c in COLS:
        out[c]["T"] = out[c]["T"] + offset + late
        out[c]["ql"] = ql_scale * out[c]["ql"]
    return out


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    """Four members (seeds 1-4) and references: their mean, the mean off
    by 5 in T throughout, off by 5 in T in records 7-12 only, and with the
    LES ql 3 times larger."""
    base = tmp_path_factory.mktemp("ensemble")
    fields = [synthetic(s) for s in (1, 2, 3, 4)]
    members = [write_recording(str(base / ("m%d" % s)), f)
               for s, f in zip((1, 2, 3, 4), fields)]
    mk = lambda name, **kw: write_recording(str(base / name),
                                            averaged(fields, **kw))
    refs = dict(alike=mk("alike"), off=mk("off", offset=5.0),
                late=mk("late", late_offset=5.0),
                wet=mk("wet", ql_scale=3.0))
    return members, refs


WIN = ((1, 6), (7, 12))


def test_distance_hold_by_window(ensemble):
    """The median of the members' mean distances to the reference within
    HOLD_FACTOR x the widest distance between two members, window by
    window: the members' mean holds in both, one off throughout
    breaks both (in T alone), one off late breaks the late window only."""
    members, refs = ensemble
    res = {k: golden.compare([r] + members, windows=WIN)
           for k, r in refs.items() if k != "wet"}
    for k, r in res.items():
        assert [w["steps"] for w in r["windows"]] == [list(w) for w in WIN]
        for w in r["windows"]:
            assert set(w["hold"]) == set(golden.HOLD_VARS)
            for v, h in w["hold"].items():
                assert len(h["d_members"]) == 4
                assert h["d_ref"] == pytest.approx(np.median(h["d_members"]))
                assert h["factor"] == golden.HOLD_FACTOR
    ok = lambda k, i, v: res[k]["windows"][i]["hold"][v]["ok"]
    assert all(ok("alike", i, v) for i in (0, 1) for v in golden.HOLD_VARS)
    assert res["alike"]["failures"] == []
    assert not ok("off", 0, "T") and not ok("off", 1, "T")
    assert ok("off", 0, "SH") and ok("off", 1, "U")
    assert ok("late", 0, "T") and not ok("late", 1, "T")
    assert res["late"]["failures"] == [
        "steps 7-12: distance hold broken for T"]
    with pytest.raises(ValueError, match="two members"):
        golden.compare([refs["alike"], members[0]], windows=WIN)


def test_climate_hold(ensemble):
    """The reference's mean over the held window's records, columns and
    levels inside [lo - r, hi + r] of the members': their mean holds;
    the one with 3 x the LES ql does not, on ql alone, and
    its ql profile leaves the level-by-level envelope at every level; the
    other windows' climate is reported, not held."""
    members, refs = ensemble
    res = golden.compare([refs["wet"]] + members, windows=WIN,
                         climate=WIN[1])
    held = [c for c in res["climate"] if c["held"]]
    assert len(held) == 1 and held[0]["steps"] == list(WIN[1])
    assert [c["steps"] for c in res["climate"]] == [list(WIN[1]),
                                                    list(WIN[0])]
    h = held[0]["hold"]
    assert not h["ql"]["ok"] and all(h[v]["ok"] for v in h if v != "ql")
    assert h["ql"]["levels_outside"] == list(range(LES_Z))
    lo, hi = min(h["T"]["members"]), max(h["T"]["members"])
    assert (h["T"]["lo"], h["T"]["hi"], h["T"]["r"]) == (lo, hi, hi - lo)
    assert res["failures"] == ["steps 7-12: climate hold broken for ql"]
    assert not res["climate"][1]["held"]
    alike = golden.compare([refs["alike"]] + members, climate=WIN[1])
    assert alike["failures"] == []
    assert all(v["ok"] for v in alike["climate"][0]["hold"].values())
    # the held window's profile means, reference first, as column_means
    means = golden.column_means(refs["alike"], steps=WIN[1])
    for v, prof in alike["climate"][0]["profiles"][0].items():
        np.testing.assert_array_equal(prof, means[v])


def test_window_not_covered_is_not_held(ensemble, tmp_path):
    """A member that ends at record 9 does not cover steps 7-12: neither
    hold is given there, each window fails with the step where that member
    ends, and its numbers over steps 7-9 are reported as partial; steps
    1-6, which it covers, are held as ever."""
    members, refs = ensemble
    short = write_recording(str(tmp_path / "short"), synthetic(5), n_rec=9)
    res = golden.compare([refs["alike"]] + members[:3] + [short],
                         windows=WIN, climate=WIN[1])
    w0, w1 = res["windows"]
    assert w0["covered"] and "partial" not in w0
    assert all(h["ok"] for h in w0["hold"].values())
    assert not w1["covered"] and "hold" not in w1
    assert w1["steps_used"] == [7, 8, 9] and w1["ends"] == {"short": 9}
    assert set(w1["partial"]) == set(golden.HOLD_VARS)
    held = res["climate"][0]
    assert held["held"] and not held["covered"] and "hold" not in held
    assert res["climate"][1]["covered"] and "hold" in res["climate"][1]
    assert res["failures"] == [
        "steps 7-12: not covered, no distance hold (short ends at step 9)",
        "steps 7-12: not covered, no climate hold (short ends at step 9)"]
    # the reference cut short fails alike
    ref = write_recording(str(tmp_path / "ref"), averaged(
        [synthetic(s) for s in (1, 2, 3, 4)]), n_rec=10)
    res = golden.compare([ref] + members, windows=WIN)
    assert res["failures"] == [
        "steps 7-12: not covered, no distance hold (ref ends at step 10)"]
    from sp_coupler_tpu_torch.verify import late_state
    assert late_state.pick_step(golden.digest(res)) == 50


def test_tendency_scales_name_where(tmp_path):
    """Each tendency's largest |value| and its column, step and level."""
    f = synthetic(1)
    f[9]["f_T"][4, 2] = -7.0
    t = golden.tendency_scales(golden.read_recording(
        write_recording(str(tmp_path / "r"), f)))
    assert t["f_T"] == dict(max=7.0, column=9, step=5, level=2)
    assert set(t) == {"f_T", "f_U"}     # the tendencies written


def test_digest_and_shrink(ensemble, tmp_path):
    """The digest of an ensemble compare: every pair's distance series over
    all matched steps, the window holds, the held climate with each
    recording's mean profiles, the tendency scales, floats to 6 figures,
    recordings by directory name; written as one JSON line. A shrunk
    recording (``shrink``) gives the same distances as the file."""
    members, refs = ensemble
    res = golden.compare([refs["late"]] + members, windows=WIN,
                         climate=WIN[1])
    path = str(tmp_path / "digest.json")
    golden.write_digest(res, path)
    with open(path) as f:
        text = f.read()
    assert text.count("\n") == 1
    d = json.loads(text)
    assert d["paths"] == ["late", "m1", "m2", "m3", "m4"]
    assert d["hold_factor"] == golden.HOLD_FACTOR
    assert len(d["pairs"]) == 10
    assert all(p["steps"] == list(range(1, N_REC + 1)) for p in d["pairs"])
    s = res["pairs"][0]["series"]["T"]
    assert d["pairs"][0]["series"]["T"] == [float("%.6g" % x) for x in s]
    assert d["failures"] == res["failures"] == [
        "steps 7-12: distance hold broken for T",
        "steps 7-12: climate hold broken for T"]
    assert [w["steps"] for w in d["windows"]] == [list(w) for w in WIN]
    assert d["profiles"]["steps"] == list(WIN[1])
    assert len(d["profiles"]["means"]) == 5
    assert len(d["profiles"]["means"][0]["ql"]) == LES_Z
    assert [c["held"] for c in d["climate"]] == [True, False]
    assert d["tendency_scales"][0]["f_T"]["column"] in COLS
    small = str(tmp_path / "late.npz")
    golden.shrink(refs["late"], small)
    a = golden.compare([refs["late"], members[0]])["pairs"][0]["series"]
    b = golden.compare([small, members[0]])["pairs"][0]["series"]
    assert a == b


def test_pick_step():
    """The join to cut: 50 when every hold holds; the join nearest the
    step where a broken distance hold parts most; the held climate
    window's middle when only the climate breaks."""
    from sp_coupler_tpu_torch.verify import late_state
    steps = list(range(1, 101))
    d = np.ones(100)
    d[28] = 9.0         # step 29: the median over the spread is largest
    pairs = [dict(i=0, j=j, steps=steps, series=dict(T=d.tolist()))
             for j in (1, 2, 3, 4)]
    pairs += [dict(i=i, j=j, steps=steps, series=dict(T=[1.0] * 100))
              for i in (1, 2, 3) for j in range(i + 1, 5)]
    hold = lambda ok: dict(T=dict(ok=ok))
    win = lambda ok: [dict(steps=[1, 10], hold=hold(True)),
                      dict(steps=[11, 50], hold=hold(ok)),
                      dict(steps=[51, 100], hold=hold(True))]
    clim = lambda ok: [dict(steps=[51, 100], held=True, hold=hold(ok)),
                       dict(steps=[11, 50], held=False, hold=hold(False))]
    summ = lambda w, c: dict(paths=["golden"] + ["s"] * 4, pairs=pairs,
                             windows=win(w), climate=clim(c))
    assert late_state.pick_step(summ(True, True)) == 50
    assert late_state.pick_step(summ(False, True)) == 25
    assert late_state.pick_step(summ(True, False)) == 75
