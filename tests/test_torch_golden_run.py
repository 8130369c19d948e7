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
  and ``--hold`` find what they should.
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
    def pair(i, j, d):
        return dict(i=i, j=j, mean={v: d for v in golden.HOLD_VARS})

    pairs = [pair(0, 1, 0.03), pair(0, 2, 0.5), pair(0, 3, 0.5),
             pair(1, 2, 0.02), pair(1, 3, 0.01), pair(2, 3, 0.015)]
    hold = golden.seed_hold(pairs, 2.0)
    assert set(hold) == set(golden.HOLD_VARS)
    assert all(h["ok"] and h["seed_spread"] == 0.02 for h in hold.values())
    pairs[0] = pair(0, 1, 0.05)
    assert not any(h["ok"] for h in golden.seed_hold(pairs, 2.0).values())


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
