"""The port's golden replay: tests/golden/spifs.nc through the port's
SPRunner (tests/test_golden.py on the port).

tests/golden/spifs.nc is a recording of BASELINE config 2 (T21 + 16 SP
columns, 100 coupled steps). The port's ReplayGCM and ReplayLESFleet
(``models/ncreplay.py``) serve the recorded values; the port's driver
recomputes every conversion, forcing and tendency on the CPU, and the
replayed GCM compares each tendency the driver sends back against the
recording. Every one must lie within 1e-5 of its variable's scale (the
largest |value| recorded in any column), as in tests/test_golden.py.

The whole 100-step replay runs here: 7 tendencies x 16 columns x 100
steps of [16, 19] profile arithmetic on the host.
"""

import json
import os

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.io import spifs
from sp_coupler_tpu_torch.models import ncreplay
from sp_coupler_tpu_torch.models.gcm import spharm
from sp_coupler_tpu_torch.runtime.driver import SPRunner, create_fleet
from sp_coupler_tpu_torch.utils import geometry

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NC = os.path.join(GOLDEN, "spifs.nc")
TENDENCIES = ("f_U", "f_V", "f_T", "f_SH", "f_QL", "f_QI", "f_A")


def meta():
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        return json.load(f)


def polygon():
    lat_lon = [float(v) for v in meta()["poly_lat_lon"]]
    return geometry.Polygon(geometry.parse_lat_lons(lat_lon))


# ---- the recording's structure, read through the port's reader -----------

def test_recording_shape():
    ds = spifs.open_reader(GOLDEN_NC)
    try:
        groups = sorted(ds.groups, key=int)
        assert len(groups) == 16
        assert meta()["steps"] == 100
        assert len(np.asarray(ds.variables["Time"][:])) >= meta()["steps"]
        for g in groups:
            grp = ds.groups[g]
            for var in ("T", "f_T", "thl", "f_thl", "u", "Psurf"):
                assert np.all(np.isfinite(np.asarray(grp.variables[var][:]))
                              ), (g, var)
            # a convecting LES column: actual density differs from base
            rhof = np.asarray(grp.variables["rhof"][-1])
            rhobf = np.asarray(grp.variables["rhobf"][-1])
            assert np.any(np.abs(rhof - rhobf) > 0)
    finally:
        ds.close()


def test_meta_polygon_selects_recorded_columns():
    """The meta polygon selects exactly the recorded columns on the port's
    T21 Gaussian grid."""
    nlon, nlat = spharm.GRID_FOR_TRUNC[21]
    mu, _ = spharm.gaussian_latitudes(nlat)
    lats = np.degrees(np.arcsin(np.asarray(mu)))
    lons = np.arange(nlon) * 360.0 / nlon
    points = [(lon, lat) for lat in lats for lon in lons]
    sel = geometry.get_mask_indices(points, [polygon()])
    ds = spifs.open_reader(GOLDEN_NC)
    try:
        recorded = sorted(int(g) for g in ds.groups)
    finally:
        ds.close()
    assert sel == recorded == meta()["columns"]


def test_physical_ranges():
    ds = spifs.open_reader(GOLDEN_NC)
    try:
        for g in ds.groups:
            grp = ds.groups[g]
            T = np.asarray(grp.variables["T"][:])
            assert np.all((T > 150.0) & (T < 330.0))
            qt = np.asarray(grp.variables["qt"][:])
            assert np.all((qt >= 0.0) & (qt < 0.05))
    finally:
        ds.close()


def test_replay_fleet_serves_the_recording():
    """ReplayLESFleet through create_fleet: the recorded grid, and the
    recorded profiles of the step nearest the time it evolved to."""
    cfg = SPConfig(les_type="ncfile", les_input_dir=GOLDEN)
    fleet = create_fleet(cfg, 2)
    try:
        assert isinstance(fleet, ncreplay.ReplayLESFleet)
        assert (fleet.get_itot(), fleet.get_jtot(), fleet.get_ktot()) == (
            64, 64, 160)
        assert fleet.get_dx() == pytest.approx(200.0)
        fleet.evolve_to(float(fleet.times[5]))
        prof = fleet.get_profiles()
        g = fleet.ds.groups[str(fleet.columns[1])]
        np.testing.assert_array_equal(prof["THL"][1],
                                      np.asarray(g.variables["thl"][5]))
        assert prof["PS"].shape == (2,)
    finally:
        fleet.cleanup_code()


def test_replay_without_h5py(monkeypatch):
    """With h5py unimportable the recording opens all the same: the port
    reads spifs.nc through its own h5lite, and ReplayLESFleet serves the
    values test_replay_fleet_serves_the_recording reads."""
    import builtins
    import sys
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **kw)

    for name in [m for m in sys.modules if m == "h5py"
                 or m.startswith("h5py.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    cfg = SPConfig(les_type="ncfile", les_input_dir=GOLDEN)
    fleet = create_fleet(cfg, 2)
    try:
        assert (fleet.get_itot(), fleet.get_jtot(), fleet.get_ktot()) == (
            64, 64, 160)
        fleet.evolve_to(float(fleet.times[5]))
        prof = fleet.get_profiles()
        g = fleet.ds.groups[str(fleet.columns[1])]
        np.testing.assert_array_equal(prof["THL"][1],
                                      np.asarray(g.variables["thl"][5]))
        gcm = ncreplay.ReplayGCM(GOLDEN_NC)
        assert len(gcm.times) == len(fleet.times) >= meta()["steps"]
        gcm.cleanup_code()
    finally:
        fleet.cleanup_code()
    assert "h5py" not in sys.modules


# ---- the replay ------------------------------------------------------------

@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    out = tmp_path_factory.mktemp("replay") / "out"
    cfg = SPConfig(gcm_type="ncfile", les_type="ncfile",
                   gcm_input_dir=GOLDEN, les_input_dir=GOLDEN,
                   gcm_steps=meta()["steps"], cplsurf=True, max_num_les=16,
                   output_dir=str(out))
    r = SPRunner(cfg, geometries=[polygon()], device="cpu")
    r.initialize()
    assert r.coupled is None        # the generic path
    r.run(meta()["steps"])
    r.finalize(save_restart=False)
    return r


def test_all_columns_all_steps_compared(replayed):
    mm = replayed.gcm.mismatches
    # 7 tendency vars x 16 columns x (steps - 10) comparison rounds at
    # least, as tests/test_golden.py asks; the port compares every step
    assert len(mm) >= 7 * 16 * 90
    assert len(mm) == 7 * 16 * meta()["steps"]
    assert {var for _, var, _, _ in mm} == set(TENDENCIES)
    assert len({col for _, _, col, _ in mm}) == 16


def test_tendencies_match_recording(replayed):
    ds = spifs.open_reader(GOLDEN_NC)
    try:
        scale = {}
        for g in ds.groups:
            for var in TENDENCIES:
                v = float(np.nanmax(np.abs(
                    np.asarray(ds.groups[g].variables[var][:]))))
                scale[var] = max(scale.get(var, 0.0), v)
    finally:
        ds.close()
    worst = {}
    for step, var, col, d in replayed.gcm.mismatches:
        worst[var] = max(worst.get(var, 0.0), d)
    for var, d in worst.items():
        assert d <= 1e-5 * max(scale[var], 1e-30), (var, d, scale[var])
