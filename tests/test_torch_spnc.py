"""The port's netCDF-classic writer (``io/spnc.py``, its own
``csrc/spnc.cpp``) and the LES cross-section output (``io/crossio.py``),
mirroring tests/test_spnc.py; and the driver's cross.nc against the JAX
driver's (tests/test_driver.py::TestCrossOutput) at T10/L8 + 16x16x24.

The two drivers start from the same state (the JAX runner's, carried over
with ``interop``) and take 2 coupled steps; their cross.nc files hold the
same records. The thl, qt and w planes and the water paths agree within
2e-3 of max|ref| plus 2e-3 |ref|, the bound the driver's spifs.nc records
are held to (tests/test_torch_driver.py).
"""

import logging
import os

import numpy as np
import jax
import pytest
import torch

from sp_coupler_tpu.config import SPConfig as JConfig
from sp_coupler_tpu.io import spnc as jspnc
from sp_coupler_tpu.runtime.driver import SPRunner as JRunner
from sp_coupler_tpu.utils import geometry as jgeom
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.io import crossio, spnc
from sp_coupler_tpu_torch.models.les import grid as lgrid, state as lstate
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.utils import geometry

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _roundtrip(writer_cls, path):
    w = writer_cls(str(path))
    t = w.def_dim("time", None)
    z = w.def_dim("z", 4)
    tv = w.def_var("time", "s", [t])
    pv = w.def_var("prof", "K", [t, z])
    sv = w.def_var("static", "m", [z])
    w.enddef()
    w.put(sv, 0, np.arange(4.0))
    for r in range(3):
        w.put(tv, r, np.asarray([r * 60.0], np.float32))
        w.put(pv, r, np.arange(4.0) + 10 * r)
    w.flush()
    w.close()
    data, units = spnc.read_cdf(str(path))
    np.testing.assert_allclose(np.asarray(data["static"]), np.arange(4.0))
    np.testing.assert_allclose(np.asarray(data["time"]).ravel(),
                               [0.0, 60.0, 120.0])
    np.testing.assert_allclose(np.asarray(data["prof"])[2],
                               np.arange(4.0) + 20.0)
    assert units["prof"] == "K"


@pytest.mark.parametrize("writer", ["PythonCDFWriter", "NativeCDFWriter"])
def test_roundtrip(tmp_path, writer):
    _roundtrip(getattr(spnc, writer), tmp_path / "f.nc")


def test_native_builds_in_the_port():
    """g++ builds the port's own source into the port's _build directory,
    keyed by its hash; nothing is read from or written to root csrc/."""
    lib = spnc._load_lib()
    assert lib is not None, "g++ build of the port's spnc.cpp failed"
    path = spnc.lib_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "sp_coupler_tpu_torch", "_build")
    assert os.path.isfile(path) and lib._name == path
    assert spnc.SRC == os.path.join(ROOT, "sp_coupler_tpu_torch", "csrc",
                                    "spnc.cpp")
    with open(spnc.SRC) as a, open(os.path.join(ROOT, "csrc", "spnc",
                                                "spnc.cpp")) as b:
        code = lambda f: [ln for ln in f.read().splitlines()
                          if not ln.startswith("//")]
        assert code(a) == code(b)       # the same writer, its own copy


def test_fallback_is_logged(monkeypatch, caplog, tmp_path):
    """A failed build gives the Python writer and a WARNING."""
    monkeypatch.setattr(spnc, "_lib", None)
    monkeypatch.setattr(spnc, "_lib_tried", False)
    monkeypatch.setattr(spnc, "SRC", str(tmp_path / "missing.cpp"))
    with caplog.at_level(logging.WARNING, logger=spnc.__name__):
        w = spnc.create_writer(str(tmp_path / "f.nc"))
    assert isinstance(w, spnc.PythonCDFWriter)
    assert any(r.levelno == logging.WARNING for r in caplog.records)
    w.close()


def test_async_many_records(tmp_path):
    w = spnc.NativeCDFWriter(str(tmp_path / "big.nc"))
    t = w.def_dim("time", None)
    y = w.def_dim("y", 32)
    x = w.def_dim("x", 32)
    v = w.def_var("f", "1", [t, y, x])
    w.enddef()
    for r in range(50):
        w.put(v, r, np.full((32, 32), float(r), np.float32))
    w.flush()
    assert w.queue_depth() == 0
    w.close()
    data, _ = spnc.read_cdf(str(tmp_path / "big.nc"))
    arr = np.asarray(data["f"])
    assert arr.shape == (50, 32, 32)
    np.testing.assert_allclose(arr[17], 17.0)
    np.testing.assert_allclose(arr[49], 49.0)


@pytest.mark.parametrize("writer", ["PythonCDFWriter", "NativeCDFWriter"])
def test_scipy_and_jax_read_it(tmp_path, writer):
    """The file is a valid netCDF classic file: scipy and the JAX package's
    reader read what the port wrote."""
    from scipy.io import netcdf_file
    path = str(tmp_path / "s.nc")
    w = getattr(spnc, writer)(path)
    t = w.def_dim("time", None)
    z = w.def_dim("z", 3)
    v = w.def_var("q", "kg/kg", [t, z])
    w.enddef()
    w.put(v, 0, np.asarray([1.0, 2.0, 3.0], np.float32))
    w.flush()
    w.close()
    f = netcdf_file(path, "r", mmap=False)
    np.testing.assert_allclose(f.variables["q"][0], [1.0, 2.0, 3.0])
    assert f.variables["q"].units == b"kg/kg"
    f.close()
    data, units = jspnc.read_cdf(path)
    np.testing.assert_array_equal(data["q"], [[1.0, 2.0, 3.0]])
    assert units["q"] == "kg/kg"


def test_fleet_cross_sections(tmp_path):
    g = lgrid.LESGrid(nx=8, ny=8, nz=10, dx=100.0, dy=100.0, dz=100.0)
    prof = torch.linspace(300.0, 310.0, 10).repeat(2, 1)
    state = lstate.init_state(g, prof * 0, prof * 0, prof,
                              torch.full((2, 10), 0.01), 1e5,
                              torch.Generator().manual_seed(0))
    io = crossio.FleetCrossIO(str(tmp_path), g, [11, 22], heights=(2, 5))
    ql = torch.zeros((2, 10, 8, 8))
    ql[:, 5] = 1e-4
    io.write(state, ql, 60.0)
    io.write(state, ql, 120.0)
    io.close()
    for pos, col in enumerate((11, 22)):
        data, units = spnc.read_cdf(
            str(tmp_path / ("les-work-%d" % col) / "cross.nc"))
        thl = np.asarray(data["thlxy002"])
        assert thl.shape == (2, 8, 8)
        np.testing.assert_array_equal(thl[1], state.thl[pos, 2].numpy())
        np.testing.assert_array_equal(np.asarray(data["wxy005"])[0],
                                      state.w[pos, 5].numpy())
        # LWP = rho * ql * dz at the one cloudy level
        lwp = np.asarray(data["lwp"])
        assert lwp.shape == (2, 8, 8) and np.all(lwp > 0)
        np.testing.assert_allclose(
            lwp[0], float(state.rhobf[pos, 5]) * 1e-4 * 100.0, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(data["time"]).ravel(),
                                   [60.0, 120.0])
        assert units["lwp"] == "kg/m^2"


# ---- the driver's cross.nc against the JAX driver's ------------------------

SMALL = dict(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
             les_itot=16, les_jtot=16, les_ktot=24, les_xsize=3200.0,
             les_ysize=3200.0, les_dz=100.0, les_dt=5.0, timing_phases=0,
             max_num_les=1, les_cross=True, les_cross_heights=(2, 10),
             les_cross_dtav=60.0)
POINT = (300.0, 15.0)


def _cross(odir, col):
    return spnc.read_cdf(os.path.join(odir, "les-work-%d" % col,
                                      "cross.nc"))


@pytest.fixture(scope="module")
def cross_runs(tmp_path_factory):
    """The JAX driver and the port's from its start state, 2 coupled steps
    each with les_cross on."""
    d = {k: str(tmp_path_factory.mktemp(k) / "run") for k in ("jax", "port")}
    rj = JRunner(JConfig(output_dir=d["jax"], **SMALL), [jgeom.Point(POINT)])
    rj.initialize()
    start = [jax.tree.map(np.asarray, s)
             for s in (rj.gcm.state, rj.fleet.state)]
    rj.run(2)
    rj.finalize(save_restart=False)
    rt = SPRunner(SPConfig(output_dir=d["port"], **SMALL),
                  [geometry.Point(POINT)], device="cpu")
    rt.initialize()
    assert rt.crossio is not None and rt.coupled is not None
    rt.gcm.state = interop.gcm_state(start[0], "cpu")
    rt.fleet.state = interop.les_state(start[1], "cpu")
    rt.run(2)
    rt.finalize(save_restart=False)
    assert rt.sp_cols == rj.sp_cols
    return {k: _cross(d[k], rt.sp_cols[0]) for k in d}


def test_driver_writes_cross_sections(cross_runs):
    """One record a step at the dtav cadence capped by the coupled step,
    levels 1-based in the config and 0-based in the names."""
    data, units = cross_runs["port"]
    np.testing.assert_array_equal(data["time"].ravel(), [600.0, 1200.0])
    assert data["thlxy001"].shape == (2, 16, 16)
    assert sorted(data) == sorted(cross_runs["jax"][0])
    assert np.all(np.isfinite(data["lwp"])) and units["lwp"] == "kg/m^2"
    assert units == cross_runs["jax"][1]


def test_driver_cross_sections_match_jax(cross_runs):
    got, ref = cross_runs["port"][0], cross_runs["jax"][0]
    for var in sorted(ref):
        a, b = np.asarray(got[var]), np.asarray(ref[var])
        assert a.shape == b.shape and np.all(np.isfinite(a)), var
        scale = max(float(np.max(np.abs(b))), 1e-12)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * scale,
                                   err_msg=var)
