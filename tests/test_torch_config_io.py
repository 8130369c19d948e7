"""The port's host-side copies against the JAX package's: run
configuration, region selection, input decks and the spifs.nc files,
which each package writes and the other reads."""

import dataclasses
import json

import numpy as np
import pytest

from sp_coupler_tpu import config as jconfig
from sp_coupler_tpu.io import spifs as jspifs
from sp_coupler_tpu.models.gcm import spharm as jspharm
from sp_coupler_tpu.utils import decks as jdecks, geometry as jgeom
from sp_coupler_tpu_torch import config as tconfig
from sp_coupler_tpu_torch.io import spifs as tspifs
from sp_coupler_tpu_torch.models.gcm import model as tmodel
from sp_coupler_tpu_torch.utils import decks as tdecks, geometry as tgeom

from test_decks import write_case


def test_config_fields_match():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        tconfig.SPConfig)] == [(f.name, f.default) for f in
                               dataclasses.fields(jconfig.SPConfig)])


def test_read_config_same_json(tmp_path):
    """One --conf JSON gives the same configuration in both packages,
    unknown keys skipped in both."""
    conf = dict(gcm_truncation=42, les_itot=32, qt_forcing="variance",
                cplsurf=True, les_cross_heights=[2, 10], timing_phases=1,
                seed=7, output_dir="somewhere", not_a_knob=3)
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    a = tconfig.read_config(str(path))
    b = jconfig.read_config(str(path))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.gcm_truncation == 42 and a.les_dx == b.les_dx == 400.0
    assert a.output_path == b.output_path
    base = tconfig.SPConfig(les_jtot=8)
    c = tconfig.read_config(conf, base=base)
    d = jconfig.read_config(conf, base=jconfig.SPConfig(les_jtot=8))
    assert dataclasses.asdict(c) == dataclasses.asdict(d)
    assert c.les_jtot == 8


def _t21_points():
    sht = jspharm.SpectralTransform(21)
    lats, lons = sht.latitudes_deg(), sht.longitudes_deg()
    return list(zip(np.tile(lons, len(lats)), np.repeat(lats, len(lons))))


def test_run_t21_columns():
    """run_T21.sh's polygon on the port's T21 grid selects columns 824 and
    888, the JAX package's on its own grid; the grids are equal."""
    g = tmodel.GCMModel(tmodel.GCMConfig(), device="cpu")
    pts = list(zip(g.longitudes, g.latitudes))
    ref = _t21_points()
    np.testing.assert_array_equal(np.asarray(pts), np.asarray(ref))
    corners = "20 -50 10 -50 10 -40 20 -40".split()
    got = tgeom.get_mask_indices(
        pts, [tgeom.Polygon(tgeom.parse_lat_lons(corners))], 2)
    want = jgeom.get_mask_indices(
        ref, [jgeom.Polygon(jgeom.parse_lat_lons(corners))], 2)
    assert got == want == [824, 888]


def _geojson(tmp_path, geom):
    path = tmp_path / "region.json"
    path.write_text(json.dumps({"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": geom, "properties": {}}]}))
    return str(path)


@pytest.mark.parametrize("case", ["point", "points", "polygon", "box",
                                  "geojson_polygon", "geojson_point"])
def test_get_mask_indices(tmp_path, case):
    pts = _t21_points()
    poly = [(300.0, 10.0), (320.0, 10.0), (320.0, 25.0), (300.0, 25.0)]

    def geoms(m):
        return {
            "point": lambda: ([m.Point((300.0, 15.0))], 3),
            "points": lambda: ([m.Point((300.0, 15.0)),
                                m.Point((10.0, -40.0))], -1),
            "polygon": lambda: ([m.Polygon(poly)], -1),
            "box": lambda: ([m.Box(-20.0, -10.0, 20.0, 10.0)], -1),
            "geojson_polygon": lambda: ([m.read_poly_file(_geojson(
                tmp_path, {"type": "Polygon", "coordinates": [
                    [[-60.0, 10.0], [-40.0, 10.0], [-40.0, 25.0],
                     [-60.0, 10.0]]]}))], -1),
            "geojson_point": lambda: ([m.read_poly_file(_geojson(
                tmp_path, {"type": "Point", "coordinates": [300.0, 15.0]}
            ))], 2),
        }[case]()

    got = tgeom.get_mask_indices(pts, *geoms(tgeom))
    want = jgeom.get_mask_indices(pts, *geoms(jgeom))
    assert got == want and len(got) > 0
    assert (tgeom.parse_lat_lons(["10", "-50", "20", "130", "5"])
            == jgeom.parse_lat_lons(["10", "-50", "20", "130", "5"]))


def test_decks_match(tmp_path):
    les, gcm = write_case(tmp_path)
    assert tdecks.dales_overrides(les) == jdecks.dales_overrides(les)
    assert tdecks.oifs_overrides(gcm) == jdecks.oifs_overrides(gcm)
    a = tdecks.apply_decks(tconfig.SPConfig(les_input_dir=les,
                                            gcm_input_dir=gcm))
    b = jdecks.apply_decks(jconfig.SPConfig(les_input_dir=les,
                                            gcm_input_dir=gcm))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.les_subgrid == "smagorinsky" and a.restart_steps == 179
    pa, pb = tdecks.read_dales_prof(les), jdecks.read_dales_prof(les)
    assert sorted(pa) == sorted(pb)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k])


def _write(mod, path, append=False):
    """A spifs.nc with one LES column and one output column, 2 records
    (3 after an append), through the writer of module mod."""
    rng = np.random.default_rng(0)
    info = dict(x=np.arange(4) * 50.0, y=np.arange(4) * 50.0,
                zf=np.arange(6) * 25.0)
    w = mod.SpifsWriter(path, 5, info, "2000-01-01 00:00:00", append=append,
                        with_surf_vars=True)
    if not append:
        w.add_les_column(12, 15.0, 300.0)
        w.add_output_column(40, -10.0, 20.0)
    for t in ((1800.0,) if append else (900.0, 1800.0)):
        w.update_time(t)
        w.write_column(12, thl=rng.normal(300, 1, 6), T=rng.normal(280, 1, 5),
                       rain=1e-3, z0m=0.1, f_U=rng.normal(0, 1, 5))
        w.write_column(40, T=rng.normal(280, 1, 5), Psurf=1e5)
    w.sync()
    w.close()


def _read(mod, path):
    ds = mod.open_reader(path)
    try:
        out = {"dims": ds.dimensions,
               "Time": (np.asarray(ds.variables["Time"][:]),
                        ds.variables["Time"].units)}
        for name, g in ds.groups.items():
            out[name] = {k: (np.asarray(v[...]), v.units)
                         for k, v in g.variables.items()}
        return out
    finally:
        ds.close()


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        if isinstance(b[k], dict) and k != "dims":
            assert sorted(a[k]) == sorted(b[k]), k
            for var in b[k]:
                np.testing.assert_array_equal(a[k][var][0], b[k][var][0])
                assert a[k][var][1] == b[k][var][1], (k, var)
        elif k == "Time":
            np.testing.assert_array_equal(a[k][0], b[k][0])
            assert a[k][1] == b[k][1]
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("writer, reader, appender", [
    pytest.param("port", "jax", "port", id="port-jax"),
    pytest.param("jax", "port", "jax", id="jax-port"),
    pytest.param("jax", "port", "port", id="jax-port-appended-by-port"),
    pytest.param("port", "jax", "jax", id="port-jax-appended-by-jax")])
def test_spifs_written_by_one_read_by_the_other(tmp_path, writer, reader,
                                                appender):
    """Same groups, variables, units, shapes and values whichever package
    writes the file, whichever appends to it (the port through h5lite, the
    JAX package through h5py) and whichever reads it."""
    mods = {"port": tspifs, "jax": jspifs}
    p1, p2 = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
    _write(mods[writer], p1)
    _write(mods[appender], p1, append=True)
    _write(mods[reader], p2)
    _write(mods[reader], p2, append=True)
    got = _read(mods[reader], p1)
    _same(got, _read(mods[reader], p2))
    assert got["Time"][0].tolist() == [900.0, 1800.0, 1800.0]
    assert got["12"]["thl"][0].shape == (3, 6)
    assert "thl" not in got["40"] and got["40"]["T"][0].shape == (3, 5)
    assert len(tspifs.LES_PROFILE_VARS) == 20
    assert tspifs.LES_PROFILE_VARS == jspifs.LES_PROFILE_VARS
    assert tspifs.GCM_PROFILE_VARS == jspifs.GCM_PROFILE_VARS
    assert tspifs.SURFACE_FLUX_VARS == jspifs.SURFACE_FLUX_VARS
