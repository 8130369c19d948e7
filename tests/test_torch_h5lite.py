"""The port's HDF5 writer and reader (``io/h5lite.py``) against h5py.

spifs.nc is netCDF-4: HDF5 with a group per column. The port writes and
reads it through h5lite on every host; h5py, where installed, is the
independent reader here, and the JAX package's writer the reference for
what the same calls give:
- test_ncformat.py's two tests on a file the port writes;
- the port's file and the JAX package's (h5py) file of the same calls,
  appends included, read by h5py: the same objects, attributes (dimension
  scales' back-references in the same order), layouts, chunks, filters,
  fill settings and values;
- the golden recording read through h5lite equals h5py's read of it;
- chunk B-trees of two levels (600 records, 75 chunks) and groups of
  several symbol-table nodes (40 links), with and without gzip + shuffle;
- the dimension-scale limit: past one object-header message of
  back-references a scale keeps the first ones, with one WARNING;
- a reader in another process sees every record after a flush made by a
  write-behind thread.
"""

import datetime
import logging
import os
import subprocess
import sys
import threading

import h5py
import numpy as np
import pytest

from sp_coupler_tpu.io import spifs as jspifs
from sp_coupler_tpu_torch.io import h5lite, spifs

GOLDEN_NC = os.path.join(os.path.dirname(__file__), "golden", "spifs.nc")


def _write_sample(path, mod=spifs, compress=0):
    """tests/test_ncformat.py's sample, through the port's writer (or the
    spifs module mod)."""
    w = mod.SpifsWriter(
        str(path), gcm_ktot=8,
        les_info={"x": np.arange(4) * 100.0 + 50.0,
                  "y": np.arange(4) * 100.0 + 50.0,
                  "zf": np.arange(6) * 25.0 + 12.5},
        start_time=datetime.datetime(2000, 1, 1), compress=compress)
    w.add_les_column(7, 13.0, -59.0)
    w.add_output_column(9, 14.0, -58.0)
    for s in range(3):
        w.update_time(900.0 * (s + 1))
        w.write_column(7, thl=np.full(6, 300.0), U=np.full(8, 5.0),
                       rain=0.5 * s)
        w.write_column(9, U=np.full(8, 4.0))
    w.sync()
    w.close()


def _append_sample(path, mod=spifs):
    """tests/test_ncformat.py's append: one more record of column 7."""
    w = mod.SpifsWriter(str(path), gcm_ktot=8, append=True)
    w.update_time(3600.0)
    w.write_column(7, thl=np.full(6, 301.0))
    w.close()


# ---- (a) tests/test_ncformat.py on the port's file --------------------------

def test_netcdf4_hdf5_conventions(tmp_path):
    path = tmp_path / "spifs.nc"
    _write_sample(path)

    f = h5py.File(str(path), "r")
    # the container: superblock 0, 8-byte offsets and lengths, group K 4/16
    assert f.id.get_create_plist().get_version() == (0, 0, 0, 0)
    assert f.id.get_create_plist().get_sizes() == (8, 8)
    with open(path, "rb") as raw:
        assert raw.read(20)[16:20] == b"\x04\x00\x10\x00"
    # provenance marker
    assert "_NCProperties" in f.attrs

    # dimension scales at root
    for dim in ("Time", "x", "y", "zf", "oifs_height"):
        d = f[dim]
        assert d.attrs.get("CLASS", b"") == b"DIMENSION_SCALE", dim

    # Time: unlimited record coordinate with units
    t = f["Time"]
    assert t.maxshape == (None,)
    assert t.shape == (3,)
    units = t.attrs["units"]
    units = units.decode() if isinstance(units, bytes) else units
    assert units.startswith("s since 2000-01-01")

    # phony (non-variable) dimension keeps the netCDF marker text
    name = f["oifs_height"].attrs["NAME"]
    name = name.decode() if isinstance(name, bytes) else name
    assert name.startswith("This is a netCDF dimension but not a")

    # group variables carry DIMENSION_LIST referencing the root scales
    g = f["7"]
    thl = g["thl"]
    assert "DIMENSION_LIST" in thl.attrs
    refs = thl.attrs["DIMENSION_LIST"]
    scales = [f[refs[ax][0]].name for ax in range(2)]
    assert scales == ["/Time", "/zf"]
    assert thl.shape == (3, 6) and thl.dtype == np.float32
    assert thl.chunks == (8, 6) and thl.maxshape == (None, 6)

    U = g["U"]
    refs = U.attrs["DIMENSION_LIST"]
    assert f[refs[1][0]].name == "/oifs_height"

    # scalar-per-step variable rides the record dimension alone
    rain = g["rain"]
    assert rain.shape == (3,) and rain.maxshape == (None,)
    np.testing.assert_allclose(rain[:], [0.0, 0.5, 1.0])
    assert g["lat"].shape == () and float(g["lat"][()]) == 13.0
    f.close()


def test_append_preserves_conventions(tmp_path):
    path = tmp_path / "spifs.nc"
    _write_sample(path)
    _append_sample(path)

    f = h5py.File(str(path), "r")
    assert f["Time"].shape == (4,)
    assert f["Time"].attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
    assert f["7"]["thl"].shape == (4, 6)
    assert float(f["7"]["thl"][3, 0]) == 301.0
    f.close()


# ---- (c) the golden recording through h5lite --------------------------------

def h5py_names(f):
    """name_of(reference) for an h5py file: a map of object ids to paths
    (h5py's .name of a dereferenced object searches the whole file)."""
    names = {f.id: "/"}

    def visit(name, obj):
        names.setdefault(obj.id, "/" + name)   # None: visit every object

    f.visititems(visit)
    return lambda ref: names[f[ref].id]


def h5lite_names(f):
    return lambda ref: f[h5lite.Reference(ref)].name


def _attrs(obj, name_of):
    """An object's attributes, references resolved to names."""
    out = {}
    for k in obj.attrs:
        v = obj.attrs[k]
        if k == "DIMENSION_LIST":
            v = [[name_of(r) for r in ax] for ax in v]
        elif k == "REFERENCE_LIST":
            v = [(name_of(r), int(d)) for r, d in v]
        else:
            v = (type(v).__name__, np.asarray(v).tolist())
        out[k] = v
    return out


def _layout(path):
    """Every object of a file as h5py reads it: attributes (references
    resolved to names; _NCProperties names the writer and is left out),
    a group's links, a dataset's layout, chunks, filters, fill settings
    and values."""
    out = {}
    with h5py.File(str(path), "r") as f:
        name_of = h5py_names(f)

        def visit(name, obj):
            attrs = _attrs(obj, name_of)
            attrs.pop("_NCProperties", None)
            if isinstance(obj, h5py.Group):
                out[name] = (attrs, sorted(obj.keys()))
                return
            p = obj.id.get_create_plist()
            out[name] = (attrs, obj.shape, obj.maxshape, obj.chunks,
                         obj.dtype.str, obj.compression,
                         obj.compression_opts, obj.shuffle,
                         float(obj.fillvalue), p.get_layout(),
                         p.get_fill_time(), p.get_alloc_time(),
                         p.fill_value_defined(),
                         [p.get_filter(i) for i in range(p.get_nfilters())],
                         obj[()].tolist())

        visit("/", f)
        f.visititems(visit)
    return out


@pytest.mark.parametrize("compress", [0, 4], ids=["plain", "gzip+shuffle"])
def test_same_file_as_the_jax_writer(tmp_path, compress):
    """The same calls, appends included, through the port (h5lite) and the
    JAX package (h5py): h5py reads the two files field for field equal,
    DIMENSION_LIST and REFERENCE_LIST (the order of back-references) among
    them."""
    port, ref = tmp_path / "port.nc", tmp_path / "jax.nc"
    _write_sample(port, spifs, compress)
    _append_sample(port, spifs)
    _write_sample(ref, jspifs, compress)
    _append_sample(ref, jspifs)
    got, want = _layout(port), _layout(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert len(want) == 93
    # Time's back-references: 54 variables of the LES column, 27 of the
    # output column (GCM profiles and surface fields)
    out_vars = (spifs.GCM_PROFILE_VARS + spifs.SURFACE_VARS
                + spifs.SURFACE_FLUX_VARS)
    assert len(want["Time"][0]["REFERENCE_LIST"]) == 54 + len(out_vars) == 81
    assert want["7/thl"][1] == (4, 6)


def test_golden_reads_as_h5py_reads_it():
    ref = h5py.File(GOLDEN_NC, "r")
    got = h5lite.File(GOLDEN_NC)
    ref_name, got_name = h5py_names(ref), h5lite_names(got)
    try:
        assert sorted(got.keys()) == sorted(ref.keys())
        assert _attrs(got, got_name) == _attrs(ref, ref_name)
        n = 0
        for gname in ref:
            r, g = ref[gname], got[gname]
            if isinstance(r, h5py.Group):
                assert isinstance(g, h5lite.Group)
                assert sorted(g.keys()) == sorted(r.keys())
                items = [(r[k], g[k]) for k in r]
            else:
                items = [(r, g)]
            for rd, gd in items:
                assert gd.name == rd.name
                assert (gd.shape, gd.maxshape, gd.chunks, gd.dtype,
                        gd.compression, gd.shuffle) == (
                    rd.shape, rd.maxshape, rd.chunks, rd.dtype,
                    rd.compression, rd.shuffle), rd.name
                np.testing.assert_array_equal(gd[()], rd[()])
                assert _attrs(gd, got_name) == _attrs(rd, ref_name), rd.name
                n += 1
        assert n == 16 * 56 + 5
        thl = got["822"]["thl"]
        assert thl.compression == "gzip" and thl.shuffle
        np.testing.assert_array_equal(thl[-1], ref["822"]["thl"][-1])
        np.testing.assert_array_equal(thl[3:50:7, ::-3],
                                      ref["822"]["thl"][()][3:50:7, ::-3])
    finally:
        got.close()
        ref.close()


# ---- (d) two-level chunk B-trees, several symbol-table nodes ----------------

@pytest.mark.parametrize("by", ["record", "box"])
@pytest.mark.parametrize("compress", [0, 4], ids=["plain", "gzip+shuffle"])
def test_many_records_and_groups(tmp_path, compress, by):
    """600 records at 8 a chunk (75 chunks: a two-level chunk B-tree) and
    40 groups (5 symbol-table nodes), flushed as they grow, then appended
    to past another node; h5py reads every value. Records are written by
    an integer key (the record path) or a one-row slice (the box path)."""
    path = str(tmp_path / "many.nc")
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(640, 5)).astype(np.float32)
    kw = dict(compression="gzip", compression_opts=compress,
              shuffle=True) if compress else {}
    f = h5lite.File(path, "w")
    d = f.create_dataset("rec", (0, 5), maxshape=(None, 5), chunks=(8, 5),
                         **kw)
    def put(d, i):
        if by == "record":
            d[i] = rows[i]
        else:
            d[i:i + 1, :] = rows[i:i + 1]

    for i in range(600):
        d.resize(i + 1)
        put(d, i)
        if i % 97 == 0:
            f.flush()
    for k in range(40):
        g = f.create_group("g%02d" % k)
        v = g.create_dataset("v", (3,), maxshape=(3,), **kw)
        v[:] = np.float32(k) + np.arange(3, dtype=np.float32)
    f.close()
    with h5py.File(path, "r") as h:
        assert h["rec"].shape == (600, 5) and h["rec"].chunks == (8, 5)
        np.testing.assert_array_equal(h["rec"][()], rows[:600])
        assert len(h) == 41
        for k in range(40):
            np.testing.assert_array_equal(h["g%02d/v" % k][()],
                                          k + np.arange(3))
    f = h5lite.File(path, "a")
    d = f["rec"]
    for i in range(600, 640):        # the 80th chunk: a new leaf
        d.resize(i + 1)
        put(d, i)
    f.create_group("late")
    f.close()
    with h5py.File(path, "r") as h:
        np.testing.assert_array_equal(h["rec"][()], rows)
        assert len(h) == 42 and "late" in h
        assert (h["rec"].compression == "gzip") == bool(compress)
    with h5lite.File(path) as f:
        np.testing.assert_array_equal(f["rec"][()], rows)
        np.testing.assert_array_equal(f["rec"][597:603], rows[597:603])


# ---- (e) the dimension-scale limit ----------------------------------------

def test_reference_list_keeps_the_first_that_fit(tmp_path, caplog):
    """80 LES columns attach 54 variables each to Time: 4,320
    back-references, past the 4,085 one message holds. Every variable
    keeps its DIMENSION_LIST; Time's REFERENCE_LIST is the first 4,085 in
    attach order; one WARNING names the scale and the count."""
    path = str(tmp_path / "wide.nc")
    ncol = 80
    with caplog.at_level(logging.WARNING, logger=h5lite.__name__):
        w = spifs.SpifsWriter(path, 3, dict(x=np.arange(2.0),
                                            y=np.arange(2.0),
                                            zf=np.arange(4.0)),
                              "2000-01-01 00:00:00")
        for c in range(ncol):
            w.add_les_column(c, 0.0, 0.0)
        w.update_time(900.0)
        w.write_column(5, thl=np.ones(4))
        w.sync()
        w.update_time(1800.0)
        w.sync()
        w.close()
    warned = [r for r in caplog.records if "REFERENCE_LIST" in r.message]
    assert len(warned) == 1
    assert "/Time" in warned[0].message and "4085 of 4320" in \
        warned[0].message
    per_col = ([v for v, _ in spifs.GCM_PROFILE_VARS]
               + [v for v, _ in spifs.SURFACE_VARS + spifs.SURFACE_FLUX_VARS]
               + [v for v, _ in spifs.LES_PROFILE_VARS]
               + [v for v, _ in spifs.GCM_FORCING_VARS])
    want = [("/%d/%s" % (c, v), 0) for c in range(ncol) for v in per_col]
    with h5py.File(path, "r") as f:
        name_of = h5py_names(f)
        rl = f["Time"].attrs["REFERENCE_LIST"]
        assert len(rl) == h5lite._RefList.LIMIT == 4085
        assert [(name_of(r), int(d)) for r, d in rl] == want[:4085]
        zf = f["zf"].attrs["REFERENCE_LIST"]
        assert len(zf) == ncol * len(spifs.LES_PROFILE_VARS)
        for c in range(ncol):
            for v in per_col:
                dl = f["%d/%s" % (c, v)].attrs["DIMENSION_LIST"]
                names = [name_of(ax[0]) for ax in dl]
                assert names[0] == "/Time"
                assert names[1:] in ([], ["/zf"], ["/oifs_height"])
        np.testing.assert_array_equal(f["5/thl"][0], np.ones(4))
        assert f["Time"].shape == (2,)


# ---- (f) a reader in another process, after a write-behind flush -----------

READER = """
import sys
import h5py
with h5py.File(sys.argv[1], "r") as f:
    t = f["Time"][()]
    rows = f["1/thl"][()]
print(len(t), float(t[-1]), float(rows[-1, 0]), float(rows[:, 0].sum()))
"""


def test_reader_in_another_process_after_flush(tmp_path):
    """The driver's write-behind contract: a thread writes and flushes
    (write_column(lock=True) and sync), while this thread adds columns;
    after each flush, h5py in a second process sees every record written
    so far. The switch interval is shortened so the threads interleave."""
    path = str(tmp_path / "wb.nc")
    w = spifs.SpifsWriter(path, 4, dict(x=np.arange(2.0), y=np.arange(2.0),
                                        zf=np.arange(5.0)),
                          "2000-01-01 00:00:00", compress=4)
    w.add_les_column(1, 0.0, 0.0)
    done, errors = threading.Event(), []

    def write_behind(n0, n1):
        try:
            for s in range(n0, n1):
                with w.lock:
                    w.update_time(900.0 * (s + 1))
                w.write_column(1, lock=True, thl=np.full(5, float(s)))
                w.sync()
        except Exception as e:      # reported by the test thread
            errors.append(e)
        finally:
            done.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        seen = []
        for n0, n1, extra in ((0, 3, range(2, 6)), (3, 13, range(6, 12))):
            done.clear()
            t = threading.Thread(target=write_behind, args=(n0, n1))
            t.start()
            for c in extra:
                with w.lock:
                    w.add_output_column(c, 1.0, 2.0)
            t.join(timeout=60)
            assert not t.is_alive() and done.is_set() and not errors, errors
            w.sync()
            out = subprocess.run([sys.executable, "-c", READER, path],
                                 capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr
            seen.append(out.stdout.split())
    finally:
        sys.setswitchinterval(old)
        w.close()
    assert seen[0] == ["3", "2700.0", "2.0", "3.0"]
    assert seen[1] == ["13", "11700.0", "12.0", str(float(sum(range(13))))]
    with h5py.File(path, "r") as f:
        assert sorted(int(k) for k in f if k.isdigit()) == [1] + list(
            range(2, 12))
