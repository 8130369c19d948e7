"""ctypes binding for the native async netCDF-classic writer.

Port of ``sp_coupler_tpu/io/spnc.py``. The C++ writer is the port's own
copy, ``sp_coupler_tpu_torch/csrc/spnc.cpp``: g++ builds it at first use
into ``sp_coupler_tpu_torch/_build/libspnc-<hash>.so`` (git-ignored),
keyed by a hash of the source and the compile command as the CUDA
builds are (``ops/_build.py``), and never into or from the repository's
root ``csrc/``. Where the build fails, the writers fall back to the
pure-Python synchronous CDF-2 writer with the same interface, and say so
at WARNING. The files need no h5py, and scipy reads them.
"""

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import tempfile
import threading

import numpy as np

log = logging.getLogger(__name__)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "spnc.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_lib = None
_lib_tried = False


def gxx_command(src, out):
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", src,
            "-o", out]


def lib_path():
    """Where the build of the current source lives."""
    h = hashlib.sha256(" ".join(gxx_command("src", "out")).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "libspnc-%s.so" % h.hexdigest()[:16])


def _build():
    """Compile csrc/spnc.cpp unless this source is built; return the .so."""
    out = lib_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(gxx_command(SRC, tmp), capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed (%d): %s" % (res.returncode,
                                                        res.stderr))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load_lib():
    """The native writer's ctypes handle, built on first use; None (and a
    WARNING) where it cannot be built or loaded."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = _build()
        lib = ctypes.CDLL(path)
        lib.spnc_create.restype = ctypes.c_void_p
        lib.spnc_create.argtypes = [ctypes.c_char_p]
        lib.spnc_def_dim.restype = ctypes.c_int32
        lib.spnc_def_dim.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint32]
        lib.spnc_def_var.restype = ctypes.c_int32
        lib.spnc_def_var.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.spnc_enddef.argtypes = [ctypes.c_void_p]
        lib.spnc_put.restype = ctypes.c_int32
        lib.spnc_put.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_uint64]
        lib.spnc_queue_depth.restype = ctypes.c_int64
        lib.spnc_queue_depth.argtypes = [ctypes.c_void_p]
        lib.spnc_flush.argtypes = [ctypes.c_void_p]
        lib.spnc_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        log.info("native spnc writer loaded (%s)", path)
    except Exception as e:
        log.warning("native spnc writer unavailable (%s); using the Python "
                    "CDF-2 writer", e)
        _lib = None
    return _lib


class NativeCDFWriter:
    """Async netCDF-classic writer backed by the C++ worker thread."""

    def __init__(self, path):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native spnc not available")
        self._lib = lib
        self._h = lib.spnc_create(path.encode())
        if not self._h:
            raise OSError("spnc_create failed for " + path)
        self._open = True

    def def_dim(self, name, length):
        """length None/0 -> the record (unlimited) dimension."""
        return self._lib.spnc_def_dim(self._h, name.encode(),
                                      0 if not length else int(length))

    def def_var(self, name, units, dimids):
        arr = (ctypes.c_int32 * len(dimids))(*dimids)
        return self._lib.spnc_def_var(self._h, name.encode(),
                                      units.encode(), len(dimids), arr)

    def enddef(self):
        self._lib.spnc_enddef(self._h)

    def put(self, vid, rec, data):
        data = np.ascontiguousarray(data, np.float32)
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.spnc_put(self._h, vid, rec, ptr, data.size)

    def queue_depth(self):
        return int(self._lib.spnc_queue_depth(self._h))

    def flush(self):
        self._lib.spnc_flush(self._h)

    def close(self):
        if self._open:
            self._lib.spnc_close(self._h)
            self._open = False


class PythonCDFWriter:
    """Synchronous pure-Python CDF-2 writer with the same interface."""

    def __init__(self, path):
        self.path = path
        self.dims = []       # (name, len)
        self.vars = []       # dict(name, units, dimids, vsize, begin, rec)
        self.rec_dimid = -1
        self.numrecs = 0
        self.recsize = 0
        self.f = open(path, "w+b")
        self._lock = threading.Lock()

    def def_dim(self, name, length):
        self.dims.append((name, 0 if not length else int(length)))
        if not length:
            self.rec_dimid = len(self.dims) - 1
        return len(self.dims) - 1

    def def_var(self, name, units, dimids):
        self.vars.append(dict(name=name, units=units, dimids=list(dimids),
                              rec=self.rec_dimid in dimids,
                              vsize=0, begin=0))
        return len(self.vars) - 1

    @staticmethod
    def _name(b, s):
        b += struct.pack(">I", len(s)) + s.encode()
        while len(b) % 4:
            b += b"\x00"
        return b

    def _header(self):
        b = b"CDF\x02" + struct.pack(">I", self.numrecs)
        if self.dims:
            b += struct.pack(">II", 0x0A, len(self.dims))
            for n, ln in self.dims:
                b = self._name(b, n)
                b += struct.pack(">I", ln)
        else:
            b += struct.pack(">II", 0, 0)
        b += struct.pack(">II", 0, 0)
        if self.vars:
            b += struct.pack(">II", 0x0B, len(self.vars))
            for v in self.vars:
                b = self._name(b, v["name"])
                b += struct.pack(">I", len(v["dimids"]))
                for d in v["dimids"]:
                    b += struct.pack(">I", d)
                if v["units"]:
                    b += struct.pack(">II", 0x0C, 1)
                    b = self._name(b, "units")
                    b += struct.pack(">I", 2)
                    b = self._name(b, v["units"])
                else:
                    b += struct.pack(">II", 0, 0)
                b += struct.pack(">II", 5, v["vsize"] & 0xFFFFFFFF)
                b += struct.pack(">Q", v["begin"])
        else:
            b += struct.pack(">II", 0, 0)
        return b

    def enddef(self):
        hdr = self._header()
        off = (len(hdr) + 3) & ~3
        for v in self.vars:
            n = 4
            for d in v["dimids"]:
                if d != self.rec_dimid:
                    n *= self.dims[d][1]
            v["vsize"] = (n + 3) & ~3
            if not v["rec"]:
                v["begin"] = off
                off += v["vsize"]
        self.recsize = 0
        for v in self.vars:
            if v["rec"]:
                v["begin"] = off + self.recsize
                self.recsize += v["vsize"]
        self.f.seek(0)
        self.f.write(self._header())

    def put(self, vid, rec, data):
        v = self.vars[vid]
        data = np.ascontiguousarray(data, ">f4")
        off = v["begin"] + (rec * self.recsize if v["rec"] else 0)
        with self._lock:
            self.f.seek(off)
            self.f.write(data.tobytes())
            if v["rec"]:
                self.numrecs = max(self.numrecs, rec + 1)

    def queue_depth(self):
        return 0

    def flush(self):
        with self._lock:
            self.f.seek(4)
            self.f.write(struct.pack(">I", self.numrecs))
            self.f.flush()

    def close(self):
        self.flush()
        self.f.close()


def create_writer(path):
    """Native async writer when available, Python fallback otherwise."""
    if _load_lib() is not None:
        try:
            return NativeCDFWriter(path)
        except Exception as e:
            log.warning("native spnc writer failed (%s); using the "
                        "Python CDF-2 writer", e)
    return PythonCDFWriter(path)


def read_cdf(path):
    """Tiny CDF-1/2 reader for tests: returns {var: array}, {var: units}."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0

    def u32():
        nonlocal pos
        v = struct.unpack_from(">I", buf, pos)[0]
        pos += 4
        return v

    def name():
        nonlocal pos
        n = u32()
        s = buf[pos:pos + n].decode()
        pos += (n + 3) & ~3
        return s

    assert buf[:3] == b"CDF"
    version = buf[3]
    pos = 4
    numrecs = u32()
    dims = []
    tag = u32()
    ndims = u32()
    if tag == 0x0A:
        for _ in range(ndims):
            dims.append((name(), u32()))
    # global atts
    gtag = u32()
    ngat = u32()
    assert gtag in (0, 0x0C) and ngat == 0
    data, units = {}, {}
    vtag = u32()
    nvars = u32()
    rec_dim = next((i for i, d in enumerate(dims) if d[1] == 0), -1)
    if vtag == 0x0B:
        for _ in range(nvars):
            vn = name()
            nd = u32()
            dimids = [u32() for _ in range(nd)]
            atag = u32()
            nat = u32()
            un = ""
            if atag == 0x0C:
                for _ in range(nat):
                    an = name()
                    at = u32()
                    av = name()
                    if an == "units":
                        un = av
            nctype = u32()
            vsize = u32()
            if version >= 2:
                begin = struct.unpack_from(">Q", buf, pos)[0]
                pos += 8
            else:
                begin = u32()
            shape = [dims[d][1] for d in dimids]
            is_rec = rec_dim in dimids
            if is_rec:
                shape[dimids.index(rec_dim)] = numrecs
            n_per = int(np.prod([s for d, s in zip(dimids, shape)
                                 if d != rec_dim])) if dimids else 1
            if is_rec:
                # records are interleaved; gather with stride
                recsize = 0  # recompute below
                data[vn] = ("REC", begin, n_per, shape)
            else:
                arr = np.frombuffer(buf, ">f4", int(np.prod(shape)) if shape
                                    else 1, begin)
                data[vn] = arr.reshape(shape)
            units[vn] = un
    # second pass for record vars: need total recsize
    rec_vars = [(vn, v) for vn, v in data.items()
                if isinstance(v, tuple) and v[0] == "REC"]
    recsize = sum(((v[2] * 4 + 3) & ~3) for _, v in rec_vars)
    for vn, (_, begin, n_per, shape) in rec_vars:
        out = np.empty((numrecs, n_per), ">f4")
        for r in range(numrecs):
            out[r] = np.frombuffer(buf, ">f4", n_per, begin + r * recsize)
        data[vn] = out.reshape(shape)
    return data, units
