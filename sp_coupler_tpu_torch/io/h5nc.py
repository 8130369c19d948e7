"""Minimal netCDF4-style file layer on HDF5, through ``h5lite``.

The API of ``sp_coupler_tpu/io/h5nc.py``: spifs.nc is an HDF5 file
following the netCDF-4 conventions (groups, dimension scales, unlimited
record dimension), written through an API mirroring the subset of
netCDF4-python the reference IO layer uses (Dataset, createDimension/
createVariable/createGroup, variable.units, var[i] = data, sync, append
mode; spio.py). The JAX package writes the same calls through h5py; the
port writes and reads them through ``h5lite``, this package's own HDF5
code, on every host, so it needs no h5py. The files of the two packages
are interchangeable.
"""

import threading

import numpy as np

from . import h5lite

_DIM_NOTE = "This is a netCDF dimension but not a netCDF variable."


class Variable:
    def __init__(self, dset, unlimited_axes):
        self._d = dset
        self._unl = unlimited_axes

    @property
    def name(self):
        return self._d.name.rsplit("/", 1)[-1]

    @property
    def shape(self):
        return self._d.shape

    @property
    def units(self):
        return self._d.attrs.get("units", "")

    @units.setter
    def units(self, val):
        self._d.attrs["units"] = np.bytes_(val)

    def _ensure(self, idx):
        """Grow the record dimension so index idx is writable."""
        if 0 in self._unl:
            need = idx + 1 if isinstance(idx, (int, np.integer)) else None
            if need is not None and self._d.shape[0] < need:
                self._d.resize(need)

    def __setitem__(self, idx, value):
        if isinstance(idx, tuple):
            if len(idx) > 0:
                self._ensure(idx[0])
        else:
            self._ensure(idx)
        self._d[idx] = value

    def __getitem__(self, idx):
        return self._d[idx]

    def __len__(self):
        return self._d.shape[0]


class _GroupMixin:
    def createDimension(self, name, size=None):
        unlimited = size is None
        n = 0 if unlimited else int(size)
        if name in self._h:
            return
        maxshape = (None,) if unlimited else (n,)
        d = self._h.create_dataset(name, shape=(n,), maxshape=maxshape,
                                   dtype="f4")
        d.make_scale(name)
        # netCDF-4 phony-dimension marker; overwritten if a coordinate
        # variable is created for this dimension later
        d.attrs["NAME"] = np.bytes_(_DIM_NOTE + (" %d" % n))
        self._dims[name] = (None if unlimited else n, d)

    def _find_dim(self, name):
        g = self
        while g is not None:
            if name in g._dims:
                return g._dims[name]
            g = g._parent
        raise KeyError("dimension %s not defined" % name)

    def _root(self):
        g = self
        while g._parent is not None:
            g = g._parent
        return g

    def createVariable(self, name, dtype, dims=()):
        shape, maxshape, unl_axes, scales = [], [], [], []
        for ax, dim in enumerate(dims):
            size, scale = self._find_dim(dim)
            scales.append(scale)
            if size is None:
                shape.append(0)
                maxshape.append(None)
                unl_axes.append(ax)
            else:
                shape.append(size)
                maxshape.append(size)
        if name in self._dims and tuple(dims) == (name,):
            # coordinate variable: reuse the scale dataset
            size, d = self._dims[name]
            var = Variable(d, unl_axes)
            d.attrs["NAME"] = np.bytes_(name)  # now a real coordinate variable
            self.variables[name] = var
            return var
        kw = {}
        compress = self._root()._compress
        if unl_axes and shape:
            # keep appended-record storage tight: small record chunks
            # instead of h5py's 128-row default (a 100-step profile var
            # would otherwise allocate 128x40 chunks, 30x the data)
            chunks = tuple(8 if ax in unl_axes else min(s, 1024)
                           for ax, s in enumerate(shape))
            if all(c > 0 for c in chunks):
                kw["chunks"] = chunks
        if compress and shape and np.dtype(dtype).kind == "f":
            kw.update(compression="gzip", compression_opts=int(compress),
                      shuffle=True)
            kw.setdefault("chunks", tuple(max(s, 1) for s in shape))
        d = self._h.create_dataset(name, shape=tuple(shape),
                                   maxshape=tuple(maxshape), dtype=dtype,
                                   **kw)
        for ax, s in enumerate(scales):
            d.dims[ax].attach_scale(s)
        var = Variable(d, unl_axes)
        self.variables[name] = var
        return var

    def createGroup(self, name):
        name = str(name)
        if name in self.groups:
            return self.groups[name]
        sub = Group(self._h.create_group(name), self)
        self.groups[name] = sub
        return sub

    def _load_existing(self):
        """Bind variables/groups of an existing file (append/read mode)."""
        for key, item in self._h.items():
            if isinstance(item, h5lite.Group):
                g = Group(item, self)
                self.groups[key] = g
                g._load_existing()
            else:
                unl = [ax for ax, m in enumerate(item.maxshape)
                       if m is None]
                is_scale = item.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
                note = item.attrs.get("NAME", b"")
                if isinstance(note, str):
                    note = note.encode()
                if is_scale:
                    self._dims[key] = (None if None in item.maxshape
                                       else item.shape[0], item)
                if not (is_scale and note.startswith(b"This is a netCDF")):
                    # real variable (possibly a coordinate variable)
                    self.variables[key] = Variable(item, unl)


class Group(_GroupMixin):
    def __init__(self, h5group, parent):
        self._h = h5group
        self._parent = parent
        self.variables = {}
        self.groups = {}
        self._dims = {}


class Dataset(_GroupMixin):
    """Root file object; thread-safe sync."""

    def __init__(self, path, mode="w", compress=0):
        self._h5file = h5lite.File(path, {"w": "w", "a": "a", "r": "r"}[mode])
        self._h = self._h5file
        self._parent = None
        self._compress = int(compress)  # gzip level for float vars; 0 = off
        self.variables = {}
        self.groups = {}
        self._dims = {}
        self._lock = threading.Lock()
        if mode == "w":
            # netCDF-4 provenance marker (written by netcdf-c; readers use
            # it to identify the file as netCDF-4-flavored HDF5)
            self._h5file.attrs["_NCProperties"] = np.bytes_(
                "version=2,sp_coupler_tpu_torch=0.1,h5lite=1")
        if mode in ("a", "r"):
            self._load_existing()

    @property
    def dimensions(self):
        return {k: v[0] for k, v in self._dims.items()}

    def sync(self):
        with self._lock:
            self._h5file.flush()

    def close(self):
        self._h5file.close()
