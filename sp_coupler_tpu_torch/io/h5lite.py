"""The HDF5 subset of spifs.nc, written and read in Python without h5py.

spifs.nc is netCDF-4: an HDF5 file with one group per column, which the
netCDF classic format (``spnc.py``) cannot hold. This module writes and
reads the part of HDF5 that such a file uses, in the layout that h5py
(HDF5 1.14, default library-version bounds) gives the same calls:

- superblock version 0 (group leaf K = 4, internal K = 16), 8-byte
  offsets and lengths; version-1 object headers with continuation blocks;
- old-style groups: a symbol-table message, a version-1 B-tree of type 0
  over symbol-table nodes (SNOD), and a local heap of link names;
- datasets: scalar, contiguous or chunked (layout version 3, a
  version-1 B-tree of type 1 as the chunk index), the first axis
  extendable; the deflate and shuffle filters;
- attributes (version-1 messages): fixed-length strings, variable-length
  sequences of object references held in global-heap collections
  (DIMENSION_LIST) and compounds of {object reference, int32}
  (REFERENCE_LIST);
- dimension scales (``Dataset.make_scale``, ``dims[axis].attach_scale``).

It creates little-endian float32 datasets and byte-string attributes,
which is all spifs.nc holds, and reads datasets and attributes of any
fixed-point or floating-point type.

Writing keeps the file's metadata in memory and puts it on disk at
``flush``: new object headers, groups' B-trees and heaps (rebuilt when
their links changed), chunk B-trees (entries rewritten in place, nodes
split into more levels as the index grows), dataspace extents, the
superblock. Writes fill one chunk buffer per dataset, written whole at
the next flush or when a write to another chunk arrives. After
``flush`` returns, a reader in another process sees every record written
so far. ``File`` serialises its calls on one lock, so a write-behind
thread may write and flush while another thread creates objects.

A dimension scale's REFERENCE_LIST is one object-header message, at most
64 KiB: where more variables attach to a scale than its message holds,
it keeps the first back-references in attach order, logs the cut once
at WARNING, and every variable keeps its DIMENSION_LIST (netCDF readers
key on the latter). Space that a rewritten chunk or node leaves behind
is not reused.
"""

import itertools
import logging
import os
import struct
import threading
import zlib

import numpy as np

log = logging.getLogger(__name__)

UNDEF = (1 << 64) - 1
SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUPERBLOCK_SIZE = 96
LEAF_K = 4             # a symbol-table node holds 2 LEAF_K links
GROUP_K = 16           # a group B-tree node holds 2 GROUP_K children
CHUNK_K = 32           # a chunk B-tree node holds 2 CHUNK_K children
MAX_MESSAGE = 65528    # the largest (8-aligned) object-header message
COLLECTION = 4096      # bytes of a global-heap collection
HEAP_FREE_NULL = 1     # a local heap's empty free list

NIL, DATASPACE, DATATYPE, FILL, LAYOUT, PIPELINE = 0, 1, 3, 5, 8, 11
ATTRIBUTE, CONTINUATION, STAB = 12, 16, 17
DEFLATE, SHUFFLE = 1, 2

ENTRY = 40             # a symbol-table entry
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY
GROUP_NODE_SIZE = 24 + 2 * GROUP_K * 8 + (2 * GROUP_K + 1) * 8

# datatype messages as h5py writes them
T_F32 = bytes.fromhex("11201f00040000000000200017080017" "7f000000")
T_U32 = bytes.fromhex("1000000004000000" "00002000")
T_REF = bytes.fromhex("1700000008000000")
T_VLEN_REF = bytes.fromhex("1900000010000000") + T_REF
F32 = np.dtype("<f4")

# the fill-value message h5py writes: default fill, allocation time
# incremental (chunked) or late (contiguous), write time "if set"
FILL_CHUNKED = bytes.fromhex("0203020100000000")
FILL_CONTIGUOUS = bytes.fromhex("0202020100000000")


def _pad8(n):
    return (n + 7) & ~7


def _padded(b):
    return b + b"\0" * (_pad8(len(b)) - len(b))


def _string_type(size, pad):
    """A fixed-length ASCII string type; pad 0 null-terminated, 1
    null-padded."""
    return struct.pack("<BBBBI", 0x13, pad, 0, 0, size)


def _member(name, offset, mtype):
    """A version-1 compound member."""
    return (_padded(name.encode() + b"\0") + struct.pack("<IB3xI4x16x",
                                                         offset, 0, 0)
            + mtype)


# REFERENCE_LIST's element: {dataset: object reference, dimension:
# uint32}, 16 bytes as HDF5 aligns it
T_REFLIST = (struct.pack("<BBBBI", 0x16, 2, 0, 0, 16)
             + _member("dataset", 0, T_REF) + _member("dimension", 8, T_U32))
REFLIST_ITEM = 16


def _space(shape, maxshape=None):
    """A version-1 dataspace message (rank 0 is a scalar)."""
    if not shape:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    maxshape = shape if maxshape is None else maxshape
    return (struct.pack("<BBBB4x", 1, len(shape), 1, 0)
            + struct.pack("<%dQ" % len(shape), *shape)
            + struct.pack("<%dQ" % len(shape),
                          *[UNDEF if m is None else m for m in maxshape]))


def _attr_body(name, dtype_b, space_b, data):
    nm = name.encode() + b"\0"
    return _padded(struct.pack("<BBHHH", 1, 0, len(nm), len(dtype_b),
                               len(space_b))
                   + _padded(nm) + _padded(dtype_b) + _padded(space_b)
                   + data)


def _message(mtype, flags, body):
    body = _padded(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


# ---- datatypes and dataspaces, decoded ---------------------------------------

class _Type:
    """A decoded datatype: kind "num" (dtype), "str" (size, pad), "ref",
    "vlen" (base) or "compound" (numpy dtype of its members, references
    as uint64 addresses)."""

    def __init__(self, kind, size, dtype=None, pad=0, base=None):
        self.kind, self.size, self.dtype = kind, size, dtype
        self.pad, self.base = pad, base


def _decode_type(b, p=0):
    """(_Type, bytes used) of the datatype encoded at b[p:]."""
    cv, b0, b1, b2, size = struct.unpack_from("<BBBBI", b, p)
    cls, ver = cv & 0x0F, cv >> 4
    bits = b0 | (b1 << 8) | (b2 << 16)
    q = p + 8
    if cls in (0, 1):
        order = ">" if bits & 1 else "<"
        if cls == 0:
            kind = "i" if bits & 0x08 else "u"
            q += 4
        else:
            kind = "f"
            q += 12
        return _Type("num", size, np.dtype("%s%s%d" % (order, kind, size))), \
            q - p
    if cls == 3:
        return _Type("str", size, np.dtype("S%d" % size), pad=bits & 0x0F), \
            q - p
    if cls == 7:
        if bits & 0x0F != 0:
            raise NotImplementedError("region references")
        return _Type("ref", size, np.dtype("<u8")), q - p
    if cls == 9:
        base, n = _decode_type(b, q)
        return _Type("vlen", size, np.dtype(object), base=base), q + n - p
    if cls == 6:
        names, offsets, formats = [], [], []
        for _ in range(bits & 0xFFFF):
            if ver > 2:
                raise NotImplementedError("compound datatype version %d"
                                          % ver)
            end = b.index(b"\0", q)
            name = b[q:end].decode()
            q += _pad8(end + 1 - q)
            offset = struct.unpack_from("<I", b, q)[0]
            q += 4
            if ver == 1:
                q += 28                # dimensionality, permutation, sizes
            mtype, n = _decode_type(b, q)
            q += n
            if mtype.kind in ("vlen", "compound"):
                raise NotImplementedError("nested compound member " + name)
            names.append(name)
            offsets.append(offset)
            formats.append(mtype.dtype)
        dt = np.dtype(dict(names=names, formats=formats, offsets=offsets,
                           itemsize=size))
        return _Type("compound", size, dt), q - p
    raise NotImplementedError("HDF5 datatype class %d" % cls)


def _decode_space(b):
    """(shape, maxshape, offset of the extent in b) of a dataspace
    message; None in maxshape is unlimited."""
    ver, rank, flags = b[0], b[1], b[2]
    at = 8 if ver == 1 else 4
    if ver == 2 and b[3] == 2:
        raise NotImplementedError("null dataspace")
    shape = struct.unpack_from("<%dQ" % rank, b, at)
    maxshape = shape
    if flags & 1:
        mx = struct.unpack_from("<%dQ" % rank, b, at + 8 * rank)
        maxshape = tuple(None if m == UNDEF else m for m in mx)
    return tuple(shape), tuple(maxshape), at


class Reference(int):
    """An object reference: the object header's address."""

    def __repr__(self):
        return "<h5lite reference to %#x>" % int(self)


# ---- attributes --------------------------------------------------------------

class _Attr:
    """A stored attribute: its encoded datatype, dataspace and data."""

    def __init__(self, name, dtype_b, space_b, data):
        self.name, self.dtype_b, self.space_b, self.data = (
            name, dtype_b, space_b, data)

    def body(self, file):
        return _attr_body(self.name, self.dtype_b, self.space_b, self.data)

    def size(self):
        """Bytes of body(), without writing anything."""
        return len(_attr_body(self.name, self.dtype_b, self.space_b,
                              self.data))

    def value(self, file):
        t, _ = _decode_type(self.dtype_b)
        shape, _, _ = _decode_space(self.space_b)
        n = int(np.prod(shape)) if shape else 1
        out = file._values(t, self.data, n)
        return out[0] if not shape else out.reshape(shape)


def _parse_attr(body):
    _, _, nlen, tlen, slen = struct.unpack_from("<BBHHH", body)
    p = 8
    name = body[p:p + nlen - 1].decode()
    p += _pad8(nlen)
    dtype_b = body[p:p + tlen]
    p += _pad8(tlen)
    space_b = body[p:p + slen]
    p += _pad8(slen)
    t, _ = _decode_type(dtype_b)
    shape, _, _ = _decode_space(space_b)
    n = int(np.prod(shape)) if shape else 1
    return _Attr(name, dtype_b, space_b, body[p:p + n * t.size])


def _encode_value(value):
    """(datatype, dataspace, data) of an attribute value: bytes, a
    null-padded string as h5py writes numpy bytes."""
    if not isinstance(value, (bytes, np.bytes_)):
        raise TypeError("attributes are written as bytes, not %s"
                        % type(value).__name__)
    raw = bytes(value)
    if not raw:
        raise ValueError("empty string attribute")
    return _string_type(len(raw), 1), _space(()), raw


class _DimList(_Attr):
    """DIMENSION_LIST of a dataset written here: per axis, the scales
    attached to it, each a one-reference sequence in the global heap."""

    def __init__(self, dataset):
        super().__init__("DIMENSION_LIST", T_VLEN_REF,
                         _space((dataset.ndim,)), b"")
        self.ds = dataset
        self.scales = [[] for _ in range(dataset.ndim)]
        self.heap_ids = {}     # (axis, scale position) -> (collection, index)

    def body(self, file):
        out = []
        for ax, scales in enumerate(self.scales):
            if not scales:
                out.append(struct.pack("<IQI", 0, 0, 0))
                continue
            key = (ax, len(scales))
            if key not in self.heap_ids:
                refs = b"".join(struct.pack("<Q", s.addr) for s in scales)
                self.heap_ids[key] = file._heap_put(refs)
            coll, idx = self.heap_ids[key]
            out.append(struct.pack("<IQI", len(scales), coll, idx))
        return _attr_body(self.name, self.dtype_b, self.space_b,
                          b"".join(out))

    def size(self):
        return len(_attr_body(self.name, self.dtype_b, self.space_b,
                              b"\0" * 16 * len(self.scales)))

    def value(self, file):
        out = np.empty(len(self.scales), dtype=object)
        for ax, scales in enumerate(self.scales):
            out[ax] = np.array([Reference(s.addr) for s in scales],
                               dtype=object)
        return out


class _RefList(_Attr):
    """REFERENCE_LIST of a scale: the (dataset, axis) pairs attached to
    it, in attach order, as many as one message holds."""

    FIXED = len(_attr_body("REFERENCE_LIST", T_REFLIST, _space((1,)), b""))
    LIMIT = (MAX_MESSAGE - FIXED) // REFLIST_ITEM

    def __init__(self, scale, pairs):
        super().__init__("REFERENCE_LIST", T_REFLIST, b"", b"")
        self.scale = scale
        self.pairs = pairs     # [(Dataset or address, axis)]
        self.warned = False

    def kept(self):
        if len(self.pairs) > self.LIMIT and not self.warned:
            log.warning("dimension scale %s: REFERENCE_LIST keeps the first "
                        "%d of %d back-references (a %d-byte object-header "
                        "message holds no more); every variable keeps its "
                        "DIMENSION_LIST", self.scale.name, self.LIMIT,
                        len(self.pairs), MAX_MESSAGE)
            self.warned = True
        return self.pairs[:self.LIMIT]

    def body(self, file):
        pairs = self.kept()
        data = b"".join(struct.pack("<QI4x", d if isinstance(d, int)
                                    else d.addr, ax) for d, ax in pairs)
        return _attr_body(self.name, T_REFLIST, _space((len(pairs),)), data)

    def size(self):
        return self.FIXED + REFLIST_ITEM * min(len(self.pairs), self.LIMIT)

    def value(self, file):
        pairs = self.pairs[:self.LIMIT]
        out = np.zeros(len(pairs), dtype=[("dataset", "<u8"),
                                          ("dimension", "<u4")])
        for i, (d, ax) in enumerate(pairs):
            out[i] = (d if isinstance(d, int) else d.addr, ax)
        return out


class AttributeManager:
    """``obj.attrs``: the attributes of one object, by name."""

    def __init__(self, obj):
        self._obj = obj

    def __contains__(self, name):
        return name in self._obj._attrs

    def __getitem__(self, name):
        with self._obj.file._lock:
            return self._obj._attrs[name].value(self._obj.file)

    def get(self, name, default=None):
        return self[name] if name in self else default

    def keys(self):
        return list(self._obj._attrs)

    def __iter__(self):
        return iter(self.keys())

    def __setitem__(self, name, value):
        obj = self._obj
        with obj.file._lock:
            obj.file._writable()
            if name in ("DIMENSION_LIST", "REFERENCE_LIST"):
                raise ValueError("%s is kept by attach_scale" % name)
            obj._attrs[name] = _Attr(name, *_encode_value(value))
            obj._dirty_header()


# ---- objects -----------------------------------------------------------------

class _Object:
    """An object header: its messages other than attributes, its
    attributes, and where it lies in the file (addr UNDEF until written)."""

    def __init__(self, file, name, addr=UNDEF):
        self.file, self.name, self.addr = file, name, addr
        self._msgs = []          # [type, flags, body] other than attributes
        self._attrs = {}         # name -> _Attr
        self._chunks = []        # [(address, size)] of the header's blocks
        self._at = {}            # message type -> file offset of its body
        self.attrs = AttributeManager(self)

    def _dirty_header(self):
        self.file._dirty_headers.add(self)

    def _body(self, mtype):
        for m in self._msgs:
            if m[0] == mtype:
                return m[2]
        return None

    def _set_body(self, mtype, body):
        for m in self._msgs:
            if m[0] == mtype:
                m[2] = body
                return
        raise KeyError(mtype)


class Group(_Object):
    """An old-style group: links by name, kept sorted on disk."""

    def __init__(self, file, name, addr=UNDEF):
        super().__init__(file, name, addr)
        self._links = {}         # name -> object or object-header address
        self._btree = UNDEF      # root node (fixed once allocated)
        self._heap = UNDEF       # local-heap header (fixed once allocated)
        self._heap_data = (UNDEF, 0)   # data segment and its capacity
        self._snods = []         # symbol-table nodes, reused in rebuilds
        self._nodes = []         # non-root B-tree nodes, reused in rebuilds

    def _get(self, name):
        obj = self._links[name]
        if isinstance(obj, int):
            obj = self.file._load(obj, self._path(name))
            self._links[name] = obj
        return obj

    def _path(self, name):
        return (self.name.rstrip("/") + "/" + name)

    def __getitem__(self, path):
        if isinstance(path, Reference):
            return self.file._by_address(int(path))
        with self.file._lock:
            obj = self
            for part in [p for p in path.split("/") if p]:
                if not isinstance(obj, Group) or part not in obj._links:
                    raise KeyError("%s not in %s" % (path, self.name))
                obj = obj._get(part)
            return obj

    def __contains__(self, name):
        return name in self._links

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._links)

    def keys(self):
        return sorted(self._links, key=lambda s: s.encode())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def _link(self, name, obj):
        if not name or "/" in name:
            raise ValueError("link name %r" % name)
        if name in self._links:
            raise ValueError("%s already exists in %s" % (name, self.name))
        self._links[name] = obj
        self.file._dirty_groups.add(self)

    def create_group(self, name):
        with self.file._lock:
            self.file._writable()
            g = Group(self.file, self._path(name))
            g._msgs = [[STAB, 0, b"\0" * 16]]
            self._link(name, g)
            self.file._new.append(g)
            self.file._dirty_groups.add(g)
            return g

    def create_dataset(self, name, shape, dtype="f4", maxshape=None,
                       chunks=None, compression=None, compression_opts=None,
                       shuffle=False):
        """A float32 dataset, chunked where h5py would chunk it (filters,
        an extendable first axis or chunks given), the chunks guessed as
        h5py guesses them where not given."""
        with self.file._lock:
            self.file._writable()
            ds = Dataset(self.file, self._path(name))
            ds._create(tuple(int(s) for s in shape), dtype, maxshape, chunks,
                       compression, compression_opts, shuffle)
            self._link(name, ds)
            self.file._new.append(ds)
            return ds


class _Dims:
    """``dataset.dims``: one entry per axis, with attach_scale."""

    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, axis):
        return _Axis(self._ds, axis)


class _Axis:
    def __init__(self, ds, axis):
        self._ds, self._axis = ds, axis

    def attach_scale(self, scale):
        self._ds._attach(self._axis, scale)


class Dataset(_Object):
    """A dataset of numbers: scalar, contiguous or chunked."""

    def __init__(self, file, name, addr=UNDEF):
        super().__init__(file, name, addr)
        self.dims = _Dims(self)
        self._data_addr = UNDEF  # contiguous data, or the chunk B-tree root
        self._filters = []       # [(id, flags, client values)]
        self._fill = 0
        self._recs = None        # chunk index: [[offset, addr, nbytes,
        self._pos = {}           #   mask, capacity]] sorted; offset -> i
        self._changed = set()    # records rewritten since the last flush
        self._grew = False       # records added since the last flush
        self._shape_on_disk = None   # nodes per level as this file last
        #                              wrote them (None: rewrite them all)
        self._nodes = []         # non-root chunk B-tree nodes, by level
        self._buf = None         # [chunk offset, array, dirty]
        self._cache = None       # (chunk offset, array) last read
        self._by_record = False  # chunks span every axis but the first

    # -- layout ----------------------------------------------------------------

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def compression(self):
        return "gzip" if any(f[0] == DEFLATE for f in self._filters) \
            else None

    @property
    def shuffle(self):
        return any(f[0] == SHUFFLE for f in self._filters)

    def __len__(self):
        return self.shape[0]

    def _create(self, shape, dtype, maxshape, chunks, compression, level,
                shuffle):
        self.dtype = np.dtype(dtype).newbyteorder("<")
        if self.dtype != F32:
            raise TypeError("dataset dtype %s (float32 is written)"
                            % self.dtype)
        self.shape = shape
        self.maxshape = tuple(shape if maxshape is None else maxshape)
        if len(self.maxshape) != len(shape) or any(
                m is not None and m < s for s, m in zip(shape, self.maxshape)):
            raise ValueError("maxshape %s for shape %s" % (maxshape, shape))
        if self.maxshape[1:] != shape[1:]:
            raise NotImplementedError("only the first axis is extendable")
        if compression not in (None, "gzip"):
            raise NotImplementedError("compression %r" % compression)
        if shape == ():
            if chunks or compression or shuffle:
                raise TypeError("scalar datasets take no chunks or filters")
            self.chunks = None
        elif chunks is None and (compression or shuffle
                                 or maxshape is not None):
            self.chunks = guess_chunk(shape, self.maxshape,
                                      self.dtype.itemsize)
        else:
            self.chunks = None if chunks is None else tuple(chunks)
        if self.chunks is None and self.maxshape != shape:
            raise ValueError("an extendable dataset is chunked")
        if shuffle:
            self._filters.append((SHUFFLE, 1, (self.dtype.itemsize,)))
        if compression:
            self._filters.append((DEFLATE, 1, (
                4 if level is None else int(level),)))
        if self.chunks is not None:
            self._recs = []
        self._set_by_record()
        self._msgs = [[DATASPACE, 0, _space(shape, self.maxshape)],
                      [DATATYPE, 1, T_F32],
                      [FILL, 1, FILL_CHUNKED if self.chunks
                       else FILL_CONTIGUOUS],
                      [LAYOUT, 0, self._layout_body()]]
        if self._filters:
            self._msgs.append([PIPELINE, 1, self._pipeline_body()])

    def _layout_body(self):
        if self.chunks is None:
            return struct.pack("<BBQQ", 3, 1, self._data_addr,
                               int(np.prod(self.shape, dtype=np.int64))
                               * self.dtype.itemsize)
        dims = tuple(self.chunks) + (self.dtype.itemsize,)
        return struct.pack("<BBBQ%dI" % len(dims), 3, 2, len(dims),
                           self._data_addr, *dims)

    def _pipeline_body(self):
        out = [struct.pack("<BB6x", 1, len(self._filters))]
        for fid, flags, values in self._filters:
            name = {DEFLATE: b"deflate\0", SHUFFLE: b"shuffle\0"}[fid]
            vals = struct.pack("<%dI" % len(values), *values)
            out.append(struct.pack("<HHHH", fid, len(name), flags,
                                   len(values)) + name + _padded(vals))
        return b"".join(out)

    def _parse(self):
        """Layout, type, extent and filters from the parsed messages."""
        t, _ = _decode_type(self._body(DATATYPE))
        if t.kind != "num":
            raise NotImplementedError("%s: datasets of %s" % (self.name,
                                                              t.kind))
        self.dtype = t.dtype
        self.shape, self.maxshape, _ = _decode_space(self._body(DATASPACE))
        lay = self._body(LAYOUT)
        if lay[0] != 3:
            raise NotImplementedError("data layout version %d" % lay[0])
        self.chunks = None
        if lay[1] == 0:
            raise NotImplementedError("%s: compact layout" % self.name)
        if lay[1] == 1:
            self._data_addr = struct.unpack_from("<Q", lay, 2)[0]
        else:
            nd = lay[2]
            self._data_addr = struct.unpack_from("<Q", lay, 3)[0]
            self.chunks = struct.unpack_from("<%dI" % (nd - 1), lay, 11)
        pl = self._body(PIPELINE)
        if pl is not None:
            self._filters = _parse_pipeline(pl)
        self._fill = _fill_value(self._body(FILL), self.dtype)
        self._set_by_record()

    def _set_by_record(self):
        # only the first axis grows, so this holds for the dataset's life
        self._by_record = (self.chunks is not None
                           and tuple(self.chunks[1:]) == self.shape[1:])

    # -- dimension scales --------------------------------------------------------

    def make_scale(self, name=""):
        with self.file._lock:
            self.file._writable()
            self._attrs["CLASS"] = _Attr("CLASS", _string_type(16, 0),
                                         _space(()), b"DIMENSION_SCALE\0")
            raw = name.encode() + b"\0"
            self._attrs["NAME"] = _Attr("NAME", _string_type(len(raw), 0),
                                        _space(()), raw)
            self._dirty_header()

    def _attach(self, axis, scale):
        with self.file._lock:
            self.file._writable()
            dl = self._attrs.get("DIMENSION_LIST")
            if dl is None:
                dl = self._attrs["DIMENSION_LIST"] = _DimList(self)
            elif not isinstance(dl, _DimList):
                raise NotImplementedError("attach to a read DIMENSION_LIST")
            dl.scales[axis].append(scale)
            rl = scale._attrs.get("REFERENCE_LIST")
            if not isinstance(rl, _RefList):
                pairs = [] if rl is None else [
                    (int(a), int(d)) for a, d in rl.value(self.file)]
                rl = scale._attrs["REFERENCE_LIST"] = _RefList(scale, pairs)
            rl.pairs.append((self, axis))
            self._dirty_header()
            scale._dirty_header()

    # -- extent ----------------------------------------------------------------

    def resize(self, size):
        """Set the length of the first axis."""
        with self.file._lock:
            self.file._writable()
            m = self.maxshape[0]
            if m is not None and size > m:
                raise ValueError("%s: the first axis holds at most %d" % (
                    self.name, m))
            self.shape = (int(size),) + self.shape[1:]
            self.file._dirty_extents.add(self)

    # -- chunk index -------------------------------------------------------------

    def _index(self):
        if self._recs is None:
            self._recs = []
            if self._data_addr != UNDEF:
                self._recs, self._nodes = self.file._read_chunk_tree(
                    self._data_addr, len(self.chunks) + 1)
            self._pos = {r[0]: i for i, r in enumerate(self._recs)}
        return self._recs

    def _chunk_bytes(self):
        return int(np.prod(self.chunks)) * self.dtype.itemsize

    def _decode_chunk(self, rec):
        raw = self.file._pread(rec[1], rec[2])
        for i in range(len(self._filters) - 1, -1, -1):
            if rec[3] & (1 << i):
                continue
            fid, _, values = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == SHUFFLE:
                raw = _unshuffle(raw, values[0] if values
                                 else self.dtype.itemsize)
            else:
                raise NotImplementedError("%s: filter %d" % (self.name, fid))
        n = self._chunk_bytes()
        if len(raw) < n:
            raise ValueError("%s: chunk at %#x holds %d of %d bytes"
                             % (self.name, rec[1], len(raw), n))
        return np.frombuffer(raw[:n], self.dtype).reshape(self.chunks)

    def _chunk(self, off):
        """The chunk at element offset off (None where none is stored)."""
        if self._buf is not None and self._buf[0] == off:
            return self._buf[1]
        if self._cache is not None and self._cache[0] == off:
            return self._cache[1]
        self._index()
        i = self._pos.get(off + (0,))
        if i is None:
            return None
        arr = self._decode_chunk(self._recs[i])
        self._cache = (off, arr)
        return arr

    def _open_chunk(self, off):
        """The write buffer of the chunk at off, the previous one flushed."""
        buf = self._buf
        if buf is not None and buf[0] == off:
            return buf
        self._flush_chunk()
        arr = self._chunk(off)
        arr = (np.full(self.chunks, self._fill, self.dtype) if arr is None
               else arr.copy())
        self._cache = None
        self._buf = [off, arr, False]
        return self._buf

    def _flush_chunk(self):
        buf = self._buf
        if buf is None or not buf[2]:
            return
        off, arr, _ = buf
        buf[2] = False
        key = off + (0,)
        self._index()
        i = self._pos.get(key)
        raw = arr.tobytes()
        if not self._filters:
            if i is None:
                i = self._insert(key, self.file._alloc(len(raw)), len(raw))
            self.file._pwrite(self._recs[i][1], raw)
            return
        for fid, _, values in self._filters:
            if fid == SHUFFLE:
                raw = _shuffle(raw, values[0])
            else:
                raw = zlib.compress(raw, values[0])
        if i is None or len(raw) > self._recs[i][4]:
            # room for the rows still to come, at this chunk's ratio
            valid = self.chunks[0]
            if self.maxshape[0] is None:
                valid = max(1, min(valid, self.shape[0] - off[0]))
            cap = len(raw)
            if valid < self.chunks[0]:
                cap = min(int(cap * self.chunks[0] / valid * 1.1) + 16,
                          arr.nbytes + arr.nbytes // 100 + 32)
                cap = max(_pad8(cap), len(raw))
            addr = self.file._alloc(cap)
            if i is None:
                i = self._insert(key, addr, len(raw), cap)
            else:
                self._recs[i][1], self._recs[i][4] = addr, cap
        rec = self._recs[i]
        rec[2] = len(raw)
        self.file._pwrite(rec[1], raw)
        self._changed.add(i)
        self.file._dirty_indexes.add(self)

    def _insert(self, key, addr, nbytes, cap=None):
        rec = [key, addr, nbytes, 0, nbytes if cap is None else cap]
        i = len(self._recs)
        if self._recs and self._recs[-1][0] > key:
            self._recs.append(rec)
            self._recs.sort(key=lambda r: r[0])
            self._pos = {r[0]: j for j, r in enumerate(self._recs)}
            self._shape_on_disk = None      # rewrite every node
            i = self._pos[key]
        else:
            self._recs.append(rec)
            self._pos[key] = i
        self._changed.add(i)
        self._grew = True
        self.file._dirty_indexes.add(self)
        return i

    # -- data --------------------------------------------------------------------

    def __getitem__(self, key):
        with self.file._lock:
            box, sub = _box(key, self.shape)
            if self.chunks is None:
                arr = self._read_all()[tuple(slice(*b) for b in box)]
            else:
                arr = self._read_box(box)
            return arr[sub]

    def _read_all(self):
        n = int(np.prod(self.shape, dtype=np.int64))
        if self._data_addr == UNDEF:
            return np.full(self.shape, self._fill, self.dtype)
        else:
            raw = self.file._pread(self._data_addr, n * self.dtype.itemsize)
        return np.frombuffer(raw, self.dtype, n).reshape(self.shape).copy()

    def _read_box(self, box):
        lo = [b[0] for b in box]
        out = np.full([b[1] - b[0] for b in box], self._fill, self.dtype)
        if out.size == 0:
            return out
        ranges = [range(b[0] // c, (b[1] - 1) // c + 1)
                  for b, c in zip(box, self.chunks)]
        for idx in itertools.product(*ranges):
            off = tuple(i * c for i, c in zip(idx, self.chunks))
            arr = self._chunk(off)
            if arr is None:
                continue
            src, dst = [], []
            for o, c, b, l0 in zip(off, self.chunks, box, lo):
                a, e = max(o, b[0]), min(o + c, b[1])
                src.append(slice(a - o, e - o))
                dst.append(slice(a - l0, e - l0))
            out[tuple(dst)] = arr[tuple(src)]
        return out

    def __setitem__(self, key, value):
        with self.file._lock:
            self.file._writable()
            if (self._by_record and isinstance(key, (int, np.integer))
                    and 0 <= key < self.shape[0]):
                # one record, spifs.nc's write: kept off the box path,
                # whose Python cost 0.3-1.1 s of host I/O a step at 1024
                # columns on the H100's host (PERF.md §6)
                c0 = self.chunks[0]
                buf = self._open_chunk((key - key % c0,)
                                       + (0,) * (self.ndim - 1))
                buf[1][key % c0] = value
                buf[2] = True
                self.file._dirty_data.add(self)
            else:
                self._write_box(key, value)

    def _write_box(self, key, value):
        box, sub = _box(key, self.shape)
        if any(isinstance(s, slice) and s.step not in (None, 1) for s in sub):
            raise NotImplementedError("strided writes")
        shape = [b[1] - b[0] for b in box]
        picked = [n for n, s in zip(shape, sub) if isinstance(s, slice)]
        val = np.broadcast_to(np.asarray(value, self.dtype), picked)
        val = np.ascontiguousarray(val).reshape(shape)
        if self.chunks is None:
            self._write_contiguous(box, val)
            return
        ranges = [range(b[0] // c, (b[1] - 1) // c + 1)
                  for b, c in zip(box, self.chunks)]
        for idx in itertools.product(*ranges):
            off = tuple(i * c for i, c in zip(idx, self.chunks))
            buf = self._open_chunk(off)
            src, dst = [], []
            for o, c, b in zip(off, self.chunks, box):
                a, e = max(o, b[0]), min(o + c, b[1])
                dst.append(slice(a - o, e - o))
                src.append(slice(a - b[0], e - b[0]))
            buf[1][tuple(dst)] = val[tuple(src)]
            buf[2] = True
        self.file._dirty_data.add(self)

    def _write_contiguous(self, box, val):
        full = self._read_all()
        full[tuple(slice(*b) for b in box)] = val
        if self._data_addr == UNDEF:
            self._data_addr = self.file._alloc(full.nbytes)
            self._set_body(LAYOUT, self._layout_body())
            self.file._dirty_layouts.add(self)
        self.file._pwrite(self._data_addr, full.tobytes())

    def _rewrite_layout(self):
        """The layout message's address field, in place."""
        at = self._at.get(LAYOUT)
        if at is not None:
            self.file._pwrite(at + (2 if self.chunks is None else 3),
                              struct.pack("<Q", self._data_addr))

    def _rewrite_extent(self):
        """The dataspace message's extent field, in place."""
        ext = 8 if self._body(DATASPACE)[0] == 1 else 4
        self.file._pwrite(self._at[DATASPACE] + ext, struct.pack(
            "<%dQ" % len(self.shape), *self.shape))

    def _sync_space(self):
        """The dataspace message for the current shape (the maximum and
        the message's version kept)."""
        body = self._body(DATASPACE)
        _, _, ext = _decode_space(body)
        dims = struct.pack("<%dQ" % len(self.shape), *self.shape)
        self._set_body(DATASPACE, body[:ext] + dims + body[ext + len(dims):])


def _box(key, shape):
    """(box, sub) of an index: the bounding [start, stop) on each axis,
    and the index into that box (0 for an integer, a slice otherwise)."""
    if key is Ellipsis:
        key = ()
    if not isinstance(key, tuple):
        key = (key,)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) \
            + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError("%d indices for %d axes" % (len(key), len(shape)))
    key = key + (slice(None),) * (len(shape) - len(key))
    box, sub = [], []
    for k, n in zip(key, shape):
        if isinstance(k, (int, np.integer)):
            k = int(k) + (n if k < 0 else 0)
            if not 0 <= k < n:
                raise IndexError("index %d on an axis of %d" % (k, n))
            box.append((k, k + 1))
            sub.append(0)
        elif isinstance(k, slice):
            r = range(*k.indices(n))
            if not r:
                box.append((0, 0))
                sub.append(slice(0, 0))
            elif r.step > 0:
                box.append((r[0], r[-1] + 1))
                sub.append(slice(None, None, r.step))
            else:
                box.append((r[-1], r[0] + 1))
                sub.append(slice(None, None, r.step))
        else:
            raise TypeError("index %r" % (k,))
    return box, tuple(sub)


def _parse_pipeline(b):
    ver, n = b[0], b[1]
    p = 8 if ver == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", b, p)[0]
        if ver == 1 or fid >= 256:
            fid, nlen, flags, nval = struct.unpack_from("<HHHH", b, p)
            p += 8 + nlen
        else:
            fid, flags, nval = struct.unpack_from("<HHH", b, p)
            p += 6
        vals = struct.unpack_from("<%dI" % nval, b, p)
        p += 4 * nval
        if ver == 1 and nval % 2:
            p += 4
        out.append((fid, flags, tuple(vals)))
    return out


def _fill_value(b, dtype):
    """The fill value a fill-value message defines (0 by default)."""
    if not b:
        return 0
    ver = b[0]
    if ver in (1, 2):
        defined = b[3]
        if defined and len(b) >= 8:
            n = struct.unpack_from("<I", b, 4)[0]
            if n:
                return np.frombuffer(b[8:8 + n], dtype)[0]
        return 0
    flags = b[1]
    if flags & 0x20:
        n = struct.unpack_from("<I", b, 2)[0]
        return np.frombuffer(b[6:6 + n], dtype)[0]
    return 0


def _shuffle(raw, size):
    a = np.frombuffer(raw, np.uint8)
    n = len(a) // size
    head = a[:n * size].reshape(n, size).T.tobytes()
    return head + raw[n * size:]


def _unshuffle(raw, size):
    a = np.frombuffer(raw, np.uint8)
    n = len(a) // size
    head = a[:n * size].reshape(size, n).T.tobytes()
    return head + raw[n * size:]


# chunk guesses: h5py's rule (h5py._hl.filters.guess_chunk), so that the
# same calls give the same chunks
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape, maxshape, typesize):
    """Chunks near a power-of-2 fraction of each axis, 8 KiB to 1 MiB,
    1024 on an axis of length 0."""
    chunks = np.array([s if s else 1024 for s in shape], dtype=np.float64)
    size = float(np.prod(chunks)) * typesize
    target = min(max(CHUNK_BASE * 2 ** np.log10(size / (1024.0 * 1024)),
                     CHUNK_MIN), CHUNK_MAX)
    i = 0
    while True:
        nbytes = float(np.prod(chunks)) * typesize
        if ((nbytes < target or abs(nbytes - target) / target < 0.5)
                and nbytes < CHUNK_MAX):
            break
        if np.prod(chunks) == 1:
            break
        chunks[i % len(shape)] = np.ceil(chunks[i % len(shape)] / 2.0)
        i += 1
    return tuple(int(c) for c in chunks)


# ---- the file ----------------------------------------------------------------

class File(Group):
    """An HDF5 file of the subset above, mode "r", "w" or "a" (append;
    a missing file is created)."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "w", "a"):
            raise ValueError("mode %r" % mode)
        if mode == "a" and not os.path.exists(path):
            mode = "w"
        flags = {"r": os.O_RDONLY, "a": os.O_RDWR,
                 "w": os.O_RDWR | os.O_CREAT | os.O_TRUNC}[mode]
        self._fd = os.open(path, flags, 0o644)
        super().__init__(self, "/")
        self.filename, self.mode = path, mode
        self._lock = threading.RLock()
        self._objects = {}       # address -> object read or written
        self._new = []           # objects without a header on disk
        self._dirty_headers, self._dirty_groups = set(), set()
        self._dirty_data, self._dirty_indexes = set(), set()
        self._dirty_extents, self._dirty_layouts = set(), set()
        self._heaps = {}         # collection address -> {index: bytes}
        self._coll = None        # [address, used, next index] being filled
        self._dirty_colls = set()
        self._paths = None
        try:
            if mode == "w":
                self._eof = SUPERBLOCK_SIZE
                self._size = 0
                self._msgs = [[STAB, 0, b"\0" * 16]]
                self._new.append(self)
                self._dirty_groups.add(self)
            else:
                self._open()
        except BaseException:
            os.close(self._fd)
            raise

    # -- file space ----------------------------------------------------------------

    def _writable(self):
        if self.mode == "r":
            raise OSError("%s is open read-only" % self.filename)
        if self._fd is None:
            raise ValueError("%s is closed" % self.filename)

    def _alloc(self, n):
        addr = self._eof
        self._eof += _pad8(n)
        return addr

    def _pread(self, addr, n):
        b = os.pread(self._fd, n, addr)
        if len(b) != n:
            raise ValueError("%s: %d bytes at %#x run past the end of the "
                             "file" % (self.filename, n, addr))
        return b

    def _pwrite(self, addr, b):
        while b:
            n = os.pwrite(self._fd, b, addr)
            addr += n
            b = b[n:]
        self._size = max(self._size, addr)

    # -- reading -------------------------------------------------------------------

    def _open(self):
        sb = self._pread(0, SUPERBLOCK_SIZE)
        if sb[:8] != SIGNATURE:
            raise ValueError("%s is not an HDF5 file" % self.filename)
        if sb[8] != 0:
            raise NotImplementedError("superblock version %d" % sb[8])
        if sb[13:15] != b"\x08\x08":
            raise NotImplementedError("offsets or lengths other than 8 bytes")
        leaf_k, group_k = struct.unpack_from("<HH", sb, 16)
        if (leaf_k, group_k) != (LEAF_K, GROUP_K):
            raise NotImplementedError("group K %d/%d" % (leaf_k, group_k))
        base, _, eof, _ = struct.unpack_from("<QQQQ", sb, 24)
        if base != 0:
            raise NotImplementedError("a base address other than 0")
        self._size = os.fstat(self._fd).st_size
        self._eof = _pad8(max(eof, self._size))
        addr = struct.unpack_from("<Q", sb, 64)[0]
        self.addr = addr
        self._objects[addr] = self
        self._read_header(self)
        self._read_group(self)

    def _read_header(self, obj):
        pre = self._pread(obj.addr, 16)
        ver, _, nmsg, _, size = struct.unpack_from("<BBHII", pre)
        if ver != 1:
            raise NotImplementedError("%s: object header version %d" % (
                obj.name, ver))
        chunks = [(obj.addr + 16, size)]
        obj._chunks = [(obj.addr, size)]
        k = 0
        while k < len(chunks):
            start, n = chunks[k]
            k += 1
            b = self._pread(start, n)
            p = 0
            while p + 8 <= n:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                body = b[p + 8:p + 8 + msize]
                if mtype == CONTINUATION:
                    ca, cl = struct.unpack_from("<QQ", body)
                    chunks.append((ca, cl))
                    obj._chunks.append((ca, cl))
                elif mtype == ATTRIBUTE:
                    a = _parse_attr(body)
                    obj._attrs[a.name] = a
                elif mtype != NIL:
                    obj._msgs.append([mtype, flags, body])
                    obj._at[mtype] = start + p + 8
                p += 8 + msize

    def _load(self, addr, name):
        obj = self._objects.get(addr)
        if obj is not None:
            return obj
        probe = _Object(self, name, addr)
        self._read_header(probe)
        kinds = {m[0] for m in probe._msgs}
        if STAB in kinds:
            obj = Group(self, name, addr)
        elif LAYOUT in kinds:
            obj = Dataset(self, name, addr)
        else:
            raise NotImplementedError("%s: object of messages %s (new-style "
                                      "groups are not read)" % (name, kinds))
        obj._msgs, obj._attrs, obj._chunks, obj._at = (
            probe._msgs, probe._attrs, probe._chunks, probe._at)
        if isinstance(obj, Group):
            self._read_group(obj)
        else:
            obj._parse()
        self._objects[addr] = obj
        return obj

    def _read_group(self, g):
        g._btree, g._heap = struct.unpack_from("<QQ", g._body(STAB))
        hdr = self._pread(g._heap, 32)
        if hdr[:4] != b"HEAP":
            raise ValueError("%s: no local heap at %#x" % (g.name, g._heap))
        size, _, data = struct.unpack_from("<QQQ", hdr, 8)
        g._heap_data = (data, size)
        names = self._pread(data, size)
        for entry in self._group_entries(g, g._btree, names):
            noff, addr = struct.unpack_from("<QQ", entry)
            name = names[noff:names.index(b"\0", noff)].decode()
            g._links[name] = addr

    def _group_entries(self, g, addr, names):
        b = self._pread(addr, GROUP_NODE_SIZE)
        if b[:4] != b"TREE" or b[4] != 0:
            raise ValueError("%s: no group B-tree node at %#x" % (g.name,
                                                                  addr))
        level, n = b[5], struct.unpack_from("<H", b, 6)[0]
        if addr != g._btree:
            g._nodes.append(addr)
        for i in range(n):
            child = struct.unpack_from("<Q", b, 24 + 8 + 16 * i)[0]
            if level > 0:
                yield from self._group_entries(g, child, names)
                continue
            g._snods.append(child)
            s = self._pread(child, SNOD_SIZE)
            if s[:4] != b"SNOD":
                raise ValueError("%s: no symbol-table node at %#x"
                                 % (g.name, child))
            for j in range(struct.unpack_from("<H", s, 6)[0]):
                yield s[8 + ENTRY * j:8 + ENTRY * (j + 1)]

    def _read_chunk_tree(self, root, ndims):
        """(records sorted by offset, non-root node addresses by level)."""
        ks = 8 + 8 * ndims
        size = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * ks
        recs, nodes = [], []

        def walk(addr, is_root):
            b = self._pread(addr, size)
            if b[:4] != b"TREE" or b[4] != 1:
                raise ValueError("no chunk B-tree node at %#x" % addr)
            level, n = b[5], struct.unpack_from("<H", b, 6)[0]
            if not is_root:
                while len(nodes) <= level:
                    nodes.append([])
                nodes[level].append(addr)
            for i in range(n):
                p = 24 + i * (ks + 8)
                nbytes, mask = struct.unpack_from("<II", b, p)
                off = struct.unpack_from("<%dQ" % ndims, b, p + 8)
                child = struct.unpack_from("<Q", b, p + ks)[0]
                if level > 0:
                    walk(child, False)
                else:
                    recs.append([tuple(off), child, nbytes, mask, nbytes])

        walk(root, True)
        recs.sort(key=lambda r: r[0])
        return recs, nodes

    def _collection(self, addr):
        objs = self._heaps.get(addr)
        if objs is None:
            hdr = self._pread(addr, 16)
            if hdr[:4] != b"GCOL":
                raise ValueError("no global heap collection at %#x" % addr)
            size = struct.unpack_from("<Q", hdr, 8)[0]
            b = self._pread(addr, size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _, n = struct.unpack_from("<HH4xQ", b, p)
                if idx == 0:
                    break
                objs[idx] = b[p + 16:p + 16 + n]
                p += 16 + _pad8(n)
            self._heaps[addr] = objs
        return objs

    def _values(self, t, data, n):
        """n values of type t from data, as a numpy array."""
        if t.kind == "vlen":
            out = np.empty(n, dtype=object)
            for i in range(n):
                cnt, coll, idx = struct.unpack_from("<IQI", data, 16 * i)
                raw = self._collection(coll)[idx] if cnt else b""
                out[i] = self._values(t.base, raw, cnt)
            return out
        arr = np.frombuffer(data, t.dtype, n)
        if t.kind == "ref":
            return np.array([Reference(int(a)) for a in arr], dtype=object)
        if t.kind == "str" and t.pad == 0:
            return np.array([s.split(b"\0", 1)[0] for s in arr],
                            dtype=t.dtype)
        return arr.copy()

    def _by_address(self, addr):
        with self._lock:
            obj = self._objects.get(addr)
            if obj is not None:
                return obj
            if self._paths is None:
                self._paths = {}

                def walk(g):
                    for name in g.keys():
                        a = g._links[name]
                        a = a if isinstance(a, int) else a.addr
                        if a not in self._paths:
                            self._paths[a] = g._path(name)
                            child = g._get(name)
                            if isinstance(child, Group):
                                walk(child)
                walk(self)
            return self._load(addr, self._paths[addr])

    # -- writing -------------------------------------------------------------------

    def _heap_put(self, data):
        """(collection, index) of a new global-heap object holding data;
        the collection is written at the end of the flush."""
        need = 16 + _pad8(len(data))
        c = self._coll
        if c is not None:
            left = COLLECTION - c[1] - need
            if left < 0 or 0 < left < 16:
                c = None
        if c is None:
            c = self._coll = [self._alloc(COLLECTION), 16, 1]
            self._heaps[c[0]] = {}
        idx = c[2]
        self._heaps[c[0]][idx] = data
        c[1] += need
        c[2] += 1
        self._dirty_colls.add(c[0])
        return c[0], idx

    def _write_collection(self, addr):
        out = [b"GCOL\x01\0\0\0" + struct.pack("<Q", COLLECTION)]
        used = 16
        for idx, data in sorted(self._heaps[addr].items()):
            out.append(struct.pack("<HH4xQ", idx, 0, len(data))
                       + _padded(data))
            used += 16 + _pad8(len(data))
        if COLLECTION - used >= 16:
            out.append(struct.pack("<HH4xQ", 0, 0, COLLECTION - used))
        b = b"".join(out)
        self._pwrite(addr, b + b"\0" * (COLLECTION - len(b)))

    def _header_size(self, obj):
        return sum(8 + _pad8(len(b)) for _, _, b in obj._msgs) + sum(
            8 + a.size() for a in obj._attrs.values())

    def _write_header(self, obj):
        """Pack the object's messages into its first block (fixed once
        allocated) and, where they overflow it, one continuation block."""
        items = [(t, _message(t, f, b)) for t, f, b in obj._msgs]
        items += [(ATTRIBUTE, _message(ATTRIBUTE, 0, a.body(self)))
                  for a in obj._attrs.values()]
        total = sum(len(m) for _, m in items)
        cap0 = obj._chunks[0][1]
        if total <= cap0:
            blocks = [(obj.addr + 16, cap0, items)]
            obj._chunks = obj._chunks[:1]
        else:
            first, used = [], 0
            while items and used + len(items[0][1]) <= cap0 - 24:
                used += len(items[0][1])
                first.append(items.pop(0))
            rest = sum(len(m) for _, m in items)
            cont = obj._chunks[1] if len(obj._chunks) > 1 else None
            if cont is None or cont[1] < rest:
                n = _pad8(rest + rest // 2)
                cont = (self._alloc(n), n)
            first.append((CONTINUATION, _message(
                CONTINUATION, 0, struct.pack("<QQ", *cont))))
            blocks = [(obj.addr + 16, cap0, first), (cont[0], cont[1], items)]
            obj._chunks = [obj._chunks[0], cont]
        nmsg, raws = 0, []
        obj._at = {}
        for start, cap, block in blocks:
            used = sum(len(m) for _, m in block)
            if cap > used:
                block.append((NIL, _message(NIL, 0, bytes(cap - used - 8))))
            p = start
            for kind, m in block:
                if kind in (DATASPACE, LAYOUT):
                    obj._at[kind] = p + 8
                p += len(m)
            nmsg += len(block)
            raws.append(b"".join(m for _, m in block))
        for (start, _, _), raw in zip(blocks[1:], raws[1:]):
            self._pwrite(start, raw)
        self._pwrite(obj.addr, struct.pack("<BBHII4x", 1, 0, nmsg, 1, cap0)
                     + raws[0])

    def _write_group(self, g):
        """Rebuild a group's heap of names, symbol-table nodes and B-tree
        (root node and heap header in place)."""
        names = sorted(g._links, key=lambda s: s.encode())
        heap = bytearray(8)
        offsets = {}
        for name in names:
            offsets[name] = len(heap)
            heap += _padded(name.encode() + b"\0")
        if g._heap == UNDEF:
            g._heap = self._alloc(32)
            g._btree = self._alloc(GROUP_NODE_SIZE)
            g._set_body(STAB, struct.pack("<QQ", g._btree, g._heap))
        data, cap = g._heap_data
        if len(heap) > cap:
            data, cap = self._alloc(len(heap)), len(heap)
            g._heap_data = (data, cap)
        heap += b"\0" * (cap - len(heap))
        self._pwrite(data, bytes(heap))
        self._pwrite(g._heap, b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", cap, HEAP_FREE_NULL, data))
        # symbol-table nodes of 2 LEAF_K links each
        per = 2 * LEAF_K
        parts = [names[i:i + per] for i in range(0, len(names), per)]
        while len(g._snods) < len(parts):
            g._snods.append(self._alloc(SNOD_SIZE))
        children = []
        for addr, part in zip(g._snods, parts):
            out = [b"SNOD\x01\0" + struct.pack("<H", len(part))]
            for name in part:
                obj = g._get(name)
                if isinstance(obj, Group):
                    out.append(struct.pack("<QQIIQQ", offsets[name], obj.addr,
                                           1, 0, obj._btree, obj._heap))
                else:
                    out.append(struct.pack("<QQII16x", offsets[name],
                                           obj.addr, 0, 0))
            b = b"".join(out)
            self._pwrite(addr, b + b"\0" * (SNOD_SIZE - len(b)))
            children.append((addr, offsets[part[-1]]))
        if not children:
            self._pwrite(g._btree, b"TREE\0\0\0\0" + struct.pack(
                "<QQ", UNDEF, UNDEF) + bytes(GROUP_NODE_SIZE - 24))
            return
        # B-tree levels over the symbol-table nodes, 2 GROUP_K a node
        level, used = 0, 0
        while True:
            per = 2 * GROUP_K
            parts = [children[i:i + per]
                     for i in range(0, len(children), per)]
            if len(parts) == 1:
                addrs = [g._btree]
            else:
                while len(g._nodes) < used + len(parts):
                    g._nodes.append(self._alloc(GROUP_NODE_SIZE))
                addrs = g._nodes[used:used + len(parts)]
                used += len(parts)
            up = []
            for j, (addr, part) in enumerate(zip(addrs, parts)):
                left = addrs[j - 1] if j > 0 else UNDEF
                right = addrs[j + 1] if j + 1 < len(addrs) else UNDEF
                b = [b"TREE\0" + struct.pack("<BHQQ", level, len(part), left,
                                             right), struct.pack("<Q", 0)]
                for child, key in part:
                    b.append(struct.pack("<QQ", child, key))
                b = b"".join(b)
                self._pwrite(addr, b + b"\0" * (GROUP_NODE_SIZE - len(b)))
                up.append((addr, part[-1][1]))
            if len(parts) == 1:
                break
            children, level = up, level + 1

    def _write_index(self, ds):
        """Write a dataset's chunk B-tree: the entries that changed in
        place, or every node where the tree's shape changed."""
        recs, nd = ds._recs, len(ds.chunks) + 1
        ks = 8 + 8 * nd
        node_size = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * ks
        per = 2 * CHUNK_K
        counts, n = [], len(recs)
        while True:
            n = (n + per - 1) // per
            counts.append(n)
            if n == 1:
                break
        shape = tuple(counts)

        def key(r):
            return struct.pack("<II%dQ" % nd, r[2], r[3], *r[0])

        last = recs[-1]
        right = struct.pack("<II%dQ" % nd, 0, 0, *(
            [o + c for o, c in zip(last[0], tuple(ds.chunks))]
            + [last[0][-1] + ds.dtype.itemsize]))
        if ds._data_addr == UNDEF:
            ds._data_addr = self._alloc(node_size)
            ds._set_body(LAYOUT, ds._layout_body())
            self._dirty_layouts.add(ds)
        if shape != ds._shape_on_disk:
            self._write_chunk_tree(ds, counts, key, right, node_size)
        else:
            span = [per ** k for k in range(len(counts))]
            for i in sorted(ds._changed):
                for lvl in range(len(counts)):
                    if i % span[lvl]:
                        break
                    node = i // (span[lvl] * per)
                    j = (i // span[lvl]) % per
                    addr = self._node_addr(ds, counts, lvl, node)
                    child = recs[i][1] if lvl == 0 else \
                        self._node_addr(ds, counts, lvl - 1, i // span[lvl])
                    self._pwrite(addr + 24 + j * (ks + 8),
                                 key(recs[i]) + struct.pack("<Q", child))
            if ds._grew:
                for lvl in range(len(counts)):
                    addr = self._node_addr(ds, counts, lvl, counts[lvl] - 1)
                    below = len(recs) if lvl == 0 else counts[lvl - 1]
                    m = below - (counts[lvl] - 1) * per
                    self._pwrite(addr + 6, struct.pack("<H", m))
                    self._pwrite(addr + 24 + m * (ks + 8), right)
        ds._shape_on_disk = shape
        ds._changed.clear()
        ds._grew = False

    def _node_addr(self, ds, counts, lvl, i):
        if lvl == len(counts) - 1:
            return ds._data_addr
        return ds._nodes[lvl][i]

    def _write_chunk_tree(self, ds, counts, key, right, node_size):
        recs, per = ds._recs, 2 * CHUNK_K
        while len(ds._nodes) < len(counts) - 1:
            ds._nodes.append([])
        for lvl in range(len(counts) - 1):
            while len(ds._nodes[lvl]) < counts[lvl]:
                ds._nodes[lvl].append(self._alloc(node_size))
        firsts = list(recs)               # left key of each entry
        children = [r[1] for r in recs]
        for lvl, n in enumerate(counts):
            addrs = ([ds._data_addr] if lvl == len(counts) - 1
                     else ds._nodes[lvl][:n])
            up_first, up_child = [], []
            for j, addr in enumerate(addrs):
                lo, hi = j * per, min((j + 1) * per, len(children))
                b = [b"TREE\x01" + struct.pack(
                    "<BHQQ", lvl, hi - lo,
                    addrs[j - 1] if j > 0 else UNDEF,
                    addrs[j + 1] if j + 1 < len(addrs) else UNDEF)]
                for i in range(lo, hi):
                    b.append(key(firsts[i]) + struct.pack("<Q", children[i]))
                b.append(right if hi == len(children) else key(firsts[hi]))
                b = b"".join(b)
                self._pwrite(addr, b + b"\0" * (node_size - len(b)))
                up_first.append(firsts[lo])
                up_child.append(addr)
            firsts, children = up_first, up_child

    def flush(self):
        """Put everything written so far on disk."""
        with self._lock:
            if self.mode == "r" or self._fd is None:
                return
            for ds in list(self._dirty_data):
                ds._flush_chunk()
            self._dirty_data.clear()
            for ds in list(self._dirty_indexes):
                self._write_index(ds)
            self._dirty_indexes.clear()
            # new objects: every header's address before any is written,
            # since headers and heaps hold each other's addresses
            new, self._new = self._new, []
            for obj in new:
                if obj.addr == UNDEF:
                    size = self._header_size(obj)
                    obj.addr = self._alloc(16 + size)
                    obj._chunks = [(obj.addr, size)]
                    self._objects[obj.addr] = obj
                if isinstance(obj, Group) and obj._heap == UNDEF:
                    obj._heap = self._alloc(32)
                    obj._btree = self._alloc(GROUP_NODE_SIZE)
                    obj._set_body(STAB, struct.pack("<QQ", obj._btree,
                                                    obj._heap))
                self._dirty_headers.add(obj)
            for g in list(self._dirty_groups):
                self._write_group(g)
            self._dirty_groups.clear()
            for ds in self._dirty_extents:
                if ds in self._dirty_headers or DATASPACE not in ds._at:
                    self._dirty_headers.add(ds)
                else:
                    ds._rewrite_extent()
            for obj in list(self._dirty_headers):
                if isinstance(obj, Dataset):
                    obj._sync_space()
                self._write_header(obj)
            for addr in self._dirty_colls:
                self._write_collection(addr)
            self._dirty_colls.clear()
            for ds in self._dirty_layouts - self._dirty_headers:
                ds._rewrite_layout()
            self._dirty_headers.clear()
            self._dirty_extents.clear()
            self._dirty_layouts.clear()
            self._write_superblock()
            if self._size < self._eof:
                os.ftruncate(self._fd, self._eof)
                self._size = self._eof
            self._paths = None

    def _write_superblock(self):
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", LEAF_K, GROUP_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, self._eof, UNDEF)
              + struct.pack("<QQIIQQ", 0, self.addr, 1, 0, self._btree,
                            self._heap))
        self._pwrite(0, sb)

    def close(self):
        with self._lock:
            if self._fd is None:
                return
            try:
                self.flush()
            finally:
                os.close(self._fd)
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
