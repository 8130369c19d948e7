"""Checkpoint / resume.

Port of ``sp_coupler_tpu/io/restart.py``. The coupled state is two trees
(GCM state, LES fleet state) plus the LES profiles of the generic path; a
checkpoint is one npz of their leaves and a small JSON of host scalars, in
the run's output directory. The leaves are numbered in
``jax.tree.flatten`` order (``utils/tree.py``) under the same
``gcm_i``/``les_i``/``prof_i`` keys, so a checkpoint written by either
package loads into the other. Resume reopens spifs.nc in append mode (the
driver writes nothing on the first restarted step, splib.py:272-274).

In a multi-process run the file holds the whole fleet: ``save`` gathers
the planes over each plane's ranks and a banded GCM's grid space over its
latitude bands, and rank 0 alone collects the fleet's rows, one leaf of
one les slot at a time through its host (``sharding.rows_to_root``; a
collective: every rank calls it), writing each leaf as it arrives;
``load`` reads on every rank only the rank's block of rows of each fleet
leaf (``NpzReader``: a stored member's rows straight from the file), cuts
them to its block of the planes, and keeps its GCM band. So a checkpoint
resumes under any decomposition, and BASELINE config 4's ranks read a
quarter of its fleet each.

Under ``--restart_overlap`` a checkpoint written while a step's record
is still pending (write-behind: that option's save, or a periodic one)
keeps that record's rain (``rain_pending``), which a run resumed under
the same option hands on as the record's flush would have: its rainrate
diagnostic is then the uninterrupted run's. Without the option neither
is done, and a resumed run's rain_last is the checkpoint's through the
overlap step, as in the JAX package.

The members are stored, not deflated (the JAX package deflates them;
``np.load`` reads both): BASELINE config 4's fleet is ~18.8 GB, which
zlib on one host thread takes tens of minutes to deflate while the other
ranks wait. The file is written under a temporary name and renamed when
whole, so a failed save leaves no short restart.npz.
"""

import json
import logging
import os
import struct
import time
import zipfile

import numpy as np
import torch

from ..interop import to_numpy
from ..parallel import mesh as pmesh, sharding as shd
from ..utils import tree

log = logging.getLogger(__name__)

FNAME = "restart.npz"
META = "restart.json"


def _flatten(tag, state):
    leaves, _ = tree.flatten(state)
    return {"%s_%d" % (tag, i): np.asarray(to_numpy(x))
            for i, x in enumerate(leaves)}


class NpzWriter:
    """An .npz written one member at a time, as ``np.savez`` writes it (a
    zip64 member ``KEY.npy`` an array), the members stored; at ``path``
    once ``close`` has run, under ``path + ".part"`` until then."""

    def __init__(self, path):
        self.path = path
        self.zf = zipfile.ZipFile(path + ".part", "w", zipfile.ZIP_STORED,
                                  allowZip64=True)

    def add(self, key, arr):
        with self.zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(arr),
                                      allow_pickle=False)

    def close(self):
        self.zf.close()
        os.replace(self.path + ".part", self.path)


class NpzReader:
    """The arrays of an .npz by key, and rows of them: a stored member
    (``NpzWriter``, ``np.savez``) is read in place, from the member's data
    offset past its .npy header, only the rows asked for; a deflated one
    (``np.savez_compressed``, the JAX package's checkpoints) whole through
    ``np.load``. ``bytes_read`` counts the array bytes read."""

    CHUNK = 1 << 30     # bytes a read call: os.preadv reads ~2 GiB at most

    def __init__(self, path):
        self.path = path
        self.zf = zipfile.ZipFile(path)
        self.files = [n[:-4] for n in self.zf.namelist()
                      if n.endswith(".npy")]
        self.fd = os.open(path, os.O_RDONLY)
        self.bytes_read = 0
        self._npz = None

    def close(self):
        os.close(self.fd)
        self.zf.close()
        if self._npz is not None:
            self._npz.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _layout(self, info):
        """(offset of the array's first byte, shape, dtype) of a stored,
        C-ordered member; None for any other."""
        if info.compress_type != zipfile.ZIP_STORED:
            return None
        with self.zf.open(info) as f:
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            header = f.tell()
        if fortran or dtype.hasobject:
            return None
        # the local header's name and extra fields may differ in length
        # from the central directory's
        name, extra = struct.unpack(
            "<HH", os.pread(self.fd, 30, info.header_offset)[26:30])
        return (info.header_offset + 30 + name + extra + header, shape,
                dtype)

    def get(self, key, rows=None):
        """The array of key, or its rows (a slice of the first axis)."""
        layout = self._layout(self.zf.getinfo(key + ".npy"))
        if layout is None or (rows is not None and rows.step not in
                              (None, 1)):
            if self._npz is None:
                self._npz = np.load(self.path)
            arr = self._npz[key]
            self.bytes_read += arr.nbytes
            return arr if rows is None else arr[rows]
        off, shape, dtype = layout
        if rows is None or not shape:
            out, start = np.empty(shape, dtype), off
        else:
            r0, r1, _ = rows.indices(shape[0])
            out = np.empty((max(r1 - r0, 0),) + tuple(shape[1:]), dtype)
            start = off + r0 * int(np.prod(shape[1:], dtype=np.int64)) \
                * dtype.itemsize
        view, got = memoryview(out.reshape(-1).view(np.uint8)), 0
        while got < len(view):
            n = os.preadv(self.fd, [view[got:got + self.CHUNK]],
                          start + got)
            if n <= 0:
                raise IOError("%s: %s ends %d bytes short" % (
                    self.path, key, len(view) - got))
            got += n
        self.bytes_read += got
        return out


def _unflatten(tag, data, template, rows=None, plane=None):
    """template's tree with its leaves replaced by data's (an NpzReader;
    their rows rows, where given, read alone, and of a leaf of 4 dims [n,
    nz(+1), ny, nx] the block of plane, where given), in order: a tensor
    leaf becomes a tensor on its device, others stay numpy."""
    leaves, spec = tree.flatten(template)
    new = []
    for i, leaf in enumerate(leaves):
        arr = data.get("%s_%d" % (tag, i), rows)
        if plane is not None and arr.ndim == 4:
            arr = arr[..., plane.y0:plane.y0 + plane.by,
                      plane.x0:plane.x0 + plane.bx]
        arr = np.ascontiguousarray(arr)
        new.append(torch.as_tensor(arr, device=leaf.device)
                   if isinstance(leaf, torch.Tensor) else arr)
    return tree.unflatten(spec, iter(new))


def _fleet_rows(fleet):
    """The rows of the whole fleet this process's fleet state holds."""
    mesh = getattr(fleet, "mesh", None)
    return None if mesh is None else mesh.block(fleet.n)


def save(runner):
    """Write the checkpoint (rank 0); a collective under a les mesh."""
    root = pmesh.rank() == 0
    meta = {
        "gcm_time": float(runner.gcm.get_model_time()),
        "fleet_time": float(getattr(runner.fleet, "time", 0.0)),
        "sp_cols": list(map(int, runner.sp_cols)),
        "rain_last": [float(x) for x in np.asarray(runner.rain_last)],
        "gcm_step": int(getattr(runner.gcm, "step_count", 0)),
    }
    pending = (runner.pending_rain()
               if getattr(runner, "restart_overlap", False) else None)
    if pending is not None:
        meta["rain_pending"] = [float(x) for x in pending]
    gcm = {}
    if hasattr(runner.gcm, "state"):
        core = getattr(runner.gcm, "core", None)
        state = runner.gcm.state
        state = state if core is None else core.whole_state(state)
        gcm = _flatten("gcm", state) if root else {}
    path = os.path.join(runner.cfg.output_dir, FNAME)
    out = NpzWriter(path) if root else None
    try:
        for key, arr in gcm.items():
            out.add(key, arr)
        if getattr(runner.fleet, "state", None) is not None:
            state = runner.fleet.state
            if getattr(runner.fleet, "plane", None) is not None:
                state = runner.fleet.plane.gather_fields(state)
            for i, leaf in enumerate(shd.rows_to_root(
                    state, getattr(runner.fleet, "mesh", None),
                    getattr(runner.fleet, "n", 0))):
                if root:
                    out.add("les_%d" % i, leaf)
        if not root:
            return      # rank 0 owns the file
        if runner.prev_profiles is not None:
            for key, arr in _flatten("prof", runner.prev_profiles).items():
                out.add(key, arr)
            meta["has_profiles"] = True
        out.close()
    finally:
        if out is not None and os.path.exists(path + ".part"):
            out.zf.close()
            os.remove(path + ".part")
    with open(os.path.join(runner.cfg.output_dir, META), "w") as f:
        json.dump(meta, f)
    log.info("restart written to %s", path)


def load(runner):
    """Resume runner from the checkpoint in its output directory; the
    seconds it took and the bytes of arrays read go to
    ``runner.restart_load``."""
    t0 = time.time()
    path = os.path.join(runner.cfg.output_dir, FNAME)
    with open(os.path.join(runner.cfg.output_dir, META)) as f:
        meta = json.load(f)
    with NpzReader(path) as data:
        if hasattr(runner.gcm, "state"):
            state = _unflatten("gcm", data, runner.gcm.state)
            core = getattr(runner.gcm, "core", None)
            runner.gcm.state = (state if core is None
                                else core.band_state(state))
            runner.gcm._first = False
            runner.gcm.step_count = int(meta.get("gcm_step", 0))
        plane = getattr(runner.fleet, "plane", None)
        if getattr(runner.fleet, "state", None) is not None:
            runner.fleet.state = _unflatten("les", data, runner.fleet.state,
                                            _fleet_rows(runner.fleet), plane)
        elif hasattr(runner.fleet, "init_states") and any(
                k.startswith("les_") for k in data.files):
            # the checkpoint holds a fleet state the fleet does not have
            # yet: initialize one as the template, then overwrite it
            nz = runner.fleet.get_ktot()
            z = np.zeros((runner.fleet.n, nz), np.float32)
            runner.fleet.init_states(z, z, z + 300.0, z + 1e-3,
                                     np.full(runner.fleet.n, 1e5, np.float32))
            runner.fleet.state = _unflatten("les", data, runner.fleet.state,
                                            _fleet_rows(runner.fleet), plane)
        runner.fleet.time = meta["fleet_time"]
        if meta.get("has_profiles") and runner.prev_profiles is None:
            runner.prev_profiles = _unflatten(
                "prof", data, to_numpy(runner.fleet.get_profiles()))
        bytes_read = data.bytes_read
    runner.rain_last = np.asarray(meta["rain_last"])
    if "rain_pending" in meta and getattr(runner, "restart_overlap", False):
        runner._pending_record = dict(write=False,
                                      rain=np.asarray(meta["rain_pending"]))
    runner.restart_load = dict(seconds=time.time() - t0,
                               bytes_read=bytes_read,
                               file_bytes=os.path.getsize(path))
    log.info("restart loaded from %s (gcm t=%s): %d bytes of arrays read "
             "in %.2f s", path, meta["gcm_time"], bytes_read,
             runner.restart_load["seconds"])
