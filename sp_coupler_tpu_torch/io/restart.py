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
``load`` reads the file on every rank and keeps the rank's block of rows
and planes and its GCM band. So a checkpoint resumes under any
decomposition.

The members are stored, not deflated (the JAX package deflates them;
``np.load`` reads both): BASELINE config 4's fleet is ~18.8 GB, which
zlib on one host thread takes tens of minutes to deflate while the other
ranks wait. The file is written under a temporary name and renamed when
whole, so a failed save leaves no short restart.npz.
"""

import json
import logging
import os
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


def _unflatten(tag, data, template, rows=None, plane=None):
    """template's tree with its leaves replaced by data's (their rows
    rows, where given, and of a leaf of 4 dims [n, nz(+1), ny, nx] the
    block of plane, where given), in order: a tensor leaf becomes a tensor
    on its device, others stay numpy."""
    leaves, spec = tree.flatten(template)
    new = []
    for i, leaf in enumerate(leaves):
        arr = data["%s_%d" % (tag, i)]
        arr = arr if rows is None else arr[rows]
        if plane is not None and arr.ndim == 4:
            arr = arr[..., plane.y0:plane.y0 + plane.by,
                      plane.x0:plane.x0 + plane.bx]
        arr = np.array(arr)
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
    path = os.path.join(runner.cfg.output_dir, FNAME)
    with open(os.path.join(runner.cfg.output_dir, META)) as f:
        meta = json.load(f)
    with np.load(path) as data:
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
    runner.rain_last = np.asarray(meta["rain_last"])
    log.info("restart loaded from %s (gcm t=%s)", path, meta["gcm_time"])
