"""Checkpoint / resume.

Port of ``sp_coupler_tpu/io/restart.py``. The coupled state is two trees
(GCM state, LES fleet state) plus the LES profiles of the generic path; a
checkpoint is one compressed npz of their leaves and a small JSON of host
scalars, in the run's output directory. The leaves are numbered in
``jax.tree.flatten`` order (``utils/tree.py``) under the same
``gcm_i``/``les_i``/``prof_i`` keys, so a checkpoint written by either
package loads into the other. Resume reopens spifs.nc in append mode (the
driver writes nothing on the first restarted step, splib.py:272-274).

In a multi-process run the file holds the whole fleet: ``save`` gathers
every rank's block (the planes over each plane's ranks, then the rows over
the les slots, and a banded GCM's grid space over its latitude bands; a
collective: every rank calls it) and rank 0 writes; ``load`` reads the
file on every rank and keeps the rank's block of rows and planes and its
GCM band. So a checkpoint resumes under any decomposition.
"""

import json
import logging
import os

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
    out = {}
    meta = {
        "gcm_time": float(runner.gcm.get_model_time()),
        "fleet_time": float(getattr(runner.fleet, "time", 0.0)),
        "sp_cols": list(map(int, runner.sp_cols)),
        "rain_last": [float(x) for x in np.asarray(runner.rain_last)],
        "gcm_step": int(getattr(runner.gcm, "step_count", 0)),
    }
    if hasattr(runner.gcm, "state"):
        core = getattr(runner.gcm, "core", None)
        state = runner.gcm.state
        out.update(_flatten("gcm", state if core is None
                            else core.whole_state(state)))
    if getattr(runner.fleet, "state", None) is not None:
        state = runner.fleet.state
        if getattr(runner.fleet, "plane", None) is not None:
            state = runner.fleet.plane.gather_fields(state)
        out.update(_flatten("les", shd.gather_rows(
            state, getattr(runner.fleet, "mesh", None),
            getattr(runner.fleet, "n", 0))))
    if pmesh.rank() != 0:
        return      # the gather above is collective; rank 0 owns the file
    if runner.prev_profiles is not None:
        out.update(_flatten("prof", runner.prev_profiles))
        meta["has_profiles"] = True
    path = os.path.join(runner.cfg.output_dir, FNAME)
    np.savez_compressed(path, **out)
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
