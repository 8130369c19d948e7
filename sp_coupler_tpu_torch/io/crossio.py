"""Per-instance LES statistics output: cross sections and column integrals.

Port of ``sp_coupler_tpu/io/crossio.py``. The reference's
DALES instances write their own netCDF files per work directory (surf_xy
cross sections at configured heights; reference README.md:108-111,
namoptions &NAMCROSSSECTION crossheight = 2,40,80, dtav = 60). Here each
instance of the fleet gets one netCDF-classic file,
``<out_dir>/les-work-<column>/cross.nc``, written through the native async
writer (``io/spnc.py``), so serialization runs off the step loop.

Variables: xy cross sections of thl, qt, ql, w at the configured level
indices (0-based), plus LWP / RWP / TWP maps (liquid / rain / total water
paths). The fleet's fields are copied to the host once per record. In a
multi-process run each rank writes the files of the instances it holds
(``positions``), from its own block of the fleet, as every DALES instance
writes its own files from its own ranks.
"""

import os
from types import SimpleNamespace

import numpy as np

from ..interop import to_numpy
from . import spnc

CROSS_FIELDS = ("thl", "qt", "ql", "w")
STATE_FIELDS = ("thl", "qt", "w", "qr", "rhobf")


class CrossSectionWriter:
    """One writer per LES instance."""

    def __init__(self, path, grid, heights=(2, 40, 80)):
        self.grid = grid
        self.heights = [h for h in heights if h < grid.nz]
        self.w = spnc.create_writer(path)
        t = self.w.def_dim("time", None)
        y = self.w.def_dim("y", grid.ny)
        x = self.w.def_dim("x", grid.nx)
        self.time_vid = self.w.def_var("time", "s", [t])
        self.vids = {}
        for name in CROSS_FIELDS:
            for k in self.heights:
                unit = {"thl": "K", "qt": "1", "ql": "1", "w": "m/s"}[name]
                self.vids[(name, k)] = self.w.def_var(
                    f"{name}xy{k:03d}", unit, [t, y, x])
        for name, unit in (("lwp", "kg/m^2"), ("rwp", "kg/m^2"),
                           ("twp", "kg/m^2")):
            self.vids[name] = self.w.def_var(name, unit, [t, y, x])
        self.w.enddef()
        self.rec = 0

    def write(self, state_i, ql_3d, t):
        """state_i: one instance's fields (numpy, [nz(+1), ny, nx] and
        rhobf [nz]); ql_3d [nz, ny, nx]."""
        g = self.grid
        self.w.put(self.time_vid, self.rec, np.asarray([t], np.float32))
        fields = {"thl": state_i.thl, "qt": state_i.qt, "ql": ql_3d,
                  "w": state_i.w[:-1]}
        for name in CROSS_FIELDS:
            for k in self.heights:
                self.w.put(self.vids[(name, k)], self.rec,
                           np.asarray(fields[name][k]))
        rho_dz = np.asarray(state_i.rhobf)[:, None, None] * g.dz
        self.w.put(self.vids["lwp"], self.rec,
                   np.sum(rho_dz * np.asarray(ql_3d), axis=0))
        self.w.put(self.vids["rwp"], self.rec,
                   np.sum(rho_dz * np.asarray(state_i.qr), axis=0))
        self.w.put(self.vids["twp"], self.rec,
                   np.sum(rho_dz * np.asarray(state_i.qt), axis=0))
        self.rec += 1

    def flush(self):
        self.w.flush()

    def close(self):
        self.w.close()


class FleetCrossIO:
    """Cross-section writers for the instances at fleet positions
    ``positions`` (default: all); sp_cols, aligned with positions, names
    each instance's work directory."""

    def __init__(self, out_dir, grid, sp_cols, heights=(2, 40, 80),
                 positions=None):
        self.positions = (list(positions) if positions is not None
                          else list(range(len(sp_cols))))
        if len(self.positions) != len(sp_cols):
            raise ValueError("%d positions for %d columns"
                             % (len(self.positions), len(sp_cols)))
        self.writers = {}
        for pos, col in zip(self.positions, sp_cols):
            d = os.path.join(out_dir, "les-work-%d" % col)
            os.makedirs(d, exist_ok=True)
            self.writers[pos] = CrossSectionWriter(
                os.path.join(d, "cross.nc"), grid, heights)

    def write(self, fleet_state, ql_3d, t, held=None):
        """fleet_state: an LESState; ql_3d [n, nz, ny, nx]; held: the
        fleet positions of their rows (default 0, 1, ...: the whole
        fleet). Only the rows this writer writes go to the host."""
        if not self.writers:
            return
        held = list(range(ql_3d.shape[0])) if held is None else list(held)
        rows = [held.index(p) for p in self.writers]
        state = {k: to_numpy(getattr(fleet_state, k)[rows])
                 for k in STATE_FIELDS}
        ql = to_numpy(ql_3d[rows])
        for j, w in enumerate(self.writers.values()):
            w.write(SimpleNamespace(**{k: v[j] for k, v in state.items()}),
                    ql[j], t)

    def flush(self):
        for w in self.writers.values():
            w.flush()

    def close(self):
        for w in self.writers.values():
            w.close()
