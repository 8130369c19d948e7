"""Replay backends: GCM/LES stand-ins that replay a recorded spifs.nc.

Port of ``sp_coupler_tpu/models/ncreplay.py``, host numpy code as there.
The reference's offline regression mechanism (splib/ncmod.py): getters
serve the recorded per-step values, setters *compare* the incoming data
against the recording and log the difference, so the coupling math is
verified end to end without either heavy model. The driver's generic path
runs them (``gcm_type`` / ``les_type`` "ncfile", "spifsnc_gcm",
"spifsnc_les").

The recording is read through ``io.spifs.open_reader``, the port's own
HDF5 reader (``io/h5lite.py``), on any host: h5py is not needed.
"""

import datetime
import logging

import numpy as np

from .. import constants as c
from ..io import spifs

log = logging.getLogger(__name__)


class _ReplayBase:
    support_async = False

    def __init__(self, ncfile):
        self.ds = spifs.open_reader(ncfile)
        tvals = np.asarray(self.ds.variables["Time"][:])
        if len(tvals) == 0:
            raise ValueError("no time values in " + ncfile)
        self.times = tvals
        self.dt = (tvals[1] - tvals[0]) if len(tvals) > 1 else tvals[0]
        self.time0 = tvals[0] - self.dt
        self.step = 0
        self.mismatches = []  # (step, var, col, maxdiff) records

    def get_timestep(self):
        return float(self.dt)

    def get_model_time(self):
        return float(self.time0 + self.step * self.dt)

    def initialize_code(self):
        pass

    def commit_parameters(self):
        pass

    def commit_grid(self):
        pass

    def cleanup_code(self):
        self.ds.close()

    def stop(self):
        pass

    def write_restart(self):
        pass

    def _compare(self, var, col, values, recorded):
        values = np.asarray(values)
        recorded = np.asarray(recorded)
        if values.shape != recorded.shape:
            log.warning("replay %s col %s: shape %s vs recorded %s",
                        var, col, values.shape, recorded.shape)
            self.mismatches.append((self.step, var, col, np.inf))
            return
        diff = float(np.nanmax(np.abs(values - recorded))) if values.size \
            else 0.0
        scale = float(np.nanmax(np.abs(recorded))) + 1e-30
        if diff > 1e-5 * scale:
            log.info("replay %s col %s step %d: max|diff| = %g",
                     var, col, self.step, diff)
        self.mismatches.append((self.step, var, col, diff))


class ReplayGCM(_ReplayBase):
    """GCM replay: grid = the recorded columns (ncmod.netcdf_gcm:90-170)."""

    def __init__(self, ncfile):
        super().__init__(ncfile)
        self.group_names = sorted(self.ds.groups.keys(), key=int)
        self.latitudes = np.array(
            [float(self.ds.groups[g].variables["lat"][()])
             for g in self.group_names])
        self.longitudes = np.array(
            [float(self.ds.groups[g].variables["lon"][()])
             for g in self.group_names])
        self.ktot = self.ds.dimensions["oifs_height"]
        self.mask = set()
        self.step_count = 0
        self._start = datetime.datetime(2000, 1, 1)

    def get_start_datetime(self):
        return self._start

    def get_ktot(self):
        return self.ktot

    def set_mask(self, i):
        self.mask.add(int(i))

    def set_vdf_in_sp_mask(self, value):
        pass

    def evolve_model_until_cloud_scheme(self):
        return True

    def evolve_model_cloud_scheme(self):
        return True

    def evolve_model_from_cloud_scheme(self):
        self.step += 1
        self.step_count += 1
        return True

    def _group(self, col):
        """Map a column POSITION to its recorded group.

        The replay grid IS the list of recorded columns (latitudes/
        longitudes above), so the driver's column indices are positions
        into group_names, matching the reference ncmod semantics
        (splib/ncmod.py:138-166). Out-of-range positions raise rather than
        being reinterpreted as original grid indices.
        """
        col = int(col)
        if not 0 <= col < len(self.group_names):
            raise KeyError(
                "replay column position %d out of range (recording has %d "
                "columns)" % (col, len(self.group_names)))
        return self.ds.groups[self.group_names[col]]

    def get_profile_fields(self, var, cols):
        out = []
        for col in cols:
            g = self._group(col)
            s = min(self.step, len(g.variables["T"]) - 1)
            if var in ("Pfull",):
                out.append(np.asarray(g.variables["Pf"][s]))
            elif var == "Phalf":
                ph = np.asarray(g.variables["Ph"][s])
                top = max(2.0 * float(g.variables["Pf"][s][0]) - ph[0], 1.0)
                out.append(np.concatenate([[top], ph]))
            elif var == "Zgfull":
                out.append(np.asarray(g.variables["Zf"][s]) * c.grav)
            elif var == "Zghalf":
                zh = np.asarray(g.variables["Zh"][s])
                zf = np.asarray(g.variables["Zf"][s])
                top = 2.0 * zf[0] - zh[0]
                out.append(np.concatenate([[top], zh]) * c.grav)
            else:
                out.append(np.asarray(g.variables[var][s]))
        return np.stack(out)

    def get_heights(self, cols):
        """The recorded heights of cols above the surface, (Zf [n, L], Zh
        [n, L + 1], its top half level as Zghalf's above): the driver takes
        them as the recorded run did. Back through Zgfull = Zf * grav, a
        float32 division does not return every recorded height (at
        27,786 m the quotients of neighbouring float32s lie 1.6 ulps
        apart), and an ulp of height can move the LES T interpolated to
        that level by an ulp of T: f_T by an ulp of T / dt."""
        zf, zh = [], []
        for col in cols:
            g = self._group(col)
            s = min(self.step, len(g.variables["T"]) - 1)
            f = np.asarray(g.variables["Zf"][s])
            h = np.asarray(g.variables["Zh"][s])
            zf.append(f)
            zh.append(np.concatenate([[2.0 * f[0] - h[0]], h]))
        return np.stack(zf), np.stack(zh)

    def get_profile_field(self, var, col):
        return self.get_profile_fields(var, [col])[0]

    # GCM-side surface getter names -> the recorded (converted) variables
    # that stand in for them on replay (spio records z0m/z0h post-conversion)
    _SURF_ALIAS = {"Z0M": "z0m", "Z0H": "z0h"}

    def get_surface_field(self, var, cols):
        name = self._SURF_ALIAS.get(var, var)
        out = []
        for col in cols:
            g = self._group(col)
            s = min(self.step, len(g.variables["T"]) - 1)
            v = g.variables.get(name)
            out.append(float(v[s]) if v is not None else 0.0)
        return np.asarray(out)

    def set_profile_tendency(self, var, col, profile):
        g = self._group(col)
        rec = g.variables.get("f_" + var)
        if rec is None:
            log.warning("no recorded tendency f_%s", var)
            return
        s = min(self.step, len(rec) - 1)
        self._compare("f_" + var, col, profile, rec[s])


class ReplayLESFleet(_ReplayBase):
    """LES fleet replay serving recorded slab profiles per step."""

    def __init__(self, ncfile, n_les, columns=None):
        super().__init__(ncfile)
        self.n = n_les
        groups = sorted(self.ds.groups.keys(), key=int)
        # LES columns are the groups that carry LES profile variables
        les_groups = [g for g in groups
                      if "thl" in self.ds.groups[g].variables]
        self.columns = columns or [int(g) for g in les_groups[:n_les]]
        self.time = 0.0
        self.zf = np.asarray(self.ds.variables["zf"][:])
        self.nx = self.ds.dimensions["x"]
        self.ny = self.ds.dimensions["y"]
        self.nz = len(self.zf)
        # grid spacing from the recorded cell-center coordinates
        # (spifs.nc root axes x/y are (i+0.5)*dx), not hardcoded
        xs = np.asarray(self.ds.variables["x"][:])
        ys = np.asarray(self.ds.variables["y"][:])
        self.dx = float(xs[1] - xs[0]) if len(xs) > 1 else 2.0 * float(xs[0])
        self.dy = float(ys[1] - ys[0]) if len(ys) > 1 else 2.0 * float(ys[0])

    def get_itot(self):
        return self.nx

    def get_jtot(self):
        return self.ny

    def get_ktot(self):
        return self.nz

    def get_dx(self):
        return self.dx

    def get_dy(self):
        return self.dy

    def get_xsize(self):
        return self.dx * self.nx

    def get_ysize(self):
        return self.dy * self.ny

    def get_zf(self):
        return self.zf

    def get_zh(self):
        dz = self.zf[1] - self.zf[0]
        return self.zf + 0.5 * dz

    def init_states(self, u, v, thl, qt, ps, start_time=0.0):
        self.time = float(start_time)

    def evolve_to(self, t_end, forcing=None):
        self.time = float(t_end)
        self.step = int(np.argmin(np.abs(self.times - t_end)))

    def _read(self, var):
        out = []
        for colv in self.columns:
            g = self.ds.groups[str(colv)]
            s = min(self.step, len(g.variables[var]) - 1)
            out.append(np.asarray(g.variables[var][s]))
        return np.stack(out)

    def get_profiles(self):
        prof = {
            "U": self._read("u"), "V": self._read("v"),
            "THL": self._read("thl"), "QT": self._read("qt"),
            "QL": self._read("ql"), "QL_ice": self._read("ql_ice"),
            "QL_water": self._read("ql_water"), "QR": self._read("qr"),
            "T": self._read("t_"), "presf": self._read("presf"),
            "Rhof": self._read("rhof"), "Rhobf": self._read("rhobf"),
            "PS": self._read("Psurf").reshape(self.n),
            "Rain": self._read("rain").reshape(self.n),
        }
        prof["cloudfrac_z"] = np.zeros_like(prof["QL"])
        prof["qt_std"] = np.zeros_like(prof["QL"])
        return prof

    def cloud_fractions(self, gcm_Zh):
        return self._read("A_d")

    def get_fields(self):
        shp = (self.n, self.nz, self.ny, self.nx)
        qt = np.broadcast_to(self._read("qt")[:, :, None, None], shp)
        thl = np.broadcast_to(self._read("thl")[:, :, None, None], shp)
        return {"QT": qt.copy(), "THL": thl.copy(),
                "QL": np.zeros(shp), "Qsat": np.full(shp, 1.0),
                "T": thl.copy()}

    def set_qt_thl(self, qt, thl):
        pass
