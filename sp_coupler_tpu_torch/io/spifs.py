"""spifs.nc output: the reference's observable, same schema and layout.

Copy of ``sp_coupler_tpu/io/spifs.py``; the two packages write and read
the same files.

One file with root axes x/y/zf/oifs_height/Time (unlimited) and one group
per superparameterized (or output-only) column holding ~45 variables:
GCM profiles (UPPERCASE), LES profiles (lowercase), both-direction forcings
(f_*), surface scalars, and nudge diagnostics — the exact variable list of
spio.py:88-225 (naming convention README.md:127-128).

The write cursor (cdf_step) advances via update_time, matching
spio.update_time (spio.py:68-72); sync runs under a lock so a background
writer thread can flush while the LES fleet computes (spio.py:76-84).
"""

import logging
import threading

import numpy as np

from . import h5nc

log = logging.getLogger(__name__)

LES_PROFILE_VARS = [
    ("u", "m/s"), ("v", "m/s"), ("thl", "K"), ("qt", "1"), ("ql", "1"),
    ("ql_ice", "1"), ("ql_water", "1"), ("qr", "1"), ("t", "K"),
    ("t_", "K"), ("f_u", "m/s"), ("f_v", "m/s"), ("f_thl", "K/s"),
    ("f_qt", "1/s"), ("presf", "Pa/s"), ("rhof", "kg/m^3"),
    ("rhobf", "kg/m^3"), ("qt_std", "1"), ("qt_alpha", "1/s"),
    ("qt_beta", "1"),
]
GCM_FORCING_VARS = [
    ("f_U", "m/s"), ("f_V", "m/s"), ("f_T", "K/s"), ("f_SH", "1/s"),
    ("f_QL", "1/s"), ("f_QI", "1/s"), ("f_A", "1/s"),
]
GCM_PROFILE_VARS = [
    ("U", "m/s"), ("V", "m/s"), ("T", "K"), ("SH", "1"), ("QL", "1"),
    ("QI", "1"), ("Pf", "Pa"), ("Ph", "Pa"), ("Tv", "K"), ("Zf", "m"),
    ("Zh", "m"), ("THL", "K"), ("QT", "1"), ("A", "1"), ("A_d", "1"),
]
SURFACE_VARS = [("Psurf", "Pa"), ("rain", "kg / m^2"),
                ("rainrate", "kg / m^2h")]
SURFACE_FLUX_VARS = [
    ("z0m", "m"), ("z0h", "m"), ("wthl", "K m/s"), ("wqt", "kg/kg m/s"),
    ("TLflux", "W/m^2"), ("TSflux", "W/m^2"), ("SHflux", "kg / m^2s"),
    ("QLflux", "kg / m^2s"), ("QIflux", "kg / m^2s"),
]


class SpifsWriter:
    """spifs.nc writer; one instance per run."""

    def __init__(self, path, gcm_ktot, les_info=None, start_time=None,
                 append=False, with_surf_vars=True, compress=0):
        """les_info: dict with x, y, zf coordinate arrays (None: no LES axes)."""
        self.path = path
        self.lock = threading.Lock()
        self.step = -1
        self.with_surf = with_surf_vars
        self.column_groups = {}
        if append:
            self.ds = h5nc.Dataset(path, "a")
            for name, grp in self.ds.groups.items():
                self.column_groups[int(name)] = grp
            return
        self.ds = h5nc.Dataset(path, "w", compress=compress)
        ds = self.ds
        if les_info is not None:
            ds.createDimension("x", len(les_info["x"]))
            ds.createDimension("y", len(les_info["y"]))
            ds.createDimension("zf", len(les_info["zf"]))
            for nm in ("x", "y", "zf"):
                v = ds.createVariable(nm, "f4", (nm,))
                v[:] = np.asarray(les_info[nm], np.float32)
                v.units = "m"
        ds.createDimension("oifs_height", gcm_ktot)
        ds.createDimension("Time", None)
        t = ds.createVariable("Time", "f4", ("Time",))
        t.units = "s since " + str(start_time)

    # -- group creation ------------------------------------------------------

    def add_les_column(self, index, lat, lon):
        grp = self.add_output_column(index, lat, lon)
        for name, unit in LES_PROFILE_VARS:
            v = grp.createVariable(name, "f4", ("Time", "zf"))
            v.units = unit
        for name, unit in GCM_FORCING_VARS:
            v = grp.createVariable(name, "f4", ("Time", "oifs_height"))
            v.units = unit
        return grp

    def add_output_column(self, index, lat, lon):
        if int(index) in self.column_groups:
            return self.column_groups[int(index)]
        grp = self.ds.createGroup(str(index))
        for name, unit in GCM_PROFILE_VARS:
            v = grp.createVariable(name, "f4", ("Time", "oifs_height"))
            v.units = unit
        srf = list(SURFACE_VARS) + (list(SURFACE_FLUX_VARS)
                                    if self.with_surf else [])
        for name, unit in srf:
            v = grp.createVariable(name, "f4", ("Time",))
            v.units = unit
        lat_v = grp.createVariable("lat", "f4", ())
        lat_v.units = "deg"
        lat_v[()] = lat
        lon_v = grp.createVariable("lon", "f4", ())
        lon_v.units = "deg"
        lon_v[()] = lon
        self.column_groups[int(index)] = grp
        return grp

    # -- writing -------------------------------------------------------------

    def update_time(self, t):
        """Advance the cursor to the next record, stamped with time t (s)."""
        tv = self.ds.variables["Time"]
        self.step = tv.shape[0]
        tv[self.step] = float(t)

    def write_column(self, index, lock=False, **kwargs):
        """Write named arrays into column group `index` at the cursor.

        Unknown variables are logged and skipped, like spio.write_les_data
        (spio.py:228-242).
        """
        grp = self.column_groups.get(int(index))
        if grp is None:
            log.error("write to unknown column %s", index)
            return
        if lock:
            self.lock.acquire()
        try:
            for var, arr in kwargs.items():
                v = grp.variables.get(var)
                if v is None:
                    log.error("write to uninitialized variable %s", var)
                    continue
                v[self.step] = np.asarray(arr, np.float32)
        finally:
            if lock:
                self.lock.release()

    def sync(self):
        with self.lock:
            self.ds.sync()

    def close(self):
        self.ds.close()


class NullWriter:
    """Writer stand-in for non-zero processes in a multi-controller run.

    The reference's netCDF file is written only by the master rank
    (run_T21_nospawn.sh rank 0); here every process executes the same host
    loop, so processes != 0 write into this sink instead of spifs.nc.
    """

    is_null = True
    step = -1

    def add_les_column(self, *a, **k):
        return None

    def add_output_column(self, *a, **k):
        return None

    def update_time(self, t):
        pass

    def write_column(self, index, lock=False, **kwargs):
        pass

    def sync(self):
        pass

    def close(self):
        pass


def open_reader(path):
    """Read-mode Dataset for replay/verification tooling, through the
    port's own HDF5 reader (``h5lite``; no h5py), for files of either
    package."""
    return h5nc.Dataset(path, "r")
