"""Analytic dummy GCM and LES backends (host numpy; no device).

Copy of ``sp_coupler_tpu/models/dummy.py``: in-process fake models with
the full duck-typed API, so that the whole coupler loop runs with no heavy
compute (the reference's spdummy.py; selected with --gcmtype dummy
--lestype dummy): analytic cos/exp fields, no-op dynamics.
"""

import datetime

import numpy as np

from sp_coupler_tpu_torch import constants as c


class DummyGCM:
    """Analytic GCM: 40 x 20 grid, 20 levels (spdummy.dummy_gcm:62-178)."""

    support_async = False

    def __init__(self, nlev=20, nlat=20, nlon=40, dt=600.0):
        self.ktot = nlev
        self.num_lats = nlat
        self.num_lons = nlon
        self._dt = dt
        self._time = 0.0
        self.mask = set()
        self.step = 0
        lats = 180.0 * (np.arange(nlat) / nlat) - 90.0
        lons = 360.0 * (np.arange(nlon) / nlon)
        self.latitudes = np.repeat(lats, nlon)
        self.longitudes = np.tile(lons, nlat)
        self._start = datetime.datetime(2000, 1, 1)
        self._sp_tend = {}

    # lifecycle
    def initialize_code(self):
        pass

    def commit_parameters(self):
        pass

    def commit_grid(self):
        pass

    def cleanup_code(self):
        pass

    def stop(self):
        pass

    def write_restart(self):
        pass

    # time
    def get_start_datetime(self):
        return self._start

    def get_timestep(self):
        return self._dt

    def get_model_time(self):
        return self._time

    def get_itot(self):
        return self.num_lons

    def get_jtot(self):
        return self.num_lats

    def get_ktot(self):
        return self.ktot

    # phases (no-op dynamics; time advances in phase B like the real core)
    def evolve_model_until_cloud_scheme(self):
        return True

    def evolve_model_cloud_scheme(self):
        self._sp_tend = {}
        return True

    def evolve_model_from_cloud_scheme(self):
        self._time += self._dt
        self.step += 1
        return True

    def set_mask(self, i):
        self.mask.add(int(i))

    def set_vdf_in_sp_mask(self, value):
        self._vdf_in_sp = value

    # analytic fields: smooth horizontal factor x vertical profile,
    # top-first ordering, physically plausible magnitudes
    def _hfac(self, cols):
        lat = np.radians(self.latitudes[cols])
        lon = np.radians(self.longitudes[cols])
        return 1.0 + 0.3 * np.cos(lat) * np.cos(lon)

    def _sigma_f(self):
        return np.exp(-4.0 * (np.arange(self.ktot)[::-1] + 0.5) / self.ktot)

    def _sigma_h(self):
        return np.exp(-4.0 * (np.arange(self.ktot + 1)[::-1]) / self.ktot)

    def get_profile_fields(self, var, cols):
        cols = np.asarray(cols, int)
        h = self._hfac(cols)[:, None]
        sf = self._sigma_f()[None, :]
        sh_lv = self._sigma_h()[None, :]
        zf = -c.rd * 280.0 / c.grav * np.log(sf)
        zh = -c.rd * 280.0 / c.grav * np.log(sh_lv)
        if var in ("U", "V"):
            return 10.0 * h * (1.0 - sf)
        if var == "T":
            return 220.0 + 80.0 * h / h.mean() * sf ** 0.3
        if var == "SH":
            return 0.015 * h * sf ** 2
        if var in ("QL", "QI"):
            return 1e-5 * h * sf
        if var == "A":
            return np.clip(0.3 * h * sf, 0.0, 1.0)
        if var == "Pfull":
            return 1.0e5 * np.repeat(sf, len(cols), 0)
        if var == "Phalf":
            return 1.0e5 * np.repeat(sh_lv, len(cols), 0)
        if var == "Zgfull":
            return c.grav * np.repeat(zf, len(cols), 0)
        if var == "Zghalf":
            return c.grav * np.repeat(zh, len(cols), 0)
        raise KeyError(var)

    def get_profile_field(self, var, col):
        return self.get_profile_fields(var, [col])[0]

    def get_surface_field(self, var, cols):
        cols = np.asarray(cols, int)
        h = self._hfac(cols)
        vals = {"Z0M": 0.1 * np.ones_like(h),
                "Z0H": 0.02 * np.ones_like(h),
                "QLflux": 0.0 * h,
                "QIflux": 0.0 * h,
                "SHflux": -4e-5 * h,      # positive down (evaporation up)
                "TLflux": -100.0 * h,
                "TSflux": -30.0 * h}
        return vals[var]

    def set_profile_tendency(self, var, col, profile):
        self._sp_tend[(var, int(col))] = np.asarray(profile)


class DummyLESFleet:
    """Analytic LES fleet: 8 x 8 x 20 instances (spdummy.dummy_les:183-345)."""

    support_async = False

    def __init__(self, n_les, nx=8, ny=8, nz=20, dx=100.0, dy=100.0,
                 dz=200.0, dt_les=60.0):
        self.n = n_les
        self.nx, self.ny, self.nz = nx, ny, nz
        self.dx, self.dy, self.dz = dx, dy, dz
        self.dt = dt_les
        self.time = 0.0
        self.sp = np.full(n_les, 1.0e5)
        self._forcing = None

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
        return self.nx * self.dx

    def get_ysize(self):
        return self.ny * self.dy

    def get_zf(self):
        return (np.arange(self.nz) + 0.5) * self.dz

    def get_zh(self):
        return (np.arange(self.nz) + 1.0) * self.dz

    def init_states(self, u, v, thl, qt, ps, start_time=0.0):
        self.sp = np.asarray(ps)
        self.time = float(start_time)

    def evolve_to(self, t_end, forcing=None):
        self.time = float(t_end)
        self._forcing = forcing

    def _zfac(self):
        zf = self.get_zf()
        return zf / zf[-1]

    def get_profiles(self):
        z = self._zfac()
        one = np.ones((self.n, 1))
        prof = {
            "U": one * np.sin(6.28 * z),
            "V": one * np.sin(6.28 * z),
            "THL": one * (283.0 + 10.0 * np.cos(6.0 * z)),
            "T": one * (283.0 + 10.0 * np.cos(6.0 * z)),
            "QT": one * (0.005 + 0.002 * np.cos(6.0 * z)),
            "QL": one * np.clip(0.0005 * np.sin(6.0 * z), 0.0, None),
            "QR": one * np.clip(1e-5 * np.sin(6.0 * z), 0.0, None),
            "presf": one * (1.0e5 * np.exp(-self.get_zf() / 8000.0)),
            "Rhof": one * (1.2 * np.exp(-self.get_zf() / 8000.0)),
            "Rhobf": one * (1.2 * np.exp(-self.get_zf() / 8000.0)),
            "cloudfrac_z": one * np.clip(0.3 * np.sin(6.0 * z), 0.0, 1.0),
            "qt_std": one * (1e-4 * np.ones_like(z)),
            "PS": self.sp.copy(),
            "Rain": np.full(self.n, 1e-4) * self.time,
        }
        prof["QL_ice"] = 0.1 * prof["QL"]
        prof["QL_water"] = 0.9 * prof["QL"]
        return prof

    def cloud_fractions(self, gcm_Zh):
        from ..utils import interp as _interp
        import torch
        cf = torch.as_tensor(self.get_profiles()["cloudfrac_z"],
                             dtype=torch.float32)
        W = _interp.conservative_matrix(
            torch.as_tensor(np.asarray(gcm_Zh), dtype=torch.float32),
            torch.arange(self.nz + 1, dtype=torch.float32) * self.dz,
            torch.ones_like(cf))
        return torch.matmul(W, cf[..., None])[..., 0].numpy()

    def get_fields(self):
        z = self._zfac()
        shp = (self.n, self.nz, self.ny, self.nx)
        qt = np.broadcast_to(
            (0.005 + 0.002 * np.cos(6.0 * z))[None, :, None, None], shp)
        return {"QT": qt.copy(), "THL": np.full(shp, 290.0),
                "QL": np.zeros(shp), "Qsat": np.full(shp, 0.01),
                "T": np.full(shp, 285.0)}

    def set_qt_thl(self, qt, thl):
        pass

    def write_restart(self):
        pass

    def cleanup_code(self):
        pass

    def stop(self):
        pass
