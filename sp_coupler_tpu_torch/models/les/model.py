"""LES fleet: all embedded instances as one batched state.

Port of ``sp_coupler_tpu/models/les/model.py``. The fleet is one LESState
with a leading instance axis on one device; evolve, profiles and fields
run on the whole fleet at once (big instances are stepped one after the
other, ``step.map_fleet``). With a mesh (``shard``) the state is this
rank's block of the fleet: its les slot's instances and, where the mesh
splits the plane (x, y), its block of their planes (``plane``). Evolve
runs on the block, the ranks of a plane together; the profile, field and
cloud-fraction getters gather the whole fleet's rows (and the fields'
whole planes) on every rank (collectives: every rank calls them in the
same order). LESInstance is the reference's per-instance
duck-typed API (get_profile_U, get_cloudfraction, ... — spcpl.py:274-385,
747-767) over the fleet, on host numpy copies.
"""

import logging

import numpy as np
import torch

from sp_coupler_tpu_torch import default_device, generator
from ...interop import to_numpy
from . import state as lstate, step as lstep, diag as ldiag
from .state import LESForcing
from ...parallel import plane as pplane, sharding as shd

log = logging.getLogger(__name__)


class LESFleet:
    """Batched LES instances sharing one grid and physics configuration,
    on the card unless device says otherwise (``default_device``). n is
    the whole fleet's size, under a mesh too."""

    def __init__(self, grid, phys: lstep.LESPhysics, n_les: int,
                 dt_les: float, seed: int = 42, schedule: str = "auto",
                 cfl: float = 0.7, peclet: float = 0.1, dt_min: float = 0.2,
                 n_substeps: int = 0, device=None):
        self.grid = grid
        self.phys = phys
        self.n = n_les
        self.dt = float(dt_les)
        self.seed = seed
        self.n_substeps = int(n_substeps)  # >0: fixed substeps per evolve
        self.cfl, self.peclet, self.dt_min = cfl, peclet, dt_min
        self.serial = (lstep.serial_fleet_default(grid) if schedule == "auto"
                       else schedule == "serial")
        self.device = default_device(device)
        self.state = None              # fleet LESState after init_states
        self.time = 0.0        # fleet clock (s); all instances share it
        self.mesh = None       # les mesh: state holds this rank's block
        self.plane = None      # this rank's block of the planes, or None
        self.positions = list(range(n_les))   # the instances state holds

    def shard(self, mesh):
        """Hold this rank's block of the fleet from now on (the state's
        too, where there is one already): its slot's rows and its block of
        their planes. Raises ValueError where the mesh does not divide the
        plane."""
        plane = pplane.for_mesh(mesh, self.grid.ny, self.grid.nx)
        if self.state is not None:
            self.state = shd.local_rows(self.state, mesh, self.n)
            if plane is not None:
                self.state = plane.block_fields(self.state)
        self.mesh, self.plane = mesh, plane
        self.positions = (list(range(self.n)) if mesh is None
                          else mesh.positions(self.n))

    # ---- grid metadata (reference getters, spio.py:94-116) ----------------

    def get_itot(self):
        return self.grid.nx

    def get_jtot(self):
        return self.grid.ny

    def get_ktot(self):
        return self.grid.nz

    def get_dx(self):
        return self.grid.dx

    def get_dy(self):
        return self.grid.dy

    def get_xsize(self):
        return self.grid.nx * self.grid.dx

    def get_ysize(self):
        return self.grid.ny * self.grid.dy

    def get_zf(self):
        return self.grid.zf("cpu").numpy()

    def get_zh(self):
        """Half-level heights [nz]: cell tops, matching DALES's zh export."""
        return self.grid.zh("cpu").numpy()[1:]

    # ---- state management --------------------------------------------------

    def init_states(self, u, v, thl, qt, ps, start_time=0.0):
        """Initialize all instances from per-instance profiles [n, nz].

        Noise amplitudes follow set_les_state (spcpl.py:285-291). Instance
        i draws from its own CPU torch.Generator keyed by (seed, i), so an
        instance's start does not depend on the fleet's size (the JAX
        package folds i into a jax.random key; the draws differ). The
        state is built on the CPU and moved to the device once, so a seed
        gives bitwise the same start on every device. Under a mesh only
        this rank's instances are built, each drawn for its whole plane
        and cut to this rank's block: a seed gives the same start under
        any decomposition.
        """
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        u, v, thl, qt = t(u), t(v), t(thl), t(qt)
        ps = t(ps).expand(self.n)
        parts = [lstate.init_state(self.grid, u[i:i + 1], v[i:i + 1],
                                   thl[i:i + 1], qt[i:i + 1], ps[i:i + 1],
                                   generator(self.seed, i))
                 for i in self.positions]
        self.state = lstate.LESState(*[torch.cat(f, dim=0).to(self.device)
                                       for f in zip(*parts)])
        if self.plane is not None:
            self.state = self.plane.block_fields(self.state)
        self.time = float(start_time)
        self.state = self.state._replace(time=torch.full(
            (len(self.positions),), start_time, dtype=torch.float32,
            device=self.device))

    def evolve_to(self, t_end, forcing: LESForcing):
        """Advance every instance to t_end under the given fleet forcing
        (the whole fleet's rows; a rank takes its block's)."""
        span = float(t_end) - self.time
        if span <= 0:
            return
        g, p = self.grid, self.phys
        nn = self.n_substeps
        forcing = shd.local_rows(forcing, self.mesh, self.n)
        te = torch.full((len(self.positions),), float(t_end),
                        dtype=torch.float32, device=self.device)
        pl = self.plane
        if nn:
            def one(s, f):
                s = lstep.evolve(g, p, s, f, span / nn, nn, plane=pl)
                z = torch.zeros(s.u.shape[0], dtype=torch.int32,
                                device=s.u.device)
                return s, z + nn, z
        else:
            def one(s, f):
                return lstep.evolve_adaptive(
                    g, p, s, f, te[:s.u.shape[0]], dt_max=self.dt,
                    cfl=self.cfl, peclet=self.peclet, dt_min=self.dt_min,
                    plane=pl)
        self.state, n_sub, n_clamp = lstep.map_fleet(one, self.state, forcing,
                                                     self.serial)
        counts = shd.gather_rows(dict(n=n_sub, c=n_clamp), self.mesh, self.n)
        n_sub, n_clamp = counts["n"], counts["c"]
        self.last_substeps = int(n_sub[0])
        self.last_dtmin_clamped = to_numpy(n_clamp)
        if np.any(self.last_dtmin_clamped > 0):
            log.warning("CFL-required dt fell below dt_min in instance(s) %s "
                        "(%s clamped substeps): LES likely unstable",
                        list(np.where(self.last_dtmin_clamped > 0)[0]),
                        self.last_dtmin_clamped[self.last_dtmin_clamped > 0])
        self.time = float(t_end)

    def get_profiles(self):
        """Slab means: dict of [n, nz] tensors (+ scalars [n])."""
        return shd.gather_rows(ldiag.slab_profiles(self.grid, self.state,
                                                   self.plane),
                               self.mesh, self.n)

    def whole_planes(self, tree_):
        """tree_ of this rank's fields with their whole planes (gathered
        over the plane's ranks where the mesh splits it)."""
        return tree_ if self.plane is None else \
            self.plane.gather_fields(tree_)

    def get_fields(self):
        """3-D diagnostic fields [n, nz, ny, nx] for the variability
        nudge, whole planes of the whole fleet."""
        return shd.gather_rows(self.whole_planes(ldiag.fields_3d(
            self.state)), self.mesh, self.n)

    def cloud_fractions(self, gcm_Zh):
        """A_d on GCM layers for every instance; gcm_Zh [n, L+1]
        descending."""
        prof = self.get_profiles()
        Zh = torch.as_tensor(np.asarray(gcm_Zh, np.float32),
                             device=self.device)
        return ldiag.cloud_fraction_on_gcm_levels(
            self.grid, prof["cloudfrac_z"], Zh)

    def set_qt_thl(self, qt, thl):
        """Write back the whole fleet's 3-D fields (variability nudge,
        spcpl.py:732-734); a rank keeps its block's."""
        new = shd.local_rows(dict(qt=qt, thl=thl), self.mesh, self.n)
        if self.plane is not None:
            new = self.plane.block_fields(new)
        self.state = self.state._replace(**new)

    def write_restart(self):
        pass  # the driver's io.restart checkpoints the fleet state

    def cleanup_code(self):
        pass

    def stop(self):
        pass


class LESInstance:
    """Per-instance duck-typed view with the reference LES API surface."""

    support_async = False

    def __init__(self, fleet: LESFleet, index: int):
        self.fleet = fleet
        self.index = index
        self.grid_index = -1           # GCM column index, set by the driver
        self.lat = 0.0
        self.lon = 0.0
        self._prof_cache = None

    # grid
    def get_itot(self):
        return self.fleet.get_itot()

    def get_jtot(self):
        return self.fleet.get_jtot()

    def get_ktot(self):
        return self.fleet.get_ktot()

    def get_zf(self):
        return self.fleet.get_zf()

    def get_zh(self):
        return self.fleet.get_zh()

    def get_model_time(self):
        return self.fleet.time

    # state / profile getters (one instance out of the fleet)
    def _profiles(self):
        if self._prof_cache is None:
            self._prof_cache = to_numpy(self.fleet.get_profiles())
        return self._prof_cache

    def invalidate_cache(self):
        self._prof_cache = None

    def _p(self, key):
        return self._profiles()[key][self.index]

    def get_profile_U(self):
        return self._p("U")

    def get_profile_V(self):
        return self._p("V")

    def get_profile_THL(self):
        return self._p("THL")

    def get_profile_QT(self):
        return self._p("QT")

    def get_profile_QL(self):
        return self._p("QL")

    def get_profile_QL_ice(self):
        return self._p("QL_ice")

    def get_profile_QL_water(self):
        return self._p("QL_water")

    def get_profile_QR(self):
        return self._p("QR")

    def get_profile_T(self):
        return self._p("T")

    def get_presf(self):
        return self._p("presf")

    def get_rhof(self):
        return self._p("Rhof")

    def get_rhobf(self):
        return self._p("Rhobf")

    def get_surface_pressure(self):
        return float(self._p("PS"))

    def get_rain(self):
        return float(self._p("Rain"))

    def get_cloudfraction(self, gcm_Zh):
        cf = self.fleet.cloud_fractions(
            np.broadcast_to(gcm_Zh, (self.fleet.n,) + np.shape(gcm_Zh)))
        return to_numpy(cf[self.index])
