"""Run loop: initialize / run / step / finalize (splib equivalent).

Port of ``sp_coupler_tpu/runtime/driver.py``. It orchestrates
the coupled system as the reference's splib.py does (read_config,
initialize, run, step, run_spinup, finalize — splib.py:97-432), with no
RPC: the native GCM and LES fleet step through one ``CoupledStepFn`` call
per coupled step (the fused path), and the host writes spifs.nc behind
the device. Dummy and mixed model types take the generic path, which
chains the models' duck-typed calls as the reference does.

Per coupled step (reference call stack SURVEY.md section 3.2):
  phase A + cloud scheme -> gather SP columns -> convert + forcings
  -> [variability nudge] -> LES fleet evolve -> slab profiles
  -> GCM tendencies (remap + scatter) -> phase B -> timing.txt line.

The runner takes the CUDA card unless the caller names a device
(``default_device``). Replayed models (``ncfile``: ``models/ncreplay.py``)
take the generic path; ``les_cross`` writes each instance's cross
sections (``io/crossio.py``); ``les_evolve_chunks`` > 1 splits the evolve
of a fused step. The GCM takes hybrid levels (``gcm_hybrid``) and
semi-Lagrangian advection (``gcm_advection`` "sl", or "auto" at T63 and
above).

Multi-process runs (``--mesh_les`` L and ``--lesprocs`` N or ``mesh_x``/
``mesh_y`` under torchrun or ``SPTPU_DIST_*``, ``parallel/mesh.py``): the
ranks form the mesh (les, x, y); a rank holds its les slot's instances
and, with x * y > 1, its block of their planes (``parallel/plane.py``);
every rank runs the GCM and the coupling math and calls the same
collectives in the same order. With --gcmprocs N > 1 the GCM's grid
space is split into latitude bands over every rank of the mesh
(``parallel/bands.py``; without a mesh the setting has no effect, as in
the JAX driver). Rank 0 alone writes spifs.nc, timing.txt
and the restart (the checkpoint gathers the whole fleet); the first rank
of each plane writes the cross.nc of its slot's instances, from their
gathered planes.
"""

import datetime
import logging
import os
import resource
import time

import numpy as np
import torch

from .. import default_device, generator
from ..config import SPConfig, read_config
from ..coupling import convert, nudge
from ..interop import to_numpy
from ..io import spifs
from ..models import dummy as dummy_mod
from ..models.les import (grid as lgrid, step as lstep, model as les_model,
                          diag as ldiag)
from ..models.les.state import LESForcing
from ..parallel import bands as pbands, mesh as pmesh
from ..utils import geometry

log = logging.getLogger(__name__)

QT_MODES = {"sp": lstep.QT_FORCING_GLOBAL,
            "variance": lstep.QT_FORCING_VARIANCE,
            "local": lstep.QT_FORCING_LOCAL,
            "strong": lstep.QT_FORCING_STRONG}


def create_gcm(cfg: SPConfig, device=None, mesh=None):
    """The run's GCM. --gcmprocs N > 1 with a mesh splits the native GCM's
    grid space into latitude bands over the whole mesh (JAX
    driver.py:55-62: GCM and LES phases never overlap in time); without a
    mesh it has no effect."""
    if cfg.gcm_type in ("sptpu", "oifs"):
        from ..models.gcm import model as gcm_model, spharm
        adv = cfg.gcm_advection
        if adv == "auto":
            # Eulerian leapfrog is CFL-limited to ~dx/u_max; at T63+ the
            # canonical OpenIFS step lengths need semi-Lagrangian advection
            adv = "sl" if cfg.gcm_truncation >= 63 else "eulerian"
        gcfg = gcm_model.GCMConfig(trunc=cfg.gcm_truncation,
                                   nlev=cfg.gcm_levels, dt=cfg.gcm_dt,
                                   start_date=cfg.gcm_start_date,
                                   hybrid=cfg.gcm_hybrid, advection=adv)
        bands = None
        if cfg.gcm_num_procs > 1:
            if mesh is None:
                log.info("--gcmprocs %d: no mesh, the GCM runs whole",
                         cfg.gcm_num_procs)
            else:
                bands = pbands.for_mesh(
                    mesh, spharm.GRID_FOR_TRUNC[cfg.gcm_truncation][1])
                log.info("GCM grid in latitude bands over %d ranks: rows "
                         "%d-%d here", bands.P, bands.r0, bands.r1 - 1)
        return gcm_model.GCMModel(gcfg, seed=cfg.seed, device=device,
                                  bands=bands)
    if cfg.gcm_type == "dummy":
        return dummy_mod.DummyGCM()
    if cfg.gcm_type in ("ncfile", "spifsnc_gcm"):
        from ..models import ncreplay
        return ncreplay.ReplayGCM(os.path.join(cfg.gcm_input_dir, "spifs.nc"))
    raise ValueError("unknown gcm_type " + cfg.gcm_type)


def create_fleet(cfg: SPConfig, n_les, device=None):
    if cfg.les_type in ("sptpu", "dales"):
        grid = lgrid.LESGrid(nx=cfg.les_itot, ny=cfg.les_jtot,
                             nz=cfg.les_ktot, dx=cfg.les_dx, dy=cfg.les_dy,
                             dz=cfg.les_dz)
        phys = lstep.LESPhysics(
            scheme=cfg.les_advection,
            subgrid=cfg.les_subgrid,
            qt_forcing=QT_MODES[cfg.qt_forcing],
            use_kernel=cfg.use_pallas)
        dt = cfg.les_dt if cfg.les_dt > 0 else 5.0
        return les_model.LESFleet(grid, phys, n_les, dt, seed=cfg.seed,
                                  schedule=cfg.les_schedule,
                                  cfl=cfg.les_cfl, peclet=cfg.les_peclet,
                                  dt_min=cfg.les_dt_min,
                                  n_substeps=cfg.les_nsubsteps,
                                  device=device)
    if cfg.les_type == "dummy":
        return dummy_mod.DummyLESFleet(n_les)
    if cfg.les_type in ("ncfile", "spifsnc_les"):
        from ..models import ncreplay
        return ncreplay.ReplayLESFleet(
            os.path.join(cfg.les_input_dir, "spifs.nc"), n_les)
    raise ValueError("unknown les_type " + cfg.les_type)


class _NullFile:
    """timing.txt of the ranks that do not write it."""

    def write(self, s):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class SPRunner:
    """One coupled superparameterized run: on one device, or one rank of a
    multi-process run.

    device: the torch device of the models (None: the CUDA card, and a
    RuntimeError where there is none; in a multi-process run on the card,
    the rank's own card). writer: the spifs.nc writer class, called as
    ``spifs.SpifsWriter`` is (its default); rank 0 alone uses it.
    restart_overlap (spmaster's --restart_overlap): ``run(n)`` writes the
    checkpoint after its step n - 1, before the last step, and
    ``finalize`` writes none. spmaster runs --steps + 1 steps, the last
    being the overlap step, which a run resumed from that checkpoint
    recomputes without writing it: legs of --steps L1, L2, ... join
    without a gap in Time and hold the records of one run of --steps
    L1 + L2 + ....
    """

    def __init__(self, config=None, geometries=(), output_geometries=(),
                 device=None, writer=None, restart_overlap=False):
        self.cfg = config if isinstance(config, SPConfig) else read_config(
            config)
        self.device = default_device(device)
        self.writer_cls = writer or spifs.SpifsWriter
        self.geometries = list(geometries)
        self.output_geometries = list(output_geometries)
        self.writer = None
        self.gcm = None
        self.fleet = None
        self.coupled = None
        self.instances = []
        self.sp_cols = []
        self.output_cols = []
        self.prev_profiles = None
        self.rain_last = None
        self.firststep = True
        self.step_index = 0  # coupled steps taken (write_every cadence)
        self.substeps = []   # LES substeps per instance of each record
        self.clamped = []    # dts clamped at les_dt_min, per instance
        self.overlap_substeps = []   # substeps of the unwritten overlap step
        self.step_walls = []  # host seconds of each step of run()
        self.restart_overlap = restart_overlap
        self.timing_file = None
        self._timing_header_done = False
        self._half_step_done = False
        self._pending_record = None
        self._fused_prof = None
        self.crossio = None
        self._cross_next = -float("inf")
        self.mesh = None      # les mesh of a multi-process run (or None)
        self.io_proc = True   # this process writes spifs.nc and the rest

    # ------------------------------------------------------------------ init

    def initialize(self):
        cfg = self.cfg
        self._check_settings()
        # the mesh first: it brings up the process group, and what follows
        # needs to know which rank owns the output files (reference: only
        # the master rank writes, spio.py)
        self.mesh = self._build_mesh()
        self.io_proc = pmesh.rank() == 0

        # clobber guard (splib.py:101-102); an empty directory is fine.
        # Every rank looks before any rank creates a file in it
        clobber = (not cfg.restart and os.path.isdir(cfg.output_dir)
                   and os.listdir(cfg.output_dir))
        if pmesh.world_size() > 1:
            pmesh.barrier()
        if clobber:
            raise RuntimeError("output dir %s exists" % cfg.output_dir)
        os.makedirs(cfg.output_dir, exist_ok=True)

        # the GCM's bands come from the mesh before the fleet may decline it
        # (_shard_fleet_state), as in the JAX driver: they stay
        self.gcm = create_gcm(cfg, self.device, self.mesh)
        self.gcm.initialize_code()
        self.gcm.commit_parameters()
        self.gcm.commit_grid()
        self.gcm.set_vdf_in_sp_mask(not cfg.cplsurf)

        lons = np.asarray(self.gcm.longitudes, float)
        lats = np.asarray(self.gcm.latitudes, float)
        points = list(zip(lons, lats))
        self.sp_cols = [int(i) for i in geometry.get_mask_indices(
            points, self.geometries, cfg.max_num_les)]
        out_idx = geometry.get_mask_indices(points, self.output_geometries)
        self.output_cols = sorted(set(out_idx) - set(self.sp_cols))
        log.info("SP columns: %s", self.sp_cols)

        if cfg.dryrun:
            if not self.io_proc:
                return self
            np.savetxt(os.path.join(cfg.output_dir, "gridpoints.txt"),
                       np.column_stack((lons, lats)), fmt="%10.6f")
            return self

        n = len(self.sp_cols)
        self.fleet = create_fleet(cfg, max(n, 1), self.device)
        self._shard_fleet_state()
        self.instances = []
        if isinstance(self.fleet, les_model.LESFleet):
            for k, col in enumerate(self.sp_cols):
                inst = les_model.LESInstance(self.fleet, k)
                inst.grid_index = col
                inst.lat, inst.lon = lats[col], lons[col]
                self.instances.append(inst)
        for col in self.sp_cols:
            self.gcm.set_mask(col)
        self.gcm.set_vdf_in_sp_mask(not cfg.cplsurf)
        zf = np.asarray(self.fleet.get_zf(), np.float32)
        self._les_zf = torch.as_tensor(zf, device=self.device)
        self._les_zh_full = torch.as_tensor(np.concatenate(
            [[0.0], np.asarray(self.fleet.get_zh())]).astype(np.float32),
            device=self.device)

        start = self.gcm.get_start_datetime() - datetime.timedelta(
            seconds=cfg.les_spinup)
        les_info = None
        if n > 0:
            dx, dy = self.fleet.get_dx(), self.fleet.get_dy()
            les_info = {
                "x": (np.arange(self.fleet.get_itot()) + 0.5) * dx,
                "y": (np.arange(self.fleet.get_jtot()) + 0.5) * dy,
                "zf": zf,
            }
        if self.io_proc:
            self.writer = self.writer_cls(
                cfg.output_path, self.gcm.get_ktot(), les_info, start,
                append=cfg.restart, with_surf_vars=cfg.cplsurf,
                compress=cfg.output_compress)
        else:
            self.writer = spifs.NullWriter()
        if not cfg.restart:
            for col in self.sp_cols:
                self.writer.add_les_column(col, lats[col], lons[col])
            for col in self.output_cols:
                self.writer.add_output_column(col, lats[col], lons[col])

        self.rain_last = np.zeros(max(n, 1))

        # per-instance LES cross-section output (DALES writes surf_xy/
        # cross-section netCDFs per work dir, reference README.md:108-111)
        if (cfg.les_cross and isinstance(self.fleet, les_model.LESFleet)
                and n > 0):
            # a rank writes the instances it holds (JAX driver.py:207-228),
            # and of a split plane the plane's first rank; an unsharded
            # fleet's files are rank 0's
            first = self.mesh is not None and (self.fleet.plane is None or (
                self.mesh.ix, self.mesh.iy) == (0, 0))
            positions = (self.fleet.positions
                         if first or (self.mesh is None and self.io_proc)
                         else [])
            if self.mesh is not None:
                log.info("les_cross shard-local: rank %d owns instances %s",
                         pmesh.rank(), positions)
            from ..io import crossio
            self.crossio = crossio.FleetCrossIO(
                cfg.output_dir, self.fleet.grid,
                [self.sp_cols[p] for p in positions],
                heights=tuple(h - 1 for h in cfg.les_cross_heights),
                positions=positions)
            log.info("per-instance cross-section output: les-work-*/"
                     "cross.nc every %.0f s", max(cfg.les_cross_dtav,
                                                  cfg.gcm_dt))

        # fused path: native GCM + native LES -> one CoupledStepFn call per
        # coupled step; the host only writes spifs.nc
        if (hasattr(self.gcm, "core")
                and isinstance(self.fleet, les_model.LESFleet) and n > 0):
            from ..coupling.coupler import CoupledStepFn
            dt_max = cfg.les_dt if cfg.les_dt > 0 else 15.0
            self.coupled = CoupledStepFn(
                self.gcm.core, self.fleet.grid, self.fleet.phys,
                np.asarray(self.sp_cols, np.int64), dt_les=dt_max,
                n_substeps=cfg.les_nsubsteps,
                cfl=cfg.les_cfl, peclet=cfg.les_peclet,
                dt_min=cfg.les_dt_min,
                les_forcing_factor=cfg.les_forcing_factor,
                gcm_forcing_factor=cfg.gcm_forcing_factor,
                conservative=cfg.conservative_coarsening,
                cplsurf=cfg.cplsurf,
                qt_variance=(cfg.qt_forcing == "variance"),
                constant_T=cfg.variability_nudge_constant_T,
                mesh=self.mesh,
                seed=cfg.seed,
                evolve_chunks=cfg.les_evolve_chunks,
                serial_evolve=cfg.les_schedule)

        if not cfg.restart:
            # first half step so U,V,T are initialized (splib.py:183-189)
            self.gcm.evolve_model_until_cloud_scheme()
            self.gcm.evolve_model_cloud_scheme()
            self._half_step_done = True
            spinup_dt = cfg.les_spinup / max(cfg.les_spinup_steps, 1)
            self.writer.update_time(spinup_dt if cfg.les_spinup > 0
                                    else self.gcm.get_timestep())

            if cfg.init_les_state and n > 0:
                conv = to_numpy(self._gather_convert(write=True))
                self.fleet.init_states(
                    u=conv["u"], v=conv["v"], thl=conv["thl"],
                    qt=conv["qt"], ps=conv["ps"], start_time=-cfg.les_spinup)
                if cfg.les_spinup > 0:
                    self.run_spinup(cfg.les_spinup, cfg.les_spinup_steps)
            elif n > 0 and cfg.les_input_dir:
                # DALES-style cold start from the case's prof.inp (the
                # reference LES initializes itself from its deck when the
                # coupler does not push state)
                from ..utils import decks
                prof = decks.read_dales_prof(cfg.les_input_dir,
                                             cfg.les_exp_name)
                if prof is not None:
                    cols = {k: np.interp(zf, prof["z"], prof[k])
                            for k in ("u", "v", "thl", "qt")}
                    rep = {k: np.repeat(v[None], n, 0)
                           for k, v in cols.items()}
                    self.fleet.init_states(
                        u=rep["u"], v=rep["v"], thl=rep["thl"],
                        qt=rep["qt"], ps=np.full(n, 1.0e5, np.float32),
                        start_time=-cfg.les_spinup)
                    if cfg.les_spinup > 0:
                        self._gather_convert(write=True)
                        self.run_spinup(cfg.les_spinup,
                                        cfg.les_spinup_steps)
        else:
            self._half_step_done = False
            from ..io import restart as restart_io
            restart_io.load(self)
        return self

    def _check_settings(self):
        """Log the reference's no-op knobs (--queue, --channel, work dirs,
        redirects)."""
        cfg = self.cfg
        if cfg.les_queue_threads > 0:
            log.info("--queue %d accepted (no-op: the LES fleet is one "
                     "batched device computation)", cfg.les_queue_threads)
        if cfg.channel_type != "spmd":
            log.info("--channel %s accepted (no-op: no RPC in one "
                     "process)", cfg.channel_type)
        for knob, default in (("gcm_run_dir", "gcm-work"),
                              ("les_run_dir", "les-work"),
                              ("gcm_redirect", "file"),
                              ("les_redirect", "file"),
                              ("gcm_exp_name", "TEST")):
            val = getattr(cfg, knob)
            if val != default:
                log.info("--%s %s accepted (no-op: no external model "
                         "processes)", knob, val)

    def _build_mesh(self):
        """The mesh (les, x, y) of --mesh_les and --lesprocs (or mesh_x,
        mesh_y) over the torch.distributed ranks, or None (JAX
        driver.py:304-349): --lesprocs N splits each plane into n_x * n_y
        = N blocks, n_x the largest divisor of N up to sqrt(N). A mesh of
        another size than the world runs unsharded, with the JAX driver's
        warning."""
        cfg = self.cfg
        if pmesh.init_distributed(self.device):
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            log.info("multi-process run: rank %d of %d on %s",
                     pmesh.rank(), pmesh.world_size(), self.device)
        n_x, n_y = cfg.mesh_x, cfg.mesh_y
        if cfg.les_num_procs > 1 and n_x * n_y == 1:
            n_x = int(np.sqrt(cfg.les_num_procs))
            while cfg.les_num_procs % n_x:
                n_x -= 1
            n_y = cfg.les_num_procs // n_x
        total = cfg.mesh_les * n_x * n_y
        if total <= 1:
            return None
        world = pmesh.world_size()
        if total != world:
            log.warning("mesh (les=%d, x=%d, y=%d) does not fit %d devices; "
                        "running unsharded", cfg.mesh_les, n_x, n_y, world)
            return None
        log.info("device mesh: les=%d, x=%d, y=%d", cfg.mesh_les, n_x, n_y)
        return pmesh.make_mesh(cfg.mesh_les, n_x, n_y)

    def _shard_fleet_state(self):
        """Lay the LES fleet out over the mesh: this rank holds its block
        of the fleet and of its planes (JAX driver.py:351-375). A fleet
        whose size the les axis does not divide stays whole on every
        rank, with the JAX driver's warning, and the run goes on without a
        mesh; a plane the x, y axes do not divide raises ValueError."""
        if self.mesh is None:
            return
        if not isinstance(self.fleet, les_model.LESFleet):
            self.mesh = None
            return
        n = self.fleet.n
        if n % self.mesh.les:
            log.warning("%d LES instances not divisible by mesh les=%d; "
                        "fleet stays unsharded", n, self.mesh.les)
            self.mesh = None
            return
        self.fleet.shard(self.mesh)

    # ------------------------------------------------------- coupling pieces

    def _t(self, d):
        """dict of arrays -> dict of float32 tensors on the run's device."""
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device) for k, v in d.items()}

    def _sync(self):
        """Wait for the device (the per-step barrier of an honest step
        wall clock)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gcm_profiles(self, cols):
        """dict of [n, L] numpy arrays for the given columns."""
        return {var: np.asarray(self.gcm.get_profile_fields(var, cols))
                for var in ("U", "V", "T", "SH", "QL", "QI", "Pfull",
                            "Phalf", "A", "Zgfull", "Zghalf")}

    def _convert(self, prof, cols):
        """convert_profiles of prof, the heights a replayed GCM recorded
        (``ReplayGCM.get_heights``) taken as they are."""
        get = getattr(self.gcm, "get_heights", None)
        heights = None if get is None else tuple(
            torch.as_tensor(np.asarray(h, np.float32), device=self.device)
            for h in get(cols))
        return convert.convert_profiles(self._t(prof), self._les_zf, heights)

    def _column_record(self, prof, conv, i):
        """spifs.nc GCM variables of column i of prof (numpy) and conv
        (numpy dict of ConvertedProfiles)."""
        return dict(
            U=prof["U"][i], V=prof["V"][i], T=prof["T"][i],
            SH=prof["SH"][i], QL=prof["QL"][i], QI=prof["QI"][i],
            Pf=prof["Pfull"][i], Ph=prof["Phalf"][i][1:],
            Zf=conv["Zf"][i], Zh=conv["Zh"][i][1:],
            Psurf=prof["Phalf"][i][-1], Tv=conv["Tv"][i],
            THL=conv["THL"][i], QT=conv["QT"][i])

    def _gather_convert(self, write):
        """gather_gcm_data + convert_profiles for all SP columns."""
        prof = self._gcm_profiles(self.sp_cols)
        self._last_gcm_prof = prof
        conv = self._convert(prof, self.sp_cols)
        self._last_conv = conv
        if write and self.writer is not None:
            cv = to_numpy(conv)
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(col,
                                         **self._column_record(prof, cv, i))
            self._write_output_columns()
        if self.cfg.cplsurf:
            self._last_surf = {v: np.asarray(self.gcm.get_surface_field(
                v, self.sp_cols)) for v in ("Z0M", "Z0H", "QLflux", "QIflux",
                                            "SHflux", "TLflux", "TSflux")}
        return conv

    def _output_columns_data(self):
        """The non-SP monitoring columns' record (host numpy)."""
        if not self.output_cols:
            return None
        prof = self._gcm_profiles(self.output_cols)
        cv = to_numpy(self._convert(prof, self.output_cols))
        return [(col, dict(self._column_record(prof, cv, i), A=prof["A"][i]))
                for i, col in enumerate(self.output_cols)]

    def _write_output_columns(self):
        for col, kwargs in self._output_columns_data() or ():
            self.writer.write_column(col, **kwargs)

    def _les_profiles(self):
        return to_numpy(self.fleet.get_profiles())

    def _build_forcings(self, conv, les_prof, dt, factor, write):
        """Fleet LESForcing + rain bookkeeping + spifs writes."""
        n = len(self.sp_cols)
        f = convert.les_forcings(conv, self._t(
            {k: les_prof[k] for k in ("U", "V", "THL", "QT", "QL", "PS")}),
            dt, factor)
        rain = np.asarray(les_prof["Rain"])
        rainrate = (rain - self.rain_last) / dt
        self.rain_last = rain.copy()

        if self.cfg.cplsurf:
            surf = self._last_surf
            gp = self._t({"ps": self._last_gcm_prof["Phalf"][:, -1],
                          "T": self._last_gcm_prof["T"][:, -1]})
            z0m, z0h, wthl, wqt = convert.convert_surface_fluxes(
                self._t(surf), gp["ps"], gp["T"])
        else:
            full = lambda v: torch.full((n,), v, dtype=torch.float32,
                                        device=self.device)
            z0m, z0h, wthl, wqt = full(0.1), full(0.02), full(0.0), full(0.0)

        forcing = LESForcing(
            f_u=f["f_u"], f_v=f["f_v"], f_thl=f["f_thl"], f_qt=f["f_qt"],
            f_ql=f["f_ql"], f_ps=f["f_ps"], ql_ref=conv.ql,
            wthl=wthl, wqt=wqt, z0m=z0m, z0h=z0h)

        if write:
            fn = to_numpy(f)
            sfc = to_numpy(dict(z0m=z0m, z0h=z0h, wthl=wthl, wqt=wqt))
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, f_u=fn["f_u"][i], f_v=fn["f_v"][i],
                    f_thl=fn["f_thl"][i], f_qt=fn["f_qt"][i],
                    rain=rain[i], rainrate=rainrate[i] * 3600.0)
                if self.cfg.cplsurf:
                    self.writer.write_column(
                        col, **{k: float(v[i]) for k, v in sfc.items()},
                        **{k: surf[k][i] for k in ("TLflux", "TSflux",
                                                   "SHflux", "QLflux",
                                                   "QIflux")})
        return forcing

    def _variability_nudge(self, conv, dt, write):
        """Coupler-side qt variance nudge (qt_forcing=variance); its draws
        come from a CPU torch.Generator keyed by (seed + 1, fleet time),
        so they are the same on every device."""
        if self.fleet.time <= 0:
            return
        fields = self.fleet.get_fields()
        prof = self.fleet.get_profiles()
        res = nudge.variability_nudge(
            fields["QT"], fields["THL"], fields["Qsat"], conv.ql,
            prof["presf"], dt,
            generator=generator(self.cfg.seed + 1, int(self.fleet.time)),
            constant_T=self.cfg.variability_nudge_constant_T)
        self.fleet.set_qt_thl(res.qt, res.thl)
        if write:
            rn = to_numpy(res)
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, qt_alpha=rn["alpha"][i], qt_beta=rn["beta"][i],
                    qt_std=rn["qt_std"][i])

    def _set_gcm_tendencies(self, conv, les_prof, dt, write):
        prof = self._last_gcm_prof
        A_d = np.asarray(to_numpy(self.fleet.cloud_fractions(
            to_numpy(conv.Zh))), np.float32)
        tend, diag = convert.gcm_tendencies(
            self._t(prof), conv,
            self._t({k: les_prof[k] for k in ("U", "V", "THL", "QT", "QL",
                                              "QL_ice", "T", "Rhobf")}),
            torch.as_tensor(A_d, device=self.device), self._les_zf,
            self._les_zh_full, dt, factor=self.cfg.gcm_forcing_factor,
            conservative=self.cfg.conservative_coarsening)
        tn = to_numpy(tend)
        if hasattr(self.gcm, "core"):  # native GCM: one scatter
            cols = torch.as_tensor(np.asarray(self.sp_cols, np.int64),
                                   device=self.device)
            self.gcm.state = self.gcm.core.with_sp_tendencies(
                self.gcm.state, cols, tend)
        else:
            for i, col in enumerate(self.sp_cols):
                for var in ("U", "V", "T", "SH", "QL", "QI", "A"):
                    self.gcm.set_profile_tendency(var, col, tn[var][i])

        if write:
            t_diag = to_numpy(diag["t"])
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col,
                    u=les_prof["U"][i], v=les_prof["V"][i],
                    presf=les_prof["presf"][i], rhof=les_prof["Rhof"][i],
                    rhobf=les_prof["Rhobf"][i], qt=les_prof["QT"][i],
                    ql=les_prof["QL"][i], ql_ice=les_prof["QL_ice"][i],
                    ql_water=les_prof["QL_water"][i],
                    thl=les_prof["THL"][i], qr=les_prof["QR"][i],
                    t=t_diag[i], t_=les_prof["T"][i],
                    **{"f_" + k: tn[k][i] for k in ("U", "V", "T", "SH",
                                                    "QL", "QI", "A")},
                    A=prof["A"][i], A_d=A_d[i],
                    Psurf=prof["Phalf"][i][-1])

    # -------------------------------------------------------------- stepping

    def _open_timing(self):
        if self.timing_file is None:
            if not self.io_proc:
                self.timing_file = _NullFile()
                return
            self.timing_file = open(
                os.path.join(self.cfg.output_dir, "timing.txt"), "a")
            if not self.cfg.restart and not self._timing_header_done:
                self.timing_file.write(
                    "# LES grid points\n"
                    + " ".join(str(cix) for cix in self.sp_cols)
                    + "\n# timing data"
                    + " (fused path: phase cols zero except every"
                    " timing_phases-th step, where gcm_half1 col ="
                    " pre phase, gcm_half2 col = post phase, per-LES"
                    " cols = evolve; extra trailing col = host IO)\n")
                self._timing_header_done = True

    def _check_finite_profiles(self, profiles):
        """Failure detection on the generic path: the fused path's abort
        semantics (reference: GCM step exception -> log + finalize + exit,
        splib.py:300-304)."""
        if not self.cfg.check_finite:
            return
        thl = np.asarray(profiles["THL"])
        if not np.all(np.isfinite(thl)):
            bad = [self.sp_cols[i] if i < len(self.sp_cols) else i
                   for i in np.where(~np.isfinite(thl).all(axis=-1))[0]]
            raise FloatingPointError(
                "non-finite LES state in column(s) %s" % bad)

    def _write_fused_diag(self, diag):
        """Write one fused-step diagnostics bundle (the packed flat vector
        of the coupled step, one device-to-host copy) to spifs.nc."""
        d = self.coupled.unpack_diag(diag)
        if self.cfg.check_finite and not np.all(
                np.isfinite(d["les"]["THL"])):
            bad = [self.sp_cols[i] for i in np.where(
                ~np.isfinite(d["les"]["THL"]).all(axis=-1))[0]]
            raise FloatingPointError(
                "non-finite LES state in column(s) %s" % bad)
        ncl = np.asarray(d.get("n_dtmin_clamped", 0))
        self.clamped.append([int(x) for x in np.broadcast_to(
            ncl, (len(self.sp_cols),))])
        if np.any(ncl > 0):
            bad = [self.sp_cols[i] for i in np.where(ncl > 0)[0]]
            log.warning("stability-required dt clamped at dt_min in "
                        "column(s) %s (%s substeps): LES near instability",
                        bad, ncl[ncl > 0])
        self.substeps.append([int(x) for x in d["n_substeps"]])
        log.info("LES substeps per column: %s", self.substeps[-1])
        gcm, les, tend, f = d["gcm"], d["les"], d["tend"], d["forcing"]
        conv = d["conv"]._asdict()
        for i, col in enumerate(self.sp_cols):
            out = dict(
                self._column_record(gcm, conv, i),
                f_u=f["f_u"][i], f_v=f["f_v"][i], f_thl=f["f_thl"][i],
                f_qt=f["f_qt"][i],
                rain=d["rain"][i], rainrate=d["rainrate"][i] * 3600.0,
                u=les["U"][i], v=les["V"][i], presf=les["presf"][i],
                rhof=les["Rhof"][i], rhobf=les["Rhobf"][i],
                qt=les["QT"][i], ql=les["QL"][i], ql_ice=les["QL_ice"][i],
                ql_water=les["QL_water"][i], thl=les["THL"][i],
                qr=les["QR"][i], t=d["t_diag"][i], t_=les["T"][i],
                A=gcm["A"][i], A_d=d["A_d"][i],
                **{"f_" + k: tend[k][i] for k in ("U", "V", "T", "SH",
                                                  "QL", "QI", "A")})
            if "qt_alpha" in d:
                out.update(qt_alpha=d["qt_alpha"][i],
                           qt_beta=d["qt_beta"][i], qt_std=d["qt_std"][i])
            if self.cfg.cplsurf and "surf" in d:
                out.update({k: d[k][i] for k in ("z0m", "z0h", "wthl",
                                                 "wqt")})
                out.update({k: d["surf"][k][i] for k in (
                    "TLflux", "TSflux", "SHflux", "QLflux", "QIflux")})
            self.writer.write_column(col, **out)
        self.rain_last = np.asarray(d["rain"])

    def _write_cross(self, t):
        """Per-instance cross-section record at the dtav cadence, from the
        instances this process holds (no collective; of a split plane, the
        whole planes gathered over the plane's ranks, a collective of
        theirs); the serialization runs on the native writer's worker
        thread, off the step loop."""
        if self.crossio is None or t + 1e-6 < self._cross_next:
            return
        if self.crossio.writers or self.fleet.plane is not None:
            state = self.fleet.state
            ql = ldiag.fields_3d(state)["QL"]
            if self.fleet.plane is not None:
                from types import SimpleNamespace
                whole = self.fleet.whole_planes(dict(
                    thl=state.thl, qt=state.qt, w=state.w, qr=state.qr,
                    ql=ql))
                ql = whole.pop("ql")
                state = SimpleNamespace(rhobf=state.rhobf, **whole)
            self.crossio.write(state, ql, t, held=self.fleet.positions)
        self._cross_next = t + max(self.cfg.les_cross_dtav, 1.0)

    def _flush_pending(self):
        """Drain the previous step's spifs record (write-behind): called
        right after the next step is run, as the reference syncs its
        output while the LES fleet evolves (splib.py:573-574). A record
        that is not written (``write`` False: the overlap step of a
        resumed run, or the pending rain a checkpoint kept) only hands
        on its rain, as a written one does through rain_last, under
        restart_overlap alone: a plain resume keeps the checkpoint's
        rain_last through the overlap step, as the JAX package's does."""
        p = self._pending_record
        if p is None:
            return
        self._pending_record = None
        if not p.get("write", True):
            if "diag" in p:
                d = self.coupled.unpack_diag(p["diag"])
                self.overlap_substeps.append(
                    [int(x) for x in d["n_substeps"]])
                p = dict(rain=d["rain"])
            if self.restart_overlap:
                self.rain_last = np.asarray(p["rain"])
            return
        if p["time"] is not None:
            self.writer.update_time(p["time"])
        self._write_fused_diag(p["diag"])
        for col, kwargs in p["outdata"] or ():
            self.writer.write_column(col, **kwargs)
        self.writer.sync()

    def _step_fused(self):
        """One coupled step through the CoupledStepFn."""
        cfg = self.cfg
        writecdf = (not (cfg.restart and self.firststep)
                    and self.step_index % max(cfg.write_every, 1) == 0)
        t = self.gcm.get_model_time()
        dt = self.gcm.get_timestep()
        start = time.time()
        skip = self._half_step_done
        self._half_step_done = False
        prev_prof = self._fused_prof
        if prev_prof is None:
            prev_prof = self.fleet.get_profiles()
        # `first` follows the GCM's Euler-start bookkeeping (not the
        # coupling firststep flag: after a spinup the GCM is still on its
        # first leapfrog step while profiles already exist).
        # Every cfg.timing_phases-th step runs as pre / evolve / post with
        # a device barrier after each (call_phased, the same math), which
        # gives timing.txt real per-phase columns at that cadence
        # (splib.py:340-343); a chunked evolve is never phased
        n_ph = int(cfg.timing_phases or 0)
        phase_t = None
        args = (self.gcm.state, self.fleet.state, prev_prof,
                np.asarray(self.rain_last, np.float32), self.gcm.step_count)
        if (n_ph > 0 and self.step_index > 0 and self.step_index % n_ph == 0
                and self.coupled.evolve_chunks == 1):
            out, phase_t = self.coupled.call_phased(
                *args, first=self.gcm._first, skip_half=skip)
        else:
            out = self.coupled(*args, first=self.gcm._first, skip_half=skip)
        gcm_state, les_state, prof, rain, diag = out
        self.gcm.state = gcm_state
        self.gcm.step_count += 1
        self.gcm._first = False
        self.fleet.state = les_state
        self.fleet.time = float(t + dt)
        self._fused_prof = prof
        self.prev_profiles = None  # host copies are stale; refetch if needed
        for inst in self.instances:
            inst.invalidate_cache()
        # write-behind: drain the previous record, then stash this one
        # (flushed on the next step or at finalize); output-column
        # profiles read this step's post-step GCM state now
        io_wall = -time.time()
        self._flush_pending()
        io_wall += time.time()
        if writecdf:
            self._pending_record = dict(
                time=(None if self.firststep
                      else t + cfg.les_spinup + dt),
                diag=diag,
                outdata=self._output_columns_data())
            if not cfg.async_io:
                io_wall -= time.time()
                self._flush_pending()
                io_wall += time.time()
        elif cfg.restart and self.firststep:
            # the overlap step: its record is not written (its substeps
            # are counted at the next step's flush)
            self._pending_record = dict(write=False, diag=diag)
        self._sync()
        self._write_cross(t + dt)
        step_wall = time.time() - start - max(io_wall, 0.0)
        n = max(len(self.sp_cols), 1)
        # phase columns (gcm1/gather/forcings/tendencies/gcm2) are zero on
        # unsampled steps and per-LES columns carry the step wall split
        # evenly; a phased step puts pre in the gcm_half1 column, post in
        # gcm_half2 and evolve split evenly in the per-LES columns. Host
        # IO is the trailing column
        if phase_t is not None:
            t_pre, t_ev, t_post = phase_t
            line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
                start, t_pre, 0.0, 0.0, 0.0, t_post)
                + " ".join("%6.2f" % (t_ev / n) for _ in self.sp_cols)
                + " %6.2f\n" % io_wall)
        else:
            line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
                start, 0.0, 0.0, 0.0, 0.0, 0.0)
                + " ".join("%6.2f" % (step_wall / n) for _ in self.sp_cols)
                + " %6.2f\n" % io_wall)
        self.timing_file.write(line)
        self.timing_file.flush()
        self.firststep = False
        self.step_index += 1

    def step(self):
        cfg = self.cfg
        self._open_timing()
        if self.coupled is not None:
            return self._step_fused()
        writecdf = (not (cfg.restart and self.firststep)
                    and self.step_index % max(cfg.write_every, 1) == 0)
        t = self.gcm.get_model_time()
        dt = self.gcm.get_timestep()

        start = time.time()
        tw1 = -time.time()
        if writecdf and not self.firststep:
            self.writer.update_time(t + cfg.les_spinup + dt)
        if self._half_step_done:
            self._half_step_done = False
        else:
            self.gcm.evolve_model_until_cloud_scheme()
            self.gcm.evolve_model_cloud_scheme()
        tw1 += time.time()

        if not self.sp_cols:
            # no superparameterized columns: GCM-only step + output columns
            if writecdf:
                self._write_output_columns()
            self.gcm.evolve_model_from_cloud_scheme()
            self.timing_file.write("%10.2f %6.2f\n" % (start,
                                                       time.time() - start))
            self.timing_file.flush()
            self.writer.sync()
            self.firststep = False
            return

        tw_gather = -time.time()
        conv = self._gather_convert(write=writecdf)
        tw_gather += time.time()

        tw_forc = -time.time()
        if self.firststep or self.prev_profiles is None:
            les_prof = self._les_profiles()
        else:
            les_prof = self.prev_profiles
        forcing = self._build_forcings(conv, les_prof, dt,
                                       cfg.les_forcing_factor, writecdf)
        if cfg.qt_forcing == "variance" and isinstance(
                self.fleet, les_model.LESFleet):
            self._variability_nudge(conv, dt, writecdf)
        tw_forc += time.time()

        tw_les = -time.time()
        self.fleet.evolve_to(t + dt, forcing)
        for inst in self.instances:
            inst.invalidate_cache()
        profiles = self._les_profiles()
        self.prev_profiles = profiles
        self._check_finite_profiles(profiles)
        if isinstance(self.fleet, les_model.LESFleet):
            self._write_cross(t + dt)
        tw_les += time.time()

        tw_tend = -time.time()
        self._set_gcm_tendencies(conv, profiles, dt, writecdf)
        tw_tend += time.time()

        tw2 = -time.time()
        self.gcm.evolve_model_from_cloud_scheme()
        self._sync()
        tw2 += time.time()

        n = max(len(self.sp_cols), 1)
        line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
            start, tw1, tw_gather, tw_forc, tw_tend, tw2)
            + " ".join("%6.2f" % (tw_les / n) for _ in self.sp_cols) + "\n")
        self.timing_file.write(line)
        self.timing_file.flush()
        self.writer.sync()
        self.firststep = False
        self.step_index += 1

    def run(self, nsteps):
        for s in range(nsteps):
            t0 = time.time()
            # trace the second step, past the Euler start (a device trace
            # on request beside the per-step timing.txt)
            if self.cfg.jax_profile and s == 1:
                self._profiled_step()
            else:
                self.step()
            self.step_walls.append(time.time() - t0)
            log.info("---- time step %d done ----", s)
            self._log_memory()
            if ((self.cfg.restart_steps > 0
                 and (s + 1) % self.cfg.restart_steps == 0)
                    or (self.restart_overlap and s + 2 == nsteps)):
                from ..io import restart as restart_io
                restart_io.save(self)

    def pending_rain(self):
        """The rain of the record still pending (write-behind), which the
        next step's flush makes rain_last; None without one."""
        p = self._pending_record
        if p is None:
            return None
        if "rain" in p:
            return np.asarray(p["rain"])
        return np.asarray(self.coupled.unpack_diag(p["diag"])["rain"])

    def summary(self):
        """What this process ran, for a harness to read from the log: the
        substeps and clamped dts of each written record, the overlap
        step's substeps, the step walls, the kernels' launches, the host's
        peak RSS and the card's peak of allocated memory."""
        from ..ops import lesstage, lesflat, lesmom, advect
        out = dict(serial=bool(getattr(self.fleet, "serial", True)),
                   substeps=self.substeps, clamped=self.clamped,
                   overlap_substeps=self.overlap_substeps,
                   step_walls=self.step_walls,
                   launches={m.__name__.rsplit(".", 1)[1]: m.launches
                             for m in (lesstage, lesflat, lesmom, advect)},
                   peak_rss_mb=resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss / 1e3,
                   card_peak_gib=None)
        if self.device.type == "cuda":
            out["card_peak_gib"] = (torch.cuda.max_memory_allocated(
                self.device) / 2 ** 30)
        return out

    def _profiled_step(self):
        """One step under torch.profiler; the chrome trace goes to
        ODIR/torch_trace.json."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.step()
        name = ("torch_trace.json" if self.io_proc
                else "torch_trace.rank%d.json" % pmesh.rank())
        path = os.path.join(self.cfg.output_dir, name)
        prof.export_chrome_trace(path)
        log.info("torch profiler trace written to %s", path)

    def _log_memory(self):
        """Per-step host memory log (the reference logs psutil full-info
        after every step, splib.py:216, 225-226), with the card's peak of
        allocated memory on the card."""
        try:
            import psutil
            rss = psutil.Process().memory_info().rss
        except ImportError:
            try:
                with open("/proc/self/status") as f:
                    line = next(l for l in f if l.startswith("VmRSS"))
                rss = int(line.split()[1]) * 1024
            except (OSError, StopIteration):
                return
        if self.device.type == "cuda":
            log.info("memory usage: %.1f MB rss, card peak %.3f GiB",
                     rss / 1e6,
                     torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
        else:
            log.info("memory usage: %.1f MB rss", rss / 1e6)

    # ---------------------------------------------------------------- spinup

    def run_spinup(self, spinup_length, spinup_steps=1):
        """Nudge the LES fleet toward the (frozen) GCM state before t=0
        (splib.py:233-249, 355-401)."""
        self._open_timing()
        iter_len = spinup_length / spinup_steps
        for s in range(spinup_steps):
            if s == spinup_steps - 1:
                iter_len = spinup_length - (spinup_steps - 1) * iter_len
            if not self.firststep:
                self.writer.update_time(self.fleet.time + iter_len
                                        + self.cfg.les_spinup)
            conv = self._last_conv
            les_prof = (self._les_profiles() if self.firststep
                        else self.prev_profiles)
            forcing = self._build_forcings(
                conv, les_prof, iter_len,
                self.cfg.les_spinup_forcing_factor, True)
            self.fleet.evolve_to(self.fleet.time + iter_len, forcing)
            profiles = self._les_profiles()
            self.prev_profiles = profiles
            self._check_finite_profiles(profiles)
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, u=profiles["U"][i], v=profiles["V"][i],
                    presf=profiles["presf"][i], qt=profiles["QT"][i],
                    ql=profiles["QL"][i], ql_ice=profiles["QL_ice"][i],
                    ql_water=profiles["QL_water"][i],
                    thl=profiles["THL"][i], t_=profiles["T"][i],
                    qr=profiles["QR"][i])
            self.firststep = False
        log.info("---- spinup done ----")

    # -------------------------------------------------------------- shutdown

    def finalize(self, save_restart=True):
        try:
            self._flush_pending()   # drain the write-behind record
        except Exception as e:
            log.error("pending spifs record flush failed: %s", e)
        if self.crossio is not None:
            try:
                self.crossio.close()
            except Exception as e:
                log.error("cross-section writer close failed: %s", e)
        if save_restart and self.fleet is not None \
                and not self.restart_overlap:
            from ..io import restart as restart_io
            try:
                restart_io.save(self)
            except Exception as e:  # never lose the nc file over a restart
                log.error("restart save failed: %s", e)
        for m in [self.gcm, self.fleet]:
            if m is None:
                continue
            try:
                m.cleanup_code()
                m.stop()
            except Exception as e:
                log.error("exception while stopping model: %s", e)
        if self.writer is not None:
            self.writer.close()
        if self.timing_file is not None:
            self.timing_file.close()
            self.timing_file = None
        log.info("sp_coupler_tpu_torch cleanup done")
