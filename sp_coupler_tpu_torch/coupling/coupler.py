"""The coupled step: GCM phase A -> LES fleet evolve -> GCM phase B.

Port of ``sp_coupler_tpu/coupling/coupler.py::CoupledStepFn``: one call
runs the GCM first half and cloud scheme, gathers and converts the SP
columns, builds the LES forcings (with the GCM's surface fluxes under
``cplsurf``), applies the variability nudge (``qt_variance``), evolves
the LES fleet (CFL/Peclet-adaptive or a fixed substep count), reduces
slab profiles, remaps the LES state back to GCM tendencies and runs the
GCM second half. The diagnostics come back packed into one flat float32
vector with the JAX package's layout (``unpack_diag`` inverts it on the
host). ``call_phased`` runs the same step as its three phases with a
device barrier after each, for the driver's per-phase timing.

With a les mesh (``parallel.mesh.LesMesh``, one torch.distributed rank a
slot) the LES state is this rank's block of the fleet. Every rank runs
the GCM and the per-column coupling math for all n columns, evolves its
own block with its own adaptive loop (the JAX package's ``shard_map``
over ``les``), and the LES side's rows (slab profiles with the cloud
fraction by level, substep and clamp counts, the nudge's diagnostics)
cross between ranks in one all_gather a step, so the tendencies, the
GCM's phase B and the packed diag are the same on every rank. Where the
mesh also splits the LES plane (x, y; ``parallel/plane.py``) a rank holds
its block of its slot's instances' planes: the ranks of a plane evolve
them together (halo exchanges, plane reductions, the gathered
projection), the slab profiles and the nudge reduce over the plane, so
every rank of a plane holds its instances' profiles, and the rows cross
over the les group (the ranks at the same block of every slot). The GCM
stays replicated on every rank (``parallel.mesh.replicate`` checks it),
or with a banded core (--gcmprocs, ``parallel/bands.py``) its spectral
state does, each rank holding its latitude band of the grid: the column
profiles then come from the bands that hold them, the same on every
rank, and a rank scatters the tendencies of its band's columns; the
cloud fraction on GCM levels still follows the gather.
"""

import time

import numpy as np
import torch

from sp_coupler_tpu_torch import generator
from . import convert, nudge
from ..models.les import step as lstep, diag as ldiag
from ..models.les.state import LESForcing
from ..parallel import plane as pplane, sharding as shd
from ..utils import tree

NUDGE_DIAG = ("qt_alpha", "qt_beta", "qt_std")


def evolve_fleet(grid, phys, state, forcing, span, serial, n_substeps=0,
                 dt_max=15.0, cfl=0.7, peclet=0.1, dt_min=0.2, plane=None):
    """Advance a fleet (under a mesh, a rank's block, on its own, or with
    the other ranks of its plane) by span seconds: n_substeps fixed
    substeps of span / n_substeps, or with n_substeps 0 CFL/Peclet-adaptive
    ones of at most dt_max. serial: each instance its own loop
    (``step.map_fleet``). plane: the state is this rank's block of the
    planes, or None. Returns (state, substeps [n] int32, dt_min-clamped
    substeps [n] int32)."""
    if n_substeps > 0:
        def one(s, f):
            s = lstep.evolve(grid, phys, s, f, span / n_substeps, n_substeps,
                             plane=plane)
            z = torch.zeros(s.u.shape[0], dtype=torch.int32,
                            device=s.u.device)
            return s, z + n_substeps, z
    else:
        def one(s, f):
            return lstep.evolve_adaptive(
                grid, phys, s, f, s.time + span, dt_max=dt_max, cfl=cfl,
                peclet=peclet, dt_min=dt_min, plane=plane)
    return lstep.map_fleet(one, state, forcing, serial)


class CoupledStepFn:
    """Coupled step for a fixed configuration on the GCM core's device;
    mesh: a mesh whose les slots divide the columns and whose x, y divide
    the LES plane (the LES state is this rank's block of the fleet and of
    its planes) or None."""

    def __init__(self, gcm_core, les_grid, les_phys, sp_cols, dt_les,
                 n_substeps, les_forcing_factor=1.0, gcm_forcing_factor=1.0,
                 conservative=False, cplsurf=False, qt_variance=False,
                 constant_T=False, mesh=None, seed=42, evolve_chunks=1,
                 serial_evolve="auto", cfl=0.7, peclet=0.1, dt_min=0.2):
        self.mesh = (mesh if mesh is not None
                     and (mesh.les > 1 or shd.spatial_axes(mesh)) else None)
        self.plane = pplane.for_mesh(self.mesh, les_grid.ny, les_grid.nx)
        self.core = gcm_core
        self.device = gcm_core.device
        self.grid = les_grid
        self.phys = les_phys
        self.cols = torch.as_tensor(np.asarray(sp_cols), dtype=torch.int64,
                                    device=self.device)
        self.n = self.cols.shape[0]
        if self.mesh is not None and self.n % self.mesh.les:
            raise ValueError("%d columns on a les mesh of %d slots (the "
                             "driver keeps such a fleet whole)"
                             % (self.n, self.mesh.les))
        self.dt_les = float(dt_les)
        self.n_substeps = int(n_substeps)
        self.cfl = float(cfl)
        self.peclet = float(peclet)
        self.dt_min = float(dt_min)
        self.ffac = les_forcing_factor
        self.gfac = gcm_forcing_factor
        self.conservative = conservative
        self.cplsurf = cplsurf
        self.qt_variance = qt_variance
        self.constant_T = constant_T
        self.seed = seed
        self.serial_evolve = serial_evolve   # "auto" | "serial" | "batched"
        # evolve_chunks > 1 runs the evolve as k evolves of dt/k between
        # pre and post (the JAX package's k device programs)
        self.evolve_chunks = max(1, int(evolve_chunks))
        self.zf = les_grid.zf(self.device)
        self.zh_full = les_grid.zh(self.device)
        self._diag_spec = None

    def __call__(self, gcm_state, les_state, prev_prof, rain_last, step_idx,
                 first=False, skip_half=False):
        """One coupled step. Returns (gcm_state, les_state, les profiles,
        rain, packed diag). skip_half: phase A and the cloud scheme were
        already run on gcm_state. step_idx seeds the nudge's draws. With
        evolve_chunks = k > 1 the evolve runs as k evolves of dt/k, their
        substep and clamp counts summed."""
        gcm_state, les_state, forcing, conv, prof, pre_diag = self._pre(
            gcm_state, les_state, prev_prof, step_idx, first, skip_half)
        k = self.evolve_chunks
        n_sub = n_clamp = 0
        for _ in range(k):
            les_state, ns, nc = self._evolve_to(les_state, forcing,
                                                self.core.cfg.dt / k)
            n_sub, n_clamp = n_sub + ns, n_clamp + nc
        return self._post(gcm_state, les_state, conv, prof, rain_last,
                          n_sub, n_clamp, pre_diag, first)

    def call_phased(self, gcm_state, les_state, prev_prof, rain_last,
                    step_idx, first=False, skip_half=False):
        """The same step as __call__, run as pre / evolve / post with a
        device barrier after each: returns (out, (t_pre, t_ev, t_post)),
        host seconds. The driver routes every timing_phases-th step here
        for the per-phase columns of timing.txt (splib.py:340-343); it
        evolves in one piece (the driver does not phase a chunked step)."""
        t0 = time.time()
        gcm_state, les_state, forcing, conv, prof, pre_diag = self._pre(
            gcm_state, les_state, prev_prof, step_idx, first, skip_half)
        self._sync()
        t_pre = time.time() - t0
        t0 = time.time()
        les_state, n_sub, n_clamp = self._evolve_to(les_state, forcing,
                                                    self.core.cfg.dt)
        self._sync()
        t_ev = time.time() - t0
        t0 = time.time()
        out = self._post(gcm_state, les_state, conv, prof, rain_last, n_sub,
                         n_clamp, pre_diag, first)
        self._sync()
        return out, (t_pre, t_ev, time.time() - t0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def nudge_noise(self, step_idx):
        """The nudge's normal draws [n, ny, nx] for step step_idx, from a
        CPU torch.Generator keyed by (seed + 1, step_idx), moved to the
        device: the same draws on every device (the JAX package folds
        step_idx into a jax.random key instead). Under a mesh every rank
        draws the whole fleet's and keeps its block's (rows and plane), so
        a rank's instances see the draws of a single process."""
        gen = generator(self.seed + 1, step_idx)
        R = self._local(torch.randn((self.n, self.grid.ny, self.grid.nx),
                                    generator=gen))
        if self.plane is not None:
            R = self.plane.block(R)
        return R.to(self.device)

    def _local(self, tree_):
        """This rank's rows of the whole fleet's tensors."""
        return shd.local_rows(tree_, self.mesh, self.n)

    def _gathered(self, tree_):
        """The whole fleet's rows of this rank's block's tensors."""
        return shd.gather_rows(tree_, self.mesh, self.n)

    # ------------------------------------------------------------------

    def _pre(self, gcm_state, les_state, prev_prof, step_idx, first,
             skip_half=False):
        """GCM first half + gather/convert/forcings (+ nudge). The
        forcing and the nudge's diagnostics come back as this rank's
        rows."""
        core = self.core
        dt = core.cfg.dt
        if not skip_half:
            gcm_state = core.phase_a(gcm_state, first)
            gcm_state = core.phase_cloud(gcm_state)

        prof = core.column_profiles(gcm_state, self.cols)
        conv = convert.convert_profiles(prof, self.zf)
        if first:
            les_prof = self._gathered(ldiag.slab_profiles(
                self.grid, les_state, self.plane))
        else:
            les_prof = {k: torch.as_tensor(v, device=self.device)
                        for k, v in prev_prof.items()}
        fdict = convert.les_forcings(
            conv, {k: les_prof[k] for k in ("U", "V", "THL", "QT", "QL",
                                            "PS")}, dt, self.ffac)
        rain = les_prof["Rain"]

        n = self.n
        if self.cplsurf:
            surf = core.surface_fields(gcm_state, self.cols)
            z0m, z0h, wthl, wqt = convert.convert_surface_fluxes(
                surf, prof["Phalf"][:, -1], prof["T"][:, -1])
        else:
            surf = None
            full = lambda v: torch.full((n,), v, dtype=torch.float32,
                                        device=self.device)
            z0m, z0h, wthl, wqt = full(0.1), full(0.02), full(0.0), full(0.0)
        forcing = self._local(LESForcing(
            f_u=fdict["f_u"], f_v=fdict["f_v"], f_thl=fdict["f_thl"],
            f_qt=fdict["f_qt"], f_ql=fdict["f_ql"], f_ps=fdict["f_ps"],
            ql_ref=conv.ql, wthl=wthl, wqt=wqt, z0m=z0m, z0h=z0h))
        pre_diag = {"gcm": prof, "forcing": fdict, "rain": rain,
                    "z0m": z0m, "z0h": z0h, "wthl": wthl, "wqt": wqt}
        if surf is not None:
            pre_diag["surf"] = surf

        if self.qt_variance:
            if first:
                # not applied on the first step; its diagnostics are zero,
                # as on the driver's generic path (fleet.time <= 0)
                z = torch.zeros_like(forcing.ql_ref)
                pre_diag.update(qt_alpha=z, qt_beta=z, qt_std=z)
            else:
                fields = ldiag.fields_3d(les_state)
                res = nudge.variability_nudge(
                    fields["QT"], fields["THL"], fields["Qsat"],
                    forcing.ql_ref, les_state.pbf, dt,
                    R=self.nudge_noise(step_idx),
                    constant_T=self.constant_T, plane=self.plane)
                les_state = les_state._replace(qt=res.qt, thl=res.thl)
                pre_diag.update(qt_alpha=res.alpha, qt_beta=res.beta,
                                qt_std=res.qt_std)
        return gcm_state, les_state, forcing, conv, prof, pre_diag

    def _evolve_to(self, les_state, forcing, dt_frac):
        """LES fleet evolve by dt_frac seconds (the hot loop). Big
        instances run serially, each with its own adaptive loop; under a
        mesh each rank evolves its block alone, with no straggler
        coupling between ranks."""
        nn = 0
        if self.n_substeps > 0:
            nn = max(1, int(round(self.n_substeps * dt_frac
                                  / self.core.cfg.dt)))
        serial = (lstep.serial_fleet_default(self.grid)
                  if self.serial_evolve == "auto"
                  else self.serial_evolve == "serial")
        return evolve_fleet(self.grid, self.phys, les_state, forcing,
                            dt_frac, serial, n_substeps=nn,
                            dt_max=self.dt_les, cfl=self.cfl,
                            peclet=self.peclet, dt_min=self.dt_min,
                            plane=self.plane)

    def _post(self, gcm_state, les_state, conv, prof, rain_last, n_sub,
              n_clamp, pre_diag, first):
        """Slab diagnostics, LES -> GCM tendencies, GCM second half.
        The LES side's rows of every rank are gathered first, in one
        all_gather under a mesh; the cloud fractions on GCM levels are
        computed from the gathered profiles, for the whole fleet at once
        as in one process (cuBLAS picks its batched product by the batch,
        so a rank's rows alone would round otherwise)."""
        core, grid = self.core, self.grid
        dt = core.cfg.dt
        rows = self._gathered(dict(
            prof=ldiag.slab_profiles(grid, les_state, self.plane),
            n_sub=n_sub,
            n_clamp=n_clamp,
            **{k: pre_diag[k] for k in NUDGE_DIAG if k in pre_diag}))
        prof_les = rows.pop("prof")
        n_sub, n_clamp = rows.pop("n_sub"), rows.pop("n_clamp")
        A_d = ldiag.cloud_fraction_on_gcm_levels(
            grid, prof_les["cloudfrac_z"], conv.Zh)
        jles = {k: prof_les[k] for k in
                ("U", "V", "THL", "QT", "QL", "QL_ice", "T", "Rhobf")}
        tend, tdiag = convert.gcm_tendencies(
            prof, conv, jles, A_d, self.zf, self.zh_full, dt,
            factor=self.gfac, conservative=self.conservative)
        gcm_state = core.with_sp_tendencies(gcm_state, self.cols, tend)
        gcm_state = core._phase_b_body(gcm_state, first)

        rain = pre_diag["rain"]
        rain_last = torch.as_tensor(rain_last, dtype=torch.float32,
                                    device=self.device)
        diag = dict(pre_diag, **rows)
        diag.update(
            conv=conv, rainrate=(rain - rain_last) / dt,
            les=prof_les, tend=tend, t_diag=tdiag["t"],
            A_d=A_d, n_substeps=n_sub, n_dtmin_clamped=n_clamp)
        return gcm_state, les_state, prof_les, rain, self._pack_diag(diag)

    def _pack_diag(self, diag):
        """Flatten the diag tree into one f32 vector; record the spec."""
        leaves, spec = tree.flatten(diag)
        self._diag_spec = (spec, [tuple(l.shape) for l in leaves],
                           [l.dtype for l in leaves])
        return torch.cat([l.to(torch.float32).reshape(-1) for l in leaves])

    def unpack_diag(self, flat):
        """Host-side inverse of _pack_diag (flat: tensor or numpy vector)."""
        if isinstance(flat, torch.Tensor):
            flat = flat.detach().cpu().numpy()
        spec, shapes, dtypes = self._diag_spec
        out, off = [], 0
        for shp, dt in zip(shapes, dtypes):
            n = int(np.prod(shp)) if shp else 1
            npdt = torch.empty((), dtype=dt).numpy().dtype
            out.append(np.asarray(flat[off:off + n]).reshape(shp)
                       .astype(npdt))
            off += n
        return tree.unflatten(spec, iter(out))
