"""The coupled step: GCM phase A -> LES fleet evolve -> GCM phase B.

Port of ``sp_coupler_tpu/coupling/coupler.py::CoupledStepFn`` without a
mesh: one call runs the GCM first half and cloud scheme, gathers and
converts the SP columns, builds the LES forcings, evolves the LES fleet
(CFL/Peclet-adaptive or a fixed substep count), reduces slab profiles,
remaps the LES state back to GCM tendencies and runs the GCM second
half. The diagnostics come back packed into one flat float32 vector with
the JAX package's layout (``unpack_diag`` inverts it on the host).
"""

import numpy as np
import torch

from . import convert
from ..models.les import step as lstep, diag as ldiag
from ..models.les.state import LESForcing

_PORTED = "ROADMAP.md, open items"


def _flatten(tree):
    """Leaves and structure of a diag tree in jax.tree.flatten order:
    dict keys sorted, NamedTuple fields in order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for p in parts for l in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [_flatten(x) for x in tree]
        return ([l for p in parts for l in p[0]],
                ("namedtuple", type(tree), [p[1] for p in parts]))
    return [tree], None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, meta, children = spec
    vals = [_unflatten(ch, leaves) for ch in children]
    if kind == "dict":
        return dict(zip(meta, vals))
    return meta(*vals)


class CoupledStepFn:
    """Coupled step for a fixed configuration on the GCM core's device."""

    def __init__(self, gcm_core, les_grid, les_phys, sp_cols, dt_les,
                 n_substeps, les_forcing_factor=1.0, gcm_forcing_factor=1.0,
                 conservative=False, cplsurf=False, qt_variance=False,
                 constant_T=False, mesh=None, seed=42, evolve_chunks=1,
                 serial_evolve="auto", cfl=0.7, peclet=0.1, dt_min=0.2):
        # constant_T and seed configure only the variability nudge
        del constant_T, seed
        if cplsurf:
            raise NotImplementedError(
                "cplsurf (coupled surface fluxes) is not ported yet (%s: "
                "convert_surface_fluxes / cplsurf)" % _PORTED)
        if qt_variance:
            raise NotImplementedError(
                "qt_variance (variability nudge) is not ported yet (%s: "
                "fields_3d / nudge)" % _PORTED)
        if mesh is not None or int(evolve_chunks) != 1:
            raise NotImplementedError(
                "meshes and evolve_chunks > 1 are not ported yet (%s: "
                "multi-device and multi-process)" % _PORTED)
        self.core = gcm_core
        self.device = gcm_core.device
        self.grid = les_grid
        self.phys = les_phys
        self.cols = torch.as_tensor(np.asarray(sp_cols), dtype=torch.int64,
                                    device=self.device)
        self.dt_les = float(dt_les)
        self.n_substeps = int(n_substeps)
        self.cfl = float(cfl)
        self.peclet = float(peclet)
        self.dt_min = float(dt_min)
        self.ffac = les_forcing_factor
        self.gfac = gcm_forcing_factor
        self.conservative = conservative
        self.serial_evolve = serial_evolve   # "auto" | "serial" | "batched"
        self.zf = les_grid.zf(self.device)
        self.zh_full = les_grid.zh(self.device)
        self._diag_spec = None

    def __call__(self, gcm_state, les_state, prev_prof, rain_last, step_idx,
                 first=False, skip_half=False):
        """One coupled step. Returns (gcm_state, les_state, les profiles,
        rain, packed diag). skip_half: phase A and the cloud scheme were
        already run on gcm_state."""
        del step_idx  # only the (unported) variability nudge reads it
        gcm_state, les_state, forcing, conv, prof, pre_diag = self._pre(
            gcm_state, les_state, prev_prof, first, skip_half)
        les_state, n_sub, n_clamp = self._evolve_to(les_state, forcing,
                                                    self.core.cfg.dt)
        return self._post(gcm_state, les_state, conv, prof, rain_last,
                          n_sub, n_clamp, pre_diag, first)

    def call_phased(self, *args, **kwargs):
        raise NotImplementedError(
            "call_phased is not ported yet (%s: call_phased)" % _PORTED)

    # ------------------------------------------------------------------

    def _pre(self, gcm_state, les_state, prev_prof, first, skip_half=False):
        """GCM first half + gather/convert/forcings."""
        core = self.core
        dt = core.cfg.dt
        if not skip_half:
            gcm_state = core._phase_a_body(gcm_state, first)
            gcm_state = core.phase_cloud(gcm_state)

        prof = core.column_profiles(gcm_state, self.cols)
        conv = convert.convert_profiles(prof, self.zf)
        if first:
            les_prof = ldiag.slab_profiles(self.grid, les_state)
        else:
            les_prof = {k: torch.as_tensor(v, device=self.device)
                        for k, v in prev_prof.items()}
        fdict = convert.les_forcings(
            conv, {k: les_prof[k] for k in ("U", "V", "THL", "QT", "QL",
                                            "PS")}, dt, self.ffac)
        rain = les_prof["Rain"]

        n = self.cols.shape[0]
        full = lambda v: torch.full((n,), v, dtype=torch.float32,
                                    device=self.device)
        z0m, z0h, wthl, wqt = full(0.1), full(0.02), full(0.0), full(0.0)
        forcing = LESForcing(
            f_u=fdict["f_u"], f_v=fdict["f_v"], f_thl=fdict["f_thl"],
            f_qt=fdict["f_qt"], f_ql=fdict["f_ql"], f_ps=fdict["f_ps"],
            ql_ref=conv.ql, wthl=wthl, wqt=wqt, z0m=z0m, z0h=z0h)
        pre_diag = {"gcm": prof, "forcing": fdict, "rain": rain,
                    "z0m": z0m, "z0h": z0h, "wthl": wthl, "wqt": wqt}
        return gcm_state, les_state, forcing, conv, prof, pre_diag

    def _evolve_to(self, les_state, forcing, dt_frac):
        """LES fleet evolve by dt_frac seconds (the hot loop). Big
        instances run serially, each with its own adaptive loop."""
        if self.n_substeps > 0:
            nn = max(1, int(round(self.n_substeps * dt_frac
                                  / self.core.cfg.dt)))

            def one(s, f):
                s = lstep.evolve(self.grid, self.phys, s, f, dt_frac / nn, nn)
                z = torch.zeros(s.u.shape[0], dtype=torch.int32,
                                device=s.u.device)
                return s, z + nn, z
        else:
            def one(s, f):
                return lstep.evolve_adaptive(
                    self.grid, self.phys, s, f, s.time + dt_frac,
                    dt_max=self.dt_les, cfl=self.cfl, peclet=self.peclet,
                    dt_min=self.dt_min)
        serial = (lstep.serial_fleet_default(self.grid)
                  if self.serial_evolve == "auto"
                  else self.serial_evolve == "serial")
        return lstep.map_fleet(one, les_state, forcing, serial)

    def _post(self, gcm_state, les_state, conv, prof, rain_last, n_sub,
              n_clamp, pre_diag, first):
        """Slab diagnostics, LES -> GCM tendencies, GCM second half."""
        core, grid = self.core, self.grid
        dt = core.cfg.dt
        prof_les = ldiag.slab_profiles(grid, les_state)
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
        diag = dict(pre_diag)
        diag.update(
            conv=conv, rainrate=(rain - rain_last) / dt,
            les=prof_les, tend=tend, t_diag=tdiag["t"],
            A_d=A_d, n_substeps=n_sub, n_dtmin_clamped=n_clamp)
        return gcm_state, les_state, prof_les, rain, self._pack_diag(diag)

    def _pack_diag(self, diag):
        """Flatten the diag tree into one f32 vector; record the spec."""
        leaves, spec = _flatten(diag)
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
        return _unflatten(spec, iter(out))
