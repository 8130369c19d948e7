"""GCM model core: phase-split stepping + the column API of the coupler.

Port of ``sp_coupler_tpu/models/gcm/model.py::GCMCore`` on one device:
the initial state, the three-phase step split at the cloud scheme
(phase A = dynamics + pre-cloud physics, cloud scheme, phase B = SP
tendencies + re-analysis + time filter), column gather, surface fields
and SP-tendency scatter, with Eulerian or semi-Lagrangian dynamics
(``semilag.py``) on sigma or hybrid levels, and the ``split_phases``
low-memory mode. The operator tables live on the core's device; the JAX
package's ``consts``/``bound`` jit plumbing and buffer donation have no
counterpart here. ``GCMModel`` is the host shell with the reference's
duck-typed model API that the driver calls.
"""

import dataclasses
import datetime
from typing import NamedTuple

import numpy as np
import torch

from sp_coupler_tpu_torch import constants as c, default_device
from ...utils import thermo
from . import spharm, vertical, dycore, physics, semilag


class GCMState(NamedTuple):
    """GCM state between phases."""

    now: dycore.SpectralState       # filtered state at t
    prev: dycore.SpectralState      # filtered state at t - dt
    new: dycore.SpectralState       # provisional state at t + dt
    grid: dycore.GridFields         # grid view of `new` (after phase A)
    sfc: dict                       # surface flux fields (after phase A)
    sp_tend: dict                   # SP tendency maps [L, nlat, nlon] or 0
    vdiff_mask: torch.Tensor        # [nlat, nlon] 1 = vdiff active
    time: torch.Tensor              # model time (s)


SP_TEND_KEYS = ("U", "V", "T", "SH", "QL", "QI", "A")


def _zero_sp_tend(device):
    """Cleared SP tendencies as scalar zeros (broadcast in phase B)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {k: z for k in SP_TEND_KEYS}


@dataclasses.dataclass(frozen=True)
class GCMConfig:
    trunc: int = 21
    nlev: int = 19
    dt: float = 900.0
    tref: float = 300.0
    start_date: str = "2000-01-01T00:00:00"
    diffusion_tau: float = 4.0 * 3600.0
    robert_eps: float = 0.05
    hybrid: bool = False         # hybrid sigma-p A/B levels; False: sigma
    advection: str = "eulerian"  # "eulerian" (flux-form leapfrog, up to
                                 # the advective CFL) | "sl" (3TL
                                 # semi-Lagrangian, semilag.py)
    sl_decenter: float = 0.1     # SL-SI off-centering epsilon
    sl_coriolis: str = "auto"    # "midpoint" | "trapezoid" | "auto"
                                 # (midpoint unless the polar f tau
                                 # approaches its bound; semilag.sl_step)
    split_phases: bool = False   # phase A's dynamics, the SL stages and
                                 # the physics as separate calls, each
                                 # intermediate dropped when consumed
    phys: physics.PhysicsParams = physics.PhysicsParams()


class GCMCore:
    """Precomputed operators + phase functions on one device."""

    def __init__(self, cfg: GCMConfig, device=None):
        if cfg.advection not in ("eulerian", "sl"):
            raise ValueError("GCMConfig.advection must be 'eulerian' or "
                             "'sl', got %r" % (cfg.advection,))
        if cfg.sl_coriolis not in ("auto", "midpoint", "trapezoid"):
            raise ValueError("GCMConfig.sl_coriolis must be 'auto', "
                             "'midpoint' or 'trapezoid', got %r"
                             % (cfg.sl_coriolis,))
        self.cfg = cfg
        self.device = default_device(device)
        self.sht = spharm.SpectralTransform(cfg.trunc, device=self.device)
        self.vc = vertical.VerticalCoords(cfg.nlev, tref=cfg.tref,
                                          device=self.device,
                                          hybrid=cfg.hybrid)
        self.slg = None
        self.sl_cor = cfg.sl_coriolis
        if self.sl_cor == "auto":
            # polar f tau = 2 Omega * 2 dt; the centered midpoint form is
            # stable below 2: take the trapezoid with a margin
            self.sl_cor = ("trapezoid"
                           if 2.0 * c.omega * 2.0 * cfg.dt > 1.5
                           else "midpoint")
        if cfg.advection == "sl":
            # dt sizes the latitude-banded interpolation windows for the
            # 150 m/s design wind (semilag.SLGrid)
            self.slg = semilag.SLGrid(self.sht, dt=cfg.dt)
            if cfg.split_phases:
                # level-chunk the window interpolation: the largest
                # divisor of nlev <= 4
                self.slg.k_chunk = next(
                    (kc for kc in range(min(4, cfg.nlev), 0, -1)
                     if cfg.nlev % kc == 0), None)
        for dt in (cfg.dt / 2.0, cfg.dt / 4.0, cfg.dt):
            self.vc.implicit_inverse(dt, cfg.trunc)
        if cfg.advection == "sl":
            # the SL-SI off-centered arrival weights (semilag.sl_solve)
            eps = cfg.sl_decenter
            self.vc.implicit_inverse((1.0 + eps) * cfg.dt / 2.0, cfg.trunc)
            self.vc.implicit_inverse((1.0 + eps) * cfg.dt, cfg.trunc)
        mu = self.sht.mu.cpu().numpy()          # float32, as the JAX core
        self.lat_rad = torch.as_tensor(np.arcsin(mu), dtype=torch.float32,
                                       device=self.device)[:, None]
        self.fcor = torch.as_tensor(2 * c.omega * mu, dtype=torch.float32,
                                    device=self.device)[:, None]
        self.nlat, self.nlon = self.sht.nlat, self.sht.nlon
        self.ncols = self.nlat * self.nlon

    # ---- initial condition ------------------------------------------------

    def initial_state(self, seed=0) -> GCMState:
        """Radiative-equilibrium T, height-decaying RH moisture and a small
        rotational perturbation drawn from a torch.Generator seeded with
        ``seed``."""
        sht, vc, cfg = self.sht, self.vc, self.cfg
        L, M, N = cfg.nlev, sht.M, sht.N
        dev = self.device
        ps = torch.full((), c.pref0, dtype=torch.float32, device=dev)
        _, p_full = vc.pressures(ps)
        p_full = p_full[:, None, None]
        Teq = physics.equilibrium_temperature(p_full, self.lat_rad, cfg.phys)
        T_grid = Teq.expand(L, self.nlat, self.nlon)
        rh = 0.8 * vc.sf[:, None, None] ** 1.5
        q_grid = rh * thermo.qsat_liq(T_grid, p_full)
        spec = dycore.SpectralState.zeros(L, M, N, device=dev)
        spec = spec._replace(T=sht.analyze(T_grid), q=sht.analyze(q_grid))
        gen = torch.Generator().manual_seed(int(seed))
        pert = 1e-6 * torch.randn((L, M, N, 2), generator=gen).to(dev)
        keep = ((torch.arange(N, device=dev)[None, :, None] < 8)
                & (torch.arange(M, device=dev)[:, None, None] < 8))
        spec = spec._replace(vort=(spec.vort + pert * keep)
                             * sht.mask[..., None])
        grid = dycore.to_grid(sht, vc, spec)
        return GCMState(
            now=spec, prev=spec, new=spec, grid=grid,
            sfc=self._surface(grid), sp_tend=_zero_sp_tend(dev),
            vdiff_mask=torch.ones((self.nlat, self.nlon), dtype=torch.float32,
                                  device=dev),
            time=torch.zeros((), dtype=torch.float32, device=dev))

    # ---- helpers -----------------------------------------------------------

    def _surface(self, grid):
        ps = c.pref0 * torch.exp(grid.lnps)
        _, pf = self.vc.pressures(ps)
        z1 = c.rd * grid.T[-1] / c.grav * (1.0 - pf[-1] / ps) * 2.0
        z1 = torch.clamp_min(z1, 10.0)
        return physics.surface_fluxes(grid.u[-1], grid.v[-1], grid.T[-1],
                                      grid.q[-1], ps, z1, self.lat_rad,
                                      self.cfg.phys)

    def _layer_depths(self, grid):
        """dz of each layer [L, nlat, nlon] from hydrostatics."""
        ps = c.pref0 * torch.exp(grid.lnps)
        ph, pf = self.vc.pressures(ps)
        dp = ph[1:] - ph[:-1]
        rho = pf / (c.rd * torch.clamp_min(grid.T, 100.0))
        return dp / (rho * c.grav)

    # ---- phases ------------------------------------------------------------

    def phase_a(self, state: GCMState, first: bool = False) -> GCMState:
        """Phase A. Under split_phases the SL dynamics runs as its stages
        in the JAX package's order (mid-grid, mid-terms, trajectories,
        departure stack, departure interpolation, arrivals, solve), each
        intermediate dropped as soon as the next stage has consumed it:
        the caching allocator then reuses its memory, in stream order, so
        no stage's working set outlives it."""
        if not (self.cfg.split_phases and self.slg is not None):
            return self._phase_a_body(state, first)
        cfg, sht, vc, slg = self.cfg, self.sht, self.vc, self.slg
        dt2 = cfg.dt if first else 2.0 * cfg.dt
        mg = semilag.sl_mid_grid(sht, vc, slg, state.now)
        mid = semilag.sl_mid_terms(sht, vc, slg, state.now, mg,
                                   coriolis=self.sl_cor)
        del mg
        traj = semilag.sl_trajectories(sht, vc, slg, state.now, dt2)
        stack = semilag.sl_dep_stack(sht, vc, slg, state.now, state.prev,
                                     dt2, decenter=cfg.sl_decenter,
                                     coriolis=self.sl_cor)
        angm = traj["angm"]
        dep_vals, pi_dep = semilag.sl_interp_dep(
            slg, stack["dep"], stack["pi_comb"], *traj["angd"])
        del stack, traj
        arr = semilag.sl_arrivals(slg, mid["mid"], mid["N_pi"], *angm,
                                  dep_vals, pi_dep, dt2,
                                  coriolis=self.sl_cor)
        del mid, angm, dep_vals, pi_dep
        new = semilag.sl_solve(sht, vc, *arr, dt2, decenter=cfg.sl_decenter)
        del arr
        new = dycore.hyperdiffuse(sht, new, cfg.dt, cfg.diffusion_tau,
                                  damp_lnps=True)
        return self._phase_a_phys(state, new)

    def _phase_a_dyn(self, state: GCMState, first: bool):
        """Dynamics half of phase A: the provisional spectral state over
        the leapfrog window (dt on the Euler start), hyperdiffused."""
        cfg, sht, vc = self.cfg, self.sht, self.vc
        dt2 = cfg.dt if first else 2.0 * cfg.dt
        if self.slg is not None:
            new = semilag.sl_step(sht, vc, self.slg, state.now, state.prev,
                                  dt2, decenter=cfg.sl_decenter,
                                  coriolis=self.sl_cor)
        else:
            N, _ = dycore.tendencies(sht, vc, state.now, self.fcor)
            new = dycore.semi_implicit_step(sht, vc, state.now, state.prev,
                                            N, dt2)
        return dycore.hyperdiffuse(sht, new, cfg.dt, cfg.diffusion_tau,
                                   damp_lnps=self.slg is not None)

    def _phase_a_body(self, state: GCMState, first: bool = False) -> GCMState:
        """Dynamics step + pre-cloud physics (radiation, vdiff). ``first``
        selects the Euler start (dt window) over the leapfrog (2 dt)."""
        return self._phase_a_phys(state, self._phase_a_dyn(state, first))

    def _phase_a_phys(self, state: GCMState, new) -> GCMState:
        """Physics half of phase A on the provisional spectral state."""
        cfg, sht, vc = self.cfg, self.sht, self.vc
        grid = dycore.to_grid(sht, vc, new)
        sfc = self._surface(grid)
        _, p_full = vc.pressures(c.pref0 * torch.exp(grid.lnps))
        dT_rad = physics.radiation(grid.T, p_full, self.lat_rad, vc.sf,
                                   cfg.phys)
        dz = self._layer_depths(grid)
        du, dv, dT_vd, dq_vd = physics.vertical_diffusion(
            vc, grid.u, grid.v, grid.T, grid.q, sfc, dz, cfg.phys,
            state.vdiff_mask)
        if cfg.phys.rayleigh_tau > 0.0:
            kf = (1.0 / cfg.phys.rayleigh_tau) * torch.clamp(
                (vc.sf[:, None, None] - 0.7) / 0.3, 0.0, 1.0)
            du = du - kf * grid.u
            dv = dv - kf * grid.v
        grid = grid._replace(
            u=grid.u + cfg.dt * du,
            v=grid.v + cfg.dt * dv,
            T=grid.T + cfg.dt * (dT_rad + dT_vd),
            q=torch.clamp_min(grid.q + cfg.dt * dq_vd, 0.0),
        )
        return state._replace(new=new, grid=grid, sfc=sfc)

    def phase_cloud(self, state: GCMState) -> GCMState:
        """Cloud scheme (large-scale condensation + cloud fraction); also
        clears the SP tendency buffers."""
        g = state.grid
        _, p_full = self.vc.pressures(c.pref0 * torch.exp(g.lnps))
        T, q, ql, qi, a = physics.cloud_scheme(
            g.T, torch.clamp_min(g.q, 0.0), torch.clamp_min(g.ql, 0.0),
            torch.clamp_min(g.qi, 0.0), torch.clamp(g.a, 0.0, 1.0),
            p_full, self.cfg.dt, self.cfg.phys)
        grid = g._replace(T=T, q=q, ql=ql, qi=qi, a=a)
        return state._replace(grid=grid, sp_tend=_zero_sp_tend(self.device))

    def phase_b(self, state: GCMState, first: bool = False) -> GCMState:
        return self._phase_b_body(state, first)

    def _phase_b_body(self, state: GCMState, first: bool = False) -> GCMState:
        """Apply SP tendencies, re-analyze, time-filter, advance the clock."""
        cfg, sht = self.cfg, self.sht
        g = state.grid
        st = state.sp_tend
        dt = cfg.dt
        g = g._replace(
            u=g.u + dt * st["U"], v=g.v + dt * st["V"],
            T=g.T + dt * st["T"],
            q=torch.clamp_min(g.q + dt * st["SH"], 0.0),
            ql=torch.clamp_min(g.ql + dt * st["QL"], 0.0),
            qi=torch.clamp_min(g.qi + dt * st["QI"], 0.0),
            a=torch.clamp(g.a + dt * st["A"], 0.0, 1.0),
        )
        vort, div = sht.vort_div_from_uv(g.u, g.v)
        new = state.new._replace(
            vort=vort, div=div, T=sht.analyze(g.T), q=sht.analyze(g.q),
            ql=sht.analyze(g.ql), qi=sht.analyze(g.qi), a=sht.analyze(g.a))
        if first:
            prev = state.now
        else:
            prev = dycore.robert_filter(state.now, state.prev, new,
                                        cfg.robert_eps)
        return state._replace(prev=prev, now=new, new=new,
                              time=state.time + dt)

    def step(self, state: GCMState, first=False) -> GCMState:
        """One GCM step: phase A, cloud scheme, phase B."""
        return self.phase_b(self.phase_cloud(self.phase_a(state, first)),
                            first)

    # ---- column API (used by the coupler) ----------------------------------

    def column_profiles(self, state: GCMState, col_idx):
        """Per-column profiles [n, L] (or [n, L+1]) at the post-cloud-scheme
        point, levels top-first. col_idx: [n] flat lat-major indices."""
        g = state.grid
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        take = lambda f: f[:, j, i].T
        ps = c.pref0 * torch.exp(g.lnps[j, i])
        ph_l, pf_l = self.vc.pressures(ps)
        Tcols = take(g.T)
        if self.vc.hybrid:
            hc = self.vc.hybrid_coeffs(ps)
            zg_full = self.vc.geopotential_full(
                Tcols, lnr=hc["lnr"].T, alpha=hc["alpha"].T)
            zg_half = self.vc.geopotential_half(Tcols, lnr=hc["lnr"].T)
        else:
            zg_full = self.vc.geopotential_full(Tcols)
            zg_half = self.vc.geopotential_half(Tcols)
        return {
            "U": take(g.u), "V": take(g.v), "T": Tcols,
            "SH": take(g.q), "QL": take(g.ql), "QI": take(g.qi),
            "A": take(g.a), "Pfull": pf_l.T, "Phalf": ph_l.T,
            "Zgfull": zg_full, "Zghalf": zg_half,
        }

    def surface_fields(self, state: GCMState, col_idx):
        """The surface fields the coupler converts under cplsurf, [n] per
        key, at the columns col_idx."""
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        return {k: state.sfc[k][j, i] for k in (
            "Z0M", "Z0H", "QLflux", "QIflux", "SHflux", "TLflux", "TSflux")}

    def with_sp_tendencies(self, state: GCMState, col_idx, tend):
        """Scatter per-column tendencies ([n, L] per variable) into the
        dense SP buffers."""
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        new_t = dict(state.sp_tend)
        shape = (self.cfg.nlev, self.nlat, self.nlon)
        for k, v in tend.items():
            base = new_t[k].expand(shape).clone()
            base[:, j, i] = v.T
            new_t[k] = base
        return state._replace(sp_tend=new_t)


class GCMModel:
    """Host-side shell with the reference-like duck-typed API."""

    support_async = False

    def __init__(self, cfg: GCMConfig = GCMConfig(), seed=0, device=None):
        self.core = GCMCore(cfg, device=device)
        self.cfg = cfg
        self.state = self.core.initial_state(seed)
        self.mask = set()
        self.step_count = 0
        self.exp_name = "TEST"
        self.num_steps = 0
        self.step = 0
        lats = self.core.sht.latitudes_deg()
        lons = self.core.sht.longitudes_deg()
        self.latitudes = np.repeat(lats, len(lons))
        self.longitudes = np.tile(lons, len(lats))
        self.ktot = cfg.nlev
        self._start = datetime.datetime.fromisoformat(cfg.start_date)
        self._phase = "idle"
        self._first = True

    # -- lifecycle (initialize_code/commit_* are no-ops in-process) --------
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

    # -- reference API ------------------------------------------------------
    def get_start_datetime(self):
        return self._start

    def get_timestep(self):
        return float(self.cfg.dt)

    def get_model_time(self):
        return float(self.state.time)

    def get_itot(self):
        return self.core.nlon

    def get_jtot(self):
        return self.core.nlat

    def get_ktot(self):
        return self.cfg.nlev

    def set_mask(self, i):
        self.mask.add(int(i))

    def set_vdf_in_sp_mask(self, value):
        """value=True disables vertical diffusion in the masked columns;
        False leaves it on everywhere. These are OpenIFS's semantics ("True
        = disable vdiff inside the mask"), which the reference driver calls
        as set_vdf_in_sp_mask(not couple_surface)."""
        m = np.ones((self.core.nlat, self.core.nlon), np.float32)
        if value:
            for idx in self.mask:
                m[idx // self.core.nlon, idx % self.core.nlon] = 0.0
        self._vdf_disable_in_mask = value
        self.state = self.state._replace(vdiff_mask=torch.as_tensor(
            m, device=self.core.device))

    def _refresh_vdiff_mask(self):
        if getattr(self, "_vdf_disable_in_mask", False):
            self.set_vdf_in_sp_mask(True)

    def evolve_model_until_cloud_scheme(self):
        self._refresh_vdiff_mask()
        self.state = self.core.phase_a(self.state, self._first)
        self._phase = "pre_cloud"
        return True

    def evolve_model_cloud_scheme(self):
        self.state = self.core.phase_cloud(self.state)
        self._phase = "post_cloud"
        return True

    def evolve_model_from_cloud_scheme(self):
        self.state = self.core.phase_b(self.state, self._first)
        self._first = False
        self._phase = "idle"
        self.step_count += 1
        return True

    def _cols(self, cols):
        return torch.as_tensor(np.asarray(cols, np.int64),
                               device=self.core.device)

    def get_profile_fields(self, var, cols):
        prof = self.core.column_profiles(self.state, self._cols(cols))
        return prof[var].cpu().numpy()

    def get_profile_field(self, var, col):
        return self.get_profile_fields(var, [col])[0]

    def get_surface_field(self, var, cols):
        sf = self.core.surface_fields(self.state, self._cols(cols))
        return sf[var].cpu().numpy()

    def set_profile_tendency(self, var, col_index, profile):
        t = torch.as_tensor(np.asarray(profile, np.float32),
                            device=self.core.device)[None]
        self.state = self.core.with_sp_tendencies(
            self.state, self._cols([col_index]), {var: t})
