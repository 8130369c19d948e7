"""LES time stepping: tendency assembly + Wicker-Skamarock RK3 + projection.

Port of ``sp_coupler_tpu/models/les/step.py``. One substep is 3 RK
stages, each followed by the pressure projection. With ``use_kernel`` and
the physics the fused stage implements (``ops.lesstage.supported``: TKE
closure, hybrid52), a stage is ``ops.lesstage.stage_fused``; otherwise it
is the split ``tendencies`` path plus the RK axpy, whose scalar and
momentum advection + diffusion go through ``ops.lesflat`` and
``ops.lesmom`` under ``use_kernel`` on every grid, the physics alone
choosing the branch, as it chooses the fused stage. Every kernel wrapper
runs the CUDA kernel on a CUDA tensor and its plain PyTorch version on a
CPU tensor. ``use_kernel=False`` is the plain split path on either
device.

The adaptive loop runs on the host: the exit test ``time < t_end - 1e-3``
is evaluated in float32 on the device and read back once per substep, and
``dt`` follows the JAX package's float32 arithmetic, so the substep
counts agree with it.

Spatial blocks (``plane``, a ``parallel.plane.Plane``): the state holds
this rank's block of every plane. Each stage pads the 7 fields of the
current state with HALO points from the neighbouring blocks (one
exchange), computes on the padded block and keeps the interior; every
plane mean and maximum is the Plane's, over the interior of the whole
plane; the projection gathers the divergence (``poisson.project``). The
adaptive dt then is the same on every rank of a plane. ``plane=None`` is
the whole plane in one tensor, bit for bit the code without blocks.
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c
from ...utils import thermo
from ...ops import lesflat, lesmom
from ...parallel.plane import reducer
from . import advect, subgrid, poisson, micro
from .advect import sp, sm, col, X, Y
from .state import LESState, LESForcing, base_state

QT_FORCING_GLOBAL = 0    # uniform profile tendency (reference "sp" mode)
QT_FORCING_VARIANCE = 1  # global + coupler-side variability nudge
QT_FORCING_LOCAL = 2     # tendency distributed proportionally to local qt
QT_FORCING_STRONG = 3    # proportional with saturation-aware clipping

# points of halo a stage pads a block with: the 5th-order faces reach 3
# cells; the closure's K at +-1 of gradients at +-1 reaches 2
HALO = 3
FIELDS = ("u", "v", "w", "thl", "qt", "qr", "e12")   # the exchanged fields


class LESPhysics(NamedTuple):
    """Static physics configuration."""

    scheme: str = "hybrid52"         # "cd2" | "hybrid52" | "hybrid62"
    subgrid: str = "tke"             # "tke" (DALES default) | "smagorinsky"
    f_coriolis: float = 0.0
    sponge_depth: float = 750.0      # m, nudge-to-mean layer below the lid
    sponge_tau: float = 120.0        # s, strongest relaxation rate at the top
    qt_forcing: int = QT_FORCING_GLOBAL
    mphys: micro.MicroParams = micro.MicroParams()
    n_sat_iter: int = 2
    use_kernel: bool = True          # CUDA kernels on the GPU


def _bcast(dt):
    """Per-instance [n] tensor -> [n, 1, 1, 1]; python floats pass."""
    if isinstance(dt, torch.Tensor) and dt.dim() == 1:
        return dt[:, None, None, None]
    return dt


def thermodynamics(state):
    """Saturation adjustment on the whole volume: (T, ql, qsat, thv)."""
    p = col(state.pbf)
    T, ql, qs = thermo.sat_adjust(state.thl, state.qt, p, n_iter=2)
    th = T * thermo.iexner(p)
    qv = state.qt - ql
    thv = th * (1.0 + c.eps_i * qv - ql - state.qr)
    return T, ql, qs, thv


def padded(plane, state, h=HALO):
    """(reductions, state) for a stage on this rank's block: the state with
    its FIELDS padded with h points from the neighbouring blocks (one
    exchange) and the plane's reductions over the padded block's interior.
    Without a plane: (WHOLE, state)."""
    if plane is None:
        return reducer(None), state
    pads = plane.halo([getattr(state, k) for k in FIELDS], h)
    return plane.padded(h), state._replace(**dict(zip(FIELDS, pads)))


def _apply_qt_forcing(state, forcing, mode, red):
    """Distribute the slab-mean qt tendency over the volume."""
    f = col(forcing.f_qt)
    if mode == QT_FORCING_GLOBAL or mode == QT_FORCING_VARIANCE:
        return f.expand(state.qt.shape)
    qt_mean = red.mean(state.qt, keepdim=True)
    scale = state.qt / torch.clamp_min(qt_mean, 1e-10)
    if mode == QT_FORCING_LOCAL:
        return f * scale
    return torch.where(f < 0, f * scale, f.expand(state.qt.shape))


def tendencies(grid, phys, state, forcing, dt, plane=None):
    """All non-pressure tendencies (dict keyed like the state). ``dt``:
    the substep length, [n] tensor or python float (microphysics limits).

    Under ``use_kernel`` the scalar advection + diffusion (hybrid52: the
    scalar kernel has no other scheme) and the momentum advection +
    diffusion (every scheme) go through the kernel wrappers on every
    grid, and the prescribed surface fluxes are added on plane 0
    afterwards, as in the JAX package under ``use_pallas``. The JAX
    package takes its kernels only on the TPU's lane grids (ny*nx a
    multiple of 128, nz of 16) and elsewhere adds the fluxes inside
    ``diffuse_scalar``: the same sum in another order. The grid limits
    are the wrappers': on a CUDA tensor they raise for a (block's)
    nx or ny below 4 and, in halo mode, a halo below 3; on a CPU tensor
    they run their plain versions.

    With a plane the state is this rank's block: it is padded (``padded``,
    HALO = 3 points, the least the kernels' halo mode takes), the
    stencils run on the padded block (the kernels in their halo mode) and
    the tendencies are the block's. The branch depends on the physics
    alone, so a run takes the same branch with blocks as without them.
    ``Plane.halo`` takes blocks of at least HALO points a side, the
    kernels at least 4: on the card a block of 3 points raises (as a
    whole plane of 3 does), so split a plane into blocks of at least
    4 x 4 there.
    """
    dt = _bcast(dt)
    red, state = padded(plane, state)
    cr = red.crop
    T, ql, qs, thv = thermodynamics(state)
    rhobf, rhobh = state.rhobf, state.rhobh
    mean = lambda f: red.mean(f, keepdim=True)
    thv_m, thl_m, qt_m = mean(thv), mean(state.thl), mean(state.qt)

    if phys.subgrid == "tke":
        Km, Kh, lam, S2, N2 = subgrid.tke_viscosity(grid, state, thv, thv_m)
    else:
        Km, Kh = subgrid.eddy_viscosity(grid, state, thv, thv_m)

    # thl, qt, qr share Kh; e12 diffuses with 2 Km; the prescribed
    # surface fluxes enter thl and qt through the bottom face
    scalars = (state.thl, state.qt, state.qr, state.e12)
    Ks = (Kh, Kh, Kh, 2.0 * Km)
    # a bottom-face flux F adds rhobh[0] F / (rhobf[0] dz) on plane 0
    corr = (rhobh[:, 0] / (rhobf[:, 0] * grid.dz))[:, None, None]
    if phys.use_kernel and phys.scheme == "hybrid52":
        fused = lesflat.advect_diffuse_scalars(
            state.u, state.v, state.w, torch.stack(Ks, dim=1),
            torch.stack(scalars, dim=1), rhobf, rhobh,
            grid.dx, grid.dy, grid.dz, halo=red.h)
        dthl, dqt, dqr, de12_all = fused.unbind(1)
        # in place on the wrapper's fresh output
        dthl[:, 0] += corr * forcing.wthl[:, None, None]
        dqt[:, 0] += corr * forcing.wqt[:, None, None]
    else:
        zero = torch.zeros_like(forcing.wthl)
        dthl, dqt, dqr, de12_all = (
            cr(advect.advect_scalar(grid, rhobf, rhobh, state.u, state.v,
                                    state.w, s, phys.scheme)
               + subgrid.diffuse_scalar(grid, rhobf, rhobh, K, s,
                                        surf_flux=sf))
            for s, K, sf in zip(scalars, Ks,
                                (forcing.wthl, forcing.wqt, zero, zero)))

    if phys.use_kernel:
        ustar, fu, fv = subgrid.surface_momentum_fluxes(grid, state,
                                                        forcing.z0m, red)
        du, dv, dw = lesmom.momentum_tendencies(
            state.u, state.v, state.w, Km, rhobf, rhobh,
            grid.dx, grid.dy, grid.dz, halo=red.h)
        du[:, 0] += corr * cr(fu)
        dv[:, 0] += corr * cr(fv)
    else:
        du = advect.advect_u(grid, rhobf, rhobh, state.u, state.v, state.w)
        dv = advect.advect_v(grid, rhobf, rhobh, state.u, state.v, state.w)
        dw = advect.advect_w(grid, rhobf, rhobh, state.u, state.v, state.w)
        tu, tv, tw, ustar = subgrid.diffuse_momentum(grid, rhobf, rhobh, Km,
                                                     state, forcing.z0m, red)
        du = cr(du + tu)
        dv = cr(dv + tv)
        dw = cr(dw + tw)

    # buoyancy on interior w faces, relative to the slab mean
    b_cent = c.grav * (thv - thv_m) / torch.clamp_min(thv_m, 1.0)
    b_face = 0.5 * (b_cent[:, 1:] + b_cent[:, :-1])
    zero = torch.zeros_like(b_face[:, :1])
    dw = dw + cr(torch.cat([zero, b_face, zero], dim=1))

    if phys.subgrid == "tke":
        de12 = de12_all + cr(subgrid.tke_sources(grid, Km, Kh, lam, S2, N2,
                                                 state.e12))
    else:
        de12 = torch.zeros_like(cr(state.e12))

    if phys.f_coriolis != 0.0:
        vc_at_u = 0.25 * (state.v + sp(state.v, Y) + sm(state.v, X)
                          + sp(sm(state.v, X), Y))
        uc_at_v = 0.25 * (state.u + sp(state.u, X) + sm(state.u, Y)
                          + sp(sm(state.u, Y), X))
        du = du + phys.f_coriolis * cr(vc_at_u)
        dv = dv - phys.f_coriolis * cr(uc_at_v)

    du = du + col(forcing.f_u)
    dv = dv + col(forcing.f_v)
    dthl = dthl + col(forcing.f_thl)
    dqt = dqt + cr(_apply_qt_forcing(state, forcing, phys.qt_forcing, red))

    mdqt, mdqr, mdthl, surf_rain = micro.rain_tendencies(
        grid, phys.mphys, rhobf, T, col(state.pbf), state.qt - ql, ql,
        state.qr, dt, red)
    dqt = dqt + cr(mdqt)
    dqr = dqr + cr(mdqr)
    dthl = dthl + cr(mdthl)

    # sponge layer: relax to slab means near the lid
    dev = state.u.device
    zf = (torch.arange(grid.nz, dtype=torch.float32, device=dev)
          + 0.5) * grid.dz
    zs = grid.zsize - phys.sponge_depth
    rate = torch.clamp((zf - zs) / phys.sponge_depth, 0.0, 1.0) \
        / phys.sponge_tau
    rate = rate[None, :, None, None]
    du = du - rate * (cr(state.u) - mean(state.u))
    dv = dv - rate * (cr(state.v) - mean(state.v))
    dthl = dthl - rate * (cr(state.thl) - thl_m)
    dqt = dqt - rate * (cr(state.qt) - qt_m)
    zh = torch.arange(grid.nz + 1, dtype=torch.float32, device=dev) * grid.dz
    rate_h = torch.clamp((zh - zs) / phys.sponge_depth, 0.0, 1.0)
    dw = dw - (rate_h / phys.sponge_tau)[None, :, None, None] * cr(state.w)

    # max eddy viscosity (Km only, as DALES tstep_update) for the Peclet
    # dt limit
    kmax = red.amax(Km)
    return dict(u=du, v=dv, w=dw, thl=dthl, qt=dqt, qr=dqr, e12=de12,
                ustar=ustar, surf_rain=surf_rain, kmax=kmax)


def substep(grid, phys, state: LESState, forcing: LESForcing, dt,
            solver=None, plane=None, skip_projection=False):
    """One LES time step of length dt ([n] float32): RK3 + projection.

    Returns (state, kmax [n]) with kmax the final stage's max eddy
    viscosity, for the adaptive driver's Peclet limit. plane: this rank's
    block of a plane split over ranks (``parallel.plane.Plane``) or None.

    ``skip_projection`` (bench only, ``sp_coupler_tpu_torch/bench.py``'s
    phase accounting): drop the pressure projection of every stage, with
    a plane its halo and gather too, so that the projection's cost in
    context is the time against the full substep. Never use it for
    physics.
    """
    from ...ops import lesstage

    if phys.use_kernel and lesstage.supported(phys):
        def stage(s, frac, base):
            (u, v, wn, thl, qt, qr, e12, kmax, ustar2,
             rain) = lesstage.stage_fused(grid, phys, s, base, forcing,
                                          frac, dt, plane=plane)
            w = torch.cat([wn, torch.zeros_like(wn[:, :1])], dim=1)
            if not skip_projection:
                u, v, w, _ = poisson.project(grid, s.rhobf, s.rhobh, u, v,
                                             w, _bcast(frac * dt),
                                             solver=solver, plane=plane)
            t = dict(kmax=kmax, surf_rain=rain)
            return s._replace(u=u, v=v, w=w, thl=thl, qt=qt, qr=qr,
                              e12=e12, ustar=torch.sqrt(ustar2)), t
    else:
        def stage(s, frac, base):
            t = tendencies(grid, phys, s, forcing, dt, plane)
            fdt = _bcast(frac * dt)
            u = base.u + fdt * t["u"]
            v = base.v + fdt * t["v"]
            w = base.w + fdt * t["w"]
            if not skip_projection:
                u, v, w, _ = poisson.project(grid, s.rhobf, s.rhobh, u, v,
                                             w, fdt, solver=solver,
                                             plane=plane)
            return s._replace(
                u=u, v=v, w=w,
                thl=base.thl + fdt * t["thl"],
                qt=torch.clamp_min(base.qt + fdt * t["qt"], 0.0),
                qr=torch.clamp_min(base.qr + fdt * t["qr"], 0.0),
                e12=torch.clamp_min(base.e12 + fdt * t["e12"],
                                    subgrid.E12_MIN),
                ustar=t["ustar"],
            ), t

    s1, _ = stage(state, 1.0 / 3.0, state)
    s2, _ = stage(s1, 0.5, state)
    s3, t3 = stage(s2, 1.0, state)
    return s3._replace(
        rain=state.rain + dt * t3["surf_rain"],
        time=state.time + dt,
    ), t3["kmax"]


def _rebase(grid, state, ps_new, plane=None):
    """Rebuild the anelastic base state from the current slab means."""
    red = reducer(plane)
    thl0 = red.mean(state.thl)
    qt0 = red.mean(state.qt)
    pbf, pbh, rhobf, rhobh = base_state(grid, thl0, qt0, ps_new)
    return state._replace(ps=ps_new, pbf=pbf, pbh=pbh, rhobf=rhobf,
                          rhobh=rhobh)


def evolve(grid, phys, state: LESState, forcing: LESForcing, dt, n_steps,
           plane=None):
    """Advance n_steps substeps of length dt under constant forcing."""
    state = _rebase(grid, state, state.ps + forcing.f_ps * dt * n_steps,
                    plane)
    solver = poisson.build_solver(grid, state.rhobf, state.rhobh)
    dtt = torch.full_like(state.ps, dt)
    for _ in range(n_steps):
        state = substep(grid, phys, state, forcing, dtt, solver=solver,
                        plane=plane)[0]
    return state


# One 64x64x160 instance has enough horizontal parallelism to fill a chip;
# above this size instances are paced independently (serial) instead of in
# lock-step, where every instance runs until the SLOWEST one finishes
SERIAL_MIN_POINTS = 512 * 1024


def serial_fleet_default(grid):
    """Whether per-instance serial pacing is the right default."""
    return grid.nx * grid.ny * grid.nz >= SERIAL_MIN_POINTS


def map_fleet(one, states, forcings, serial):
    """Apply ``one(states, forcings)`` to the fleet.

    serial=False: one batched call over the whole fleet.
    serial=True: one call per instance (a sub-fleet of 1), outputs
    concatenated along the fleet axis.
    """
    if not serial:
        return one(states, forcings)
    outs = [one(states.index(slice(i, i + 1)),
                forcings.index(slice(i, i + 1)))
            for i in range(states.u.shape[0])]
    first = outs[0]
    cat = lambda xs: torch.cat(xs, dim=0)
    return (LESState(*[cat([o[0][k] for o in outs])
                       for k in range(len(first[0]))]),
            cat([o[1] for o in outs]), cat([o[2] for o in outs]))


def _put(dst, idx, src):
    """dst with rows idx replaced by src (None idx: whole fleet)."""
    return src if idx is None else dst.index_copy(0, idx, src)


def stable_dt(grid, state, kmax, cfl=0.7, peclet=0.1, red=None):
    """The substep length [n] the CFL and Peclet limits allow for state,
    kmax [n] the largest eddy viscosity (the previous substep's), before
    ``evolve_adaptive`` clamps it; red: the plane's reductions
    (``reducer``)."""
    red = reducer(None) if red is None else red
    min2 = min(grid.dx, grid.dy, grid.dz) ** 2
    rate_cell = (torch.abs(state.u) / grid.dx + torch.abs(state.v) / grid.dy
                 + torch.abs(0.5 * (state.w[:, 1:] + state.w[:, :-1]))
                 / grid.dz)
    rate = red.amax(rate_cell)
    return torch.minimum(cfl / torch.clamp_min(rate, 1e-6),
                         peclet * min2 / torch.clamp_min(kmax, 1e-9))


def start_kmax(grid, state, red=None):
    """The eddy viscosity bound an adaptive evolve starts from: CM x the
    grid scale x the largest e12 [n]."""
    red = reducer(None) if red is None else red
    delta = (grid.dx * grid.dy * grid.dz) ** (1.0 / 3.0)
    return subgrid.CM * delta * red.amax(state.e12)


def evolve_adaptive(grid, phys, state: LESState, forcing: LESForcing,
                    t_end, dt_max=15.0, cfl=0.7, dt_min=0.2, peclet=0.1,
                    plane=None):
    """Advance every instance to exactly t_end ([n] float32) with
    CFL/Peclet-adaptive substeps.

    The fleet steps together until its slowest instance is done; an
    instance that has reached t_end is masked out and keeps its state
    frozen, as in the JAX package's vmapped while_loop. With a plane the
    CFL and Peclet rates are maxima over the whole plane, so every rank
    of a plane takes the same substeps. Returns (state, n_substeps [n]
    int32, n_dtmin_clamped [n] int32).
    """
    red = reducer(plane)
    state = _rebase(grid, state, state.ps + forcing.f_ps
                    * (t_end - state.time), plane)
    solver = poisson.build_solver(grid, state.rhobf, state.rhobh)
    kmax = start_kmax(grid, state, red)
    n_fleet = state.u.shape[0]
    n = torch.zeros(n_fleet, dtype=torch.int32, device=state.u.device)
    nclamp = torch.zeros_like(n)
    t_stop = t_end - 1e-3
    while True:
        active = state.time < t_stop
        n_act = int(active.sum())                  # the one host read
        if n_act == 0:
            break
        if n_act == n_fleet:
            idx, s, f, sol, k, te = None, state, forcing, solver, kmax, t_end
        else:
            idx = torch.nonzero(active)[:, 0]
            s, f, sol = state.index(idx), forcing.index(idx), \
                solver.index(idx)
            k, te = kmax[idx], t_end[idx]
        dt = stable_dt(grid, s, k, cfl, peclet, red)
        dnc = (dt < dt_min).to(torch.int32)
        dt = torch.clamp(dt, dt_min, dt_max)
        dt = torch.minimum(dt, te - s.time)
        s, k = substep(grid, phys, s, f, dt, solver=sol, plane=plane)
        state = LESState(*[_put(a, idx, b) for a, b in zip(state, s)])
        kmax = _put(kmax, idx, k)
        n = _put(n, idx, (n if idx is None else n[idx]) + 1)
        nclamp = _put(nclamp, idx, (nclamp if idx is None else nclamp[idx])
                      + dnc)
    return state, n, nclamp
