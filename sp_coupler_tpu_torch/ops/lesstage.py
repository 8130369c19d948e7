"""The fused LES RK stage: CUDA kernel wrapper + its plain PyTorch version.

``stage_fused`` replaces ``sp_coupler_tpu/ops/lesstage_pallas.py::
stage_fused`` (the Pallas TPU kernel ``_kernel``). On CUDA tensors it
launches the hand-written Hopper kernel ``csrc/lesstage.cu`` (built at
first use, ops/_build.py) and raises if the launch fails; on CPU tensors
it runs ``stage_fused_reference``, the plain split ``tendencies`` path
plus the RK axpy — the same reference the JAX package holds its kernel
against. Both implement only the physics ``supported`` accepts (the
Deardorff TKE closure and hybrid52 advection); ``stage_fused`` raises for
any other.

The note at the top of the CUDA source gives the kernel's bound and what
its two-launch design does about it. ``stage_geometry`` is its launch
geometry: tile, levels per z-chunk and shared-memory bytes of a block.

Halo mode, for a rank's block of planes split over ranks (``stage_fused(
..., plane=)``): the current fields are padded with HALO points from the
neighbouring blocks (one exchange, ``parallel.plane``); ``stage_sums``
launches the plane-means kernel on the block, the ranks sum its float64
sums, and ``stage_apply`` fills the means from the whole plane's sums and
launches the stage kernel over the block; kmax is then the plane's
maximum. The all_reduce between the two launches is a host collective in
every stage.
"""

import ctypes

import torch

from . import _build, tiling
from ..models.les import step as lstep, subgrid

launches = 0        # stage calls that launched the kernel on a whole plane
halo_launches = 0   # ... in halo mode, on a padded block (stage_apply)

# csrc/lesstage.cu: its tile of TX x TY columns (measured fastest at
# 64x64x160, PERF.md Findings; a tile wider than the plane wraps), and its
# shared-memory ring (HALO-point x/y halo, NSLOT planes of NF fields,
# NCSLOT closure planes of Km, Kh and the TKE source)
TX, TY = 32, 8
HALO, NF, NSLOT, NCSLOT = 3, 7, 5, 4
# k_stage blocks an SM holds at once: registers bind (at most 128 a
# thread, __launch_bounds__ in the source), then shared memory
RESIDENT = 2
# a chunk's start (its z-halo copied before any overlap, closure at three
# levels, thermodynamics at two) costs about as much as this many levels
CHUNK_START_LEVELS = 3


def shared_bytes():
    """Dynamic shared memory of a k_stage block (csrc/lesstage.cu, Tile):
    the field ring, the closure ring and the row/column index tables."""
    w, h = TX + 2 * HALO, TY + 2 * HALO
    return 4 * (NSLOT * NF * w * h + NCSLOT * 3 * (TX + 2) * (TY + 2)) \
        + 4 * (w + h)


def stage_geometry(n, nz, ny, nx, tz=None):
    """The stage kernel's launch geometry for an [n, nz, ny, nx] fleet
    (ops/tiling.py).

    tz: levels per z-chunk, by default ``tiling.chunk_levels`` (at
    64x64x160: 10 for n = 1, 20 for n = 2, each one wave of 256 blocks).
    Only the tests and chip_profile.py's sweep pass tz: on a small grid the
    default is one level a chunk, so a block marches several levels over a
    ragged tile only when tz is given. Raises ValueError for tz < 1 or
    shared memory above ``tiling.SMEM_LIMIT``.
    """
    return tiling.tile_geometry("stage", n, nz, ny, nx, TX, TY,
                                shared_bytes(), RESIDENT, CHUNK_START_LEVELS,
                                tz)


class _StageArgs(ctypes.Structure):
    """Mirror of ``struct StageArgs`` in csrc/lesstage.cu."""

    _fields_ = (
        [(k, ctypes.c_int) for k in
         ("n", "nz", "ny", "nx", "qt_mode", "n_sat_iter",
          "tx", "ty", "tz", "smem", "halo")]
        + [(k, ctypes.c_float) for k in
           ("dx", "dy", "dz", "fdt", "f_cor", "sponge_depth", "sponge_tau",
            "zs", "delta", "nc_fac", "auto_k", "accr_k", "evap_tau",
            "sed_a", "sed_b", "ice_tau", "ice_qi0", "sed_ai", "sed_bi")]
        + [(k, ctypes.c_void_p) for k in
           ("u", "v", "w", "thl", "qt", "qr", "e12",
            "ub", "vb", "wb", "thlb", "qtb", "qrb", "e12b",
            "pbf", "rhobf", "rhobh", "f_u", "f_v", "f_thl", "f_qt",
            "dt", "wthl", "wqt", "z0m",
            "un", "vn", "wn", "thln", "qtn", "qrn", "e12n", "aux",
            "means", "sums")])


def supported(phys):
    """Whether the stage kernel implements this physics: the physics half
    of ``sp_coupler_tpu/ops/lesstage_pallas.py::supported``."""
    return phys.subgrid == "tke" and phys.scheme == "hybrid52"


def _check_supported(phys):
    if not supported(phys):
        raise ValueError("the fused stage implements subgrid='tke' with "
                         "scheme='hybrid52', not subgrid=%r, scheme=%r"
                         % (phys.subgrid, phys.scheme))


def stage_fused_reference(grid, phys, cur, base, forcing, frac_dt, dt,
                          plane=None):
    """Plain PyTorch version: split tendencies(cur) -> base + frac*dt*tend,
    with the clips of the kernel. Same signature and outputs as
    ``stage_fused``. The tendencies take their own plain path
    (use_kernel=False), so no other kernel runs inside it."""
    t = lstep.tendencies(grid, phys._replace(use_kernel=False), cur,
                         forcing, dt, plane)
    f = (frac_dt * dt)[:, None, None, None]
    return (base.u + f * t["u"], base.v + f * t["v"],
            (base.w + f * t["w"])[:, :-1],
            base.thl + f * t["thl"],
            torch.clamp_min(base.qt + f * t["qt"], 0.0),
            torch.clamp_min(base.qr + f * t["qr"], 0.0),
            torch.clamp_min(base.e12 + f * t["e12"], subgrid.E12_MIN),
            t["kmax"], t["ustar"] ** 2, t["surf_rain"])


class PendingStage:
    """A stage whose plane-means kernel ran on a padded block
    (``stage_sums``): its arguments, its buffers (kept alive until the
    stage kernel is launched) and its float64 sums [n, 7, nz]."""

    def __init__(self, args, outs, aux, means, sums, keep):
        self.args, self.outs, self.aux = args, outs, aux
        self.means, self.sums, self.keep = means, sums, keep


def _stage_args(grid, phys, cur, base, forcing, frac_dt, dt, tz, halo):
    """(StageArgs, outputs, aux, means, kept tensors) of one stage on CUDA
    tensors; cur carries halo points a side."""
    _check_supported(phys)
    mp = phys.mphys
    if not (mp.sed_b > 0.0 and mp.sed_bi > 0.0):
        raise ValueError("the fused stage needs fall-speed exponents > 0 "
                         "(sed_b=%r, sed_bi=%r)" % (mp.sed_b, mp.sed_bi))
    if halo != 0 and halo < HALO:
        raise ValueError("the stage kernel's halo mode needs a halo of at "
                         "least %d points, got %d" % (HALO, halo))
    n, nz, pny, pnx = cur.thl.shape
    ny, nx = pny - 2 * halo, pnx - 2 * halo
    if nx < 4 or ny < 4:
        raise ValueError("the fused stage needs nx, ny >= 4")
    dev = cur.thl.device
    fld, face = (n, nz, ny, nx), (n, nz + 1, ny, nx)
    pfld, pface = (n, nz, pny, pnx), (n, nz + 1, pny, pnx)
    emp = lambda shp: torch.empty(shp, dtype=torch.float32, device=dev)
    outs = [emp(fld) for _ in range(7)]
    aux = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    means = emp((n, 7, nz))
    dt = dt.to(torch.float32).reshape(n).contiguous()
    geom = stage_geometry(n, nz, ny, nx, tz)

    a = _StageArgs(
        n=n, nz=nz, ny=ny, nx=nx, qt_mode=int(phys.qt_forcing),
        n_sat_iter=int(phys.n_sat_iter), tx=geom.tx, ty=geom.ty,
        tz=geom.tz, smem=geom.smem, halo=halo, dx=grid.dx, dy=grid.dy,
        dz=grid.dz,
        fdt=float(frac_dt), f_cor=float(phys.f_coriolis),
        sponge_depth=phys.sponge_depth, sponge_tau=phys.sponge_tau,
        zs=grid.zsize - phys.sponge_depth,
        delta=(grid.dx * grid.dy * grid.dz) ** (1.0 / 3.0),
        nc_fac=(mp.nc0 * 1e-6) ** (-1.79), auto_k=mp.auto_k,
        accr_k=mp.accr_k, evap_tau=mp.evap_tau, sed_a=mp.sed_a,
        sed_b=mp.sed_b, ice_tau=mp.ice_tau, ice_qi0=mp.ice_qi0,
        sed_ai=mp.sed_ai, sed_bi=mp.sed_bi)
    _check = _build.check_cuda
    for k in ("u", "v", "thl", "qt", "qr", "e12"):
        setattr(a, k, _check(getattr(cur, k), pfld, "cur." + k))
        setattr(a, k + "b", _check(getattr(base, k), fld, "base." + k))
    a.w = _check(cur.w, pface, "cur.w")
    a.wb = _check(base.w, face, "base.w")
    for k in ("pbf", "rhobf"):
        setattr(a, k, _check(getattr(cur, k), (n, nz), "cur." + k))
    a.rhobh = _check(cur.rhobh, (n, nz + 1), "cur.rhobh")
    for k in ("f_u", "f_v", "f_thl", "f_qt"):
        setattr(a, k, _check(getattr(forcing, k), (n, nz), "forcing." + k))
    a.dt = _check(dt, (n,), "dt")
    for k in ("wthl", "wqt", "z0m"):
        setattr(a, k, _check(getattr(forcing, k), (n,), "forcing." + k))
    for k, o in zip(("un", "vn", "wn", "thln", "qtn", "qrn", "e12n"), outs):
        setattr(a, k, o.data_ptr())
    a.aux, a.means = aux.data_ptr(), means.data_ptr()
    return a, outs, aux, means, (cur, base, forcing, dt)


def _launch(entry, a, dev):
    fn = _build.function("lesstage", entry,
                         [ctypes.c_void_p, ctypes.c_void_p])
    _build.launch(fn, (ctypes.byref(a),), dev, "lesstage")


def _result(outs, aux):
    un, vn, wn, thl, qt, qr, e12 = outs
    return un, vn, wn, thl, qt, qr, e12, aux[:, 0], aux[:, 1], aux[:, 2]


def stage_fused_cuda(grid, phys, cur, base, forcing, frac_dt, dt, tz=None):
    """Launch the Hopper kernel for one fused stage on CUDA tensors (the
    whole plane), at the launch geometry ``stage_geometry(n, nz, ny, nx,
    tz)``."""
    global launches
    a, outs, aux, _, keep = _stage_args(grid, phys, cur, base, forcing,
                                        frac_dt, dt, tz, 0)
    _launch("lesstage_stage", a, cur.thl.device)
    launches += 1
    return _result(outs, aux)


def stage_sums(grid, phys, cur, base, forcing, frac_dt, dt, halo=HALO,
               tz=None):
    """Halo mode, first launch: the plane-means kernel on a block whose
    current fields cur carry halo points a side (base: the unpadded
    block). Returns a PendingStage whose ``sums`` [n, 7, nz] float64 are
    the block's: sum them over the plane's blocks, then ``stage_apply``."""
    a, outs, aux, means, keep = _stage_args(grid, phys, cur, base, forcing,
                                            frac_dt, dt, tz, halo)
    n, nz = means.shape[0], means.shape[2]
    sums = torch.zeros((n, 7, nz), dtype=torch.float64,
                       device=cur.thl.device)
    a.sums = sums.data_ptr()
    _launch("lesstage_means", a, cur.thl.device)
    return PendingStage(a, outs, aux, means, sums, keep)


def stage_apply(pending, sums, points):
    """Halo mode, second launch: fill the means from the whole plane's
    summed sums [n, 7, nz] over its ``points`` (slots 0-4; <u*^2> and the
    rain flux from slots 5-6 of level 0), then launch the stage kernel over
    the block. Returns what ``stage_fused`` returns, kmax the block's."""
    global halo_launches
    p = pending
    p.means[:, :5] = (sums[:, :5] / points).to(torch.float32)
    p.aux[:, 1:] = (sums[:, 5:, 0] / points).to(torch.float32)
    _launch("lesstage_apply", p.args, p.means.device)
    halo_launches += 1
    return _result(p.outs, p.aux)


def stage_fused(grid, phys, cur, base, forcing, frac_dt, dt, plane=None):
    """One fused RK stage: tendencies(cur) -> base + frac_dt*dt*tend.

    cur, base: fleet LESState ([n, ...]); forcing: LESForcing; frac_dt: the
    RK fraction (python float); dt: substep lengths [n]. Returns (u, v,
    w[faces 0..nz-1], thl, qt, qr, e12, kmax [n], <u*^2> [n], surface rain
    flux [n]) — velocities before the projection; the caller projects and
    appends w face nz (= 0). plane: cur and base are this rank's block of
    the planes (``parallel.plane.Plane``), the kernel runs in its halo
    mode and the means, <u*^2>, rain and kmax are the whole plane's. CUDA
    tensors go to the kernel, CPU tensors to the plain version; physics
    outside ``supported`` raises ValueError on either.
    """
    _check_supported(phys)
    if cur.thl.device.type != "cuda":
        return stage_fused_reference(grid, phys, cur, base, forcing, frac_dt,
                                     dt, plane)
    if plane is None:
        return stage_fused_cuda(grid, phys, cur, base, forcing, frac_dt, dt)
    _, pcur = lstep.padded(plane, cur, HALO)
    pending = stage_sums(grid, phys, pcur, base, forcing, frac_dt, dt)
    out = stage_apply(pending, plane.sum_(pending.sums), plane.points)
    return out[:7] + (plane.max_(out[7].contiguous()),) + out[8:]
