"""The fused LES RK stage: CUDA kernel wrapper + its plain PyTorch version.

``stage_fused`` replaces ``sp_coupler_tpu/ops/lesstage_pallas.py::
stage_fused`` (the Pallas TPU kernel ``_kernel``). On CUDA tensors it
launches the hand-written Hopper kernel ``csrc/lesstage.cu`` (built at
first use, ops/_build.py) and raises if the launch fails; on CPU tensors
it runs ``stage_fused_reference``, the split ``tendencies`` path plus the
RK axpy — the same reference the JAX package holds its kernel against.

The kernel is bounded by memory traffic (7 fields in, 7 base fields, 7
out, plus 3 scratch fields per stage); see the note at the top of the
CUDA source for what its three-pass design does about that.
"""

import ctypes

import torch

from ..models.les import step as lstep, subgrid

launches = 0   # kernel launches made by stage_fused on CUDA tensors

_N_SCRATCH = 3   # Km, Kh, TKE source


class _StageArgs(ctypes.Structure):
    """Mirror of ``struct StageArgs`` in csrc/lesstage.cu."""

    _fields_ = (
        [(k, ctypes.c_int) for k in
         ("n", "nz", "ny", "nx", "qt_mode", "n_sat_iter")]
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
            "means", "Km", "Kh", "src")])


def _lib():
    from . import _build
    lib = _build.load("lesstage")
    if not getattr(lib, "_argtypes_set", False):
        lib.lesstage_stage.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.lesstage_stage.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def stage_fused_reference(grid, phys, cur, base, forcing, frac_dt, dt):
    """Plain PyTorch version: split tendencies(cur) -> base + frac*dt*tend,
    with the clips of the kernel. Same signature and outputs as
    ``stage_fused``."""
    t = lstep.tendencies(grid, phys, cur, forcing, dt)
    f = (frac_dt * dt)[:, None, None, None]
    return (base.u + f * t["u"], base.v + f * t["v"],
            (base.w + f * t["w"])[:, :-1],
            base.thl + f * t["thl"],
            torch.clamp_min(base.qt + f * t["qt"], 0.0),
            torch.clamp_min(base.qr + f * t["qr"], 0.0),
            torch.clamp_min(base.e12 + f * t["e12"], subgrid.E12_MIN),
            t["kmax"], t["ustar"] ** 2, t["surf_rain"])


def _check(x, shape, name):
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("%s: need a float32 CUDA tensor, got %s %s"
                         % (name, x.dtype, x.device))
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError("%s: need a contiguous %s tensor, got %s"
                         % (name, tuple(shape), tuple(x.shape)))
    return x.data_ptr()


def stage_fused_cuda(grid, phys, cur, base, forcing, frac_dt, dt):
    """Launch the Hopper kernel for one fused stage on CUDA tensors."""
    global launches
    mp = phys.mphys
    if not (mp.sed_b > 0.0 and mp.sed_bi > 0.0):
        raise ValueError("the fused stage needs fall-speed exponents > 0 "
                         "(sed_b=%r, sed_bi=%r)" % (mp.sed_b, mp.sed_bi))
    if grid.nx < 4 or grid.ny < 4:
        raise ValueError("the fused stage needs nx, ny >= 4")
    n, nz, ny, nx = cur.thl.shape
    dev = cur.thl.device
    fld, face = (n, nz, ny, nx), (n, nz + 1, ny, nx)
    emp = lambda shp: torch.empty(shp, dtype=torch.float32, device=dev)
    outs = [emp(fld) for _ in range(7)]
    aux = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    means = emp((n, 5, nz))
    scratch = [emp(fld) for _ in range(_N_SCRATCH)]
    dt = dt.to(torch.float32).reshape(n).contiguous()

    a = _StageArgs(
        n=n, nz=nz, ny=ny, nx=nx, qt_mode=int(phys.qt_forcing),
        n_sat_iter=int(phys.n_sat_iter), dx=grid.dx, dy=grid.dy, dz=grid.dz,
        fdt=float(frac_dt), f_cor=float(phys.f_coriolis),
        sponge_depth=phys.sponge_depth, sponge_tau=phys.sponge_tau,
        zs=grid.zsize - phys.sponge_depth,
        delta=(grid.dx * grid.dy * grid.dz) ** (1.0 / 3.0),
        nc_fac=(mp.nc0 * 1e-6) ** (-1.79), auto_k=mp.auto_k,
        accr_k=mp.accr_k, evap_tau=mp.evap_tau, sed_a=mp.sed_a,
        sed_b=mp.sed_b, ice_tau=mp.ice_tau, ice_qi0=mp.ice_qi0,
        sed_ai=mp.sed_ai, sed_bi=mp.sed_bi)
    for k in ("u", "v", "thl", "qt", "qr", "e12"):
        setattr(a, k, _check(getattr(cur, k), fld, "cur." + k))
        setattr(a, k + "b", _check(getattr(base, k), fld, "base." + k))
    a.w = _check(cur.w, face, "cur.w")
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
    a.Km, a.Kh, a.src = (s.data_ptr() for s in scratch)

    err = _lib().lesstage_stage(ctypes.byref(a),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("lesstage kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    un, vn, wn, thl, qt, qr, e12 = outs
    return un, vn, wn, thl, qt, qr, e12, aux[:, 0], aux[:, 1], aux[:, 2]


def stage_fused(grid, phys, cur, base, forcing, frac_dt, dt):
    """One fused RK stage: tendencies(cur) -> base + frac_dt*dt*tend.

    cur, base: fleet LESState ([n, ...]); forcing: LESForcing; frac_dt: the
    RK fraction (python float); dt: substep lengths [n]. Returns (u, v,
    w[faces 0..nz-1], thl, qt, qr, e12, kmax [n], <u*^2> [n], surface rain
    flux [n]) — velocities before the projection; the caller projects and
    appends w face nz (= 0). CUDA tensors go to the kernel, CPU tensors to
    the plain version.
    """
    if cur.thl.device.type == "cuda":
        return stage_fused_cuda(grid, phys, cur, base, forcing, frac_dt, dt)
    return stage_fused_reference(grid, phys, cur, base, forcing, frac_dt, dt)
