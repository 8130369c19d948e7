"""Scalar advection + diffusion of a scalar stack: CUDA kernel wrapper and
its plain PyTorch version.

``advect_diffuse_scalars`` replaces ``sp_coupler_tpu/ops/lesflat_pallas.py::
advect_diffuse_scalars`` (the Pallas TPU kernel ``_kernel``), which the
split ``tendencies`` path runs for thl, qt, qr and e12 under
``use_kernel`` when the scheme is hybrid52, on every grid (the grid
limits are the launch's: nx, ny >= 4). On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/lesflat.cu`` (built at first use,
ops/_build.py) and raises if the launch fails; on CPU tensors it runs
``advect_diffuse_scalars_reference``. The kernel is bounded by memory
traffic; the note at the top of the CUDA source says what its design (a
block per tile of columns and the whole stack, marching up a z-chunk,
each face flux computed once) does about that. ``scalar_geometry`` is its
launch geometry.

Halo mode (``halo=h``, h >= 3): the inputs are a rank's block of the
planes padded with h points from its neighbours (``parallel.plane``),
[.., ny + 2h, nx + 2h], and the output is the block's [.., ny, nx]; the
launch geometry is the block's. The plain version then computes on the
padded block and keeps its interior.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, tiling
from ..models.les import advect, subgrid

launches = 0        # kernel launches made by advect_diffuse_scalars
halo_launches = 0   # ... of them in halo mode

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])

# csrc/lesflat.cu: its tile of TX x TY columns; a block takes up to SMAX
# scalars of the stack (all 4 on the LES path). Its shared-memory ring has
# NSLOT levels, each SMAX scalar planes (tile + HALO-point halo) and SMAX K
# planes with u, v and w (tile + 1-point halo); NFLUX flux planes a scalar
# over the tile's (TX + 1) x (TY + 1) faces
TX, TY = 32, 8
SMAX, HALO, NSLOT, NFLUX = 4, 3, 3, 4
# blocks an SM holds at once: registers (at most 80 a thread,
# __launch_bounds__ in the source) and shared memory both bind
RESIDENT = 3
# a chunk's start (two levels copied before any overlap, the lower-face
# fluxes of its first level) costs about this many levels
CHUNK_START_LEVELS = 2


def shared_bytes():
    """Dynamic shared memory of a k_scalars block (csrc/lesflat.cu, Tile):
    the ring, the flux planes and the row/column index tables."""
    w, h = TX + 2 * HALO, TY + 2 * HALO
    k = (TX + 2) * (TY + 2)
    return 4 * (NSLOT * (SMAX * w * h + (SMAX + 3) * k)
                + SMAX * NFLUX * (TX + 1) * (TY + 1)) + 4 * (w + h)


def scalar_geometry(n, S, nz, ny, nx, tz=None):
    """The scalar kernel's launch geometry for a stack of S scalars on an
    [n, nz, ny, nx] fleet (ops/tiling.py): ceil(S / SMAX) groups of the
    stack, tz levels per z-chunk, by default ``tiling.chunk_levels`` (at
    64x64x160 and S = 4: 7 for n = 1, 14 for n = 2, one wave of 368 and 384
    blocks); the tests and chip_profile.py's sweep pass their own. Raises
    ValueError for tz < 1 or S < 1."""
    if S < 1:
        raise ValueError("the scalar kernel needs a stack, got S = %d" % S)
    return tiling.tile_geometry("scalar", n, nz, ny, nx, TX, TY,
                                shared_bytes(), RESIDENT, CHUNK_START_LEVELS,
                                tz, groups=-(-S // SMAX))


def interior(f, halo):
    """The block of f [..., ny + 2 halo, nx + 2 halo] without its halo."""
    return f if halo == 0 else f[..., halo:-halo, halo:-halo]


def advect_diffuse_scalars_reference(u, v, w, Ks, scalars, rhobf, rhobh,
                                     dx, dy, dz, halo=0):
    """Plain PyTorch version: hybrid52 ``advect_scalar`` plus
    ``diffuse_scalar`` without a surface flux, for each scalar of the
    stack (on the padded block, keeping its interior, in halo mode). Same
    signature and output as ``advect_diffuse_scalars``."""
    g = SimpleNamespace(dx=dx, dy=dy, dz=dz)
    return interior(torch.stack([
        advect.advect_scalar(g, rhobf, rhobh, u, v, w, scalars[:, i],
                             "hybrid52")
        + subgrid.diffuse_scalar(g, rhobf, rhobh, Ks[:, i], scalars[:, i])
        for i in range(scalars.shape[1])], dim=1), halo).contiguous()


def _check_halo(halo, name):
    if halo != 0 and halo < HALO:
        raise ValueError("the %s kernel's halo mode needs a halo of at "
                         "least %d points, got %d" % (name, HALO, halo))


def launch_scalars(entry, u, v, w, Ks, scalars, rhobf, rhobh, dx, dy, dz,
                   tz=None, halo=0):
    """Launch csrc/lesflat.cu through its C entry ``entry`` on CUDA
    tensors (counted by the caller), at the launch geometry
    ``scalar_geometry(n, S, nz, ny, nx, tz)`` of the (interior) block;
    returns the [n, S, nz, ny, nx] tendency. halo: the inputs' halo."""
    _check_halo(halo, "scalar")
    n, S, nz, pny, pnx = scalars.shape
    ny, nx = pny - 2 * halo, pnx - 2 * halo
    if nx < 4 or ny < 4:
        raise ValueError("the scalar kernel needs nx, ny >= 4, got %d, %d"
                         % (nx, ny))
    chk = _build.check_cuda
    fld, face = (n, nz, pny, pnx), (n, nz + 1, pny, pnx)
    ptrs = (chk(u, fld, "u"), chk(v, fld, "v"), chk(w, face, "w"),
            chk(Ks, scalars.shape, "Ks"),
            chk(scalars, (n, S, nz, pny, pnx), "scalars"),
            chk(rhobf, (n, nz), "rhobf"), chk(rhobh, (n, nz + 1), "rhobh"))
    geom = scalar_geometry(n, S, nz, ny, nx, tz)
    out = torch.empty((n, S, nz, ny, nx), dtype=scalars.dtype,
                      device=scalars.device)
    fn = _build.function("lesflat", entry, _ARGTYPES)
    _build.launch(fn, ptrs + (out.data_ptr(), n, S, nz, ny, nx, geom.tz,
                              geom.smem, halo, dx, dy, dz), u.device, entry)
    return out


def advect_diffuse_scalars_cuda(u, v, w, Ks, scalars, rhobf, rhobh,
                                dx, dy, dz, tz=None, halo=0):
    """Launch the Hopper kernel on CUDA tensors (tz: levels per z-chunk,
    ``scalar_geometry``; halo: the inputs' halo)."""
    global launches, halo_launches
    out = launch_scalars("lesflat_tend", u, v, w, Ks, scalars, rhobf, rhobh,
                         dx, dy, dz, tz, halo)
    if halo:
        halo_launches += 1
    else:
        launches += 1
    return out


def advect_diffuse_scalars(u, v, w, Ks, scalars, rhobf, rhobh, dx, dy, dz,
                           halo=0):
    """Advection + diffusion tendencies of a scalar stack, whole fleet.

    u, v: [n, nz, ny, nx]; w: [n, nz+1, ny, nx]; Ks, scalars: [n, S, nz,
    ny, nx]; rhobf: [n, nz]; rhobh: [n, nz+1]. Returns [n, S, nz, ny, nx]
    (surface flux excluded: the caller adds it on plane 0). halo: the
    inputs are a block padded with halo points (the output is the
    block's). CUDA tensors go to the kernel, CPU tensors to the plain
    version.
    """
    if scalars.device.type != "cuda":
        return advect_diffuse_scalars_reference(u, v, w, Ks, scalars, rhobf,
                                                rhobh, dx, dy, dz, halo)
    return advect_diffuse_scalars_cuda(u, v, w, Ks, scalars, rhobf, rhobh,
                                       dx, dy, dz, halo=halo)
