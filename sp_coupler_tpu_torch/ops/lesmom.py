"""Momentum advection + diffusion: CUDA kernel wrapper and its plain
PyTorch version.

``momentum_tendencies`` replaces ``sp_coupler_tpu/ops/lesmom_pallas.py::
momentum_tendencies`` (the Pallas TPU kernel ``_kernel``), which the split
``tendencies`` path runs for u, v and w whenever ``lesflat.supported(grid)``
holds, whatever the scheme. On CUDA tensors it launches the hand-written
Hopper kernel ``csrc/lesmom.cu`` (built at first use, ops/_build.py) and
raises if the launch fails; on CPU tensors it runs
``momentum_tendencies_reference``. The kernel is bounded by memory
traffic; the note at the top of the CUDA source says what its design (a
block per tile of columns marching up a z-chunk, each face flux computed
once) does about that. ``momentum_geometry`` is its launch geometry.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, tiling
from ..models.les import advect, subgrid

launches = 0   # kernel launches made by momentum_tendencies

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])

# csrc/lesmom.cu: its tile of TX x TY columns, its shared-memory ring of
# NSLOT planes of NF fields (u, v, w, Km; tile + 1-point halo), a 2-plane
# ring of the face viscosity Kf, and NFLUX flux planes over the tile's
# (TX + 1) x (TY + 1) faces
TX, TY = 32, 8
NF, NSLOT, NFLUX = 4, 4, 11
# blocks an SM holds at once: registers bind (at most 64 a thread,
# __launch_bounds__ in the source)
RESIDENT = 4
# a chunk's start (four planes copied before any overlap, Kf and the
# lower-face fluxes of its first level) costs about this many levels
CHUNK_START_LEVELS = 3


def shared_bytes():
    """Dynamic shared memory of a k_momentum block (csrc/lesmom.cu, Tile):
    the field ring, the Kf ring, the flux planes and the row/column index
    tables."""
    w, h = TX + 2, TY + 2
    return 4 * (NSLOT * NF * w * h + 2 * w * h
                + NFLUX * (TX + 1) * (TY + 1)) + 4 * (w + h)


def momentum_geometry(n, nz, ny, nx, tz=None):
    """The momentum kernel's launch geometry for an [n, nz, ny, nx] fleet
    (ops/tiling.py): tz levels per z-chunk, by default
    ``tiling.chunk_levels`` (at 64x64x160: 5 for n = 1, 10 for n = 2, one
    wave of 512 blocks); the tests and chip_profile.py's sweep pass their
    own. Raises ValueError for tz < 1."""
    return tiling.tile_geometry("momentum", n, nz, ny, nx, TX, TY,
                                shared_bytes(), RESIDENT, CHUNK_START_LEVELS,
                                tz)


def momentum_tendencies_reference(u, v, w, Km, rhobf, rhobh, dx, dy, dz):
    """Plain PyTorch version: ``advect_u/v/w`` plus ``diffuse_momentum``
    without the surface stress. Same signature and outputs as
    ``momentum_tendencies``."""
    g = SimpleNamespace(dx=dx, dy=dy, dz=dz)
    du = (advect.advect_u(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_scalar(g, rhobf, rhobh, Km, u))
    dv = (advect.advect_v(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_scalar(g, rhobf, rhobh, Km, v))
    dw = (advect.advect_w(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_w(g, rhobf, rhobh, Km, w))
    return du, dv, dw


def momentum_tendencies_cuda(u, v, w, Km, rhobf, rhobh, dx, dy, dz,
                             tz=None):
    """Launch the Hopper kernel on CUDA tensors, at the launch geometry
    ``momentum_geometry(n, nz, ny, nx, tz)``."""
    global launches
    n, nz, ny, nx = u.shape
    if nx < 4 or ny < 4:
        raise ValueError("the momentum kernel needs nx, ny >= 4, got %d, %d"
                         % (nx, ny))
    chk = _build.check_cuda
    fld, face = (n, nz, ny, nx), (n, nz + 1, ny, nx)
    ptrs = (chk(u, fld, "u"), chk(v, fld, "v"), chk(w, face, "w"),
            chk(Km, fld, "Km"), chk(rhobf, (n, nz), "rhobf"),
            chk(rhobh, (n, nz + 1), "rhobh"))
    geom = momentum_geometry(n, nz, ny, nx, tz)
    du, dv = torch.empty_like(u), torch.empty_like(u)
    dw = torch.empty_like(w)
    fn = _build.function("lesmom", "lesmom_tend", _ARGTYPES)
    _build.raise_on_error(
        fn(*ptrs, du.data_ptr(), dv.data_ptr(), dw.data_ptr(), n, nz, ny, nx,
           geom.tz, geom.smem, dx, dy, dz,
           torch.cuda.current_stream(u.device).cuda_stream),
        "lesmom")
    launches += 1
    return du, dv, dw


def momentum_tendencies(u, v, w, Km, rhobf, rhobh, dx, dy, dz):
    """Momentum advection + diffusion tendencies, whole fleet.

    u, v, Km: [n, nz, ny, nx]; w: [n, nz+1, ny, nx]; rhobf: [n, nz];
    rhobh: [n, nz+1]. Returns (du, dv [n, nz, ny, nx], dw [n, nz+1, ny,
    nx]) with dw zero on faces 0 and nz (surface stress excluded: the
    caller adds it on plane 0). CUDA tensors go to the kernel, CPU tensors
    to the plain version.
    """
    if u.device.type != "cuda":
        return momentum_tendencies_reference(u, v, w, Km, rhobf, rhobh,
                                             dx, dy, dz)
    return momentum_tendencies_cuda(u, v, w, Km, rhobf, rhobh, dx, dy, dz)
