"""Momentum advection + diffusion: CUDA kernel wrapper and its plain
PyTorch version.

``momentum_tendencies`` replaces ``sp_coupler_tpu/ops/lesmom_pallas.py::
momentum_tendencies`` (the Pallas TPU kernel ``_kernel``), which the split
``tendencies`` path runs for u, v and w under ``use_kernel``, whatever
the scheme, on every grid (the grid limits are the launch's: nx, ny >=
4). On CUDA tensors it launches the hand-written Hopper kernel
``csrc/lesmom.cu`` (built at first use, ops/_build.py) and raises if the
launch fails; on CPU tensors it runs
``momentum_tendencies_reference``. The kernel is bounded by memory
traffic; the note at the top of the CUDA source says what its design (a
block per tile of columns marching up a z-chunk, each face flux computed
once) does about that. ``momentum_geometry`` is its launch geometry.

Halo mode (``halo=h``, h >= 3): the inputs are a rank's block of the
planes padded with h points from its neighbours (``parallel.plane``),
[.., ny + 2h, nx + 2h], and the outputs are the block's [.., ny, nx]; the
launch geometry is the block's. The plain version then computes on the
padded block and keeps its interior.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build, tiling
from .lesflat import HALO, interior
from ..models.les import advect, subgrid

launches = 0        # kernel launches made by momentum_tendencies
halo_launches = 0   # ... of them in halo mode

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
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


def momentum_tendencies_reference(u, v, w, Km, rhobf, rhobh, dx, dy, dz,
                                  halo=0):
    """Plain PyTorch version: ``advect_u/v/w`` plus ``diffuse_momentum``
    without the surface stress (on the padded block, keeping its interior,
    in halo mode). Same signature and outputs as
    ``momentum_tendencies``."""
    g = SimpleNamespace(dx=dx, dy=dy, dz=dz)
    du = (advect.advect_u(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_scalar(g, rhobf, rhobh, Km, u))
    dv = (advect.advect_v(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_scalar(g, rhobf, rhobh, Km, v))
    dw = (advect.advect_w(g, rhobf, rhobh, u, v, w)
          + subgrid.diffuse_w(g, rhobf, rhobh, Km, w))
    if halo == 0:
        return du, dv, dw
    return tuple(interior(t, halo).contiguous() for t in (du, dv, dw))


def momentum_tendencies_cuda(u, v, w, Km, rhobf, rhobh, dx, dy, dz,
                             tz=None, halo=0):
    """Launch the Hopper kernel on CUDA tensors, at the launch geometry
    ``momentum_geometry(n, nz, ny, nx, tz)`` of the (interior) block;
    halo: the inputs' halo."""
    global launches, halo_launches
    if halo != 0 and halo < HALO:
        raise ValueError("the momentum kernel's halo mode needs a halo of "
                         "at least %d points, got %d" % (HALO, halo))
    n, nz, pny, pnx = u.shape
    ny, nx = pny - 2 * halo, pnx - 2 * halo
    if nx < 4 or ny < 4:
        raise ValueError("the momentum kernel needs nx, ny >= 4, got %d, %d"
                         % (nx, ny))
    chk = _build.check_cuda
    fld, face = (n, nz, pny, pnx), (n, nz + 1, pny, pnx)
    ptrs = (chk(u, fld, "u"), chk(v, fld, "v"), chk(w, face, "w"),
            chk(Km, fld, "Km"), chk(rhobf, (n, nz), "rhobf"),
            chk(rhobh, (n, nz + 1), "rhobh"))
    geom = momentum_geometry(n, nz, ny, nx, tz)
    emp = lambda k: torch.empty((n, k, ny, nx), dtype=u.dtype,
                                device=u.device)
    du, dv, dw = emp(nz), emp(nz), emp(nz + 1)
    fn = _build.function("lesmom", "lesmom_tend", _ARGTYPES)
    _build.launch(fn, ptrs + (du.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                              n, nz, ny, nx, geom.tz, geom.smem, halo, dx, dy,
                              dz), u.device, "lesmom")
    if halo:
        halo_launches += 1
    else:
        launches += 1
    return du, dv, dw


def momentum_tendencies(u, v, w, Km, rhobf, rhobh, dx, dy, dz, halo=0):
    """Momentum advection + diffusion tendencies, whole fleet.

    u, v, Km: [n, nz, ny, nx]; w: [n, nz+1, ny, nx]; rhobf: [n, nz];
    rhobh: [n, nz+1]. Returns (du, dv [n, nz, ny, nx], dw [n, nz+1, ny,
    nx]) with dw zero on faces 0 and nz (surface stress excluded: the
    caller adds it on plane 0). halo: the inputs are a block padded with
    halo points (the outputs are the block's). CUDA tensors go to the
    kernel, CPU tensors to the plain version.
    """
    if u.device.type != "cuda":
        return momentum_tendencies_reference(u, v, w, Km, rhobf, rhobh,
                                             dx, dy, dz, halo)
    return momentum_tendencies_cuda(u, v, w, Km, rhobf, rhobh, dx, dy, dz,
                                    halo=halo)
