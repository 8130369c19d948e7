"""Momentum advection + diffusion: CUDA kernel wrapper and its plain
PyTorch version.

``momentum_tendencies`` replaces ``sp_coupler_tpu/ops/lesmom_pallas.py::
momentum_tendencies`` (the Pallas TPU kernel ``_kernel``), which the split
``tendencies`` path runs for u, v and w whenever ``lesflat.supported(grid)``
holds, whatever the scheme. On CUDA tensors it launches the hand-written
Hopper kernel ``csrc/lesmom.cu`` (built at first use, ops/_build.py) and
raises if the launch fails; on CPU tensors it runs
``momentum_tendencies_reference``. The kernel is bounded by memory
traffic; the note at the top of the CUDA source says what its simple
design does about that.
"""

import ctypes
from types import SimpleNamespace

import torch

from . import _build
from ..models.les import advect, subgrid

launches = 0   # kernel launches made by momentum_tendencies

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])


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


def momentum_tendencies_cuda(u, v, w, Km, rhobf, rhobh, dx, dy, dz):
    """Launch the Hopper kernel on CUDA tensors."""
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
    du, dv = torch.empty_like(u), torch.empty_like(u)
    dw = torch.empty_like(w)
    fn = _build.function("lesmom", "lesmom_tend", _ARGTYPES)
    _build.raise_on_error(
        fn(*ptrs, du.data_ptr(), dv.data_ptr(), dw.data_ptr(), n, nz, ny, nx,
           dx, dy, dz, torch.cuda.current_stream(u.device).cuda_stream),
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
