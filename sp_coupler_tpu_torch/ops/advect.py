"""Scalar advection + diffusion in the un-flattened layout: a second binding
of the scalar kernel, and its plain PyTorch version.

``advect_diffuse_scalars`` replaces ``sp_coupler_tpu/ops/advect_pallas.py::
advect_diffuse_scalars`` (the Pallas TPU kernel ``_kernel``). That kernel
computes what ``lesflat_pallas`` computes, on [n, S, nz, ny, nx] instead of
[n, S, nz, ny*nx]; the two differ only in their TPU VMEM tiling, and on the
card both are the same contiguous memory. So it launches the device code
of ``csrc/lesflat.cu`` through that file's own C entry ``advect_tend``,
with its own launch counter. Like the TPU kernel (whose slab height
``pick_bz`` sizes VMEM and is not ported), it takes any nz and any plane
with nx, ny >= 4. On CPU tensors it runs the plain version.
"""

from . import lesflat

launches = 0   # kernel launches made by advect_diffuse_scalars

# the plain version: the same computation as the lesflat kernel's
advect_diffuse_scalars_reference = lesflat.advect_diffuse_scalars_reference


def advect_diffuse_scalars_cuda(u, v, w, Ks, scalars, rhobf, rhobh,
                                dx, dy, dz, tz=None):
    """Launch the Hopper kernel (entry advect_tend) on CUDA tensors (tz:
    levels per z-chunk, ``lesflat.scalar_geometry``)."""
    global launches
    out = lesflat.launch_scalars("advect_tend", u, v, w, Ks, scalars, rhobf,
                                 rhobh, dx, dy, dz, tz)
    launches += 1
    return out


def advect_diffuse_scalars(u, v, w, Ks, scalars, rhobf, rhobh, dx, dy, dz):
    """u, v: [n, nz, ny, nx]; w: [n, nz+1, ny, nx]; Ks, scalars: [n, S, nz,
    ny, nx]; rhobf: [n, nz]; rhobh: [n, nz+1]. Returns [n, S, nz, ny, nx].
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if scalars.device.type != "cuda":
        return advect_diffuse_scalars_reference(u, v, w, Ks, scalars, rhobf,
                                                rhobh, dx, dy, dz)
    return advect_diffuse_scalars_cuda(u, v, w, Ks, scalars, rhobf, rhobh,
                                       dx, dy, dz)
