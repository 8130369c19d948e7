"""The H100's peaks and the kernels' operation counts: the least time the
card could take for a kernel's work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the H100's 3.35 TB/s, and
its float operations over the data sheet's 67 TFLOP/s of float32 outside
the tensor cores (SXM part, 700 W). Operations per grid point, counted by
hand from the CUDA sources (an add, multiply, divide, min/max, compare,
sqrt, exp, log or pow is one; the saturation adjustment at its default 2
iterations): lesstage ~86 closure + ~100 thermodynamics + ~890 tendencies
and axpy + ~80 plane means; lesflat/advect 4 scalars x ~140; lesmom ~230.
The data sheet's rate counts a fused multiply-add as two operations, as
this count does a multiply and an add, so the rate bounds the count
whatever share of it the compiler fuses: at least half an instruction an
operation, 128 float32 instructions a clock per SM, 132 SMs at 1.98 GHz.
``chip_smoke.py`` and ``sp_coupler_tpu_torch/bench.py`` read the same
counts from here.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_OPS = dict(lesstage=1160, lesflat=560, advect=560, lesmom=230)


def stage_bound(n, nz, ny, nx):
    """(bytes, float operations) the stage needs at this shape: 7 current
    fields, 7 base fields and the profiles read once, 7 fields and aux
    written once; KERNEL_OPS per point."""
    pts = n * nz * ny * nx
    return (4 * (21 * pts + n * (7 * nz + 1 + 4) + 3 * n),
            KERNEL_OPS["lesstage"] * pts)


def bound_ms(nbytes, ops):
    """The least time for the work on an H100 (SXM): bytes over 3.35 TB/s
    and float32 operations over 67 TFLOP/s (F32_OPS_PER_S), the larger;
    and which binds."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
