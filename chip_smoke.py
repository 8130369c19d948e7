#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port (sp_coupler_tpu_torch).

Drives the port's two paths — the reference T21/L19 GCM coupled two-way to
2 LES instances of 64 x 64 x 160 (RICO), CFL/Peclet-adaptive, the case of
bench.py — on one CUDA card: the main path (Deardorff TKE closure) through
the hand-written CUDA stage kernel, and the Smagorinsky path (the split
tendency path) through the scalar and momentum kernels; then the
semi-Lagrangian GCM alone and the T159 regional case (T159/L19 SL GCM +
64 LES of 64 x 64 x 160, scripts/bench_t159.py) through the stage kernel.

Phases (any failure raises and exits non-zero):
  1. environment: torch / nvcc versions, card name and power limit;
  2. build the CUDA sources from this checkout, all at once (timed, with
     ptxas's register and spill lines);
  3. the stage kernel against its plain PyTorch version on the card, at
     STAGE_SHAPES: the main path's shapes (64x64x160, n = 1 and 2), a
     small one (16x16x32, n = 2), a ragged grid (12x10x20, n = 3), the
     smallest plane (4x4) and z-chunks that do not divide nz: the
     outputs, the increments out - base on their own, and kmax against a
     float64 run of the plain version, for the stage_inputs state and a
     rough one (rough_inputs), and at the T159 leg's batch (FLEET_SHAPES:
     64x64x160, n = 64) for stage_inputs; then each option of STAGE_OPTIONS
     (f_coriolis != 0, qt forcing modes 1-3) by its own effect; with
     CUDA-event timings of both and the kernel's bound;
  3b. the scalar (lesflat), momentum (lesmom) and un-flattened scalar
     (advect) kernels against their plain versions at STAGE_SHAPES (the
     same tiles, ragged grids and z-chunks), for the split_inputs state
     and a rough one (rough_split_inputs), each output array at the JAX
     tests' tolerance and at ARRAY_FRAC of its own max|ref|; with
     CUDA-event and device timings of both;
  4. a small coupled step (T10/L8 + 2 x 16x16x32) through the kernels
     against the same step through the plain split path, for each closure:
     the substep counts, the slab profiles and their change over the step;
  5. the main path: 2 coupled steps (first=True, then first=False); the
     stage kernel's launch count must equal 3 x the substeps taken;
  6. the Smagorinsky path: the same 2 coupled steps with
     LESPhysics(subgrid="smagorinsky"); the scalar and momentum kernels'
     launch counts must each equal 3 x the substeps taken, and the stage
     kernel must not run;
  7. the CLI (phase_cli), as a user runs the port: run_T21.sh's flags
     (T21/L19 + 2 x 64x64x160, columns 824/888, --cplsurf) through
     spmaster for 2 coupled steps, the second through call_phased; the
     stage kernel launches 3 x the substeps the run reports, the records
     are finite and timing.txt has its phase columns; then the same run
     restarted from its restart.npz appends a record; then a small run
     (T10/L8 + 2 x 16x16x32) with the Smagorinsky closure and the
     variability nudge, where lesflat and lesmom launch 3 x substeps.
     spifs.nc is not written (the card's host may lack h5py): the records
     go to MemoryWriter and are checked there, and a line says so. The
     run_T21.sh leg also writes the LES cross sections (les_cross,
     heights 2/40/80, dtav 60 s): les-work-<col>/cross.nc of both columns,
     written by the native writer (a Python fallback fails the phase),
     read back by the port's reader and by scipy;
  8. the seed: LESFleet.init_states at 2 x 64x64x160 on the card equals
     the CPU's start, moved to the card, bit for bit;
  9. the parity harness at full width (verify/parity.py, real mode:
     T21/L19 + 2 x 64x64x160, dt 600 s, dt_les 5 s) on the card through
     the stage kernel, held by parity.compare against the committed CPU
     run of the port and reported against the JAX package's (verify/ref/,
     PARITY_REFS); the stage kernel launches 3 x the substeps;
  10. the chunked step: one coupled step of the main path's case with
     evolve_chunks=3 from the start of an unchunked one; 3 x substeps
     launches, finite profiles within PROFILE_TOL[0] of the unchunked
     step's;
  11. the SL GCM alone (phase_gcm_sl): the JAX package's two 10-day T42
     guards (T42/L19, hybrid, SL, dt 1800 s, 481 steps; T42_GUARDS), the
     window interpolation against the gather one at T159 (WG_*), and
     CUDA-event times of each method's departure interpolation and of
     one SL step at T159/L19;
  12. the T159 regional case (phase_t159): the SL GCM at T159/L19 on the
     card against the port's CPU run from the same start for 3 steps
     (T159_*), then T159/L19 SL + 64 x 64x64x160 at the columns of
     bench_t159.py, dt_les 15 s, evolve_chunks 8, the batched fleet, 2
     coupled steps: finite profiles and GCM fields, the stage kernel's
     launches = 3 x the substeps of the batched loop; writes
     chiprun_out/chip_smoke_t159.json.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Run: python3 chip_smoke.py   (needs a CUDA card, nvcc and this checkout)
"""

import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time

import numpy as np
import torch

OUT_DIR = "chiprun_out"
# kernel name -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "lesstage": ("sp_coupler_tpu_torch/csrc/lesstage.cu",
                 "sp_coupler_tpu/ops/lesstage_pallas.py:167"),
    "lesflat": ("sp_coupler_tpu_torch/csrc/lesflat.cu",
                "sp_coupler_tpu/ops/lesflat_pallas.py:82"),
    "lesmom": ("sp_coupler_tpu_torch/csrc/lesmom.cu",
               "sp_coupler_tpu/ops/lesmom_pallas.py:38"),
    "advect": ("sp_coupler_tpu_torch/csrc/lesflat.cu",
               "sp_coupler_tpu/ops/advect_pallas.py:58"),
}
BUILDS = ("lesstage", "lesflat", "lesmom")   # the sources under csrc/
# the kernels each path runs, by LESPhysics.subgrid
PATH_KERNELS = {"tke": ("lesstage",), "smagorinsky": ("lesflat", "lesmom")}
# tolerances of the JAX package's own kernel check (tests/test_ops.py),
# on the stage's outputs base + f*tend, except kmax: it sits at the
# weakest-stratified level, where N^2 is a ~0.14 K difference of two
# ~300 K slab means of thv, so the last-bit rounding of thv moves it.
# phase 3 prints how far the kernel's and the float32 plain version's kmax
# lie from a float64 run of the plain version, for each input
FIELD_TOL = dict(atol=5e-4, rtol=1e-4)
KMAX_RTOL = 1e-3
RAIN_TOL = dict(atol=1e-10, rtol=1e-3)
USTAR2_RTOL = 1e-3
# The outputs' tolerance is far above the increments f*tend of w, qt, qr
# and e12, so the increments are held on their own: the stage is run
# again from INC_BASE, a base of constants small enough that float32
# holds base + increment to ~1e-6 of the increment and large enough that
# no clip acts, and out - base is held at INC_FRAC of max|increment| of
# the plain version (plus INC_RTOL). Float32 rounding of w's buoyancy
# (thv - <thv>, two ~300 K values) puts the plain version 3e-4 of
# max|dw| off its float64 run; every other field is within 1.2e-4. Two
# inputs: "stirred" (the state above: advection, microphysics and TKE
# sources dominate) and "calm" (u = v = w = qr = 0, where the scalar
# diffusion, surface fluxes and sponge are the whole thl and qt
# increments)
INC_BASE = dict(u=0.0, v=0.0, w=0.0, thl=0.0, qt=1e-3, qr=1e-4, e12=0.1)
INC_FRAC, INC_RTOL = 2e-3, 1e-3
# the grids of the tiled kernels (the stage kernel, and #2-#4 in phase
# 3b), (nx, ny, nz), n, tz (None: the levels per z-chunk of each kernel's
# launch geometry, ops/tiling.py). Beside the main path's: a grid whose
# last tile is ragged in y and wider than the plane in x, the smallest
# plane the kernels take, and z-chunks that do not divide nz (at
# 64x64x157, n = 2 the default chunks leave a last one of 17 levels for
# the stage, 3 for lesflat, 7 for lesmom)
STAGE_SHAPES = (((16, 16, 32), 2, None), ((64, 64, 160), 1, None),
                ((64, 64, 160), 2, None), ((12, 10, 20), 3, 6),
                ((4, 4, 9), 1, 4), ((16, 16, 32), 1, 5),
                ((64, 64, 157), 2, None))
# the stage kernel alone (phase 3) also at the T159 leg's batch: 64
# instances of 64x64x160 in one launch, for the smooth input
FLEET_SHAPES = (((64, 64, 160), 64, None),)
# physics options the main path does not take (LESPhysics fields), each
# held by its own effect: the change of the outputs from the default run,
# against the plain version's change, at INC_FRAC of its max (f_coriolis
# 1e-4 s^-1 is a mid-latitude value)
STAGE_OPTIONS = (dict(f_coriolis=1e-4), dict(qt_forcing=1),
                 dict(qt_forcing=2), dict(qt_forcing=3))
# change of the slab profiles over the small coupled step, kernel path
# against split path, as a fraction of the split path's max |change|
# (the kernel path's THL is 2.6e-3 off, QT 1.4e-4, on an NVIDIA H100
# 80GB HBM3 at 700 W)
COUPLED_FRAC = 1e-2
# kernels #2-#4 (lesflat, lesmom, advect) are held at the tolerance of the
# JAX package's own check of the Pallas kernels (tests/test_ops.py:42 for
# the scalar kernels, :125 for momentum) and, because an absolute tolerance
# cannot see a whole term of a small field (qr, dw), each output array
# (each scalar of the stack; du, dv, dw) also at ARRAY_FRAC of its own
# max|ref|. At the inputs of split_inputs the float32 plain version lies
# within 5e-7 of max|ref| of its float64 run, and the plain version with
# any one term removed (horizontal or vertical advection or diffusion; for
# momentum also w's diffusion or the m0 / fm masks) or with a fault of a
# tiled kernel (K read one level off; x and y swapped in the stencil)
# moves some array by 4.2e-3 of its max|ref| or more, at split_inputs and
# at rough_split_inputs (tests/test_torch_lesops.py)
SCALAR_TOL = dict(atol=2e-4, rtol=1e-4)
MOM_TOL = dict(atol=5e-5, rtol=1e-4)
ARRAY_FRAC = 1e-4
# a kernel's bound: the bytes it must move (each input read once, each
# output written once) over the H100's 3.35 TB/s, against its float
# operations over their issue rate. Operations per grid point, counted by
# hand from the CUDA sources (an add, multiply, divide, min/max, compare,
# sqrt, exp, log or pow is one; the saturation adjustment at its default
# 2 iterations): lesstage ~86 closure + ~100 thermodynamics + ~890
# tendencies and axpy + ~80 plane means; lesflat/advect 4 scalars x ~140;
# lesmom ~230. Each is one float32 instruction, issued at 128 a clock per
# SM: 33.5 T/s on 132 SMs at 1.98 GHz, half the data sheet's 67 TFLOP/s
# of float32 outside the tensor cores (SXM, 700 W), which counts a fused
# multiply-add as two operations
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
KERNEL_OPS = dict(lesstage=1160, lesflat=560, advect=560, lesmom=230)


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True
                          ).stdout.strip()


def phase_env():
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch.ops import _build
    log(run([_build.find_nvcc(), "--version"]).splitlines()[-1])
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    log("card:", card)
    return card


def phase_build():
    """Build every CUDA source, one nvcc each, all started together."""
    from sp_coupler_tpu_torch.ops import _build

    def one(name):
        t0 = time.time()
        _build.load(name)
        return time.time() - t0

    def native_writer():
        from sp_coupler_tpu_torch.io import spnc
        t0 = time.time()
        if spnc._load_lib() is None:
            raise AssertionError("the native netCDF writer "
                                 "(sp_coupler_tpu_torch/csrc/spnc.cpp) did "
                                 "not build")
        return time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(BUILDS) + 1) as ex:
        spnc_s = ex.submit(native_writer)
        secs = dict(zip(BUILDS, ex.map(one, BUILDS)))
        secs["spnc (g++)"] = spnc_s.result()
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in BUILDS:
        blog = _build.build_log(name)   # '' if this process built nothing
        if blog:
            with open(os.path.join(OUT_DIR, "build_%s.log" % name), "w") as f:
                f.write(blog)
        for line in blog.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                log("ptxas %s:" % name, line.strip())
        log("build: %s %.1f s" % (name, secs[name]))
    log("build: native netCDF writer spnc (g++) %.1f s" % secs["spnc (g++)"])
    log("build: all %.1f s" % (time.time() - t0))


def stage_inputs(grid, n, seed, dev="cuda"):
    """Physical fleet state (port init_state) with perturbed w and qr, as
    the JAX package's stage-kernel test (tests/test_ops.py:139-154). The
    CPU tests build the same inputs with dev="cpu"."""
    from sp_coupler_tpu_torch.models.les import state as lstate
    dev = torch.device(dev)
    nz = grid.nz
    gen = torch.Generator(device=dev).manual_seed(seed)
    rep = lambda a: torch.tensor(np.tile(np.asarray(a, np.float32), (n, 1)),
                                 device=dev)
    base = lstate.init_state(
        grid, rep(np.linspace(-5, 5, nz)), rep(np.zeros(nz)),
        rep(np.linspace(298, 312, nz)), rep(np.linspace(0.016, 0.002, nz)),
        101300.0, gen)
    shp = (n, nz, grid.ny, grid.nx)
    w = base.w.clone()
    w[:, 1:-1] = 0.1 * torch.randn((n, nz - 1, grid.ny, grid.nx),
                                   generator=gen, device=dev)
    qr = 1e-4 * torch.rand(shp, generator=gen, device=dev)
    base = base._replace(w=w, qr=qr)
    cur = base._replace(thl=base.thl + 0.05, u=base.u * 1.01)
    frc = lstate.LESForcing.zeros(n, nz, device=dev)
    full = lambda v: torch.full((n, nz), v, device=dev)
    frc = frc._replace(wthl=frc.wthl + 0.01, wqt=frc.wqt + 1e-5,
                       f_thl=full(1e-5), f_qt=full(-1e-9), f_u=full(1e-5),
                       f_v=full(-1e-5))
    dt = torch.full((n,), 2.0, device=dev)
    return cur, base, frc, dt


def rough_inputs(grid, n, seed, dev="cuda"):
    """The stage_inputs state made rough where a tiled kernel could misplace
    a term unseen: e12 per point in [0.02, 0.42] (Km, Kh and the TKE
    source vary in x, y and z), qt per point scaled by [0.6, 1.4] (the
    proportional qt forcing modes differ from the uniform one), v + 2 m/s
    (Coriolis acts on u), and f_qt of +-1e-5 alternating by level (qt mode
    3 takes both of its branches)."""
    cur, base, frc, dt = stage_inputs(grid, n, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    r = lambda: torch.rand(cur.thl.shape, generator=gen, device=dev)
    cur = cur._replace(e12=0.02 + 0.4 * r(), qt=cur.qt * (0.6 + 0.8 * r()),
                       v=cur.v + 2.0)
    sign = torch.tensor([(-1.0) ** k for k in range(grid.nz)], device=dev)
    frc = frc._replace(f_qt=(1e-5 * sign).expand(n, grid.nz).contiguous())
    return cur, base, frc, dt


def cuda_ms(fn, reps=20, warm=3):
    """Median time of fn() over reps calls, each timed with CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# the device kernels of each wrapper (part of their torch.profiler names),
# each launched once a call
DEVICE_KERNELS = dict(lesstage=("k_means", "k_stage"), lesflat=("k_scalars",),
                      advect=("k_scalars",), lesmom=("k_momentum",))


def device_us(fn, reps=20, expect=(), tries=3):
    """Device time per call of fn, by kernel name, in us: the mean time of
    a launch (torch.profiler, over reps calls after one warm-up call)
    times the launches a call makes. The profiler can lose records: one
    launch of a capture now and then, once every launch of one kernel (a
    capture of the stage kernel held k_means and not k_stage). So a
    kernel is timed by the launches it shows, and a capture in which a
    kernel named in `expect` does not show is taken again, up to `tries`
    times; then this raises."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by, count = {}, {}
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
                count[e.name] = count.get(e.name, 0) + 1
        if by and all(any(x in k for k in by) for x in expect):
            return {k: v / count[k] * max(1, round(count[k] / reps))
                    for k, v in by.items()}
    raise RuntimeError("the profiler saw %s in %d calls, not each of %s"
                       % (count, reps, expect))


def device_ms(fn, expect=()):
    """Device time per call of fn, every kernel it launches (ms); expect
    as for device_us."""
    return 1e-3 * sum(device_us(fn, expect=expect).values())


def check_close(name, got, ref, atol, rtol):
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: %d of %d elements out of tolerance, max "
                             "abs err %g" % (name, int(bad.sum()),
                                             got.numel(), float(err.max())))
    return float(err.max())


def check_increment(name, got, ref, base, frac, rtol):
    """Hold got - base against ref - base, at frac * max|ref - base|;
    returns the error as a fraction of that scale (0 if both are 0)."""
    d_ref = ref - base
    scale = float(d_ref.abs().max())
    err = check_close(name + " increment", got - base, d_ref, frac * scale,
                      rtol)
    return err / scale if scale > 0 else err


def as_f64(t):
    """A NamedTuple of tensors with its float tensors in float64."""
    return t._replace(**{k: v.double() for k, v in t._asdict().items()
                         if torch.is_tensor(v) and v.is_floating_point()})


def increment_base(cur):
    """The INC_BASE state of the shape of cur."""
    return cur._replace(**{k: torch.full_like(getattr(cur, k), v)
                           for k, v in INC_BASE.items()})


def increment_cases(cur):
    """(name, cur, base) of the increment checks, from a stirred state.
    The calm state has qr = 0, so its qr increment is autoconversion
    alone, >= 0 and as small as ~4e-9 at 64x64x160, where float32 holds
    it from a base of 1e-4 only to ~2e-3; its base has qr = 0, which
    holds it exactly and lets no clip act."""
    z = torch.zeros_like
    calm = cur._replace(u=z(cur.u), v=z(cur.v), w=z(cur.w), qr=z(cur.qr))
    return [("stirred", cur, increment_base(cur)),
            ("calm", calm, increment_base(calm)._replace(qr=z(calm.qr)))]


STAGE_NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")


def check_stage(kern, grid, phys, cur, base, frc, dt):
    """kern (the stage kernel or a stand-in with its signature) against
    the plain version from one input: the outputs at FIELD_TOL, kmax
    against the plain version and its float64 run at KMAX_RTOL, u*^2 and
    the rain flux; then the increments out - base of the stirred and the
    calm case at INC_FRAC. Returns (max abs err of the outputs, kmax rel
    err vs float64 of the kernel and of the float32 plain version, worst
    increment err / max|increment| per field)."""
    from sp_coupler_tpu_torch.ops import lesstage
    args = (grid, phys, cur, base, frc, 0.5, dt)
    got = kern(*args)
    ref = lesstage.stage_fused_reference(*args)
    ref64 = lesstage.stage_fused_reference(
        grid, phys, as_f64(cur), as_f64(base), as_f64(frc), 0.5, dt.double())
    worst = max(check_close(k, a, b, **FIELD_TOL)
                for k, a, b in zip(STAGE_NAMES, got[:7], ref[:7]))
    check_close("kmax", got[7], ref[7], 0.0, KMAX_RTOL)
    check_close("kmax vs float64", got[7].double(), ref64[7], 0.0, KMAX_RTOL)
    check_close("ustar2", got[8], ref[8], 0.0, USTAR2_RTOL)
    check_close("rain", got[9], ref[9], **RAIN_TOL)
    rel64 = lambda x: float((x.double() / ref64[7] - 1).abs().max())
    inc = dict.fromkeys(STAGE_NAMES, 0.0)
    for case, c, b in increment_cases(cur):
        a_ = (grid, phys, c, b, frc, 0.5, dt)
        g_, r_ = kern(*a_), lesstage.stage_fused_reference(*a_)
        for k, x, y in zip(STAGE_NAMES, g_[:7], r_[:7]):
            b_k = b.w[:, :-1] if k == "w" else getattr(b, k)
            inc[k] = max(inc[k], check_increment(
                "%s %s" % (case, k), x, y, b_k, INC_FRAC, INC_RTOL))
    return worst, rel64(got[7]), rel64(ref[7]), inc


def check_options(kern, grid, cur, frc, dt):
    """Each option of STAGE_OPTIONS through kern against the plain
    version, from cur and the increment base: the outputs at FIELD_TOL,
    and their change from the default physics against the plain version's
    change, at INC_FRAC of its max (a change that is 0 must be 0). Returns
    {option: worst change err / max|change|}."""
    from sp_coupler_tpu_torch.models.les import step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    base = increment_base(cur)
    run = lambda fn, phys: fn(grid, phys, cur, base, frc, 0.5, dt)
    k0 = run(kern, lstep.LESPhysics())
    p0 = run(lesstage.stage_fused_reference, lstep.LESPhysics())
    res = {}
    for opt in STAGE_OPTIONS:
        name = " ".join("%s=%g" % kv for kv in opt.items())
        phys = lstep.LESPhysics(**opt)
        k1, p1 = run(kern, phys), run(lesstage.stage_fused_reference, phys)
        res[name] = 0.0
        for k, a, b, a0, b0 in zip(STAGE_NAMES, k1[:7], p1[:7], k0[:7],
                                   p0[:7]):
            check_close("%s %s" % (name, k), a, b, **FIELD_TOL)
            res[name] = max(res[name], check_change(
                "%s %s" % (name, k), a - a0, b - b0))
    return res


def check_change(name, got, ref):
    """Hold a change got (kernel) against ref (plain version) at INC_FRAC
    of max|ref| plus INC_RTOL; returns the error / max|ref| (0 if both
    are 0)."""
    scale = float(ref.abs().max())
    err = check_close(name + " change", got, ref, INC_FRAC * scale, INC_RTOL)
    return err / scale if scale > 0 else err


def stage_bound(n, nz, ny, nx):
    """(bytes, float operations) the stage needs at this shape: 7 current
    fields, 7 base fields and the profiles read once, 7 fields and aux
    written once; KERNEL_OPS per point."""
    pts = n * nz * ny * nx
    return (4 * (21 * pts + n * (7 * nz + 1 + 4) + 3 * n),
            KERNEL_OPS["lesstage"] * pts)


def bound_ms(nbytes, ops):
    """The least time for the work on an H100 (SXM): bytes over 3.35 TB/s
    and float32 operations over 33.5 T/s (F32_OPS_PER_S), the larger; and
    which binds."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_kernel(card):
    """The stage kernel against its plain version, on the card."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    phys = lstep.LESPhysics()
    worst = 0.0
    times = {}
    shapes = ([(s, (stage_inputs, rough_inputs)) for s in STAGE_SHAPES]
              + [(s, (stage_inputs,)) for s in FLEET_SHAPES])
    for ((nx, ny, nz), n, tz), inputs_of in shapes:
        grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
        geom = lesstage.stage_geometry(n, nz, ny, nx, tz=tz)
        kern = lambda *a: lesstage.stage_fused_cuda(*a, tz=tz)
        label = "%dx%dx%d n=%d (tile %dx%d, tz %d, %d blocks)" % (
            nx, ny, nz, n, geom.tx, geom.ty, geom.tz, geom.blocks)
        for inputs in inputs_of:
            cur, base, frc, dt = inputs(grid, n, 7 + n)
            err, k64, p64, inc = check_stage(kern, grid, phys, cur, base,
                                             frc, dt)
            worst = max(worst, err)
            log("kernel lesstage %s, %s: outputs ok, max abs err %.3g; kmax "
                "rel err vs float64 plain: kernel %.3g, float32 plain %.3g; "
                "increments ok, err / max|increment|: %s"
                % (label, inputs.__name__, err, k64, p64,
                   " ".join("%s %.2g" % kv for kv in inc.items())))
        if inputs is rough_inputs:
            # the options act visibly on the rough input only (on the
            # smooth one the qt modes' change is below float32's
            # resolution of qt)
            opts = check_options(kern, grid, cur, frc, dt)
            log("  options ok, change err / max|change|: %s" % (
                " ".join("%s %.2g" % kv for kv in opts.items())))
        if tz is None:
            cur, base, frc, dt = stage_inputs(grid, n, 7 + n)
            args = (grid, phys, cur, base, frc, 0.5, dt)
            ms = cuda_ms(lambda: kern(*args))
            dev_ms = device_ms(lambda: kern(*args),
                               DEVICE_KERNELS["lesstage"])
            plain = cuda_ms(lambda: lesstage.stage_fused_reference(*args))
            b_ms, by = bound_ms(*stage_bound(n, nz, ny, nx))
            times[(nx, ny, nz, n)] = (ms, plain, b_ms, by, dev_ms)
            log("  %.3f ms by CUDA events, %.4f ms of device time (plain "
                "PyTorch %.3f ms); bound %.4f ms (%s), %.1f %% of the device "
                "time, on %s" % (ms, dev_ms, plain, b_ms, by,
                                 100 * b_ms / dev_ms, card))
    return worst, times


def split_inputs(grid, n, seed, dev="cuda"):
    """Inputs of kernels #2-#4 as the Smagorinsky path makes them from the
    stage_inputs state: u, v, w, the scalar stack [thl, qt, qr, e12] with
    Ks = [Kh, Kh, Kh, 2 Km] from the Smagorinsky closure, rhobf, rhobh and
    Km. The CPU tests build the same inputs with dev="cpu"."""
    from sp_coupler_tpu_torch.models.les import step as lstep, subgrid
    cur = stage_inputs(grid, n, seed, dev)[0]
    Km, Kh = subgrid.eddy_viscosity(grid, cur, lstep.thermodynamics(cur)[3])
    return dict(u=cur.u, v=cur.v, w=cur.w,
                Ks=torch.stack([Kh, Kh, Kh, 2.0 * Km], dim=1),
                scalars=torch.stack([cur.thl, cur.qt, cur.qr, cur.e12], dim=1),
                rhobf=cur.rhobf, rhobh=cur.rhobh, Km=Km)


def rough_split_inputs(grid, n, seed, dev="cuda"):
    """The split_inputs state made rough where a tiled kernel could misplace
    a term unseen: each scalar and each K (Ks and Km) scaled per point (by
    [0.99, 1.01] and [0.5, 1.5]), and u, v uniform in [-3, 3] m/s with a
    tenth of the faces exactly 0 (the upwind face value's sign(0) == 0)."""
    a = split_inputs(grid, n, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    r = lambda t: torch.rand(t.shape, generator=gen, device=dev)
    a.update(scalars=a["scalars"] * (0.99 + 0.02 * r(a["scalars"])),
             Ks=a["Ks"] * (0.5 + r(a["Ks"])), Km=a["Km"] * (0.5 + r(a["Km"])))
    for k in ("u", "v"):
        vel = 3.0 * (2.0 * r(a[k]) - 1.0)
        a[k] = torch.where(r(a[k]) < 0.1, torch.zeros_like(vel), vel)
    return a


def scalar_args(a, grid):
    return (a["u"], a["v"], a["w"], a["Ks"], a["scalars"], a["rhobf"],
            a["rhobh"], grid.dx, grid.dy, grid.dz)


def momentum_args(a, grid):
    return (a["u"], a["v"], a["w"], a["Km"], a["rhobf"], a["rhobh"],
            grid.dx, grid.dy, grid.dz)


def output_arrays(out):
    """The arrays a kernel's output is held by: each scalar of a stack
    [n, S, ...], or each of (du, dv, dw)."""
    return out.unbind(1) if torch.is_tensor(out) else out


def check_arrays(name, got, ref, tol):
    """Hold each output array of got against ref: at tol, and within
    ARRAY_FRAC of the array's own max|ref|. Returns each array's max abs
    error as a fraction of its max|ref|."""
    fracs = []
    for j, (a, b) in enumerate(zip(output_arrays(got), output_arrays(ref))):
        scale = float(b.abs().max())
        check_close("%s array %d" % (name, j), a, b, **tol)
        err = check_close("%s array %d vs its max|ref|" % (name, j), a, b,
                          ARRAY_FRAC * scale, 0.0)
        fracs.append(err / scale if scale > 0 else err)
    return fracs


def split_kernels():
    """(name, kernel launcher, plain version, args_of, tolerance, launch
    geometry of (args, tz)) of kernels #2-#4."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom, advect
    scal_geom = lambda a, tz: lesflat.scalar_geometry(
        a[0].shape[0], a[4].shape[1], *a[0].shape[1:], tz=tz)
    mom_geom = lambda a, tz: lesmom.momentum_geometry(*a[0].shape, tz=tz)
    return (
        ("lesflat", lesflat.advect_diffuse_scalars_cuda,
         lesflat.advect_diffuse_scalars_reference, scalar_args, SCALAR_TOL,
         scal_geom),
        ("lesmom", lesmom.momentum_tendencies_cuda,
         lesmom.momentum_tendencies_reference, momentum_args, MOM_TOL,
         mom_geom),
        ("advect", advect.advect_diffuse_scalars_cuda,
         advect.advect_diffuse_scalars_reference, scalar_args, SCALAR_TOL,
         scal_geom))


def phase_split_kernels(card):
    """Kernels #2-#4 against their plain versions, on the card, at
    STAGE_SHAPES for both inputs; timed at the shapes of the default
    geometry."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    res = {}
    for name, launch, plain, args_of, tol, geom_of in split_kernels():
        r = res[name] = dict(max_abs_err=0.0, times={})
        for (nx, ny, nz), n, tz in STAGE_SHAPES:
            grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
            kern = lambda *a: launch(*a, tz=tz)
            for inputs in (split_inputs, rough_split_inputs):
                args = args_of(inputs(grid, n, 11 + n), grid)
                got, ref = kern(*args), plain(*args)
                torch.cuda.synchronize()
                fracs = check_arrays(name, got, ref, tol)
                r["max_abs_err"] = max([r["max_abs_err"]] + [
                    float((a - b).abs().max())
                    for a, b in zip(output_arrays(got), output_arrays(ref))])
                g = geom_of(args, tz)
                log("kernel %s %dx%dx%d n=%d (tile %dx%d, tz %d, %d blocks), "
                    "%s: ok, err / max|ref| per array: %s"
                    % (name, nx, ny, nz, n, g.tx, g.ty, g.tz, g.blocks,
                       inputs.__name__, " ".join("%.2g" % f for f in fracs)))
            if tz is not None:
                continue
            args = args_of(split_inputs(grid, n, 11 + n), grid)
            ms = cuda_ms(lambda: kern(*args))
            dev_ms = device_ms(lambda: kern(*args), DEVICE_KERNELS[name])
            plain_ms = cuda_ms(lambda: plain(*args))
            b_ms, by = bound_ms(tensor_bytes(args, got),
                                KERNEL_OPS[name] * n * nz * ny * nx)
            r["times"][(nx, ny, nz, n)] = (ms, plain_ms, b_ms, by, dev_ms)
            log("  %.3f ms by CUDA events, %.4f ms of device time (plain "
                "PyTorch %.3f ms); bound %.4f ms (%s), %.1f %% of the device "
                "time, on %s" % (ms, dev_ms, plain_ms, b_ms, by,
                                 100 * b_ms / dev_ms, card))
    return res


def tensor_bytes(args, out):
    """Bytes of the tensors among args and of the outputs out: each input
    read once, each output written once."""
    ts = [a for a in args if torch.is_tensor(a)] + list(output_arrays(out))
    return sum(4 * t.numel() for t in ts)


def reset_launches():
    from sp_coupler_tpu_torch.ops import lesstage, lesflat, lesmom, advect
    for m in (lesstage, lesflat, lesmom, advect):
        m.launches = 0


def read_launches():
    from sp_coupler_tpu_torch.ops import lesstage, lesflat, lesmom, advect
    return dict(lesstage=lesstage.launches, lesflat=lesflat.launches,
                lesmom=lesmom.launches, advect=advect.launches)


def phase_small_coupled(card, subgrid="tke"):
    """A small coupled step through the kernels against the plain split
    path, with the given closure."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    cols = [100, 200]
    outs = []
    for use_kernel in (True, False):
        core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8,
                                                     dt=300.0))
        gs = core.initial_state(seed=0)
        les = seed_les(core, gs, grid, cols)
        phys = lstep.LESPhysics(subgrid=subgrid, use_kernel=use_kernel)
        fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0, n_substeps=0)
        prof = ldiag.slab_profiles(grid, les)
        reset_launches()
        out = fn(gs, les, prof, torch.zeros(2, device=core.device), 0,
                 first=True)
        counts = read_launches()
        ran = [k for k in PATH_KERNELS[subgrid] if counts[k] > 0]
        if use_kernel and len(ran) != len(PATH_KERNELS[subgrid]):
            raise AssertionError("kernel path of %s launched %s" % (subgrid,
                                                                   counts))
        if not use_kernel and any(counts.values()):
            raise AssertionError("plain path launched %s" % counts)
        outs.append((prof, out, fn.unpack_diag(out[4])))
    (p0, o_k, d_k), (_, o_p, d_p) = outs
    if not np.array_equal(d_k["n_substeps"], d_p["n_substeps"]):
        raise AssertionError("substeps differ: kernel %s, plain %s"
                             % (d_k["n_substeps"], d_p["n_substeps"]))
    gaps = {}
    for k in ("THL", "QT", "U", "V"):
        ref = o_p[2][k]
        scale = float(ref.abs().max())
        check_close("coupled " + k, o_k[2][k], ref, 2e-3 * scale, 2e-3)
        gaps[k] = check_increment("coupled " + k, o_k[2][k], ref, p0[k],
                                  COUPLED_FRAC, 0.0)
    log("small coupled step T10/L8 + 2x16x16x32, %s: kernel path == plain "
        "path (substeps %s); profile change err / max|change|: %s on %s"
        % (subgrid, [int(x) for x in d_k["n_substeps"]],
           " ".join("%s %.2g" % kv for kv in gaps.items()), card))


def seed_les(core, gs, grid, cols):
    """LES fleet started from the GCM column state (bench.py:49-61)."""
    from sp_coupler_tpu_torch.models.les import state as lstate
    from sp_coupler_tpu_torch.coupling import convert
    dev = core.device
    prof0 = core.column_profiles(gs, torch.as_tensor(cols, device=dev))
    conv0 = convert.convert_profiles(prof0, grid.zf(dev))
    gen = torch.Generator(device=dev).manual_seed(42)
    return lstate.init_state(grid, conv0.u, conv0.v, conv0.thl, conv0.qt,
                             conv0.ps, gen)


def main_path_case(subgrid="tke"):
    """The bench.py case on the port: T21/L19 + 2 x 64x64x160 (RICO),
    columns 1208/1272, adaptive with dt_les 15 s, with the given LES
    closure. Returns the step function and its start (gcm state, LES
    fleet, profiles, rain)."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=21, nlev=19,
                                                 dt=900.0))
    if core.device.type != "cuda":
        raise AssertionError("GCMCore took %s, not the card" % core.device)
    grid = lgrid.LESGrid()
    cols = [1208, 1272]
    gs = core.initial_state(seed=0)
    les = seed_les(core, gs, grid, cols)
    fn = CoupledStepFn(core, grid, lstep.LESPhysics(subgrid=subgrid), cols,
                       dt_les=15.0, n_substeps=0)
    prof = ldiag.slab_profiles(grid, les)
    return fn, (gs, les, prof, torch.zeros(len(cols), device=core.device))


def phase_main(card, subgrid="tke"):
    """A path at full width: 2 coupled steps of the bench.py case with the
    given closure. Returns the kernels' launch counts of the run."""
    fn, (gs, les, prof, rain) = main_path_case(subgrid)
    grid = fn.grid
    torch.cuda.synchronize()
    reset_launches()
    total_sub = 0
    steps = []
    for step, first in ((0, True), (1, False)):
        t0 = time.time()
        gs, les, prof, rain, diag = fn(gs, les, prof, rain, step,
                                       first=first)
        torch.cuda.synchronize()
        wall = time.time() - t0
        d = fn.unpack_diag(diag)
        nsub = [int(x) for x in d["n_substeps"]]
        for k in ("THL", "QT"):
            if not bool(torch.isfinite(prof[k]).all()):
                raise AssertionError("non-finite %s after step %d" % (k, step))
        if tuple(prof["THL"].shape) != (2, grid.nz):
            raise AssertionError("THL profile shape %s" % (prof["THL"].shape,))
        if min(nsub) <= 0:
            raise AssertionError("no substeps taken: %s" % nsub)
        total_sub += sum(nsub)
        rate = grid.nx * grid.ny * grid.nz * sum(nsub) / wall
        steps.append(dict(first=first, wall_s=wall, substeps=nsub,
                          gridpoint_updates_per_s=rate))
        log("%s path step %d (first=%s): %.3f s, substeps %s, %.4g LES "
            "gridpoint-updates/s on %s" % (subgrid, step, first, wall, nsub,
                                           rate, card))
    launches = read_launches()
    for k, count in launches.items():
        want = 3 * total_sub if k in PATH_KERNELS[subgrid] else 0
        if count != want:
            raise AssertionError("%s path: %s launches %d, want %d (3 x %d "
                                 "substeps on the path's kernels)"
                                 % (subgrid, k, count, want, total_sub))
    log("%s path: launches %s for %d substeps" % (subgrid, launches,
                                                  total_sub))
    os.makedirs(OUT_DIR, exist_ok=True)
    out = "chip_smoke_main%s.json" % ("" if subgrid == "tke"
                                      else "_" + subgrid)
    with open(os.path.join(OUT_DIR, out), "w") as f:
        json.dump(dict(card=card, subgrid=subgrid, steps=steps,
                       launches=launches), f, indent=1)
    return launches, steps


def phase_seed(card):
    """LESFleet.init_states at 2 x 64x64x160 on the card: bitwise the
    start it gives on the CPU, moved to the card (the draws come from CPU
    generators keyed by (seed, instance))."""
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 model as les_model)
    grid = lgrid.LESGrid()
    prof = lambda a: np.tile(np.asarray(a, np.float32), (2, 1))
    args = (prof(np.linspace(-5.0, 5.0, grid.nz)), prof(np.full(grid.nz, 2.0)),
            prof(np.linspace(298.0, 312.0, grid.nz)),
            prof(np.linspace(0.016, 0.002, grid.nz)),
            np.full(2, 101300.0, np.float32))
    states = {}
    for dev in ("cuda", "cpu"):
        fleet = les_model.LESFleet(grid, lstep.LESPhysics(), 2, 15.0,
                                   device=dev)
        fleet.init_states(*args)
        states[dev] = fleet.state
    for name, a, b in zip(states["cpu"]._fields, states["cuda"],
                          states["cpu"]):
        if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
            raise AssertionError("init_states on the card differs from the "
                                 "CPU's in %s" % name)
    log("seed: LESFleet.init_states at 2 x %dx%dx%d on the card == the "
        "CPU's, bit for bit (%d fields) on %s"
        % (grid.nx, grid.ny, grid.nz, len(states["cpu"]), card))


# the parity harness's full-width reference runs on the CPU, and whether
# the card's run is held against each. The card starts from the port's
# CPU run's state, so it is held against that run. The JAX run starts
# from other draws (jax.random for the GCM's vorticity perturbation and
# the LES noise) and leaves PROFILE_TOL on the CPU already (the GCM's
# winds differ by up to 43 m/s at the start: PARITY_H100.md), so the
# card's run is only reported against it
PARITY_REFS = (("torch", "parity_real_torch_cpu.npz", True),
               ("jax", "parity_real_jax_cpu.npz", False))


def phase_parity(card):
    """verify/parity.py's real case on the card, through the stage kernel,
    held against the committed CPU runs. Returns the launch counts."""
    from sp_coupler_tpu_torch.verify import parity
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    ref_dir = os.path.join(os.path.dirname(parity.__file__), "ref")
    with np.load(os.path.join(ref_dir, PARITY_REFS[0][1])) as ref:
        n_steps = 1 + max(int(k[4:k.index("_")]) for k in ref.files)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "parity_real_h100.npz")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    _, substeps = parity.run(path, n_steps=n_steps, device="cuda",
                             **parity.REAL)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    grid = lgrid.LESGrid(nx=parity.REAL["les_n"], ny=parity.REAL["les_n"],
                         nz=parity.REAL["les_nz"])
    per_step = np.sum if lstep.serial_fleet_default(grid) else np.max
    total = int(sum(per_step(s) for s in substeps))
    for k, count in launches.items():
        want = 3 * total if k == "lesstage" else 0
        if count != want or (k == "lesstage" and count == 0):
            raise AssertionError("parity: %s launches %d, want %d (3 x %d "
                                 "substeps)" % (k, count, want, total))
    log("parity real (T21/L19 + 2 x 64x64x160, dt 600 s, dt_les 5 s): %d "
        "steps in %.3f s, substeps %s, launches %s on %s"
        % (n_steps, wall, substeps, launches, card))
    res = dict(card=card, steps=n_steps, wall_s=wall, substeps=substeps,
               launches=launches, against={})
    failed = []
    for name, fname, enforced in PARITY_REFS:
        ref_path = os.path.join(ref_dir, fname)
        diffs = parity.diffs(ref_path, path)
        ok = parity.compare(ref_path, path, verbose=False)
        res["against"][name] = dict(file=fname, enforced=enforced, ok=ok,
                                    diffs=diffs)
        log("parity vs %s (%s): %s, enforced %s; max rel diff by key: %s"
            % (name, fname, "PASS" if ok else "FAIL", enforced,
               " ".join("%s %.3g" % kv for kv in diffs.items())))
        if enforced and not ok:
            failed.append(name)
    with open(os.path.join(OUT_DIR, "chip_smoke_parity.json"), "w") as f:
        json.dump(res, f, indent=1)
    if failed:
        raise AssertionError("parity: the card's run is outside PROFILE_TOL "
                             "of %s" % failed)
    return launches


def phase_chunked(card):
    """One coupled step of the main path's case with evolve_chunks=3 from
    the start of an unchunked step: 3 x substeps launches, finite profiles
    within PROFILE_TOL[0] of the unchunked step's (the card's CFL dt makes
    the substep sequences differ; their exact equality is a CPU test).
    At this size the fleet runs serially, so the kernel launches once per
    substep of each instance. Returns the chunked step's launch counts."""
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    from sp_coupler_tpu_torch.verify import parity
    fn, start = main_path_case()
    fn3 = CoupledStepFn(fn.core, fn.grid, fn.phys, fn.cols.tolist(),
                        dt_les=fn.dt_les, n_substeps=0, evolve_chunks=3,
                        serial_evolve=fn.serial_evolve)
    out = {}
    for k, f in ((1, fn), (3, fn3)):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        res = f(*start, 0, first=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
        nsub = [int(x) for x in f.unpack_diag(res[4])["n_substeps"]]
        out[k] = (res[2], nsub, launches)
        log("chunked: evolve_chunks=%d: %.3f s, substeps %s, launches %s on "
            "%s" % (k, wall, nsub, launches, card))
    prof3, nsub3, launches = out[3]
    for k, count in launches.items():
        want = 3 * sum(nsub3) if k == "lesstage" else 0
        if count != want or (k == "lesstage" and count == 0):
            raise AssertionError("chunked: %s launches %d, want %d (3 x %s "
                                 "substeps)" % (k, count, want, nsub3))
    gaps = {}
    for key in ("THL", "QT", "U"):
        a, b = out[1][0][key], prof3[key]
        if not bool(torch.isfinite(b).all()):
            raise AssertionError("chunked: non-finite %s" % key)
        gaps[key] = float((a - b).abs().max() / a.abs().max())
        if gaps[key] > parity.PROFILE_TOL[0]:
            raise AssertionError("chunked: %s %.3g of max|unchunked| off, "
                                 "over %g" % (key, gaps[key],
                                              parity.PROFILE_TOL[0]))
    log("chunked: profiles of 3 chunks against 1, max rel diff: %s (tol %g)"
        % (" ".join("%s %.3g" % kv for kv in gaps.items()),
           parity.PROFILE_TOL[0]))
    return launches


def check_cross(odir, cols, n_steps, grid):
    """les-work-<col>/cross.nc of each column: the native writer wrote it,
    the port's reader and scipy read it, thlxy* planes ny x nx with at
    least one record a step, finite water paths."""
    from scipy.io import netcdf_file
    from sp_coupler_tpu_torch.io import spnc
    if spnc._load_lib() is None:
        raise AssertionError("cross.nc: the native writer is not loaded "
                             "(the Python fallback wrote it)")
    shapes = {}
    for col in cols:
        path = os.path.join(odir, "les-work-%d" % col, "cross.nc")
        if not os.path.isfile(path):
            raise AssertionError("cross.nc missing: %s" % path)
        data, units = spnc.read_cdf(path)
        planes = sorted(k for k in data if k.startswith("thlxy"))
        for k in planes:
            shp = np.asarray(data[k]).shape
            if shp[1:] != (grid.ny, grid.nx) or shp[0] < n_steps:
                raise AssertionError("cross.nc %d %s shape %s" % (col, k, shp))
        if len(planes) != 3 or not np.all(np.isfinite(data["lwp"])) or \
                units["lwp"] != "kg/m^2":
            raise AssertionError("cross.nc %d: planes %s, lwp finite %s"
                                 % (col, planes,
                                    bool(np.all(np.isfinite(data["lwp"])))))
        f = netcdf_file(path, "r", mmap=False)
        try:
            np.testing.assert_array_equal(f.variables[planes[0]][:],
                                          data[planes[0]])
        finally:
            f.close()
        shapes[col] = {k: list(np.asarray(data[k]).shape) for k in planes}
    return shapes


# run_T21.sh's flags (its polygon of SP columns near Barbados, 2 LES
# instances, surface coupling) and the columns they select on the T21 grid
RUN_T21 = ["--gcmexp", "TEST", "--poly", "20", "-50", "10", "-50", "10",
           "-40", "20", "-40", "--numles", "2", "--cplsurf"]
RUN_T21_COLS = [824, 888]


class MemoryWriter:
    """A spifs.nc writer (``spifs.SpifsWriter``'s calls) that keeps every
    record in memory: the card's host may have no h5py, which the file
    needs. The records of a path outlive the writer in STORE, so that a
    restarted run appends to them as it would to the file."""

    STORE = {}

    def __init__(self, path, gcm_ktot, les_info=None, start_time=None,
                 append=False, with_surf_vars=True, compress=0):
        if not append:
            MemoryWriter.STORE[path] = {"Time": [], "groups": {}}
        self.rec = MemoryWriter.STORE[path]
        self.step = len(self.rec["Time"]) - 1

    def add_les_column(self, index, lat, lon):
        self.rec["groups"].setdefault(int(index), {})

    add_output_column = add_les_column

    def update_time(self, t):
        self.rec["Time"].append(float(t))
        self.step = len(self.rec["Time"]) - 1

    def write_column(self, index, lock=False, **kwargs):
        g = self.rec["groups"][int(index)]
        for var, arr in kwargs.items():
            g.setdefault(var, {})[self.step] = np.asarray(arr, np.float32)

    def sync(self):
        pass

    def close(self):
        pass


def read_records(path):
    """(Time list, {column: {var: [records, ...] array}}) of a run's
    output kept by MemoryWriter."""
    rec = MemoryWriter.STORE[path]
    groups = {col: {var: np.stack([r[i] for i in sorted(r)])
                    for var, r in g.items()}
              for col, g in rec["groups"].items()}
    return list(rec["Time"]), groups


def cli_leg(argv, writer):
    """One run through the port's CLI (spmaster.build_runner + drive, as
    spmaster.main), each step timed on the host clock; the launch counts
    are set to 0 just before it and read just after; the cross-section
    writes inside the steps are timed too (runner.cross_walls). Returns
    (runner, step walls, launches)."""
    from sp_coupler_tpu_torch import spmaster
    runner = spmaster.build_runner(argv, writer=writer)
    if runner.device.type != "cuda":
        raise AssertionError("the CLI took %s, not the card" % runner.device)
    walls, step = [], runner.step
    runner.cross_walls, write_cross = [], runner._write_cross

    def timed_cross(t):
        t0 = time.time()
        write_cross(t)
        runner.cross_walls.append(time.time() - t0)

    runner._write_cross = timed_cross

    def timed_step():
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)

    runner.step = timed_step
    torch.cuda.synchronize()
    reset_launches()
    rc = spmaster.drive(runner)
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        raise AssertionError("spmaster %s exited %d" % (" ".join(argv), rc))
    return runner, walls, launches


def check_leg_launches(name, runner, launches, kernels):
    """The path's kernels launched 3 x the substeps the run reports, the
    others not at all. A serial fleet launches once per substep of each
    instance; a batched one (small instances) once per substep of the
    fleet, as many as its slowest instance takes."""
    per_step = np.sum if runner.fleet.serial else np.max
    total = int(sum(per_step(s) for s in runner.substeps))
    for k, count in launches.items():
        want = 3 * total if k in kernels else 0
        if count != want or (k in kernels and count == 0):
            raise AssertionError("%s: %s launches %d, want %d (3 x %d "
                                 "substeps)" % (name, k, count, want, total))


def check_finite_records(name, groups, cols, n_rec, variables):
    for col in cols:
        for var in variables:
            a = groups[col][var]
            if a.shape[0] != n_rec or not np.all(np.isfinite(a)):
                raise AssertionError("%s: column %d %s has shape %s, finite "
                                     "%s" % (name, col, var, a.shape,
                                             bool(np.all(np.isfinite(a)))))


def timing_rows(odir):
    """timing.txt: (its header lines, its step rows as float lists)."""
    with open(os.path.join(odir, "timing.txt")) as f:
        lines = f.read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    rows = [[float(x) for x in ln.split()] for ln in lines
            if not ln.startswith("#")][1:]
    return head, rows


def phase_cli(card, main_steps):
    """run_T21.sh's run through the port's CLI on the card, its restart,
    and a small Smagorinsky leg with the variability nudge.
    main_steps: phase_main's step records of the same 2 steps through the
    bare CoupledStepFn, printed beside the CLI's."""
    import importlib.util
    import tempfile
    writer = MemoryWriter
    have_h5py = importlib.util.find_spec("h5py") is not None
    log("cli: spifs.nc is not written (h5py %s here): the records are "
        "kept in memory (MemoryWriter) and checked there; the file format "
        "is held by the CPU tests" % ("imports" if have_h5py
                                      else "does not import"))
    res = dict(card=card, h5py=have_h5py)
    with tempfile.TemporaryDirectory() as tmp:
        odir = os.path.join(tmp, "run_T21")
        conf = os.path.join(tmp, "phases.json")
        with open(conf, "w") as f:
            json.dump({"timing_phases": 1, "les_cross": True,
                       "les_cross_heights": [2, 40, 80],
                       "les_cross_dtav": 60.0}, f)
        spifs_path = os.path.join(odir, "spifs.nc")
        # 1. run_T21.sh's flags, 2 coupled steps (--steps 1 + the overlap)
        argv = RUN_T21 + ["--steps", "1", "--conf", conf, "--odir", odir]
        runner, walls, launches = cli_leg(argv, writer)
        if runner.sp_cols != RUN_T21_COLS:
            raise AssertionError("run_T21.sh's polygon selected %s, not %s"
                                 % (runner.sp_cols, RUN_T21_COLS))
        check_leg_launches("cli run_T21", runner, launches,
                           PATH_KERNELS["tke"])
        times, groups = read_records(spifs_path)
        if len(times) != 2:
            raise AssertionError("cli run_T21: %d records, want 2"
                                 % len(times))
        check_finite_records("cli run_T21", groups, RUN_T21_COLS, 2,
                             ("thl", "f_T", "A_d", "z0m", "wthl", "rain"))
        head, rows = timing_rows(odir)
        if not head or not head[0].startswith("# LES grid points") or \
                len(rows) != 2:
            raise AssertionError("timing.txt: header %s, %d step rows"
                                 % (head, len(rows)))
        if not (rows[1][1] > 0.0 and rows[1][5] > 0.0):
            raise AssertionError("call_phased row without pre/post: %s"
                                 % rows[1])
        grid = runner.fleet.grid
        pts = grid.nx * grid.ny * grid.nz
        legs = [dict(name="run_T21", steps=[
            dict(wall_s=w, substeps=s, io_s=r[-1],
                 gridpoint_updates_per_s=pts * sum(s) / w)
            for w, s, r in zip(walls, runner.substeps, rows)],
            launches=launches, phased_row=rows[1])]
        for i, st in enumerate(legs[0]["steps"]):
            log("cli run_T21 step %d: %.3f s, substeps %s, %.4g LES "
                "gridpoint-updates/s, host I/O column %.2f s (bare "
                "CoupledStepFn, phase_main: %.3f s, substeps %s) on %s"
                % (i, st["wall_s"], st["substeps"],
                   st["gridpoint_updates_per_s"], st["io_s"],
                   main_steps[i]["wall_s"], main_steps[i]["substeps"], card))
        log("cli run_T21: columns %s, launches %s, call_phased row %s"
            % (runner.sp_cols, launches, rows[1]))
        cross = check_cross(odir, RUN_T21_COLS, 2, grid)
        legs[0]["cross"] = dict(shapes=cross, write_s=runner.cross_walls)
        log("cli run_T21: les-work-<col>/cross.nc by the native writer, "
            "read by spnc.read_cdf and scipy: %s; the writes took %s s in "
            "the steps" % (cross, ["%.4f" % w for w in runner.cross_walls]))

        # 2. the restart: loads restart.npz, appends one record
        runner, walls, launches = cli_leg(argv + ["--restart"], writer)
        times, groups = read_records(spifs_path)
        if len(times) != 3 or launches["lesstage"] == 0:
            raise AssertionError("cli restart: %d records (want 3), "
                                 "launches %s" % (len(times), launches))
        check_finite_records("cli restart", groups, RUN_T21_COLS, 3,
                             ("thl", "f_T", "A_d", "z0m", "wthl", "rain"))
        legs.append(dict(name="restart", walls=walls, launches=launches,
                         times=times))
        log("cli restart: %d records at %s s, step walls %s, launches %s"
            % (len(times), times, ["%.3f" % w for w in walls], launches))

        # 3. small: Smagorinsky split path + the variability nudge
        odir3 = os.path.join(tmp, "nudge")
        conf3 = os.path.join(tmp, "small.json")
        with open(conf3, "w") as f:
            json.dump({"les_itot": 16, "les_jtot": 16, "les_ktot": 32,
                       "les_subgrid": "smagorinsky", "timing_phases": 0}, f)
        argv3 = ["--trunc", "10", "--levels", "8", "--steps", "1",
                 "--points", "15", "-50", "--numles", "2", "--qt_forcing",
                 "variance", "--conf", conf3, "--odir", odir3]
        runner, walls, launches = cli_leg(argv3, writer)
        check_leg_launches("cli nudge", runner, launches,
                           PATH_KERNELS["smagorinsky"])
        times, groups = read_records(os.path.join(odir3, "spifs.nc"))
        cols = runner.sp_cols
        check_finite_records("cli nudge", groups, cols, 2,
                             ("thl", "qt_std", "qt_beta"))
        for col in cols:
            # the nudge is not applied on the first step (its diagnostics
            # stay 0) and is on the second (beta > 0, qt_std > 0)
            g = groups[col]
            if not (np.all(g["qt_beta"][0] == 0.0)
                    and np.all(g["qt_beta"][1] > 0.0)
                    and np.all(g["qt_std"][1] > 0.0)):
                raise AssertionError("cli nudge: column %d qt_beta %s, "
                                     "qt_std of step 2 %s"
                                     % (col, g["qt_beta"], g["qt_std"][1]))
        legs.append(dict(name="nudge", walls=walls, launches=launches,
                         substeps=runner.substeps, columns=cols))
        log("cli nudge (T10/L8 + 2 x 16x16x32, Smagorinsky, qt_forcing "
            "variance): columns %s, substeps %s, launches %s, qt_std step 2 "
            "max %s on %s" % (cols, runner.substeps, launches,
                              [float(groups[c]["qt_std"][1].max())
                               for c in cols], card))
    res["legs"] = legs
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_cli.json"), "w") as f:
        json.dump(res, f, indent=1)
    return [leg["launches"] for leg in legs]


# ---- the semi-Lagrangian GCM -------------------------------------------

# the JAX package's 10-day T42 guards (tests/test_gcm.py:166-243): T42/L19,
# hybrid levels, SL, dt 1800 s, the Euler start and 480 steps; the bounds
# on T and |u| (and q) after day 10 are the JAX tests'. "hs94" is the dry
# Held-Suarez configuration, "moist" the default physics
T42_GUARDS = {
    "hs94": dict(T=(140.0, 350.0), umax=200.0, qmax=None),
    "moist": dict(T=(150.0, 340.0), umax=150.0, qmax=0.05),
}
# window against gather (tests/test_gcm.py:424-467): random displacements
# of up to WG_DLON x 128 / nlon in longitude and WG_DLAT x 64 / nlat in
# latitude (the same number of cells as the JAX test's 0.1 and 0.05 rad
# at T42), taps equal to WG_TOL, level-chunked window to WG_CHUNK_TOL;
# the ladder is sized for dt WG_DT, the T159 case's
WG_DLON, WG_DLAT, WG_TOL, WG_CHUNK_TOL = 0.1, 0.05, 1e-5, 1e-4
WG_DT = 900.0


def gcm_core(dev, **kw):
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    core = gcm_model.GCMCore(gcm_model.GCMConfig(**kw), device=dev)
    if core.device.type != torch.device(dev).type:
        raise AssertionError("GCMCore took %s, not %s" % (core.device, dev))
    return core


def t42_guard(name, card):
    """One 10-day T42 guard on the card: returns its record."""
    from sp_coupler_tpu_torch.models.gcm import physics
    kw = dict(trunc=42, nlev=19, dt=1800.0, hybrid=True, advection="sl")
    if name == "hs94":
        kw["phys"] = physics.PhysicsParams(
            dtheta_z=10.0, tau_rad=40.0 * 86400.0,
            tau_rad_sfc=4.0 * 86400.0, rayleigh_tau=86400.0)
    core = gcm_core("cuda", **kw)
    state = core.initial_state(seed=3)
    if name == "hs94":
        z = torch.zeros_like
        dry = state.now._replace(q=z(state.now.q), ql=z(state.now.ql),
                                 qi=z(state.now.qi), a=z(state.now.a))
        state = state._replace(now=dry, prev=dry, new=dry,
                               vdiff_mask=z(state.vdiff_mask))
    torch.cuda.synchronize()
    t0 = time.time()
    state = core.step(state, first=True)
    for day in range(10):
        for _ in range(48):
            state = core.step(state)
        if not bool(torch.isfinite(state.now.vort).all()):
            raise AssertionError("t42 %s: non-finite vorticity after day %d"
                                 % (name, day + 1))
    torch.cuda.synchronize()
    wall = time.time() - t0
    g, b = state.grid, T42_GUARDS[name]
    fields = ("u", "v", "T") + (("q",) if b["qmax"] else ())
    for k in fields:
        if not bool(torch.isfinite(getattr(g, k)).all()):
            raise AssertionError("t42 %s: non-finite %s" % (name, k))
    rec = dict(T_min=float(g.T.min()), T_max=float(g.T.max()),
               u_max=float(g.u.abs().max()), wall_s=wall,
               steps_per_s=481 / wall)
    ok = (b["T"][0] < rec["T_min"] and rec["T_max"] < b["T"][1]
          and rec["u_max"] < b["umax"])
    if b["qmax"]:
        rec["q_max"] = float(g.q.max())
        ok = ok and rec["q_max"] < b["qmax"]
    log("gcm_sl: 10-day T42/L19 %s guard (hybrid, SL, dt 1800 s, 481 "
        "steps): %s, bounds %s, %.2f s (%.1f steps/s) on %s"
        % (name, " ".join("%s %.4g" % kv for kv in rec.items()), b, wall,
           rec["steps_per_s"], card))
    if not ok:
        raise AssertionError("t42 %s: outside the JAX test's bounds" % name)
    return rec


def window_vs_gather(sht, dev="cuda"):
    """tests/test_gcm.py:424-467 at this truncation on the card: the
    window path (one band, and the dt-sized ladder whole and level-chunked)
    against the gather path from random in-window targets. Returns the
    max differences."""
    from sp_coupler_tpu_torch.models.gcm import semilag
    slg_g = semilag.SLGrid(sht, method="gather")
    slg_w = semilag.SLGrid(sht, method="window")
    slg_b = semilag.SLGrid(sht, method="window", dt=WG_DT)
    rows = sorted((r0, r1) for segs, _ in slg_b.lon_bands for r0, r1 in segs)
    if rows[0][0] != 0 or rows[-1][1] != sht.nlat or any(
            a[1] != b[0] for a, b in zip(rows, rows[1:])):
        raise AssertionError("the window ladder does not partition the "
                             "rows: %s" % slg_b.lon_bands)
    rng = np.random.default_rng(0)
    shp = (4, sht.nlat, sht.nlon)
    lam = 2 * np.pi * np.arange(sht.nlon) / sht.nlon
    phi = np.arcsin(sht.mu.cpu().numpy())
    dl = rng.uniform(-1, 1, shp) * WG_DLON * 128 / sht.nlon
    dp = rng.uniform(-1, 1, shp) * WG_DLAT * 64 / sht.nlat
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    fields = t(rng.standard_normal((3,) + shp))
    lam_t = t(np.remainder(lam[None, None] + dl, 2 * np.pi))
    phi_t = t(np.clip(phi[None, :, None] + dp, -np.pi / 2 + 1e-4,
                      np.pi / 2 - 1e-4))
    err = {}
    for cubic in (True, False):
        a = slg_g.interp(fields, lam_t, phi_t, cubic=cubic)
        for name, slg in (("window", slg_w), ("window_dt", slg_b)):
            key = "%s %s" % (name, "cubic" if cubic else "linear")
            err[key] = float((a - slg.interp(fields, lam_t, phi_t,
                                             cubic=cubic)).abs().max())
            if not err[key] < WG_TOL:
                raise AssertionError("gcm_sl: %s off gather by %g"
                                     % (key, err[key]))
    cs = slg_b.clamp_stats(lam_t, phi_t)
    if float(cs["lon"]) != 0.0 or float(cs["lat"]) != 0.0:
        raise AssertionError("gcm_sl: in-window targets clamped: %s" % cs)
    ref = slg_b.interp(fields, lam_t, phi_t)
    slg_b.k_chunk = 2
    err["window_dt chunked"] = float(
        (ref - slg_b.interp(fields, lam_t, phi_t)).abs().max())
    if not err["window_dt chunked"] < WG_CHUNK_TOL:
        raise AssertionError("gcm_sl: chunked window off by %g"
                             % err["window_dt chunked"])
    return err


def phase_gcm_sl(card):
    """The SL GCM alone on the card: the JAX package's two 10-day T42
    guards, window against gather at T159, and CUDA-event times of each
    method's departure interpolation and of one SL step at T159/L19.
    Returns its record."""
    from sp_coupler_tpu_torch.models.gcm import semilag
    rec = dict(card=card, t42={k: t42_guard(k, card) for k in T42_GUARDS})
    core = gcm_core("cuda", trunc=159, nlev=19, dt=900.0, advection="sl")
    rec["window_vs_gather"] = window_vs_gather(core.sht)
    log("gcm_sl: window == gather at T159 (%dx%d) within %g (chunked %g): "
        "%s" % (core.nlat, core.nlon, WG_TOL, WG_CHUNK_TOL,
                " ".join("%s %.3g" % kv
                         for kv in rec["window_vs_gather"].items())))
    # the departure interpolation of a leapfrog step from a state one
    # Euler step in: [8, 19, 240, 480] fields at the real departure points
    state = core.step(core.initial_state(seed=0), first=True)
    sht, vc, tau = core.sht, core.vc, 2.0 * core.cfg.dt
    traj = semilag.sl_trajectories(sht, vc, core.slg, state.now, tau)
    dep = semilag.sl_dep_stack(sht, vc, core.slg, state.now, state.prev,
                               tau)["dep"]
    lam_d, phi_d = traj["angd"][:2]
    times = {}
    vals = {}
    for method in ("gather", "window"):
        slg = semilag.SLGrid(sht, method=method, dt=core.cfg.dt)
        vals[method] = slg.interp(dep, lam_d, phi_d)
        times["interp_%s_ms" % method] = cuda_ms(
            lambda: slg.interp(dep, lam_d, phi_d), reps=10, warm=2)
        if method == "window":
            cs = slg.clamp_stats(lam_d, phi_d)
            rec["window_clamped"] = {k: float(v) for k, v in cs.items()}
    rec["dep_window_vs_gather"] = float(
        (vals["gather"] - vals["window"]).abs().max()
        / vals["gather"].abs().max())
    times["sl_dynamics_ms"] = cuda_ms(
        lambda: core._phase_a_dyn(state, False), reps=5, warm=1)
    times["step_ms"] = cuda_ms(lambda: core.step(state), reps=5, warm=1)
    rec["times"] = times
    log("gcm_sl: T159/L19 departure interpolation of [8, 19, 240, 480] "
        "(cubic): gather %.3f ms, window %.3f ms (window/gather max rel "
        "diff %.3g, clamped %s); SL dynamics %.3f ms, a whole step %.3f ms, "
        "by CUDA events on %s"
        % (times["interp_gather_ms"], times["interp_window_ms"],
           rec["dep_window_vs_gather"], rec["window_clamped"],
           times["sl_dynamics_ms"], times["step_ms"], card))
    return rec


# ---- the T159 regional case (scripts/bench_t159.py) ----------------------

T159_LES = 64
# the SL GCM at T159/L19 on the card against the port's CPU run from the
# same start, 3 steps: the dynamical grid fields at rtol T159_RTOL plus
# T159_ATOL of max|cpu|; the condensate at T159_Q_ATOL of max|q| and the
# cloud fraction at T159_A_ATOL absolute. The two differ by float32
# rounding: the GEMMs of the transforms sum in another order, and CUDA's
# arcsin/atan2 of the trajectories differ in the last bits; 3 steps grow
# that to 1.1e-4 of max|cpu| in lnps (a field of max ~5e-3), 6e-5 in the
# winds and 9e-6 in T. The cloud scheme's relative-humidity threshold
# turns such differences of T and q into finite ones of qi and the cloud
# fraction (measured 1.5e-8 kg/kg and 8.8e-4; NVIDIA H100 80GB HBM3,
# 700 W)
T159_RTOL, T159_ATOL, T159_Q_ATOL, T159_A_ATOL = 1e-4, 5e-4, 1e-5, 2e-2


def t159_columns(core, n=T159_LES):
    """scripts/bench_t159.py:32-39: 8 rows of |lat| < 15 deg x 8
    longitudes."""
    lats = np.asarray(core.sht.latitudes_deg())
    rows = np.where(np.abs(lats) < 15.0)[0]
    cols = []
    for r in rows[:: max(1, len(rows) // 8)]:
        for k in range(8):
            cols.append(int(r * core.nlon + (k * core.nlon) // 8))
    cols = cols[:n]
    if len(cols) != n:
        raise AssertionError("T159: %d columns, want %d" % (len(cols), n))
    return cols


def t159_gcm_vs_cpu(card, n_steps=3):
    """The T159/L19 SL GCM on the card against the port's CPU run from
    the same (CPU-built) start. Returns the worst errors by field."""
    from sp_coupler_tpu_torch import interop
    kw = dict(trunc=159, nlev=19, dt=900.0, advection="sl")
    cpu = gcm_core("cpu", **kw)
    dev = gcm_core("cuda", **kw)
    s_cpu = cpu.initial_state(seed=0)
    s_dev = interop.gcm_state(interop.to_numpy(s_cpu), "cuda")
    t0 = time.time()
    for i in range(n_steps):
        s_cpu = cpu.step(s_cpu, first=i == 0)
    t_cpu = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(n_steps):
        s_dev = dev.step(s_dev, first=i == 0)
    torch.cuda.synchronize()
    t_dev = time.time() - t0
    qmax = float(s_cpu.grid.q.abs().max())
    errs, bad = {}, []
    for k in ("u", "v", "T", "q", "lnps", "ql", "qi", "a"):
        ref = getattr(s_cpu.grid, k)
        got = getattr(s_dev.grid, k).cpu()
        err = (got - ref).abs()
        if k in ("ql", "qi"):
            tol = T159_Q_ATOL * qmax
        elif k == "a":
            tol = T159_A_ATOL
        else:
            tol = T159_ATOL * float(ref.abs().max()) + T159_RTOL * ref.abs()
        errs[k] = [float(err.max()), float(ref.abs().max())]
        if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
            bad.append(k)
    log("t159: SL GCM T159/L19, %d steps, card against the CPU from the "
        "same start: max err / max|cpu| %s; card %.2f s, CPU %.2f s on %s"
        % (n_steps, " ".join("%s %.3g / %.3g" % (k, e, m)
                             for k, (e, m) in errs.items()), t_dev, t_cpu,
           card))
    if bad:
        raise AssertionError("t159: the card's GCM leaves the tolerance "
                             "in %s" % bad)
    return dict(errors=errs, card_s=t_dev, cpu_s=t_cpu, steps=n_steps)


def t159_case(schedule="batched"):
    """The T159 regional case on the port (scripts/bench_t159.py:15-60):
    the T159/L19 SL GCM, 64 LES of 64x64x160 (RICO, TKE) at the columns
    bench_t159.py picks, dt_les 15 s, evolve_chunks 8, the fleet paced
    by `schedule`. Returns the step function and its start (gcm state,
    LES fleet, profiles, rain)."""
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    core = gcm_core("cuda", trunc=159, nlev=19, dt=900.0, advection="sl")
    grid = lgrid.LESGrid()
    cols = t159_columns(core)
    gs = core.initial_state(seed=0)
    les = seed_les(core, gs, grid, cols)
    fn = CoupledStepFn(core, grid, lstep.LESPhysics(), cols, dt_les=15.0,
                       n_substeps=0, evolve_chunks=8,
                       serial_evolve=schedule)
    prof = ldiag.slab_profiles(grid, les)
    return fn, (gs, les, prof, torch.zeros(len(cols), device=core.device))


def phase_t159(card):
    """The T159 regional case on the card: T159/L19 SL GCM + 64 LES of
    64x64x160 (RICO, TKE), columns as scripts/bench_t159.py picks them,
    dt_les 15 s, evolve_chunks 8, the batched fleet, 2 coupled steps.
    The stage kernel launches 3 x the substeps of the batched loop (the
    substep calls, each over the instances still running). Returns its
    record."""
    from sp_coupler_tpu_torch.models.les import step as lstep
    rec = dict(card=card, gcm_vs_cpu=t159_gcm_vs_cpu(card))
    torch.cuda.reset_peak_memory_stats()
    fn, (gs, les, prof, rain) = t159_case()
    core, grid, cols = fn.core, fn.grid, fn.cols.tolist()
    calls = [0]
    substep = lstep.substep

    def counting_substep(*a, **kw):
        calls[0] += 1
        return substep(*a, **kw)

    lstep.substep = counting_substep
    steps = []
    try:
        torch.cuda.synchronize()
        reset_launches()
        for step, first in ((0, True), (1, False)):
            n0 = calls[0]
            t0 = time.time()
            gs, les, prof, rain, diag = fn(gs, les, prof, rain, step,
                                           first=first)
            torch.cuda.synchronize()
            wall = time.time() - t0
            nsub = [int(x) for x in fn.unpack_diag(diag)["n_substeps"]]
            for k in ("THL", "QT", "U"):
                if not bool(torch.isfinite(prof[k]).all()):
                    raise AssertionError("t159: non-finite %s after step %d"
                                         % (k, step))
            for k in ("u", "v", "T", "q", "lnps"):
                if not bool(torch.isfinite(getattr(gs.grid, k)).all()):
                    raise AssertionError("t159: non-finite GCM %s after "
                                         "step %d" % (k, step))
            if tuple(prof["THL"].shape) != (T159_LES, grid.nz) or \
                    min(nsub) <= 0:
                raise AssertionError("t159: THL %s, substeps %s"
                                     % (tuple(prof["THL"].shape), nsub))
            rate = grid.nx * grid.ny * grid.nz * sum(nsub) / wall
            steps.append(dict(first=first, wall_s=wall,
                              instance_substeps=sum(nsub),
                              loop_substeps=calls[0] - n0,
                              substeps_min_max=[min(nsub), max(nsub)],
                              gridpoint_updates_per_s=rate))
            log("t159 step %d (first=%s): %.3f s, %d instance-substeps "
                "(%d..%d per instance) in %d substeps of the batched loop, "
                "%.4g LES gridpoint-updates/s on %s"
                % (step, first, wall, sum(nsub), min(nsub), max(nsub),
                   calls[0] - n0, rate, card))
        launches = read_launches()
    finally:
        lstep.substep = substep
    loop = sum(st["loop_substeps"] for st in steps)
    for k, count in launches.items():
        want = 3 * loop if k == "lesstage" else 0
        if count != want or (k == "lesstage" and count == 0):
            raise AssertionError("t159: %s launches %d, want %d (3 x %d "
                                 "substeps of the batched loop)"
                                 % (k, count, want, loop))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec.update(columns=cols, steps=steps, launches=launches,
               peak_memory_gib=peak, les=T159_LES,
               les_grid=[grid.nx, grid.ny, grid.nz],
               gcm_grid=[core.nlat, core.nlon])
    log("t159: T159/L19 SL (%dx%d) + %d x %dx%dx%d, launches %s for %d "
        "substeps of the batched loop, peak memory %.2f GiB on %s"
        % (core.nlat, core.nlon, T159_LES, grid.nx, grid.ny, grid.nz,
           launches, loop, peak, card))
    return rec


def write_t159(gcm_sl, t159):
    """chiprun_out/chip_smoke_t159.json: the T159 leg and the SL GCM's
    times."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_t159.json"), "w") as f:
        json.dump(dict(gcm_sl=gcm_sl, t159=t159), f, indent=1)


def main():
    card = phase_env()
    phase_build()
    worst, times = phase_kernel(card)
    split = phase_split_kernels(card)
    phase_small_coupled(card)
    phase_small_coupled(card, "smagorinsky")
    tke, main_steps = phase_main(card)
    runs = [tke, phase_main(card, "smagorinsky")[0]]
    runs += phase_cli(card, main_steps)
    phase_seed(card)
    runs.append(phase_parity(card))
    runs.append(phase_chunked(card))
    gcm_sl = phase_gcm_sl(card)
    t159 = phase_t159(card)
    write_t159(gcm_sl, t159)
    runs.append(t159["launches"])
    stats = dict(split, lesstage=dict(max_abs_err=worst, times=times))
    record = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain, b_ms, by, dev_ms = stats[name]["times"][(64, 64, 160, 1)]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r[name] for r in runs),
            max_abs_err=stats[name]["max_abs_err"], ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=by,
            library_ms=None, device_ms=dev_ms))
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
