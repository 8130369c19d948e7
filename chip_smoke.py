#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port (sp_coupler_tpu_torch).

Drives the port's main path — the reference T21/L19 GCM coupled two-way to
2 LES instances of 64 x 64 x 160 (RICO), CFL/Peclet-adaptive, the case of
bench.py — through the hand-written CUDA stage kernel, on one CUDA card.

Phases (any failure raises and exits non-zero):
  1. environment: torch / nvcc versions, card name and power limit;
  2. build the CUDA sources from this checkout (timed);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (64x64x160, n = 1 and 2) and a small one
     (16x16x32, n = 2): the outputs, the increments out - base on their
     own, and kmax against a float64 run of the plain version; with
     CUDA-event timings of both;
  4. a small coupled step (T10/L8 + 2 x 16x16x32) through the kernel
     against the same step through the plain split path: the substep
     counts, the slab profiles and their change over the step;
  5. the main path: 2 coupled steps (first=True, then first=False); the
     kernel's launch count must equal 3 x the substeps taken.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Run: python3 chip_smoke.py   (needs a CUDA card, nvcc and this checkout)
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

OUT_DIR = "chiprun_out"
KERNEL_SOURCE = "sp_coupler_tpu_torch/csrc/lesstage.cu"
KERNEL_REPLACES = "sp_coupler_tpu/ops/lesstage_pallas.py:167"
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
# change of the slab profiles over the small coupled step, kernel path
# against split path, as a fraction of the split path's max |change|
# (the kernel path's THL was 1.3e-3 off, QT 1.3e-4, on an NVIDIA H100
# 80GB HBM3 at 700 W)
COUPLED_FRAC = 1e-2


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
    from sp_coupler_tpu_torch.ops import _build
    t0 = time.time()
    _build.load("lesstage")
    dt = time.time() - t0
    blog = _build.build_log("lesstage")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_lesstage.log"), "w") as f:
        f.write(blog)
    for line in blog.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())
    log("build: lesstage %.1f s" % dt)


def stage_inputs(grid, n, seed):
    """Physical fleet state (port init_state) with perturbed w and qr, as
    the JAX package's stage-kernel test (tests/test_ops.py:139-154)."""
    from sp_coupler_tpu_torch.models.les import state as lstate
    dev = torch.device("cuda")
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


def increment_cases(cur):
    """(name, cur, base) of the increment checks, from a stirred state."""
    z = torch.zeros_like
    calm = cur._replace(u=z(cur.u), v=z(cur.v), w=z(cur.w), qr=z(cur.qr))
    return [(name, c, c._replace(**{k: torch.full_like(getattr(c, k), v)
                                    for k, v in INC_BASE.items()}))
            for name, c in (("stirred", cur), ("calm", calm))]


def phase_kernel(card):
    """The stage kernel against its plain version, on the card."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    dev = torch.device("cuda")
    phys = lstep.LESPhysics()
    names = ("u", "v", "w", "thl", "qt", "qr", "e12")
    worst = 0.0
    times = {}
    for (nx, ny, nz), n in (((16, 16, 32), 2), ((64, 64, 160), 1),
                            ((64, 64, 160), 2)):
        grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
        cur, base, frc, dt = stage_inputs(grid, n, 7 + n)
        args = (grid, phys, cur, base, frc, 0.5, dt)
        got = lesstage.stage_fused_cuda(*args)
        ref = lesstage.stage_fused_reference(*args)
        ref64 = lesstage.stage_fused_reference(
            grid, phys, as_f64(cur), as_f64(base), as_f64(frc), 0.5,
            dt.double())
        for k, a, b in zip(names, got[:7], ref[:7]):
            worst = max(worst, check_close(k, a, b, **FIELD_TOL))
        check_close("kmax", got[7], ref[7], 0.0, KMAX_RTOL)
        check_close("kmax vs float64", got[7].double(), ref64[7], 0.0,
                    KMAX_RTOL)
        check_close("ustar2", got[8], ref[8], 0.0, USTAR2_RTOL)
        check_close("rain", got[9], ref[9], **RAIN_TOL)
        rel64 = lambda x: float((x.double() / ref64[7] - 1).abs().max())
        log("kernel lesstage %dx%dx%d n=%d: outputs ok, max abs err %.3g; "
            "kmax rel err vs float64 plain: kernel %.3g, float32 plain %.3g"
            % (nx, ny, nz, n, worst, rel64(got[7]), rel64(ref[7])))
        for case, c, b in increment_cases(cur):
            a_ = (grid, phys, c, b, frc, 0.5, dt)
            got, ref = (lesstage.stage_fused_cuda(*a_),
                        lesstage.stage_fused_reference(*a_))
            inc = {k: check_increment(
                "%s %s" % (case, k), x, y,
                b.w[:, :-1] if k == "w" else getattr(b, k),
                INC_FRAC, INC_RTOL)
                for k, x, y in zip(names, got[:7], ref[:7])}
            log("  %s increments ok, err / max|increment|: %s" % (
                case, " ".join("%s %.2g" % kv for kv in inc.items())))
        ms = cuda_ms(lambda: lesstage.stage_fused_cuda(*args))
        plain = cuda_ms(lambda: lesstage.stage_fused_reference(*args))
        times[(nx, ny, nz, n)] = (ms, plain)
        log("  %.3f ms (plain PyTorch %.3f ms) on %s" % (ms, plain, card))
    return worst, times


def phase_small_coupled(card):
    """A small coupled step through the kernel against the split path."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    dev = torch.device("cuda")
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    cols = [100, 200]
    outs = []
    for use_kernel in (True, False):
        core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8,
                                                     dt=300.0), device=dev)
        gs = core.initial_state(seed=0)
        les = seed_les(core, gs, grid, cols)
        fn = CoupledStepFn(core, grid, lstep.LESPhysics(use_kernel=use_kernel),
                           cols, dt_les=15.0, n_substeps=0)
        prof = ldiag.slab_profiles(grid, les)
        out = fn(gs, les, prof, torch.zeros(2, device=dev), 0, first=True)
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
    log("small coupled step T10/L8 + 2x16x16x32: kernel path == plain path "
        "(substeps %s); profile change err / max|change|: %s on %s"
        % ([int(x) for x in d_k["n_substeps"]],
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


def main_path_case():
    """The bench.py case on the port: T21/L19 + 2 x 64x64x160 (RICO),
    columns 1208/1272, adaptive with dt_les 15 s. Returns the step
    function and its start (gcm state, LES fleet, profiles, rain)."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    dev = torch.device("cuda")
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=21, nlev=19,
                                                 dt=900.0), device=dev)
    grid = lgrid.LESGrid()
    cols = [1208, 1272]
    gs = core.initial_state(seed=0)
    les = seed_les(core, gs, grid, cols)
    fn = CoupledStepFn(core, grid, lstep.LESPhysics(), cols, dt_les=15.0,
                       n_substeps=0)
    prof = ldiag.slab_profiles(grid, les)
    return fn, (gs, les, prof, torch.zeros(len(cols), device=dev))


def phase_main(card):
    """The main path: 2 coupled steps of the bench.py case."""
    from sp_coupler_tpu_torch.ops import lesstage
    fn, (gs, les, prof, rain) = main_path_case()
    grid = fn.grid
    torch.cuda.synchronize()
    lesstage.launches = 0
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
        log("main path step %d (first=%s): %.3f s, substeps %s, %.4g LES "
            "gridpoint-updates/s on %s" % (step, first, wall, nsub, rate,
                                           card))
    launches = lesstage.launches
    if launches != 3 * total_sub:
        raise AssertionError("stage kernel launches %d != 3 x %d substeps"
                             % (launches, total_sub))
    log("main path: %d stage-kernel launches for %d substeps"
        % (launches, total_sub))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_main.json"), "w") as f:
        json.dump(dict(card=card, steps=steps, launches=launches), f,
                  indent=1)
    return launches


def main():
    card = phase_env()
    phase_build()
    worst, times = phase_kernel(card)
    phase_small_coupled(card)
    launches = phase_main(card)
    ms, plain = times[(64, 64, 160, 1)]
    print(json.dumps({"kernels": [{
        "name": "lesstage", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": ms, "plain_ms": plain}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
