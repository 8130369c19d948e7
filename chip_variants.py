#!/usr/bin/env python
"""Variants of the scalar (csrc/lesflat.cu) and momentum (csrc/lesmom.cu)
kernels, timed on one CUDA card beside the sources as they are.

A variant is the kernel's source with some lines replaced:
  - another tile, stack group or occupancy (TILINGS), with the wrapper's
    constants set to match; it is held against the plain version
    (chip_smoke.check_arrays) on a ragged grid with and without z-chunks
    and at 64x64x160 before it is timed;
  - an ablation (ABLATIONS), the kernel with one part removed: timed
    only, since its output is wrong.
Each variant is built with the package's nvcc command, all at once, into
sp_coupler_tpu_torch/_build/variants/, and its device time per call
(torch.profiler, mean of 20 calls) taken three times at 64x64x160, n = 1
and 2. The replacements are written against this checkout's sources: one
that no longer matches raises.

Run: python3 chip_variants.py   (needs a CUDA card, nvcc and this checkout)
"""

import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs

# the second round of the flux pass (%s: lesmom's bound has a " + 1")
EXTRA_X = ("    if (tid < TY)\n"
           "      fluxes(g, tid, TX);  // x-faces of the column beyond the "
           "tile\n"
           "    else if (tid < TY + TX%s)\n"
           "      fluxes(g, TY, tid - TY);  // y-faces of the row beyond the "
           "tile\n")
# kernel -> [(variant, {source line: replacement}, {wrapper constant: value})]
TILINGS = {
    "lesflat": [
        ("2 scalars a block, 4 blocks an SM",
         {"SMAX = 4;": "SMAX = 2;", "RESIDENT = 3;": "RESIDENT = 4;"},
         dict(SMAX=2, RESIDENT=4)),
        ("2 blocks an SM", {"RESIDENT = 3;": "RESIDENT = 2;"},
         dict(RESIDENT=2)),
        ("32x4 tile, 6 blocks an SM",
         {"TY = 8;": "TY = 4;", "RESIDENT = 3;": "RESIDENT = 6;"},
         dict(TY=4, RESIDENT=6)),
        ("32x4 tile, 4 blocks an SM",
         {"TY = 8;": "TY = 4;", "RESIDENT = 3;": "RESIDENT = 4;"},
         dict(TY=4, RESIDENT=4)),
        ("64x4 tile", {"TX = 32, TY = 8;": "TX = 64, TY = 4;"},
         dict(TX=64, TY=4)),
    ],
    "lesmom": [
        ("3 blocks an SM", {"RESIDENT = 4;": "RESIDENT = 3;"},
         dict(RESIDENT=3)),
        ("32x4 tile, 8 blocks an SM",
         {"TY = 8;": "TY = 4;", "RESIDENT = 4;": "RESIDENT = 8;"},
         dict(TY=4, RESIDENT=8)),
        ("32x4 tile, 6 blocks an SM",
         {"TY = 8;": "TY = 4;", "RESIDENT = 4;": "RESIDENT = 6;"},
         dict(TY=4, RESIDENT=6)),
        ("64x4 tile", {"TX = 32, TY = 8;": "TX = 64, TY = 4;"},
         dict(TX=64, TY=4)),
    ],
}
ABLATIONS = {
    kernel: [
        ("no copies of the next level",
         {"    if (g + 2 <= k1) load(g + 2);\n": ""}),
        ("no extra row and column of faces", {EXTRA_X % extra: ""}),
        ("no flux pass",
         {"    fluxes(g, ty, tx);\n" + EXTRA_X % extra: ""}),
        ("no middle barrier", {"    __syncthreads();\n\n": "\n"}),
    ] + ([("no Kf plane",
           {"    if (g + 1 < k1) face_visc(g + 1);\n": ""})]
         if kernel == "lesmom" else [])
    for kernel, extra in (("lesflat", ""), ("lesmom", " + 1"))
}


def variant_source(kernel, label, reps):
    """Write the variant's source and the shared header into its own
    directory; return the directory."""
    from sp_coupler_tpu_torch.ops import _build
    d = os.path.join(_build.BUILD_DIR, "variants", "%s-%s" % (
        kernel, "".join(c if c.isalnum() else "_" for c in label)))
    os.makedirs(d, exist_ok=True)
    src = open(os.path.join(_build.CSRC_DIR, kernel + ".cu")).read()
    for a, b in reps.items():
        if src.count(a) != 1:
            raise ValueError("%s, %s: %r is not in the source once"
                             % (kernel, label, a))
        src = src.replace(a, b)
    with open(os.path.join(d, kernel + ".cu"), "w") as f:
        f.write(src)
    shutil.copy(os.path.join(_build.CSRC_DIR, "stencil.cuh"), d)
    return d


def build(job):
    """nvcc the variant (job = kernel, label, directory); returns the
    library path and ptxas's register and spill lines."""
    from sp_coupler_tpu_torch.ops import _build
    kernel, _, d = job
    out = os.path.join(d, kernel + ".so")
    res = subprocess.run(_build.nvcc_command(
        os.path.join(d, kernel + ".cu"), out, _build.find_nvcc()),
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s" % (d, res.stderr))
    return out, " | ".join(
        line.split(":", 1)[-1].strip()
        for line in (res.stdout + res.stderr).splitlines()
        if "registers" in line or "spill" in line)


def main():
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    from sp_coupler_tpu_torch.ops import _build, lesflat, lesmom
    card = cs.phase_env()
    cs.phase_build()
    runs = [(k, "the source", {}, {}, True) for k in ("lesflat", "lesmom")]
    runs += [(k, label, reps, consts, True)
             for k, vs in TILINGS.items() for label, reps, consts in vs]
    runs += [(k, label, reps, {}, False)
             for k, vs in ABLATIONS.items() for label, reps in vs]
    jobs = [(k, label, variant_source(k, label, reps))
            for k, label, reps, _, _ in runs]
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(build, jobs))
    grid = lgrid.LESGrid()
    small = lgrid.LESGrid(nx=12, ny=10, nz=20)
    kernels = {k[0]: k for k in cs.split_kernels()}
    for (kernel, label, _, consts, check), (lib, regs) in zip(runs, built):
        mod = lesflat if kernel == "lesflat" else lesmom
        names = ("TX", "TY", "RESIDENT") + (
            ("SMAX",) if kernel == "lesflat" else ())
        saved = {k: getattr(mod, k) for k in names}
        name, launch, plain, args_of, tol, geom_of = kernels[kernel]
        cs.log("%s, %s: %s" % (kernel, label, regs))
        try:
            for k, v in consts.items():
                setattr(mod, k, v)
            _build._loaded[kernel] = (ctypes.CDLL(lib), "")
            cases = ((small, 3, 6), (small, 3, None), (grid, 1, None),
                     (grid, 2, None)) if check else ()
            for g, n, tz in cases:
                for inputs in (cs.split_inputs, cs.rough_split_inputs):
                    args = args_of(inputs(g, n, 11 + n), g)
                    got, ref = launch(*args, tz=tz), plain(*args)
                    torch.cuda.synchronize()
                    cs.check_arrays(name, got, ref, tol)
            for n in (1, 2):
                args = args_of(cs.split_inputs(grid, n, 11 + n), grid)
                us = [sum(cs.device_us(lambda: launch(*args),
                                       expect=cs.DEVICE_KERNELS[name]
                                       ).values()) for _ in range(3)]
                g = geom_of(args, None)
                cs.log("  n=%d (tile %dx%d, tz %d, %d blocks, %d B shared)%s: "
                       "device %s us on %s"
                       % (n, g.tx, g.ty, g.tz, g.blocks, g.smem,
                          ", checked" if check else "",
                          " ".join("%.1f" % u for u in us), card))
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
            _build._loaded.pop(kernel, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
