#!/usr/bin/env python
"""GPU smoke run of the PyTorch/CUDA port (sp_coupler_tpu_torch).

Drives the port's two paths — the reference T21/L19 GCM coupled two-way to
2 LES instances of 64 x 64 x 160 (RICO), CFL/Peclet-adaptive, the case of
bench.py — on one CUDA card: the main path (Deardorff TKE closure) through
the hand-written CUDA stage kernel, and the Smagorinsky path (the split
tendency path) through the scalar and momentum kernels; the port's
bench (sp_coupler_tpu_torch/bench.py, the JAX package's bench.py) and
its fleet benches (serial against batched pacing, throughput against
batch size); then the semi-Lagrangian GCM alone and the T159 regional
case (T159/L19 SL GCM + 64 LES of 64 x 64 x 160, scripts/bench_t159.py)
through the stage kernel;
then the main path's case on 2 ranks sharing the card (instance
parallelism over torch.distributed), on 4 ranks each holding a block
of every plane (--lesprocs 4: the kernels in their halo mode), and the
GCM on latitude bands (--gcmprocs) with the T159 case on 4 ranks; then
the GCM alone up to TL639/L60, the T255 case with 128x128x160 LES
(BASELINE configs 5 and 4) and the GCM's climate runs.

Phases (any failure raises and exits non-zero):
  1. environment: torch / nvcc versions, card name and power limit;
  2. build the CUDA sources from this checkout, all at once (timed, with
     ptxas's register and spill lines);
  3. the stage kernel against its plain PyTorch version on the card, at
     STAGE_SHAPES: the main path's shapes (64x64x160, n = 1 and 2), a
     small one (16x16x32, n = 2), a ragged grid (12x10x20, n = 3), the
     smallest plane (4x4), z-chunks that do not divide nz and the T255
     case's planes (128x128x160, n = 1 and 2): the
     outputs, the increments out - base on their own, and kmax against a
     float64 run of the plain version, for the stage_inputs state and a
     rough one (rough_inputs), and at the fleets' batches (FLEET_SHAPES:
     64x64x160, n = 3, 4, 8, 16, 32 and 64, every launch geometry of
     phase_schedule, phase_batch and the T159 leg; 128x128x160, n = 4,
     phase_t255's, and n = 64, a card's batch of config 4 in --cards 4
     (g), its references REF_CHUNK instances at a time) for
     stage_inputs; then each option of STAGE_OPTIONS
     (f_coriolis != 0, qt forcing modes 1-3) by its own effect; with
     CUDA-event timings of both and the kernel's bound (written to
     chip_smoke_kernel.json);
  3b. the scalar (lesflat), momentum (lesmom) and un-flattened scalar
     (advect) kernels against their plain versions at STAGE_SHAPES (the
     same tiles, ragged grids and z-chunks), for the split_inputs state
     and a rough one (rough_split_inputs), each output array at the JAX
     tests' tolerance and at ARRAY_FRAC of its own max|ref|; with
     CUDA-event and device timings of both;
  4. a small coupled step (T10/L8 + 2 x 16x16x32) through the kernels
     against the same step through the plain split path, for each closure
     and for the advection schemes cd2 and hybrid62 with the TKE closure
     (SMALL_PATHS; their scalars take the plain path, their momentum the
     lesmom kernel): the substep counts, the slab profiles and their
     change over the step; the path's kernels launch 3 x the substeps of
     the fleet's loop;
  5. the main path: 2 coupled steps (first=True, then first=False); the
     stage kernel's launch count must equal 3 x the substeps taken;
  6. the Smagorinsky path: the same 2 coupled steps with
     LESPhysics(subgrid="smagorinsky"); the scalar and momentum kernels'
     launch counts must each equal 3 x the substeps taken, and the stage
     kernel must not run;
  6b. the split path at full width on other grids (phase_split_grids,
     SPLIT_GRIDS): the bench case for one coupled step with (a) the
     Smagorinsky closure at 64x64x150 (nz not a multiple of 16), (b) at
     60x60x160 (3,600 points a plane, ragged 32x8 tiles), (c) TKE with
     cd2 and (d) TKE with hybrid62 at 64x64x160, each through the kernels
     (lesflat and lesmom launch 3 x the substep calls with hybrid52,
     lesmom alone with cd2 and hybrid62) and through the plain split path:
     finite profiles, the substeps within SPLIT_SUBSTEP_SLACK, the profile
     change within phase 4's bounds, walls and gridpoint-updates/s; on the
     fleet states of (a) and (b) kernels #2 and #3 against their plain
     versions (at the JAX tests' tolerance, and each array against the
     plain version's float64 run within F32_RATIO x the float32 plain
     version's error) with CUDA-event and device times beside the bound;
     writes chip_smoke_split_grids.json;
  7. the CLI (phase_cli), as a user runs the port: run_T21.sh's flags
     (T21/L19 + 2 x 64x64x160, columns 824/888, --cplsurf) through
     spmaster for 2 coupled steps, the second through call_phased; the
     stage kernel launches 3 x the substeps the run reports, the records
     are finite and timing.txt has its phase columns; then the same run
     restarted from its restart.npz appends a record; then a small run
     (T10/L8 + 2 x 16x16x32) with the Smagorinsky closure and the
     variability nudge, where lesflat and lesmom launch 3 x substeps.
     Every leg writes spifs.nc through the port's default writer (h5lite;
     the card's host has no h5py), and the file, read back through the
     port's reader, must hold every record the driver handed the writer
     bit for bit (TeeWriter keeps a copy), the restart's appended record
     included; a line gives the writer, the file size, timing.txt's
     host-I/O column and whether h5py is importable. The
     run_T21.sh leg also writes the LES cross sections (les_cross,
     heights 2/40/80, dtav 60 s): les-work-<col>/cross.nc of both columns,
     written by the native writer (a Python fallback fails the phase),
     read back by the port's reader and by scipy;
  8. the seed: LESFleet.init_states at 2 x 64x64x160 on the card equals
     the CPU's start, moved to the card, bit for bit;
  9. the parity harness at full width (verify/parity.py, real mode:
     T21/L19 + 2 x 64x64x160, dt 600 s, dt_les 5 s) on the card through
     the stage kernel, held by parity.compare against the committed CPU
     run of the port and reported against the JAX package's and the
     port's CPU run from JAX's start (verify/ref/, PARITY_REFS); the
     stage kernel launches 3 x the substeps; writes
     chip_smoke_parity.json, parity_real_h100.npz and the report of
     verify/parity_report.py (PARITY_H100.md) into OUT_DIR;
  10. the chunked step: one coupled step of the main path's case with
     evolve_chunks=3 from the start of an unchunked one; 3 x substeps
     launches, finite profiles within PROFILE_TOL[0] of the unchunked
     step's;
  10b. the bench (phase_bench): sp_coupler_tpu_torch/bench.py at its
     defaults (the bench case, 2 warm and 3 timed coupled steps, the phase
     breakdown with and without the projection): its JSON line's keys
     (BENCH_KEYS), value > 0, finite profiles, the stage kernel launched 3
     x every substep of the run; writes chip_smoke_bench.json;
  10c. serial against batched pacing (phase_schedule):
     runtime/schedulebench.py, the 4-instance mixed-wind fleet of
     64x64x160 over 60 s: the same substeps per instance in both
     schedules, spread at least 2x, the fields within EVOLVE_TOL of each
     field's max, the stage kernel 3 x the substep calls;
  10d. fleet throughput against batch size (phase_batch):
     runtime/batchbench.py at n = BATCH_SIZES (up to 64 x 64x64x160), 20
     fixed-dt substeps: finite output, the stage kernel 3 x the substeps,
     the peak of device memory; 10c and 10d write chip_smoke_fleet.json;
  11. the SL GCM alone (phase_gcm_sl): the JAX package's two 10-day T42
     guards (T42/L19, hybrid, SL, dt 1800 s, 481 steps; T42_GUARDS), the
     window interpolation against the gather one at T159 (WG_*), and
     CUDA-event times of each method's departure interpolation and of
     one SL step at T159/L19;
  12. the T159 regional case (phase_t159): the SL GCM at T159/L19 on the
     card against the port's CPU run from the same start for 3 steps
     (T159_*), then the case through runtime/t159bench.py: T159/L19 SL +
     64 x 64x64x160 at the columns of bench_t159.py, dt_les 15 s,
     evolve_chunks 8, the batched fleet, 2 warm coupled steps and
     T159_TIMED timed: finite profiles and GCM fields, the stage kernel's
     launches = 3 x the substeps of the batched loop; writes
     chiprun_out/chip_smoke_t159.json.
  13. instance parallelism (phase_mesh): the bench case through the CLI
     (T21/L19 + 2 x 64x64x160 at columns 1208/1272, TKE, dt_les 15 s,
     serial pacing, 2 coupled steps) in this process, then on 2 ranks
     sharing the card (subprocesses of this script, gloo, --mesh_les 2,
     MESH_TIMEOUT s): rank 0's records and the GCM state equal the single
     process's bit for bit, the GCM state is the same on both ranks
     (parallel.mesh.replicate), each rank launched lesstage 3 x its own
     substeps; the walls of both side by side (one shared card: not a
     scaling number) and scalebench.measure(sizes=[1, 2]) at 32x32x64
     (structural); writes chip_smoke_mesh.json and the ranks' logs
     mesh_rank<r>.log into OUT_DIR.
  14. intra-LES spatial decomposition (phase_spatial): (a) the halo-mode
     kernels #1-#3 in this process on 2 x 2 blocks of 64x64x160, n = 2
     (halos filled by slicing the whole field, the plane-means kernel's
     float64 sums added across the blocks) against the whole-plane kernels
     and against their plain versions, with device times of a 32x32x160
     block; (b) one 64x64x160 instance, 20 substeps of 2 s, on 2 x 2
     blocks by 4 gloo ranks sharing the card against one process, at
     atol/rtol 2e-3 (tests/test_parallel.py:185-229); (c) the bench case
     through the CLI with --lesprocs 4 on the same ranks against phase
     13's single process: equal substeps, rank 0's records within
     PROFILE_TOL, the GCM the same on every rank, lesstage launched 3 x
     each rank's substeps in halo mode; then phase 7's small Smagorinsky
     + nudge leg with --mesh_les 2 --lesprocs 2, whose lesflat/lesmom
     launches are in halo mode; writes chip_smoke_spatial.json and the
     ranks' logs spatial_rank<r>.log.
  15. the GCM's latitude bands (phase_gcm_bands, --gcmprocs): (a) the
     T159/L19 SL GCM on hybrid levels on 4 bands of 60 rows (4 gloo
     ranks sharing the card), 3 steps from a CPU-built start against one
     process on the card: spectral vort, div, T, q at atol 2e-4 / rtol
     1e-3 and grid T at 5e-3 / 1e-4 (tests/test_parallel.py:116-128), the
     spectral state the same on every rank bit for bit, each step's
     CUDA-event time beside one process's, the all_reduces a step and
     their bytes; (c) one coupled step of the T159 regional case with
     les = 4 (16 instances a rank) and the GCM on 4 bands, from phase
     12's start, against phase 12's first step: the per-instance
     substeps, the profiles within PROFILE_TOL[0], each rank's lesstage
     3 x its batched loop's substeps, wall and peak memory; (b) the bench
     case through the CLI with --mesh_les 2 --gcmprocs 2 on 2 ranks
     against phase 13's single process: step 1's substeps, rank 0's
     records within PROFILE_TOL, the spectral state the same on both
     ranks, lesstage 3 x each rank's substeps. Every rank's grid must
     hold nlat / P rows. Writes chip_smoke_bands.json and the ranks' logs
     bands_rank<r>.log, bands_cli_rank<r>.log.
  16. the golden replay (phase_replay, on the host): tests/golden/spifs.nc
     (gzip + shuffle, 16 columns, 101 records) read through the port's
     reader, its 100 steps replayed through the port's driver (ncreplay),
     every column and step compared, each tendency within REPLAY_TOL of
     its scale (tests/test_torch_replay.py's checks);
  17. the columns bench (phase_columns): runtime/columnbench.py at
     T63/L19 + 64 SP columns of 64x64x160, batched, 2 coupled steps: its
     JSON row and peak_gib, lesstage launched 3 x the batched loop's
     substeps, a spifs.nc of 64 groups and 2 records read back; writes
     chip_smoke_columns.json.
  18. the GCM across truncations (phase_gcm_scale): runtime/gcmscale.py's
     rows at T159, T255 and TL639 (L60, SL, hybrid), GCM_SCALE_REPEATS
     timed steps and spectral round-trips each: finite, with the core's
     build time and the peak of device memory;
  19. BASELINE config 5's GCM (phase_tl639): runtime/tl639.py at its
     defaults (TL639/L60, dt 720 s, +-60 m/s jets, split phases) for
     TL639_STEPS steps, which must pass its PASS rule (the full 600-step
     run does not: it goes non-finite); the card's analysis of the run's
     Euler state against float64, no further from it than the CPU's
     (tl639_analysis, spharm.card_sums); then the same run one row a step
     (verify/tl639_rows.py) to its first non-finite step, held against
     the port's CPU rows (verify/ref/tl639_rows_cpu.json) within
     TL639_ROW_TOL through TL639_AGREE_STEP, with both runs' first
     non-finite steps reported; writes tl639_rows_card.json;
  20. BASELINE config 4 (phase_t255): runtime/t255bench.py at full width,
     T255/L19 SL + 4 x 128x128x160 (TKE), batched, a warm step and a
     timed one: the stage kernel launches 3 x the substeps of the batched
     loop, the profiles are finite and [4, 160]; writes
     chip_smoke_t255.json;
  21. the GCM as an atmosphere (phase_climate): verify/held_suarez.py and
     verify/moist_endurance.py for CLIMATE_DAYS model days each at
     T42/L19, finite, with their JSON lines' keys; phases 18-21 write
     chip_smoke_scale.json and their reports into OUT_DIR.
Phases 13-15 hand their runs the same writer, on rank 0 where there
are ranks, and compare rank 0's file with the single process's.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

``--cards N`` (N = 2 or 4; cards_main) runs the distributed layers over
nccl instead, one card a rank (run_rank_set(backend="nccl")), each phase
against one process on card 0 of the same machine: (a) phase 13 on 2
cards; (b) phase 15 (c), the T159 regional case with les = 4 and 4 GCM
bands, against one card's first step (t159_first_step); (c) phase 15
(a), the T159 GCM on 4 bands; (d) phase 14 (b)-(c) with BASELINE config
4's 4 x 128x128x160 (config4_fleet) on 2 x 2 blocks of 64x64x160; (e)
kernels #1-#3, whole-plane and in halo mode, against their plain
versions on every card (card_kernels_rank); (f) runtime/scalebench.py
--sizes 1,2,4 at 16 x 64x64x160 a card; (g) BASELINE config 4 at its
stated size through the CLI (phase_config4): T255/L19 SL hybrid + 256 x
128x128x160, batched, --mesh_les 4 --gcmprocs 4 (64 instances and 96 GCM
rows a card), 2 coupled steps, each rank's lesstage 3 x its substep
calls, then its first 4 columns on card 0 without a mesh: (i) the GCM's
replicated state the same on every rank, (ii) step 1's records of
instances 0-3 within PROFILE_TOL of card 0's and their substeps within
C_SUBSTEP_SLACK, (iii) every record finite and every instance
substepping, (iv) rank 0's checkpoint holding every leaf at [256, ...]
and the whole GCM state, each instance's float64 sums equal to its
rank's; each card's step walls, evolve seconds and peak, rank 0's
spifs.nc bytes, timing.txt rows and checkpoint seconds and bytes are
printed. Every rank reports its backend and the CUDA tensors its
collectives took through the host (0 under nccl). It raises with fewer
than N cards; with N = 2, (b)-(d) and (g) do not run. Every phase runs; any failure fails the run at the end, and ranks
that hang end it at once. Its last line is {"ok": true, "device": {...,
"count": N}}; summary in chiprun_out/chip_smoke_cards.json ((g) also in
chip_smoke_config4.json).

Run: python3 chip_smoke.py   (needs a CUDA card, nvcc and this checkout)
     python3 chip_smoke.py --cards 4   (4 cards)
"""

import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from sp_coupler_tpu_torch.ops.bounds import KERNEL_OPS, bound_ms, stage_bound

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
# plane the kernels take, z-chunks that do not divide nz (at 64x64x157,
# n = 2 the default chunks leave a last one of 17 levels for the stage,
# 3 for lesflat, 7 for lesmom), and the T255 case's 128x128x160 planes
# (phase_t255), four times the tiles of a 64x64 plane
STAGE_SHAPES = (((16, 16, 32), 2, None), ((64, 64, 160), 1, None),
                ((64, 64, 160), 2, None), ((12, 10, 20), 3, 6),
                ((4, 4, 9), 1, 4), ((16, 16, 32), 1, 5),
                ((64, 64, 157), 2, None), ((128, 128, 160), 1, None),
                ((128, 128, 160), 2, None))
# the stage kernel alone (phase 3) also at the batches of the fleets that
# run it, for the smooth input: at 64x64x160 every launch geometry of the
# fleet benches, n = 3 (tz 32, 5 chunks; phase_schedule's batched fleet
# once one instance is done), 4 (tz 40; its whole fleet), 8 (tz 80),
# 16 (one chunk, 256 blocks), 32 (one chunk, 512 blocks; phase_batch's
# BATCH_SIZES) and 64 (the T159 leg's and phase_batch's largest), and
# phase_t255's 4 of 128x128x160 in one launch (one z-chunk a column)
FLEET_N = (3, 4, 8, 16, 32, 64)
FLEET_SHAPES = tuple(((64, 64, 160), n, None) for n in FLEET_N) + (
    ((128, 128, 160), 4, None), ((128, 128, 160), 64, None))
# above REF_WHOLE_POINTS points (n x nx x ny x nz; the largest fleet held
# whole, 64 x 64x64x160) the references, the plain version and its
# float64 run, are computed REF_CHUNK instances at a time and concatenated
# (the stage is per instance): a plain run of config 4's 64 x 128x128x160
# a card (phase_config4) may not fit beside the kernel's inputs and outputs
REF_WHOLE_POINTS = 64 * 64 * 64 * 160
REF_CHUNK = 4
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
# On a coupled run's fleet state (phase_split_grids) the float32 plain
# version itself is not that close: the thl tendency is the sum of flux
# divergences of thl ~300 K that cancel to ~1e-3 K/s, and the plain
# version lies 2e-3 to 4e-3 of its max|ref| off its float64 run (a
# Smagorinsky step at 16x16x30 and 32x32x40 on the CPU); e12, which the
# Smagorinsky closure does not step, has tendencies of rounding alone.
# There each array is held against the float64 run, at the larger of
# ARRAY_FRAC of its max and F32_RATIO x the float32 plain version's own
# error: a float32 path more than 3x further from float64 than another is
# at fault (chip_profile.py's GEMM_RATIO holds the card's GCM sums so)
F32_RATIO = 3.0


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


def ref_chunk(grid, n):
    """The instances a reference run of n instances of grid takes at once
    (None: all of them)."""
    return (REF_CHUNK if n * grid.nx * grid.ny * grid.nz > REF_WHOLE_POINTS
            else None)


def stage_reference(grid, phys, cur, base, frc, frac, dt, f64=False):
    """The plain version's outputs (in float64 from the float32 inputs
    with f64), computed ref_chunk instances at a time and concatenated."""
    from sp_coupler_tpu_torch.ops import lesstage
    n = dt.shape[0]
    step = ref_chunk(grid, n) or n
    conv = as_f64 if f64 else (lambda t: t)
    parts = []
    for i in range(0, n, step):
        cut = lambda t: conv(type(t)(*[x[i:i + step] for x in t]))
        parts.append(lesstage.stage_fused_reference(
            grid, phys, cut(cur), cut(base), cut(frc), frac,
            dt[i:i + step].double() if f64 else dt[i:i + step]))
    return parts[0] if len(parts) == 1 else tuple(
        torch.cat(p) for p in zip(*parts))


def check_stage(kern, grid, phys, cur, base, frc, dt):
    """kern (the stage kernel or a stand-in with its signature) against
    the plain version from one input: the outputs at FIELD_TOL, kmax
    against the plain version and its float64 run at KMAX_RTOL, u*^2 and
    the rain flux; then the increments out - base of the stirred and the
    calm case at INC_FRAC. The references run ref_chunk instances at a
    time. Returns (max abs err of the outputs, kmax rel err vs float64 of
    the kernel and of the float32 plain version, worst increment err /
    max|increment| per field)."""
    args = (grid, phys, cur, base, frc, 0.5, dt)
    got = kern(*args)
    ref = stage_reference(*args)
    ref64 = stage_reference(*args, f64=True)
    worst = max(check_close(k, a, b, **FIELD_TOL)
                for k, a, b in zip(STAGE_NAMES, got[:7], ref[:7]))
    check_close("kmax", got[7], ref[7], 0.0, KMAX_RTOL)
    check_close("kmax vs float64", got[7].double(), ref64[7], 0.0, KMAX_RTOL)
    check_close("ustar2", got[8], ref[8], 0.0, USTAR2_RTOL)
    check_close("rain", got[9], ref[9], **RAIN_TOL)
    rel64 = lambda x: float((x.double() / ref64[7] - 1).abs().max())
    k64, p64 = rel64(got[7]), rel64(ref[7])
    del got, ref, ref64
    inc = dict.fromkeys(STAGE_NAMES, 0.0)
    for case, c, b in increment_cases(cur):
        a_ = (grid, phys, c, b, frc, 0.5, dt)
        g_, r_ = kern(*a_), stage_reference(*a_)
        for k, x, y in zip(STAGE_NAMES, g_[:7], r_[:7]):
            b_k = b.w[:, :-1] if k == "w" else getattr(b, k)
            inc[k] = max(inc[k], check_increment(
                "%s %s" % (case, k), x, y, b_k, INC_FRAC, INC_RTOL))
    return worst, k64, p64, inc


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
            # the plain version as check_stage runs it (ref_chunk
            # instances a call), fewer times where it is chunked
            plain = cuda_ms(lambda: stage_reference(*args),
                            *((3, 1) if ref_chunk(grid, n) else ()))
            b_ms, by = bound_ms(*stage_bound(n, nz, ny, nx))
            times[(nx, ny, nz, n)] = (ms, plain, b_ms, by, dev_ms)
            log("  %.3f ms by CUDA events, %.4f ms of device time (plain "
                "PyTorch %.3f ms); bound %.4f ms (%s), %.1f %% of the device "
                "time, on %s" % (ms, dev_ms, plain, b_ms, by,
                                 100 * b_ms / dev_ms, card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernel.json"), "w") as f:
        json.dump(dict(card=card, max_abs_err=worst, times=[
            dict(grid=k[:3], n=k[3], ms=v[0], plain_ms=v[1], bound_ms=v[2],
                 bound_by=v[3], device_ms=v[4]) for k, v in times.items()]),
            f, indent=1)
    return worst, times


def split_inputs(grid, n, seed, dev="cuda"):
    """Inputs of kernels #2-#4 as the Smagorinsky path makes them from the
    stage_inputs state (state_split_inputs). The CPU tests build the same
    inputs with dev="cpu"."""
    return state_split_inputs(grid, stage_inputs(grid, n, seed, dev)[0])


def state_split_inputs(grid, cur):
    """Inputs of kernels #2-#4 as the Smagorinsky path makes them from the
    LES state cur: u, v, w, the scalar stack [thl, qt, qr, e12] with Ks =
    [Kh, Kh, Kh, 2 Km] from the Smagorinsky closure, rhobf, rhobh and
    Km."""
    from sp_coupler_tpu_torch.models.les import step as lstep, subgrid
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
    for m in (lesstage, lesflat, lesmom):
        m.halo_launches = 0


def read_launches():
    """Each wrapper's launches: whole-plane (by kernel name) and in halo
    mode (name + "_halo")."""
    from sp_coupler_tpu_torch.ops import lesstage, lesflat, lesmom, advect
    return dict(lesstage=lesstage.launches, lesflat=lesflat.launches,
                lesmom=lesmom.launches, advect=advect.launches,
                lesstage_halo=lesstage.halo_launches,
                lesflat_halo=lesflat.halo_launches,
                lesmom_halo=lesmom.halo_launches)


def check_launches(name, launches, calls, kernels=("lesstage",)):
    """Each of kernels launched 3 x calls (substep calls) times, and at
    least once; every other wrapper not at all."""
    for k, count in launches.items():
        want = 3 * calls if k in kernels else 0
        if count != want or (k in kernels and count == 0):
            raise AssertionError("%s: %s launches %d, want %d (3 x %d "
                                 "substeps)" % (name, k, count, want, calls))


# (closure, advection scheme) of the small coupled steps: the two closures,
# and the split path's other schemes, whose scalars take the plain path
# and whose momentum takes the lesmom kernel
SMALL_PATHS = (("tke", "hybrid52"), ("smagorinsky", "hybrid52"),
               ("tke", "cd2"), ("tke", "hybrid62"))


def path_kernels(subgrid="tke", scheme="hybrid52"):
    """The kernels a path launches: the stage kernel for TKE with hybrid52;
    else the split path's momentum kernel, and its scalar kernel with
    hybrid52 (the scalar kernel implements hybrid52 advection only)."""
    if scheme == "hybrid52":
        return PATH_KERNELS[subgrid]
    return ("lesmom",)


def phase_small_coupled(card, subgrid="tke", scheme="hybrid52"):
    """A small coupled step through the kernels against the plain split
    path, with the given closure and advection scheme. The path's kernels
    launch 3 x the substeps of the fleet's loop (the substep calls, each
    over the instances still running), the others not at all. Returns
    the kernel path's launch counts."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.runtime import t255bench
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    cols = [100, 200]
    kernels = path_kernels(subgrid, scheme)
    outs = []
    for use_kernel in (True, False):
        core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=10, nlev=8,
                                                     dt=300.0))
        gs = core.initial_state(seed=0)
        les = t255bench.seed_les(core, gs, grid, cols)
        phys = lstep.LESPhysics(subgrid=subgrid, scheme=scheme,
                                use_kernel=use_kernel)
        fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0, n_substeps=0)
        prof = ldiag.slab_profiles(grid, les)
        reset_launches()
        out, calls = counted_substeps(lambda: fn(
            gs, les, prof, torch.zeros(2, device=core.device), 0,
            first=True))
        counts = read_launches()
        check_launches("%s/%s %s path" % (
            subgrid, scheme, "kernel" if use_kernel else "plain"), counts,
            calls, kernels if use_kernel else ())
        if use_kernel:
            launches = counts
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
    log("small coupled step T10/L8 + 2x16x16x32, %s/%s: kernel path == "
        "plain path (substeps %s; launches %s); profile change err / "
        "max|change|: %s on %s"
        % (subgrid, scheme, [int(x) for x in d_k["n_substeps"]], launches,
           " ".join("%s %.2g" % kv for kv in gaps.items()), card))
    return launches


def main_path_case(subgrid="tke", grid=None, scheme="hybrid52",
                   use_kernel=True):
    """The bench.py case on the port: T21/L19 + 2 x 64x64x160 (RICO),
    columns 1208/1272, adaptive with dt_les 15 s, with the given LES
    closure and advection scheme, on another LES grid if one is given (the
    GCM columns' profiles set on its levels). Returns the step function
    and its start (gcm state, LES fleet, profiles, rain)."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.runtime import t255bench
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=21, nlev=19,
                                                 dt=900.0))
    if core.device.type != "cuda":
        raise AssertionError("GCMCore took %s, not the card" % core.device)
    grid = grid or lgrid.LESGrid()
    cols = [1208, 1272]
    gs = core.initial_state(seed=0)
    les = t255bench.seed_les(core, gs, grid, cols)
    phys = lstep.LESPhysics(subgrid=subgrid, scheme=scheme,
                            use_kernel=use_kernel)
    fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0, n_substeps=0)
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


# the split path at full width off the TPU's lane rule and with its other
# schemes (phase_split_grids): (tag, closure, scheme, (nx, ny, nz)). (a)
# nz not a multiple of 16; (b) 3,600 points a plane, not a multiple of
# 128, and ragged 32x8 tiles; (c), (d) cd2 and hybrid62 on the bench grid
SPLIT_GRIDS = (("a", "smagorinsky", "hybrid52", (64, 64, 150)),
               ("b", "smagorinsky", "hybrid52", (60, 60, 160)),
               ("c", "tke", "cd2", (64, 64, 160)),
               ("d", "tke", "hybrid62", (64, 64, 160)))
# the kernel path against the plain split path over one coupled step: the
# adaptive dt is cfl / (the fleet's largest rate), and the two paths part
# at float32 rounding, so the sum of an instance's dts over the 900 s
# parts by ~1e-6 of it: the instance can take one substep more or fewer
# (its last, partial one), never two. The profiles' change over the step
# is held as phase_small_coupled holds it (COUPLED_FRAC)
SPLIT_SUBSTEP_SLACK = 1


def one_step(fn, start):
    """One coupled step (first=True) from start, its wall (synchronised)
    and the substep calls it made: (outputs, wall s, calls)."""
    gs, les, prof, rain = start
    torch.cuda.synchronize()
    t0 = time.time()
    out, calls = counted_substeps(lambda: fn(gs, les, prof, rain, 0,
                                             first=True))
    torch.cuda.synchronize()
    return out, time.time() - t0, calls


def check_arrays_f64(name, got, ref, ref64):
    """Hold each output array of got against the plain version's float64
    run ref64: within the larger of ARRAY_FRAC of its max|ref64| and
    F32_RATIO x the float32 plain version's (ref's) own max error against
    ref64. Returns each array's (kernel, plain) max error against ref64
    as fractions of its max|ref64|."""
    fracs = []
    for j, (a, b, c) in enumerate(zip(output_arrays(got), output_arrays(ref),
                                      output_arrays(ref64))):
        scale = float(c.abs().max()) or 1.0
        plain_err = float((b.double() - c).abs().max())
        err = check_close("%s array %d vs float64" % (name, j), a.double(),
                          c, max(ARRAY_FRAC * scale, F32_RATIO * plain_err),
                          0.0)
        fracs.append((err / scale, plain_err / scale))
    return fracs


def split_grid_kernels(card, tag, grid, les):
    """Kernels #2 and #3 against their plain versions on SPLIT_GRIDS' grid
    of run tag: for phase 3b's two inputs (check_arrays), then on the
    fleet state les (one call each) at the JAX tests' tolerance
    (SCALAR_TOL, MOM_TOL) and each array against the plain version's
    float64 run (check_arrays_f64), with CUDA-event and device times
    beside the bound. Returns {name: (max abs err against the
    plain version, ms, device ms, plain ms, bound ms, bound by, the
    arrays' errors against float64)}."""
    a = state_split_inputs(grid, les)
    n = les.u.shape[0]
    out = {}
    for name, launch, plain, args_of, tol, geom_of in split_kernels()[:2]:
        for inputs in (split_inputs, rough_split_inputs):
            args = args_of(inputs(grid, n, 11 + n, les.u.device.type),
                           grid)
            fracs = check_arrays(name, launch(*args), plain(*args), tol)
            log("(%s) kernel %s %dx%dx%d n=%d, %s: ok, err / max|ref| per "
                "array: %s" % (tag, name, grid.nx, grid.ny, grid.nz, n,
                               inputs.__name__,
                               " ".join("%.2g" % f for f in fracs)))
        args = args_of(a, grid)
        got, ref = launch(*args), plain(*args)
        ref64 = plain(*[x.double() if torch.is_tensor(x) else x
                        for x in args])
        torch.cuda.synchronize()
        for j, (x, y) in enumerate(zip(output_arrays(got),
                                       output_arrays(ref))):
            check_close("%s array %d" % (name, j), x, y, **tol)
        fracs = check_arrays_f64(name, got, ref, ref64)
        del ref64
        err = max(float((x - y).abs().max())
                  for x, y in zip(output_arrays(got), output_arrays(ref)))
        ms = cuda_ms(lambda: launch(*args))
        dev_ms = device_ms(lambda: launch(*args), DEVICE_KERNELS[name])
        plain_ms = cuda_ms(lambda: plain(*args), reps=5, warm=1)
        b_ms, by = bound_ms(tensor_bytes(args, got), KERNEL_OPS[name] * n
                            * grid.nz * grid.ny * grid.nx)
        g = geom_of(args, None)
        out[name] = (err, ms, dev_ms, plain_ms, b_ms, by, fracs)
        log("(%s) kernel %s on the fleet state %dx%dx%d n=%d (tile %dx%d, "
            "tz %d, %d blocks): ok, err / max|float64| per array, kernel "
            "(plain float32): %s; %.3f ms by CUDA events, %.4f ms of device "
            "time (plain PyTorch %.3f ms); bound %.4f ms (%s), %.1f %% of "
            "the device time, on %s"
            % (tag, name, grid.nx, grid.ny, grid.nz, n, g.tx, g.ty, g.tz,
               g.blocks, " ".join("%.2g (%.2g)" % f for f in fracs), ms,
               dev_ms, plain_ms, b_ms, by, 100 * b_ms / dev_ms, card))
    return out


def phase_split_grids(card):
    """The split path at full width on SPLIT_GRIDS: the bench case (T21/L19
    + 2 instances, columns 1208/1272, adaptive, dt_les 15 s, the GCM
    columns' profiles on the grid's levels) for one coupled step through
    the kernels, then the same step through the plain split path
    (use_kernel=False). The kernel run's path kernels (path_kernels:
    lesflat and lesmom with hybrid52, lesmom alone with cd2 and hybrid62)
    launch 3 x its substep calls, the others not at all; the plain run
    launches none; its profiles are finite; the substeps agree within
    SPLIT_SUBSTEP_SLACK and the THL/QT/U/V change over the step within
    phase_small_coupled's bounds. On (a) and (b) kernels #2 and #3 are
    held against their plain versions and its float64 run on the fleet
    state after the step (split_grid_kernels). Returns (the kernel runs'
    launch counts, the summary)."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    t_phase = time.time()
    runs, summary = [], []
    for tag, subgrid, scheme, (nx, ny, nz) in SPLIT_GRIDS:
        grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
        kernels = path_kernels(subgrid, scheme)
        outs = []
        for use_kernel in (True, False):
            fn, start = main_path_case(subgrid, grid, scheme, use_kernel)
            reset_launches()
            out, wall, calls = one_step(fn, start)
            counts = read_launches()
            what = "(%s) %s/%s %dx%dx%d %s path" % (
                tag, subgrid, scheme, nx, ny, nz,
                "kernel" if use_kernel else "plain")
            check_launches(what, counts, calls,
                           kernels if use_kernel else ())
            prof = out[2]
            for k in ("THL", "QT", "U", "V"):
                if not bool(torch.isfinite(prof[k]).all()):
                    raise AssertionError("%s: non-finite %s" % (what, k))
            if tuple(prof["THL"].shape) != (2, nz):
                raise AssertionError("%s: THL profile shape %s"
                                     % (what, tuple(prof["THL"].shape)))
            nsub = [int(x) for x in fn.unpack_diag(out[4])["n_substeps"]]
            if min(nsub) <= 0:
                raise AssertionError("%s: no substeps taken: %s"
                                     % (what, nsub))
            rate = nx * ny * nz * sum(nsub) / wall
            log("%s: %.3f s, substeps %s (%d substep calls), %.4g LES "
                "gridpoint-updates/s, launches %s, on %s"
                % (what, wall, nsub, calls, rate,
                   {k: v for k, v in counts.items() if v}, card))
            outs.append(dict(prof0=start[2], out=out, nsub=nsub, wall=wall,
                             rate=rate, launches=counts))
        k_run, p_run = outs
        runs.append(k_run["launches"])
        dsub = np.asarray(k_run["nsub"]) - np.asarray(p_run["nsub"])
        if np.any(np.abs(dsub) > SPLIT_SUBSTEP_SLACK):
            raise AssertionError("(%s) substeps: kernel %s, plain %s" % (
                tag, k_run["nsub"], p_run["nsub"]))
        gaps = {}
        for k in ("THL", "QT", "U", "V"):
            got, ref = k_run["out"][2][k], p_run["out"][2][k]
            scale = float(ref.abs().max())
            check_close("(%s) %s" % (tag, k), got, ref, 2e-3 * scale, 2e-3)
            gaps[k] = check_increment("(%s) %s" % (tag, k), got, ref,
                                      k_run["prof0"][k], COUPLED_FRAC, 0.0)
        log("(%s) kernel path == plain path: substeps %s / %s; profile "
            "change err / max|change|: %s"
            % (tag, k_run["nsub"], p_run["nsub"],
               " ".join("%s %.2g" % kv for kv in gaps.items())))
        held = (split_grid_kernels(card, tag, grid, k_run["out"][1])
                if "lesflat" in kernels else {})
        summary.append(dict(
            tag=tag, subgrid=subgrid, scheme=scheme, grid=[nx, ny, nz],
            kernel=dict(wall_s=k_run["wall"], substeps=k_run["nsub"],
                        gridpoint_updates_per_s=k_run["rate"],
                        launches=k_run["launches"]),
            plain=dict(wall_s=p_run["wall"], substeps=p_run["nsub"],
                       gridpoint_updates_per_s=p_run["rate"]),
            change_err=gaps, kernels=held))
    wall = time.time() - t_phase
    log("phase_split_grids: %.1f s on %s" % (wall, card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_split_grids.json"),
              "w") as f:
        json.dump(dict(card=card, wall_s=wall, runs=summary), f, indent=1)
    return runs, summary


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
# card's run is only reported against it. The port's CPU run from JAX's
# whole start (tests/parity_from_jax_gcm.py --les-from-jax) stays inside
# PROFILE_TOL of JAX's, prof_U within 3.2e-4 (PARITY_FROM_JAX.md); it
# starts from JAX's draws, not the card's, so it too is reported only
PARITY_REFS = (("torch", "parity_real_torch_cpu.npz", True),
               ("jax", "parity_real_jax_cpu.npz", False),
               ("torch_from_jax", "parity_real_torch_cpu_from_jax.npz",
                False))


def phase_parity(card):
    """verify/parity.py's real case on the card, through the stage kernel,
    held against the committed CPU runs. Returns the launch counts."""
    from sp_coupler_tpu_torch.verify import parity, parity_report
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
    refs = [os.path.join(ref_dir, fname) for _, fname, _ in PARITY_REFS]
    parity_report.write(os.path.join(OUT_DIR, "PARITY_H100.md"), refs[0],
                        path, card, refs[1])
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


# ---- the port's benches (sp_coupler_tpu_torch/bench.py, runtime/) ---------

# the keys of bench.py's JSON line on the port (tests/test_torch_benches.py
# reads them from the JAX package's bench.py)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "phase_ms",
              "phase_method", "hbm_gbs", "hbm_frac", "f32_op_frac",
              "op_model"]
BATCH_SIZES = (2, 8, 16, 32, 64)


def counted_substeps(fn):
    """(fn(), the number of models/les/step.substep calls it made)."""
    from sp_coupler_tpu_torch.models.les import step as lstep
    calls = [0]
    substep = lstep.substep

    def counting_substep(*a, **kw):
        calls[0] += 1
        return substep(*a, **kw)

    lstep.substep = counting_substep
    try:
        return fn(), calls[0]
    finally:
        lstep.substep = substep


def phase_bench(card):
    """sp_coupler_tpu_torch/bench.py at its defaults, in this process: the
    bench case (T21/L19 + 2 x 64x64x160), 2 warm and 3 timed coupled steps,
    then the phase breakdown (2 x (1 + 3) x 50 fixed-dt substeps, with and
    without the projection). The line has bench.py's keys, value > 0,
    finite profiles, and the stage kernel launched 3 x every substep of
    the run (the substep calls; the fleet runs serially at this size, so
    the coupled steps call it once a substep of each instance, and the
    breakdown's batch of 2 once a substep). Writes chip_smoke_bench.json.
    Returns the launch counts."""
    from sp_coupler_tpu_torch import bench
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    args = bench.parser().parse_args([])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    (line, extras), calls = counted_substeps(
        lambda: bench.run(args, torch.device("cuda")))
    wall = time.time() - t0
    launches = read_launches()
    if list(line) != BENCH_KEYS or list(line["phase_ms"]) != [
            "substep", "stage_x3", "projection_x3"]:
        raise AssertionError("bench: keys %s" % list(line))
    if not line["value"] > 0:
        raise AssertionError("bench: value %r" % line["value"])
    for k in ("THL", "QT", "U"):
        if not bool(torch.isfinite(extras["prof"][k]).all()):
            raise AssertionError("bench: non-finite %s" % k)
    sub = extras["substeps"]
    serial = lstep.serial_fleet_default(lgrid.LESGrid(
        nx=args.nx, ny=args.ny, nz=args.nz))
    if serial and calls != sum(sub.values()):
        raise AssertionError("bench: %d substep calls, the run counts %s"
                             % (calls, sub))
    check_launches("bench", launches, calls)
    log("bench: %.4g gridpoint-updates/s (vs_baseline %.1f), phase_ms %s, "
        "hbm_frac %.3g, f32_op_frac %.3g; launches %s for substeps %s; "
        "%.1f s in all on %s"
        % (line["value"], line["vs_baseline"], line["phase_ms"],
           line["hbm_frac"], line["f32_op_frac"], launches, sub, wall, card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_bench.json"), "w") as f:
        json.dump(dict(card=card, line=line, substeps=sub,
                       launches=launches, wall_s=wall), f, indent=1)
    return launches


def phase_schedule(card):
    """runtime/schedulebench.py at full width: the 4-instance mixed-wind
    fleet of 64x64x160, 60 s, batched and serial, a warm call and 3 reps
    each. Both schedules take the same substeps per instance, with a
    spread of at least 2x across the fleet; the two last reps' fields
    agree within EVOLVE_TOL of each field's max (cuBLAS may round the
    projection's batched products by the batch size); the
    stage kernel launches 3 x the substep calls. Returns the record and
    the launch counts."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    from sp_coupler_tpu_torch.runtime import schedulebench
    grid = lgrid.LESGrid()
    state, forcing = schedulebench.fleet(grid, torch.device("cuda"))
    torch.cuda.synchronize()
    reset_launches()
    res, calls = counted_substeps(
        lambda: schedulebench.run(grid, state, forcing))
    launches = read_launches()
    b, s = res["batched"], res["serial"]
    if b["substeps"] != s["substeps"] or max(b["substeps"]) < 2 * min(
            b["substeps"]):
        raise AssertionError("schedule: substeps batched %s, serial %s"
                             % (b["substeps"], s["substeps"]))
    gaps = {}
    for k in STAGE_NAMES:
        ref = getattr(s["state"], k)
        scale = float(ref.abs().max())
        gaps[k] = check_close("schedule " + k, getattr(b["state"], k), ref,
                              EVOLVE_TOL["atol"] * scale,
                              EVOLVE_TOL["rtol"]) / max(scale, 1e-30)
    check_launches("schedule", launches, calls)
    rec = dict(batched_s=b["s"], serial_s=s["s"], speedup=res["speedup"],
               substeps=b["substeps"], field_gap_of_max=gaps,
               launches=launches)
    log("schedule: 4 x 64x64x160 over 60 s, batched %.3f s, serial %.3f s "
        "(serial speedup %.2fx), substeps %s; batched against serial, max "
        "err / max|serial|: %s on %s"
        % (b["s"], s["s"], res["speedup"], b["substeps"],
           " ".join("%s %.2g" % kv for kv in gaps.items()), card))
    return rec, launches


def phase_batch(card):
    """runtime/batchbench.py at full width: fleets of BATCH_SIZES x
    64x64x160, 20 fixed-dt substeps, a warm call and 2 timed ones each;
    finite output, the stage kernel 3 x 3 x 20 launches a fleet, the peak
    of device memory. Returns the rows and the launch counts."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    from sp_coupler_tpu_torch.runtime import batchbench
    grid = lgrid.LESGrid()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (rows, out), calls = counted_substeps(
        lambda: batchbench.run(grid, torch.device("cuda"), BATCH_SIZES))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in STAGE_NAMES:
        if not bool(torch.isfinite(getattr(out, k)).all()):
            raise AssertionError("batch: non-finite %s at n = %d"
                                 % (k, BATCH_SIZES[-1]))
    if calls != len(BATCH_SIZES) * (1 + batchbench.REPS) * batchbench.N_SUB:
        raise AssertionError("batch: %d substep calls" % calls)
    check_launches("batch", launches, calls)
    log("batch: %s; peak %.2f GiB, launches %s on %s"
        % ("; ".join("n=%d %.3f ms/substep %.4g updates/s" % (
            r["n_les"], r["ms_per_substep"], r["updates_per_s"])
            for r in rows), peak, launches, card))
    return dict(rows=rows, peak_memory_gib=peak, launches=launches), launches


def write_fleet(schedule, batch):
    """chiprun_out/chip_smoke_fleet.json: the schedule and batch benches."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_fleet.json"), "w") as f:
        json.dump(dict(schedule=schedule, batch=batch), f, indent=1)


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
    """A copy of every record a spifs.nc writer is handed
    (``spifs.SpifsWriter``'s calls), kept in memory: TeeWriter's tee. The
    records of a path outlive the writer in STORE, so that a restarted run
    appends to them as it does to the file."""

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


def tee_writer():
    """The port's default spifs.nc writer (``spifs.SpifsWriter``, on
    h5lite), every call of it also handed to a MemoryWriter, so that
    read_records can hold the file against what the driver wrote."""
    from sp_coupler_tpu_torch.io import spifs

    class TeeWriter(spifs.SpifsWriter):
        def __init__(self, path, *a, **kw):
            super().__init__(path, *a, **kw)
            self.tee = MemoryWriter(path, *a, **kw)

        def add_les_column(self, index, lat, lon):
            self.tee.add_les_column(index, lat, lon)
            return super().add_les_column(index, lat, lon)

        def add_output_column(self, index, lat, lon):
            self.tee.add_output_column(index, lat, lon)
            return super().add_output_column(index, lat, lon)

        def update_time(self, t):
            self.tee.update_time(t)
            super().update_time(t)

        def write_column(self, index, lock=False, **kwargs):
            self.tee.write_column(index, **kwargs)
            super().write_column(index, lock=lock, **kwargs)

    return TeeWriter


def read_records(path):
    """(Time list, {column: {var: [records, ...] array}}) of a run's
    spifs.nc, read through the port's reader (``spifs.open_reader``),
    for the variables the run wrote. Raises unless the file holds every
    record the writer was handed (TeeWriter's copy) bit for bit, and as
    many records."""
    from sp_coupler_tpu_torch.io import spifs
    rec = MemoryWriter.STORE[path]
    ds = spifs.open_reader(path)
    try:
        times = np.asarray(ds.variables["Time"][:])
        groups = {int(name): {var: np.asarray(g.variables[var][...])
                              for var in rec["groups"].get(int(name), {})}
                  for name, g in ds.groups.items()}
    finally:
        ds.close()
    if times.tolist() != np.asarray(rec["Time"], np.float32).tolist():
        raise AssertionError("%s: Time %s, the writer was handed %s"
                             % (path, times.tolist(), rec["Time"]))
    if set(groups) != set(rec["groups"]):
        raise AssertionError("%s: groups %s, the writer's %s" % (
            path, sorted(groups), sorted(rec["groups"])))
    for col, g in rec["groups"].items():
        for var, steps in g.items():
            got = groups[col][var]
            for i, want in steps.items():
                if got[i].shape != want.shape or \
                        got[i].tobytes() != want.tobytes():
                    raise AssertionError(
                        "%s: column %d %s record %d differs from what the "
                        "writer was handed" % (path, col, var, i))
    return times.tolist(), groups


def cli_leg(argv, writer, before_finalize=None):
    """One run through the port's CLI (spmaster.build_runner + drive, as
    spmaster.main), each step timed on the host clock; the launch counts
    are set to 0 just before it and read just after; the cross-section
    writes inside the steps are timed too (runner.cross_walls);
    before_finalize(runner), where given, runs after the last step and
    before runner.finalize (the checkpoint). Returns (runner, step walls,
    launches)."""
    from sp_coupler_tpu_torch import spmaster
    runner = spmaster.build_runner(argv, writer=writer)
    if before_finalize is not None:
        finalize = runner.finalize

        def hooked_finalize(*a, **kw):
            before_finalize(runner)
            return finalize(*a, **kw)

        runner.finalize = hooked_finalize
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
    check_launches(name, launches,
                   int(sum(per_step(s) for s in runner.substeps)), kernels)


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


def spifs_file(path, have_h5py):
    """What wrote a spifs.nc (its _NCProperties, which must name h5lite),
    its size and timing.txt's host-I/O column; logged."""
    from sp_coupler_tpu_torch.io import spifs
    ds = spifs.open_reader(path)
    try:
        prov = ds._h5file.attrs["_NCProperties"].decode()
    finally:
        ds.close()
    if "h5lite" not in prov or "h5py" in sys.modules:
        raise AssertionError("%s written as %r; h5py imported: %s"
                             % (path, prov, "h5py" in sys.modules))
    _, rows = timing_rows(os.path.dirname(path))
    out = dict(provenance=prov, bytes=os.path.getsize(path),
               host_io_s=[r[-1] for r in rows], h5py_importable=have_h5py)
    log("spifs.nc: written by the port's h5lite writer (%s), h5py %s on "
        "this host and not imported; %d bytes, every record read back "
        "bit for bit through spifs.open_reader; timing.txt host-I/O "
        "column %s s" % (prov, "importable" if have_h5py
                         else "not importable", out["bytes"],
                         out["host_io_s"]))
    return out


def phase_cli(card, main_steps):
    """run_T21.sh's run through the port's CLI on the card, its restart,
    and a small Smagorinsky leg with the variability nudge.
    main_steps: phase_main's step records of the same 2 steps through the
    bare CoupledStepFn, printed beside the CLI's."""
    import importlib.util
    import tempfile
    writer = tee_writer()
    have_h5py = importlib.util.find_spec("h5py") is not None
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
        res["spifs"] = spifs_file(spifs_path, have_h5py)
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
        res["spifs_restart"] = spifs_file(spifs_path, have_h5py)
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


# ---- instance parallelism: 2 ranks on one card --------------------------

# the bench.py case through the CLI: T21/L19 + 2 x 64x64x160 (RICO, TKE),
# columns 1208/1272, dt_les 15 s, each instance its own adaptive loop
# (serial: bitwise the same arithmetic on 1 rank and on 2), 2 coupled steps
BENCH_COLS = [1208, 1272]
MESH_RANKS = 2
MESH_TIMEOUT = 300      # s for the ranks' run: a hung collective fails it
MESH_CONF = {"les_schedule": "serial", "timing_phases": 0}
SCALE_GRID = (32, 32, 64)   # scalebench.measure(sizes=[1, 2]) in the ranks


def bench_argv(odir, conf, mesh_les=1):
    """spmaster flags of the bench.py case: the columns as --points (the
    T21 grid's own lat/lon, so each point selects its column)."""
    from sp_coupler_tpu_torch.models.gcm import spharm
    sht = spharm.SpectralTransform(21, device="cpu")
    lats, lons = sht.latitudes_deg(), sht.longitudes_deg()
    pts = []
    for c in BENCH_COLS:
        pts += ["%.6f" % lats[c // len(lons)], "%.6f" % lons[c % len(lons)]]
    return (["--points"] + pts + ["--les_dt", "15", "--steps", "1",
                                  "--conf", conf, "--odir", odir]
            + (["--mesh_les", str(mesh_les)] if mesh_les > 1 else []))


def gcm_leaves(runner):
    from sp_coupler_tpu_torch.utils import tree
    return [l.detach().cpu().numpy() for l in tree.flatten(runner.gcm.state)[0]]


def mesh_rank(odir, conf, report):
    """One rank of phase_mesh (``chip_smoke.py --mesh-rank ODIR CONF
    REPORT``, SPTPU_DIST_* set): the bench case through the CLI with
    --mesh_les 2, the replicate check of the GCM state, then
    scalebench.measure(sizes=[1, 2]); writes REPORT.<rank>.json (+ the
    GCM state, and rank 0's records)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    from sp_coupler_tpu_torch.runtime import scalebench
    try:
        runner, walls, launches = cli_leg(bench_argv(odir, conf, MESH_RANKS),
                                          tee_writer())
        rank = pmesh.rank()
        if runner.mesh is None or pmesh.world_size() != MESH_RANKS:
            raise AssertionError("rank %d: no les mesh over %d ranks"
                                 % (rank, MESH_RANKS))
        pmesh.replicate(runner.gcm.state, pmesh.make_mesh())
        pos = runner.fleet.positions
        np.savez("%s.%d.gcm.npz" % (report, rank), *gcm_leaves(runner))
        if rank == 0:
            times, groups = read_records(os.path.join(odir, "spifs.nc"))
            np.savez(report + ".records.npz", Time=np.asarray(times),
                     **{"%d/%s" % (c, v): a for c, g in groups.items()
                        for v, a in g.items()})
        nx, ny, nz = SCALE_GRID
        bench = scalebench.measure(sizes=[1, 2], nx=nx, ny=ny, nz=nz,
                                   device=runner.device, verbose=False)
        rep = dict(rank=rank, device=str(runner.device), positions=pos,
                   sp_cols=runner.sp_cols, walls=walls,
                   substeps=runner.substeps, launches=launches,
                   own_substeps=int(sum(s[p] for s in runner.substeps
                                        for p in pos)),
                   bench=bench, **transport())
    finally:
        pmesh.shutdown()
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


class RanksTimedOut(AssertionError):
    """A rank set that did not finish in its time (a hung collective)."""


def rank_env(n, rank, store, backend, threads=None):
    """The environment of rank `rank` of n meeting through the file store:
    under "gloo" the ranks share this card (SPTPU_DIST_BACKEND=gloo); under
    "nccl" (the port's default on the card) each rank takes its own card,
    cuda:LOCAL_RANK, and SPTPU_DIST_BACKEND is unset."""
    if backend not in ("gloo", "nccl"):
        raise ValueError("backend %r (gloo or nccl)" % backend)
    env = dict(os.environ, SPTPU_DIST_COORD="file://" + store,
               SPTPU_DIST_NPROCS=str(n), SPTPU_DIST_PROC_ID=str(rank))
    env.pop("SPTPU_DIST_BACKEND", None)
    if backend == "gloo":
        env["SPTPU_DIST_BACKEND"] = "gloo"
    else:
        env.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        env.setdefault("NCCL_DEBUG", "WARN")     # nccl's faults in the log
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def transport():
    """A rank's process group backend and the CUDA tensors its collectives
    took through host memory (counted since the process started)."""
    import torch.distributed as dist
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    return dict(backend=dist.get_backend(), staged=pmesh.staged_tensors)


def check_transport(what, reps, backend):
    """Every rank ran `backend`; under nccl rank r ran on cuda:r and its
    collectives took no CUDA tensor through host memory."""
    for rep in reps:
        r = rep["rank"]
        if rep["backend"] != backend:
            raise AssertionError("%s: rank %d ran %s, not %s"
                                 % (what, r, rep["backend"], backend))
        if backend == "nccl" and (rep["device"] != "cuda:%d" % r
                                  or rep["staged"]):
            raise AssertionError(
                "%s: rank %d ran on %s (want cuda:%d) and staged %d CUDA "
                "tensors through the host" % (what, r, rep["device"], r,
                                              rep["staged"]))


def where(backend, n):
    """How n ranks sit on the cards, for the logs."""
    return ("%d ranks sharing one card (gloo)" % n if backend == "gloo"
            else "%d ranks on %d cards, one card a rank (nccl)" % (n, n))


def run_rank_set(tag, n, timeout, argv, store, threads=None, backend="gloo",
                 module=None):
    """Start n ranks of this script (``chip_smoke.py ARGV``, or ``python -m
    MODULE ARGV``; SPTPU_DIST_* set, rank_env), meeting through the file
    store: under gloo on this card (shared), under nccl one card a rank.
    Each must exit 0 within timeout s, else every rank is killed and the
    phase fails; a rank that fails ends the set at once (its peers would
    wait for it in a collective). Their logs go to
    OUT_DIR/<tag>_rank<r>.log. Returns the seconds they took."""
    os.makedirs(OUT_DIR, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ([sys.executable, "-m", module] if module else
           [sys.executable, os.path.join(here, "chip_smoke.py")])
    procs, logs = [], []
    for rank in range(n):
        env = rank_env(n, rank, store, backend, threads)
        logs.append(open(os.path.join(OUT_DIR, "%s_rank%d.log" % (tag, rank)),
                         "w"))
        procs.append(subprocess.Popen(
            cmd + [str(a) for a in argv], cwd=here, env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.time() - t0 > timeout:
                raise RanksTimedOut(
                    "%s: the ranks did not finish in %d s (logs in "
                    "%s/%s_rank*.log)" % (tag, timeout, OUT_DIR, tag))
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        first = ([r for r in bad if procs[r].returncode > 0] or bad)[0]
        with open(os.path.join(OUT_DIR, "%s_rank%d.log" % (tag, first))) as f:
            tail = f.read()[-3000:]
        raise AssertionError("%s: rank(s) %s exited %s:\n%s"
                             % (tag, bad, [procs[r].returncode for r in bad],
                                tail))
    return time.time() - t0


def phase_mesh(card, backend="gloo"):
    """The bench case on 2 ranks (--mesh_les 2; under gloo sharing this
    card, under nccl on 2 cards) against one process in the same call:
    rank 0's records and the GCM state equal the single process's, the
    GCM state is the same on both ranks, each rank launches lesstage 3 x
    its own substeps; the walls of both, and scalebench's sizes 1 and 2
    (structural). Returns the launch counts of both runs (the ranks'
    summed) and the single process's records, substeps, walls and GCM
    state (phase_spatial's reference)."""
    import tempfile
    from sp_coupler_tpu_torch.ops import _build
    _build.load("lesstage")         # built before the ranks start
    with tempfile.TemporaryDirectory() as tmp:
        conf, single, launches1, grid, row_bytes = bench_single(tmp)
        times1, groups1, gcm1, sub1, walls1 = (
            single[k] for k in ("times", "groups", "gcm", "substeps",
                                "walls"))
        report = os.path.join(tmp, "rank")
        tag = "mesh" if backend == "gloo" else "cards_mesh"
        ranks_wall = run_rank_set(
            tag, MESH_RANKS, MESH_TIMEOUT,
            ["--mesh-rank", os.path.join(tmp, "mesh"), conf, report],
            os.path.join(tmp, "store"), backend=backend)
        reps = []
        for r in range(MESH_RANKS):
            with open("%s.%d.json" % (report, r)) as f:
                reps.append(json.load(f))
        check_transport(tag, reps, backend)
        gcms = [np.load("%s.%d.gcm.npz" % (report, r))
                for r in range(MESH_RANKS)]
        gcms = [[g["arr_%d" % i] for i in range(len(g.files))] for g in gcms]
        rec = np.load(report + ".records.npz")
        diffs = {}
        if not np.array_equal(rec["Time"], np.asarray(times1)):
            diffs["Time"] = (rec["Time"].tolist(), times1)
        keys = {"%d/%s" % (c, v) for c, g in groups1.items() for v in g}
        if keys != set(rec.files) - {"Time"}:
            raise AssertionError("mesh: rank 0 wrote %s, the single process "
                                 "%s" % (sorted(rec.files), sorted(keys)))
        for k in sorted(keys):
            c, v = k.split("/", 1)
            a, b = rec[k], groups1[int(c)][v]
            if not np.array_equal(a, b):
                diffs[k] = float(np.max(np.abs(a - b))
                                 / max(float(np.max(np.abs(b))), 1e-30))
        for r, g in enumerate(gcms[1:], 1):
            if not all(np.array_equal(x, y) for x, y in zip(g, gcms[0])):
                raise AssertionError("mesh: the GCM state of rank %d differs "
                                     "from rank 0's" % r)
        if not all(np.array_equal(x, y) for x, y in zip(gcms[0], gcm1)):
            diffs["gcm state"] = max(float(np.max(np.abs(x - y)))
                                     for x, y in zip(gcms[0], gcm1))
        if diffs:
            raise AssertionError("mesh: rank 0's output differs from the "
                                 "single process's (max|diff| / max|ref|): "
                                 "%s" % diffs)
        total = {k: 0 for k in launches1}
        for rep in reps:
            if rep["substeps"] != sub1:
                raise AssertionError("mesh: rank %d substeps %s, single %s"
                                     % (rep["rank"], rep["substeps"], sub1))
            for k, count in rep["launches"].items():
                want = 3 * rep["own_substeps"] if k == "lesstage" else 0
                if count != want or (k == "lesstage" and count == 0):
                    raise AssertionError(
                        "mesh: rank %d launched %s %d times, want %d (3 x "
                        "its %d substeps)" % (rep["rank"], k, count, want,
                                              rep["own_substeps"]))
                total[k] += count
        log("%s: %s, --mesh_les 2, bench case T21/L19 + 2 x %dx%dx%d, "
            "columns %s: rank 0's %d records == the single process's, bit "
            "for bit (%d variables), the GCM state the same on both ranks "
            "and the single process; ranks on %s, CUDA tensors staged "
            "through the host %s; positions %s, lesstage launches %s = 3 x "
            "own substeps %s; the step's all_gather moves %d B an instance "
            "on %s"
            % (tag, where(backend, MESH_RANKS), grid.nx, grid.ny, grid.nz,
               BENCH_COLS, len(times1), len(keys),
               [r["device"] for r in reps], [r["staged"] for r in reps],
               [r["positions"] for r in reps],
               [r["launches"]["lesstage"] for r in reps],
               [r["own_substeps"] for r in reps], row_bytes, card))
        for i in range(len(walls1)):
            log("%s step %d walls (%s): rank 0 %.3f s, rank 1 %.3f s; "
                "single process %.3f s; substeps %s"
                % (tag, i, where(backend, MESH_RANKS), reps[0]["walls"][i],
                   reps[1]["walls"][i], walls1[i], sub1[i]))
        b = reps[0]["bench"]
        log("%s scalebench %s, %d x %s instances a rank, %d substeps (%s; "
            "structural): updates/s %s, efficiency %s on %s"
            % (tag, b["mode"], b["per_device_instances"], b["grid"],
               b["substeps"], where(backend, MESH_RANKS),
               b["updates_per_s"], b["efficiency"], card))
        res = dict(card=card, backend=backend,
                   single=dict(walls=walls1, substeps=sub1,
                               launches=launches1),
                   ranks=reps, ranks_wall_s=ranks_wall, bitwise=True,
                   gather_bytes_per_instance=row_bytes)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_%s.json" % tag), "w") as f:
        json.dump(res, f, indent=1)
    return [launches1, total], single


def bench_single(tmp):
    """The bench case through the CLI in this process, its conf
    (MESH_CONF) and output in the directory tmp: phase_mesh's single
    process. Returns (the conf's path, {times, groups: its records,
    substeps, walls, gcm: the GCM state's leaves}, its launches, the LES
    grid, the bytes an instance the coupled step's all_gather moves)."""
    from sp_coupler_tpu_torch.models.les import diag as ldiag
    conf = os.path.join(tmp, "mesh.json")
    with open(conf, "w") as f:
        json.dump(MESH_CONF, f)
    single_dir = os.path.join(tmp, "single")
    runner, walls, launches = cli_leg(bench_argv(single_dir, conf),
                                      tee_writer())
    if runner.sp_cols != BENCH_COLS:
        raise AssertionError("the bench points selected %s, not %s"
                             % (runner.sp_cols, BENCH_COLS))
    check_leg_launches("mesh single", runner, launches, PATH_KERNELS["tke"])
    times, groups = read_records(os.path.join(single_dir, "spifs.nc"))
    grid = runner.fleet.grid
    # the all_gather's row: the slab profiles, the substep and clamp counts
    prof = ldiag.slab_profiles(grid, runner.fleet.state)
    row_bytes = 4 * (sum(v.numel() for v in prof.values())
                     // runner.fleet.n + 2)
    single = dict(times=times, groups=groups, substeps=runner.substeps,
                  walls=walls, gcm=gcm_leaves(runner))
    del runner, prof
    torch.cuda.empty_cache()
    return conf, single, launches, grid, row_bytes


# ---- intra-LES spatial decomposition: blocks of the plane --------------

# (a) the halo-mode kernels in this process: SPATIAL_GRID (nx, ny, nz) at
# n = SPATIAL_N, cut into SPLIT = (n_x, n_y) blocks whose halos are
# filled by slicing the whole field (parallel.plane.Plane.block), the
# plane-means kernel's float64 sums added across the blocks
SPATIAL_GRID, SPATIAL_N, SPLIT = (64, 64, 160), 2, (2, 2)
# (b), (c): SPATIAL_RANKS ranks sharing this card (gloo), each a
# subprocess of this script, SPATIAL_TIMEOUT s for all their legs
SPATIAL_RANKS = 4
SPATIAL_TIMEOUT = 600
# (b): tests/test_parallel.py:185-229 on the port: one 64x64x160
# instance (its _one_instance profiles, the port's draws), 20 substeps of
# 2 s, 2 x 2 blocks against one process, at its atol/rtol 2e-3
EVOLVE_SUBSTEPS, EVOLVE_DT = 20, 2.0
EVOLVE_TOL = dict(atol=2e-3, rtol=2e-3)
# under nccl (--cards 4) (b) evolves BASELINE config 4's fleet instead,
# CONFIG4_N x 128x128x160 (phase_t255's), on 2 x 2 blocks of 64x64x160
CONFIG4_N = 4
# (c): the bench case through the CLI with --lesprocs 4 against phase_mesh's
# single process (its records within verify/parity.py's PROFILE_TOL of
# max|ref| by step), and phase_cli's small Smagorinsky + nudge leg with
# --mesh_les 2 --lesprocs 2
SPATIAL_ARGS = ["--lesprocs", "4"]
SMAG_SPATIAL = ["--mesh_les", "2", "--lesprocs", "2"]
SMAG_CONF = {"les_itot": 16, "les_jtot": 16, "les_ktot": 32,
             "les_subgrid": "smagorinsky", "timing_phases": 0,
             "les_schedule": "serial"}
SMAG_ARGV = ["--trunc", "10", "--levels", "8", "--steps", "1", "--points",
             "15", "-50", "--numles", "2", "--qt_forcing", "variance"]
# f_thl = (THL_gcm - <thl>_les) / dt, the LES thl forcing, is a difference
# of two ~300 K float32 values over dt; on blocks <thl> is a float64 sum
# over the ranks, in one process a float32 one, so the two differ by a
# float32 spacing or two of 300 K (3.05e-5 K) over the record's dt. Beside
# PROFILE_TOL of max|ref| it may differ by F_ULPS spacings of max|thl|
# over dt (tests/test_torch_spatial.py holds the CPU runs the same way)
F_ULPS = 8
# the halo-mode entries of the kernels line: name -> the wrapper's
# whole-plane entry
HALO_KERNELS = {"lesstage_halo": "lesstage", "lesflat_halo": "lesflat",
                "lesmom_halo": "lesmom"}


def split_planes(ny, nx):
    """The Planes of the SPLIT blocks of an ny x nx plane (their cuts
    only: no collective runs in this process)."""
    from sp_coupler_tpu_torch.parallel import plane as pplane
    n_x, n_y = SPLIT
    return [pplane.Plane(ny, nx, n_y, n_x, iy, ix)
            for ix in range(n_x) for iy in range(n_y)]


def assemble(planes, parts):
    """The whole planes of the blocks parts[i] of planes[i]."""
    p0 = planes[0]
    out = torch.empty(parts[0].shape[:-2] + (p0.ny, p0.nx),
                      dtype=parts[0].dtype, device=parts[0].device)
    for p, x in zip(planes, parts):
        out[..., p.y0:p.y0 + p.by, p.x0:p.x0 + p.bx] = x
    return out


def stage_blocks(planes, grid, phys, cur, base, frc, frac, dt):
    """The stage kernel in halo mode on every block of planes, in this
    process: the plane-means kernel on each padded block, their float64
    sums added, then the stage kernel on each; the outputs assembled into
    whole planes, kmax the blocks' maximum."""
    from sp_coupler_tpu_torch.models.les import step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    pend = []
    for p in planes:
        pcur = cur._replace(**{k: p.block(getattr(cur, k), lesstage.HALO)
                               for k in lstep.FIELDS})
        pend.append(lesstage.stage_sums(grid, phys, pcur,
                                        p.block_fields(base), frc, frac, dt))
    total = sum(q.sums for q in pend)
    outs = [lesstage.stage_apply(q, total, grid.ny * grid.nx) for q in pend]
    fields = [assemble(planes, [o[i] for o in outs]) for i in range(7)]
    kmax = torch.stack([o[7] for o in outs]).amax(0)
    return tuple(fields) + (kmax, outs[0][8], outs[0][9])


def split_blocks(planes, name, args, halo):
    """The split kernel `name`'s arguments on each block of planes, the
    fields padded with halo points (the density profiles and spacings
    as they are)."""
    fields = 5 if name != "lesmom" else 4
    return [tuple(p.block(a, halo) for a in args[:fields]) + args[fields:]
            for p in planes]


def spatial_kernels(card):
    """(a): the halo-mode kernels #1-#3 on 2 x 2 blocks of SPATIAL_GRID,
    n = SPATIAL_N, against the whole-plane kernels and against their plain
    versions; device times of a 32 x 32 block's call against the whole
    plane's, and against the whole-plane kernel on a plane of the block's
    size. Returns {name: max_abs_err, times} for the kernels line."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    nx, ny, nz = SPATIAL_GRID
    n = SPATIAL_N
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    planes = split_planes(ny, nx)
    phys = lstep.LESPhysics()
    res = {}
    worst = 0.0
    for inputs in (stage_inputs, rough_inputs):
        cur, base, frc, dt = inputs(grid, n, 21)
        args = (grid, phys, cur, base, frc, 0.5, dt)
        got = stage_blocks(planes, *args)
        whole = lesstage.stage_fused_cuda(*args)
        plain = lesstage.stage_fused_reference(*args)
        inc_k, inc_p = {}, {}
        for k, a, b, c in zip(STAGE_NAMES, got[:7], whole[:7], plain[:7]):
            b_k = base.w[:, :-1] if k == "w" else getattr(base, k)
            inc_k[k] = check_increment("halo %s vs whole-plane kernel" % k,
                                       a, b, b_k, INC_FRAC, INC_RTOL)
            inc_p[k] = check_increment("halo %s vs plain" % k, a, c, b_k,
                                       INC_FRAC, INC_RTOL)
            worst = max(worst, check_close("halo %s vs plain" % k, a, c,
                                           **FIELD_TOL))
        for ref, what in ((whole, "whole-plane kernel"), (plain, "plain")):
            check_close("halo kmax vs " + what, got[7], ref[7], 0.0,
                        KMAX_RTOL)
            check_close("halo ustar2 vs " + what, got[8], ref[8], 0.0,
                        USTAR2_RTOL)
            check_close("halo rain vs " + what, got[9], ref[9], **RAIN_TOL)
        log("spatial (a) lesstage halo mode, %dx%dx%d n=%d in %dx%d blocks "
            "(halo %d), %s: increments ok, err / max|increment| vs the "
            "whole-plane kernel %s, vs plain %s; kmax rel err vs whole %.3g"
            % (nx, ny, nz, n, SPLIT[0], SPLIT[1], lesstage.HALO,
               inputs.__name__, " ".join("%s %.2g" % kv
                                         for kv in inc_k.items()),
               " ".join("%s %.2g" % kv for kv in inc_p.items()),
               float((got[7] / whole[7] - 1).abs().max())))
    res["lesstage_halo"] = dict(max_abs_err=worst)

    # times: one block's halo-mode call (both launches, its own sums)
    # against the whole plane's call and the whole-plane kernel on a
    # plane of the block's size
    cur, base, frc, dt = stage_inputs(grid, n, 21)
    p = planes[0]
    pcur = cur._replace(**{k: p.block(getattr(cur, k), lesstage.HALO)
                           for k in lstep.FIELDS})
    pbase = p.block_fields(base)

    def block_call():
        q = lesstage.stage_sums(grid, phys, pcur, pbase, frc, 0.5, dt)
        return lesstage.stage_apply(q, q.sums, grid.ny * grid.nx)

    bgrid = lgrid.LESGrid(nx=p.bx, ny=p.by, nz=nz)
    bcur, bbase, bfrc, bdt = stage_inputs(bgrid, n, 21)
    small = lambda: lesstage.stage_fused_cuda(bgrid, phys, bcur, bbase,
                                              bfrc, 0.5, bdt)
    plain_block = lambda: lesstage.stage_fused_reference(
        bgrid, phys, bcur, bbase, bfrc, 0.5, bdt)
    big = lambda: lesstage.stage_fused_cuda(grid, phys, cur, base, frc, 0.5,
                                            dt)
    ms = cuda_ms(block_call)
    dev = device_ms(block_call, DEVICE_KERNELS["lesstage"])
    dev_small = device_ms(small, DEVICE_KERNELS["lesstage"])
    dev_big = device_ms(big, DEVICE_KERNELS["lesstage"])
    plain_ms = cuda_ms(plain_block)
    pts = n * nz * p.by * p.bx
    nbytes = 4 * (7 * n * nz * (p.by + 6) * (p.bx + 6) + 14 * pts
                  + n * (7 * nz + 4) + 3 * n) + 8 * 7 * n * nz
    b_ms, by = bound_ms(nbytes, KERNEL_OPS["lesstage"] * pts)
    res["lesstage_halo"]["times"] = (ms, plain_ms, b_ms, by, dev)
    log("  lesstage halo mode, a %dx%dx%d block n=%d: %.3f ms by CUDA "
        "events, %.4f ms of device time; the whole-plane kernel on a "
        "%dx%dx%d plane %.4f ms, on the whole %dx%dx%d plane %.4f ms (4 "
        "blocks' worth); plain PyTorch on a plane of the block's size %.3f "
        "ms; bound %.4f ms (%s), %.1f %% of the device time, on %s"
        % (p.bx, p.by, nz, n, ms, dev, p.bx, p.by, nz, dev_small, nx, ny,
           nz, dev_big, plain_ms, b_ms, by, 100 * b_ms / dev, card))

    # kernels #2, #3: each block against its plain version on the same
    # padded block and against the whole-plane kernel's block
    for name, launch, plain, args_of, tol, _ in split_kernels():
        if name == "advect":
            continue
        r = res[name + "_halo"] = dict(max_abs_err=0.0)
        for inputs in (split_inputs, rough_split_inputs):
            args = args_of(inputs(grid, n, 31), grid)
            whole = launch(*args)
            fr_k, fr_p = [], []
            for q, pa in zip(planes, split_blocks(planes, name, args,
                                                  lesstage.HALO)):
                got = launch(*pa, halo=lesstage.HALO)
                ref = plain(*pa, halo=lesstage.HALO)
                cut = (q.block(whole) if torch.is_tensor(whole)
                       else tuple(q.block(x) for x in whole))
                fr_p += check_arrays(name + " halo vs plain", got, ref, tol)
                fr_k += check_arrays(name + " halo vs whole-plane kernel",
                                     got, cut, tol)
                r["max_abs_err"] = max([r["max_abs_err"]] + [
                    float((a - b).abs().max())
                    for a, b in zip(output_arrays(got), output_arrays(ref))])
            log("spatial (a) %s halo mode, %dx%dx%d n=%d in %dx%d blocks, "
                "%s: ok, worst err / max|ref| per array vs plain %.2g, vs "
                "the whole-plane kernel %.2g" % (
                    name, nx, ny, nz, n, SPLIT[0], SPLIT[1],
                    inputs.__name__, max(fr_p), max(fr_k)))
        args = args_of(split_inputs(grid, n, 31), grid)
        pa = split_blocks(planes, name, args, lesstage.HALO)[0]
        blk = lambda: launch(*pa, halo=lesstage.HALO)
        out = blk()
        ms = cuda_ms(blk)
        dev = device_ms(blk, DEVICE_KERNELS[name])
        plain_ms = cuda_ms(lambda: plain(*pa, halo=lesstage.HALO))
        dev_big = device_ms(lambda: launch(*args), DEVICE_KERNELS[name])
        b_ms, by = bound_ms(tensor_bytes(pa, out),
                            KERNEL_OPS[name] * n * nz * p.by * p.bx)
        r["times"] = (ms, plain_ms, b_ms, by, dev)
        log("  %s halo mode, a %dx%dx%d block n=%d: %.3f ms by CUDA "
            "events, %.4f ms of device time (plain PyTorch on the padded "
            "block %.3f ms); the whole-plane kernel on the whole plane "
            "%.4f ms; bound %.4f ms (%s), %.1f %% of the device time, on "
            "%s" % (name, p.bx, p.by, nz, n, ms, dev, plain_ms, dev_big,
                    b_ms, by, 100 * b_ms / dev, card))
    return res


def one_instance(dev):
    """tests/test_parallel.py's _one_instance on the port: one 64x64x160
    instance (RICO profiles, the port's draws from a CPU generator) and
    its forcing."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, state as lstate
    grid = lgrid.LESGrid()
    zf = grid.zf("cpu")
    thl0 = 297.9 + torch.clamp_min(zf - 740.0, 0.0) * 19.1 / 3260.0
    qt0 = 16e-3 * torch.exp(-zf / 2500.0)
    u0 = -9.9 + 2e-3 * zf
    v0 = torch.full_like(zf, -3.8)
    st = lstate.init_state(grid, u0[None], v0[None], thl0[None], qt0[None],
                           1.0e5, torch.Generator().manual_seed(42))
    frc = lstate.LESForcing.zeros(1, grid.nz, device="cpu")
    full = lambda v: torch.full((1,), v)
    frc = frc._replace(wthl=full(0.012), wqt=full(4e-5))
    to = lambda t: type(t)(*[x.to(dev) for x in t])
    return grid, to(st), to(frc)


def spatial_rank(odir, report):
    """One rank of phase_spatial (``chip_smoke.py --spatial-rank ODIR
    REPORT``, SPTPU_DIST_* set): (b) the evolve of ODIR/evolve.pt's fleet
    on 2 x 2 blocks, then (c) the bench case through the CLI with
    SPATIAL_ARGS and the small Smagorinsky + nudge leg with SMAG_SPATIAL;
    writes REPORT.<rank>.json (+ rank 0's fields and records, each rank's
    GCM state)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch.models.les import step as lstep
    from sp_coupler_tpu_torch.parallel import mesh as pmesh, plane as pplane
    dev = torch.device("cuda")
    try:
        pmesh.init_distributed(dev)
        rank = pmesh.rank()
        dev = torch.device("cuda", torch.cuda.current_device())
        # (b)
        grid, st, frc = load_case(os.path.join(odir, "evolve.pt"), dev)
        mesh = pmesh.make_mesh(1, 2, 2)
        plane = pplane.for_mesh(mesh, grid.ny, grid.nx)
        local = pmesh.shard_fleet(st, mesh, plane)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        out = lstep.evolve(grid, lstep.LESPhysics(), local, frc, EVOLVE_DT,
                           EVOLVE_SUBSTEPS, plane=plane)
        torch.cuda.synchronize()
        ev = dict(wall=time.time() - t0, launches=read_launches())
        ev["warm"] = device_split(lambda: lstep.evolve(
            grid, lstep.LESPhysics(), local, frc, EVOLVE_DT,
            EVOLVE_SUBSTEPS, plane=plane))[1]       # the same again, warm
        whole = plane.gather_fields(out)
        if rank == 0:
            np.savez(report + ".evolve.npz",
                     **{k: getattr(whole, k).cpu().numpy()
                        for k in STAGE_NAMES})
        # (c)
        conf = os.path.join(odir, "mesh.json")
        runner, walls, launches = cli_leg(
            bench_argv(os.path.join(odir, "bench"), conf) + SPATIAL_ARGS,
            tee_writer())
        if runner.mesh is None or runner.fleet.plane is None:
            raise AssertionError("rank %d: no spatial mesh" % rank)
        pmesh.replicate(runner.gcm.state, runner.mesh)
        np.savez("%s.%d.gcm.npz" % (report, rank), *gcm_leaves(runner))
        if rank == 0:
            times, groups = read_records(os.path.join(odir, "bench",
                                                      "spifs.nc"))
            np.savez(report + ".records.npz", Time=np.asarray(times),
                     **{"%d/%s" % (c, v): a for c, g in groups.items()
                        for v, a in g.items()})
        pos = runner.fleet.positions
        bench = dict(walls=walls, substeps=runner.substeps,
                     launches=launches, positions=pos,
                     block=list(runner.fleet.state.u.shape),
                     own_substeps=int(sum(s[p] for s in runner.substeps
                                          for p in pos)))
        del runner
        conf3 = os.path.join(odir, "small.json")
        runner, walls, launches = cli_leg(
            SMAG_ARGV + ["--conf", conf3, "--odir",
                         os.path.join(odir, "small")] + SMAG_SPATIAL,
            tee_writer())
        pos = runner.fleet.positions
        smag = dict(walls=walls, substeps=runner.substeps,
                    launches=launches, positions=pos,
                    block=list(runner.fleet.state.u.shape),
                    own_substeps=int(sum(s[p] for s in runner.substeps
                                         for p in pos)))
        if rank == 0:
            times, groups = read_records(os.path.join(odir, "small",
                                                      "spifs.nc"))
            smag["finite"] = all(np.all(np.isfinite(a))
                                 for g in groups.values()
                                 for a in g.values())
            smag["n_rec"] = len(times)
        rep = dict(rank=rank, device=str(dev), evolve=ev, bench=bench,
                   smag=smag, **transport())
    finally:
        pmesh.shutdown()
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


def record_diffs(ref_times, ref_groups, rec):
    """{column/variable: largest over records t of max|got_t - ref_t| /
    max|ref_t|} of rank 0's records rec (npz) against the single
    process's; raises where a record lies beyond verify/parity.py's
    PROFILE_TOL for its step (f_thl: plus F_ULPS float32 spacings of the
    slab-mean thl over the record's dt)."""
    from sp_coupler_tpu_torch.verify.parity import PROFILE_TOL
    if not np.array_equal(rec["Time"], np.asarray(ref_times)):
        raise AssertionError("spatial: record times %s, single %s"
                             % (rec["Time"].tolist(), ref_times))
    keys = {"%d/%s" % (c, v) for c, g in ref_groups.items() for v in g}
    if keys != set(getattr(rec, "files", rec)) - {"Time"}:
        raise AssertionError("spatial: rank 0 wrote %s, the single process "
                             "%s" % (sorted(rec.files), sorted(keys)))
    out, bad = {}, []
    for k in sorted(keys):
        c, v = k.split("/", 1)
        a = np.asarray(ref_groups[int(c)][v], np.float64)
        b = np.asarray(rec[k], np.float64)
        d = 0.0
        for t in range(a.shape[0]):
            scale = float(np.max(np.abs(a[t]))) + 1e-12
            err = float(np.max(np.abs(b[t] - a[t])))
            tol = PROFILE_TOL[min(t, len(PROFILE_TOL) - 1)] * scale
            if v == "f_thl":
                dt = ref_times[t] - (ref_times[t - 1] if t else 0.0)
                thl = np.max(np.abs(ref_groups[int(c)]["thl"][t]))
                tol += F_ULPS * float(np.spacing(np.float32(thl))) / dt
            if err > tol:
                bad.append((k, t, err / scale, err))
            d = max(d, err / scale)
        out[k] = d
    if bad:
        raise AssertionError("spatial: records beyond PROFILE_TOL: %s" % bad)
    return out


def save_case(path, grid, st, frc):
    """Write an evolve case (its grid's extents and spacings, the fleet
    state and forcing, on the CPU) for load_case."""
    torch.save(dict(grid=dict(nx=grid.nx, ny=grid.ny, nz=grid.nz,
                              dx=grid.dx, dy=grid.dy, dz=grid.dz),
                    state=[x.cpu() for x in st],
                    forcing=[x.cpu() for x in frc]), path)


def load_case(path, dev):
    """save_case's (grid, state, forcing), the tensors on dev."""
    from sp_coupler_tpu_torch.models.les import grid as lgrid, state as lstate
    d = torch.load(path, weights_only=False)
    return (lgrid.LESGrid(**d["grid"]),
            lstate.LESState(*[x.to(dev) for x in d["state"]]),
            lstate.LESForcing(*[x.to(dev) for x in d["forcing"]]))


def config4_fleet(dev):
    """BASELINE config 4's instances as phase_t255 starts them
    (runtime/t255bench.py at T255_ARGV: T255/L19 SL hybrid from seed 0,
    4 columns, 128x128x160 LES at 100 m, seed_les), with
    one_instance's surface fluxes as forcing."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model
    from sp_coupler_tpu_torch.models.les import grid as lgrid, state as lstate
    from sp_coupler_tpu_torch.runtime import t255bench
    core = gcm_model.GCMCore(gcm_model.GCMConfig(
        trunc=255, nlev=19, dt=900.0, hybrid=True, advection="sl"),
        device=dev)
    grid = lgrid.LESGrid(nx=128, ny=128, nz=160, dx=100.0, dy=100.0,
                         dz=25.0)
    cols = t255bench.columns(core, CONFIG4_N)
    st = t255bench.seed_les(core, core.initial_state(seed=0), grid, cols)
    frc = lstate.LESForcing.zeros(CONFIG4_N, grid.nz, device=dev)
    full = lambda v: torch.full((CONFIG4_N,), v, device=dev)
    return grid, st, frc._replace(wthl=full(0.012), wqt=full(4e-5))


def phase_spatial(card, single, backend="gloo"):
    """Intra-LES spatial decomposition on the card: (a) under gloo, the
    halo-mode kernels in this process (under nccl each card checks them,
    phase_card_kernels); (b) an evolve on 2 x 2 blocks by 4 ranks against
    one process: under gloo one 64x64x160 instance (one_instance) on
    ranks sharing the card, under nccl BASELINE config 4's 4 x
    128x128x160 (config4_fleet) on 4 cards; (c) the bench case through
    the CLI with --lesprocs 4 against phase_mesh's single process
    (``single``), and a small Smagorinsky + nudge leg with --mesh_les 2
    --lesprocs 2 whose split-kernel launches are in halo mode. Returns
    (kernels-line stats or None, the ranks' launch counts)."""
    import tempfile
    from sp_coupler_tpu_torch.models.les import step as lstep
    t_phase = time.time()
    stats = spatial_kernels(card) if backend == "gloo" else None
    tag = "spatial" if backend == "gloo" else "cards_spatial"
    # (b)'s single process, on the card
    case = one_instance if backend == "gloo" else config4_fleet
    grid, st, frc = case(torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.time()
    ref = lstep.evolve(grid, lstep.LESPhysics(), st, frc, EVOLVE_DT,
                       EVOLVE_SUBSTEPS)
    torch.cuda.synchronize()
    ref_wall = time.time() - t0
    ref_warm = device_split(lambda: lstep.evolve(
        grid, lstep.LESPhysics(), st, frc, EVOLVE_DT, EVOLVE_SUBSTEPS))[1]
    with tempfile.TemporaryDirectory() as tmp:
        save_case(os.path.join(tmp, "evolve.pt"), grid, st, frc)
        del st, frc
        ref = {k: getattr(ref, k).cpu().numpy() for k in STAGE_NAMES}
        torch.cuda.empty_cache()
        with open(os.path.join(tmp, "mesh.json"), "w") as f:
            json.dump(MESH_CONF, f)
        with open(os.path.join(tmp, "small.json"), "w") as f:
            json.dump(SMAG_CONF, f)
        report = os.path.join(tmp, "rank")
        ranks_wall = run_rank_set(
            tag, SPATIAL_RANKS, SPATIAL_TIMEOUT,
            ["--spatial-rank", tmp, report], os.path.join(tmp, "store"),
            threads=2, backend=backend)
        reps = []
        for r in range(SPATIAL_RANKS):
            with open("%s.%d.json" % (report, r)) as f:
                reps.append(json.load(f))
        check_transport(tag, reps, backend)
        got = np.load(report + ".evolve.npz")
        errs = {}
        for k in STAGE_NAMES:
            a = ref[k]
            b = got[k]
            np.testing.assert_allclose(b, a, err_msg="spatial (b) " + k,
                                       **EVOLVE_TOL)
            errs[k] = float(np.max(np.abs(b - a)))
        for rep in reps:
            la = rep["evolve"]["launches"]
            if la["lesstage_halo"] != 3 * EVOLVE_SUBSTEPS or la["lesstage"]:
                raise AssertionError("spatial (b): rank %d launches %s, want "
                                     "lesstage_halo %d" % (
                                         rep["rank"], la,
                                         3 * EVOLVE_SUBSTEPS))
        log("%s (b): %d x %dx%dx%d, %d substeps of %g s on 2 x 2 blocks "
            "of %dx%dx%d, %s, against one process: max abs diff %s "
            "(atol/rtol 2e-3); ranks on %s, CUDA tensors staged through "
            "the host %s; rank walls %s s, one process %.3f s on %s"
            % (tag, got["u"].shape[0], grid.nx, grid.ny, grid.nz,
               EVOLVE_SUBSTEPS, EVOLVE_DT, grid.nx // 2, grid.ny // 2,
               grid.nz, where(backend, SPATIAL_RANKS),
               {k: float("%.3g" % v) for k, v in errs.items()},
               [r["device"] for r in reps], [r["staged"] for r in reps],
               ["%.3f" % r["evolve"]["wall"] for r in reps], ref_wall, card))
        log("%s (b) the same evolve again, warm, under torch.profiler: "
            "ranks %s; one process %s" % (
                tag, "; ".join(split_text(r["evolve"]["warm"])
                               for r in reps), split_text(ref_warm)))

        # (c) the bench case: substeps, records, the GCM, launches
        gcms = [np.load("%s.%d.gcm.npz" % (report, r))
                for r in range(SPATIAL_RANKS)]
        gcms = [[g["arr_%d" % i] for i in range(len(g.files))] for g in gcms]
        for r, g in enumerate(gcms[1:], 1):
            if not all(np.array_equal(x, y) for x, y in zip(g, gcms[0])):
                raise AssertionError("spatial: the GCM state of rank %d "
                                     "differs from rank 0's" % r)
        diffs = record_diffs(single["times"], single["groups"],
                             np.load(report + ".records.npz"))
        worst = max(diffs.items(), key=lambda kv: kv[1])
        gcm_diff = max(float(np.max(np.abs(x - y)) / (np.max(np.abs(y))
                                                      + 1e-30))
                       for x, y in zip(gcms[0], single["gcm"]))
        launches = []
        for rep in reps:
            for leg, kern in (("bench", "lesstage_halo"),
                              ("smag", ("lesflat_halo", "lesmom_halo"))):
                r = rep[leg]
                if leg == "bench" and r["substeps"] != single["substeps"]:
                    raise AssertionError(
                        "spatial (c): rank %d substeps %s, single %s"
                        % (rep["rank"], r["substeps"], single["substeps"]))
                kern = kern if isinstance(kern, tuple) else (kern,)
                for k, count in r["launches"].items():
                    want = 3 * r["own_substeps"] if k in kern else 0
                    if count != want or (k in kern and count == 0):
                        raise AssertionError(
                            "spatial (c) %s: rank %d launched %s %d times, "
                            "want %d (3 x its %d substeps)" % (
                                leg, rep["rank"], k, count, want,
                                r["own_substeps"]))
                launches.append(r["launches"])
            launches.append(rep["evolve"]["launches"])
        if not (reps[0]["smag"]["finite"] and reps[0]["smag"]["n_rec"] == 2):
            raise AssertionError("spatial (c) smag: records %s"
                                 % reps[0]["smag"])
        b0 = reps[0]["bench"]
        log("%s (c): the bench case (T21/L19 + 2 x 64x64x160) through "
            "the CLI with --lesprocs 4 on %s: "
            "blocks %s, substeps %s == the single process's, rank 0's %d "
            "records within PROFILE_TOL (largest: %s %.3g of max|ref|), the "
            "GCM state the same on every rank (%.3g of max|ref| from the "
            "single process's), lesstage halo launches %s = 3 x own "
            "substeps %s; the Smagorinsky + nudge leg (T10/L8 + 2 x "
            "16x16x32, --mesh_les 2 --lesprocs 2): blocks %s, lesflat/lesmom "
            "halo launches %s on %s"
            % (tag, where(backend, SPATIAL_RANKS), b0["block"],
               b0["substeps"], len(single["times"]), worst[0],
               worst[1], gcm_diff,
               [r["bench"]["launches"]["lesstage_halo"] for r in reps],
               [r["bench"]["own_substeps"] for r in reps],
               [r["smag"]["block"] for r in reps],
               [(r["smag"]["launches"]["lesflat_halo"],
                 r["smag"]["launches"]["lesmom_halo"]) for r in reps], card))
        for i in range(len(single["walls"])):
            log("%s step %d walls (%s): ranks %s s; single process %.3f s"
                % (tag, i, where(backend, SPATIAL_RANKS),
                   ["%.3f" % r["bench"]["walls"][i] for r in reps],
                   single["walls"][i]))
        res = dict(card=card, backend=backend, kernels=stats,
                   evolve=dict(ref_wall=ref_wall, ref_warm=ref_warm,
                               max_abs_diff=errs,
                               shape=list(got["u"].shape)),
                   ranks=reps, ranks_wall_s=ranks_wall,
                   record_diffs=diffs, gcm_rel_diff=gcm_diff,
                   single_walls=single["walls"],
                   phase_s=time.time() - t_phase)
    with open(os.path.join(OUT_DIR, "chip_smoke_%s.json" % tag), "w") as f:
        json.dump(res, f, indent=1, default=str)
    log("%s: the phase took %.1f s (the ranks %.1f s)"
        % (tag, res["phase_s"], ranks_wall))
    return stats, launches


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
    """One 10-day T42 guard on the card (the dry HS94 start and forcing of
    verify/held_suarez.py, or the default moist physics): returns its
    record."""
    from sp_coupler_tpu_torch.verify import held_suarez
    if name == "hs94":      # T42/L19, dt 1800 s, SL, hybrid: its defaults
        core = held_suarez.hs94_core(device="cuda")
        state = held_suarez.dry_start(core, core.initial_state(seed=3))
    else:
        core = gcm_core("cuda", trunc=42, nlev=19, dt=1800.0, hybrid=True,
                        advection="sl")
        state = core.initial_state(seed=3)
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


# the T159 case through runtime/t159bench.py: its 2 warm steps and
# T159_TIMED timed ones, the batched fleet
T159_TIMED = 1


def phase_t159(card):
    """The T159 regional case on the card through runtime/t159bench.py:
    T159/L19 SL GCM + 64 LES of 64x64x160 (RICO, TKE), columns as
    scripts/bench_t159.py picks them, dt_les 15 s, evolve_chunks 8, the
    batched fleet, its 2 warm steps and T159_TIMED timed ones. The stage
    kernel launches 3 x the substeps of the batched loop (the substep
    calls, each over the instances still running). Returns its record
    and the first step's per-instance substeps and profiles
    (phase_gcm_bands' reference)."""
    from sp_coupler_tpu_torch.runtime import t159bench
    rec = dict(card=card, gcm_vs_cpu=t159_gcm_vs_cpu(card))
    torch.cuda.reset_peak_memory_stats()
    args = t159bench.parser().parse_args(
        ["batched", "--steps", str(T159_TIMED)])
    torch.cuda.synchronize()
    reset_launches()
    (row, extras), calls = counted_substeps(
        lambda: t159bench.run(args, torch.device("cuda")))
    launches = read_launches()
    gs, prof, steps = extras["gcm"], extras["prof"], extras["steps"]
    for k in ("THL", "QT", "U"):
        if not bool(torch.isfinite(prof[k]).all()):
            raise AssertionError("t159: non-finite %s" % k)
    for k in ("u", "v", "T", "q", "lnps"):
        if not bool(torch.isfinite(getattr(gs.grid, k)).all()):
            raise AssertionError("t159: non-finite GCM %s" % k)
    nz = args.nz
    if tuple(prof["THL"].shape) != (args.n, nz) or \
            min(min(st["substeps"]) for st in steps) <= 0:
        raise AssertionError("t159: THL %s, substeps %s"
                             % (tuple(prof["THL"].shape), steps))
    for st in steps:
        log("t159 step (first=%s): %.3f s, %d instance-substeps (%d..%d per "
            "instance) on %s" % (st["first"], st["wall_s"],
                                 sum(st["substeps"]), min(st["substeps"]),
                                 max(st["substeps"]), card))
    check_launches("t159", launches, calls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec.update(row=row, columns=extras["cols"], steps=steps,
               loop_substeps=calls, launches=launches,
               peak_memory_gib=peak, les=args.n,
               les_grid=[args.nx, args.ny, nz])
    log("t159: T159/L19 SL + %d x %dx%dx%d through t159bench, launches %s "
        "for %d substeps of the batched loop, peak memory %.2f GiB on %s"
        % (args.n, args.nx, args.ny, nz, launches, calls, peak, card))
    first_step = dict(nsub=steps[0]["substeps"], prof=extras["first_prof"],
                      wall_s=steps[0]["wall_s"])
    return rec, first_step


# ---- the GCM's latitude bands (--gcmprocs) ------------------------------

# ranks sharing this card (gloo), each a subprocess of this script:
# BANDS_RANKS for (a) and (c), MESH_RANKS for (b), each set within its
# timeout (a hung collective fails the phase)
BANDS_RANKS, BANDS_TIMEOUT = 4, 600
BANDS_CLI_TIMEOUT = 300
# (a) the T159/L19 SL GCM on hybrid levels alone, BANDS_STEPS steps from
# a start built on the CPU (as t159_gcm_vs_cpu's), on 4 bands of 60 rows
# against one process on the card, at tests/test_parallel.py:121-128's
# tolerances
BANDS_GCM = dict(trunc=159, nlev=19, dt=900.0, advection="sl", hybrid=True)
BANDS_STEPS = 3
SPEC_TOL = dict(atol=2e-4, rtol=1e-3)
GRID_TOL = dict(atol=5e-3, rtol=1e-4)
# (b) the bench case through the CLI with --mesh_les 2 --gcmprocs 2
BANDS_CLI_ARGS = ["--gcmprocs", str(MESH_RANKS)]
# (c) the T159 regional case (t159bench.case: T159/L19 SL, 64 x 64x64x160,
# dt_les 15 s, evolve_chunks 8, batched) on les = 4 ranks of 16 instances
# with 4 GCM bands of 60 rows, one coupled step from phase_t159's start.
# A rank's batched loop runs 16 instances where phase_t159's runs 64, and
# cuBLAS rounds the projection's batched products by the batch, so
# the trajectories part at rounding level and an instance's adaptive
# substep count may move by C_SUBSTEP_SLACK (measured: 2 of 64 instances
# by one substep, NVIDIA H100 80GB HBM3, 700 W)
C_SUBSTEP_SLACK = 1


def bands_core(dev, mesh, **kw):
    """A banded GCMCore over the mesh's ranks whose bands' all_reduce
    counts its calls and bytes (core.bands.sums: [bytes, ...])."""
    from sp_coupler_tpu_torch.models.gcm import model as gcm_model, spharm
    from sp_coupler_tpu_torch.parallel import bands as pbands
    bands = pbands.for_mesh(mesh, spharm.GRID_FOR_TRUNC[kw["trunc"]][1])
    sums, sum_ = [], bands.sum_

    def counting_sum(t):
        sums.append(t.numel() * t.element_size())
        return sum_(t)

    bands.sum_, bands.sums = counting_sum, sums
    core = gcm_model.GCMCore(gcm_model.GCMConfig(**kw), device=dev,
                             bands=bands)
    if core.device.type != "cuda":
        raise AssertionError("GCMCore took %s, not the card" % core.device)
    return core


def cuda_event_ms(fn):
    """(fn's result, its CUDA-event milliseconds, the host's between a
    synchronize before and after)."""
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.time()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b), 1e3 * (time.time() - t0)


def device_split(fn):
    """fn() under torch.profiler, after a synchronise: (its result, {wall_ms:
    the host clock to the synchronise after it; kernel_ms: the summed
    device time of every kernel and copy it ran; nccl_ms: of nccl's
    kernels, which also wait for the slowest peer; gemm_ms: of the GEMMs
    and GEMVs, the projection's solves and the transforms' products})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    split = dict(wall_ms=1e3 * wall, kernel_ms=0.0, nccl_ms=0.0, gemm_ms=0.0)
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            name = e.name.lower()
            split["kernel_ms"] += ms
            split["nccl_ms"] += ms * ("nccl" in name)
            split["gemm_ms"] += ms * ("gemm" in name or "gemv" in name)
    return out, split


def split_text(d):
    """device_split's numbers for the logs."""
    return "wall %.1f, kernels %.1f (nccl %.1f, GEMM %.1f) ms" % (
        d["wall_ms"], d["kernel_ms"], d["nccl_ms"], d["gemm_ms"])


def bands_rank(odir, report):
    """One rank of phase_gcm_bands (``chip_smoke.py --bands-rank ODIR
    REPORT``, SPTPU_DIST_* set, BANDS_RANKS ranks): (a) the T159 SL GCM
    on 4 bands from ODIR/t159_start.pt, BANDS_STEPS steps, then (c) one
    coupled step of the T159 regional case with les = 4 and the GCM on 4
    bands; writes REPORT.<rank>.json and .npz (the replicated spectral
    state, of rank 0 the gathered grid T and the LES profiles)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.runtime import t159bench, t255bench
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    from sp_coupler_tpu_torch.models.les import (grid as lgrid, step as lstep,
                                                 diag as ldiag)
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    from sp_coupler_tpu_torch.utils import tree
    try:
        pmesh.init_distributed(torch.device("cuda"))
        rank = pmesh.rank()
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = pmesh.make_mesh(BANDS_RANKS)
        arrays = {}
        # (a)
        core = bands_core(dev, mesh, **BANDS_GCM)
        start = torch.load(os.path.join(odir, "t159_start.pt"),
                           weights_only=False)
        s = core.band_state(interop.gcm_state(interop.to_numpy(start), dev))
        steps = []
        for i in range(BANDS_STEPS):
            n0 = len(core.bands.sums)
            s, ev_ms, host_ms = cuda_event_ms(
                lambda: core.step(s, first=i == 0))
            steps.append(dict(cuda_ms=ev_ms, host_ms=host_ms,
                              sums=len(core.bands.sums) - n0,
                              sum_bytes=sum(core.bands.sums[n0:])))
        rows = int(s.grid.T.shape[-2])
        split = device_split(lambda: core.step(s))[1]     # result dropped
        for i, leaf in enumerate(tree.flatten(core.replicated(s))[0]):
            arrays["spec_%d" % i] = leaf.cpu().numpy()
        gridT = core.whole_state(s).grid.T
        if rank == 0:
            arrays["gridT"] = gridT.cpu().numpy()
        gcm = dict(steps=steps, rows=rows, split=split,
                   band=[core.bands.r0, core.bands.r1])
        del core, s, start, gridT
        torch.cuda.empty_cache()
        # (c) phase_t159's start (t159bench.case), the fleet in les blocks
        whole = gcm_core(dev, trunc=159, nlev=19, dt=900.0, advection="sl")
        grid = lgrid.LESGrid()
        cols = t159bench.columns(whole)
        gs = whole.initial_state(seed=0)
        les = t255bench.seed_les(whole, gs, grid, cols)
        prof = ldiag.slab_profiles(grid, les)
        del whole
        core = bands_core(dev, mesh, trunc=159, nlev=19, dt=900.0,
                          advection="sl")
        gs = core.band_state(gs)
        # the rank's instances, apart from the whole fleet's storage
        les = type(les)(*[x.clone() for x in pmesh.shard_fleet(les, mesh)])
        fn = CoupledStepFn(core, grid, lstep.LESPhysics(), cols, dt_les=15.0,
                           n_substeps=0, evolve_chunks=8,
                           serial_evolve="batched", mesh=mesh)
        calls = [0]
        substep = lstep.substep

        def counting_substep(*a, **kw):
            calls[0] += 1
            return substep(*a, **kw)

        lstep.substep = counting_substep
        # the rank's own evolve, timed between synchronises
        evolve_s, evolve_to = [0.0], fn._evolve_to

        def timed_evolve(*a):
            torch.cuda.synchronize()
            t0 = time.time()
            out = evolve_to(*a)
            torch.cuda.synchronize()
            evolve_s[0] += time.time() - t0
            return out

        fn._evolve_to = timed_evolve
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_launches()
            out, ev_ms, host_ms = cuda_event_ms(lambda: fn(
                gs, les, prof, torch.zeros(len(cols), device=dev), 0,
                first=True))
            launches = read_launches()
        finally:
            lstep.substep = substep
        gs, les, prof, _, diag = out
        for k, v in prof.items():
            if rank == 0:
                arrays["prof_" + k] = v.cpu().numpy()
        regional = dict(
            wall_s=host_ms / 1e3, cuda_ms=ev_ms, evolve_s=evolve_s[0],
            loop_substeps=calls[0],
            launches=launches, positions=mesh.positions(len(cols)),
            nsub=[int(x) for x in fn.unpack_diag(diag)["n_substeps"]],
            held=int(les.u.shape[0]), rows=int(gs.grid.T.shape[-2]),
            sums=len(core.bands.sums), sum_bytes=sum(core.bands.sums),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        for i, leaf in enumerate(tree.flatten(core.replicated(gs))[0]):
            arrays["t159_spec_%d" % i] = leaf.cpu().numpy()
        rep = dict(rank=rank, device=str(dev), gcm=gcm, regional=regional,
                   **transport())
    finally:
        pmesh.shutdown()
    np.savez("%s.%d.npz" % (report, rank), **arrays)
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


def bands_cli_rank(odir, conf, report):
    """One rank of phase_gcm_bands (b) (``chip_smoke.py --bands-cli-rank
    ODIR CONF REPORT``, MESH_RANKS ranks): the bench case through the CLI
    with --mesh_les 2 --gcmprocs 2; writes REPORT.<rank>.json and .npz
    (the replicated spectral state), rank 0 REPORT.records.npz."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    from sp_coupler_tpu_torch.utils import tree
    try:
        runner, walls, launches = cli_leg(
            bench_argv(odir, conf, MESH_RANKS) + BANDS_CLI_ARGS,
            tee_writer())
        rank = pmesh.rank()
        core = runner.gcm.core
        if runner.mesh is None or core.bands is None:
            raise AssertionError("rank %d: mesh %s, GCM bands %s"
                                 % (rank, runner.mesh, core.bands))
        arrays = {"spec_%d" % i: leaf.cpu().numpy() for i, leaf in
                  enumerate(tree.flatten(core.replicated(
                      runner.gcm.state))[0])}
        if rank == 0:
            times, groups = read_records(os.path.join(odir, "spifs.nc"))
            np.savez(report + ".records.npz", Time=np.asarray(times),
                     **{"%d/%s" % (c, v): a for c, g in groups.items()
                        for v, a in g.items()})
        pos = runner.fleet.positions
        rep = dict(rank=rank, positions=pos, walls=walls,
                   substeps=runner.substeps, launches=launches,
                   own_substeps=int(sum(s[p] for s in runner.substeps
                                        for p in pos)),
                   rows=int(runner.gcm.state.grid.T.shape[-2]),
                   band=[core.bands.r0, core.bands.r1])
    finally:
        pmesh.shutdown()
    np.savez("%s.%d.npz" % (report, rank), **arrays)
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


def same_on_ranks(arrays, prefix):
    """The array keys starting with prefix that differ from rank 0's on
    some rank, as "key (rank r)" (empty: the same everywhere, bit for
    bit)."""
    return ["%s (rank %d)" % (k, r) for r, a in enumerate(arrays[1:], 1)
            for k in arrays[0] if k.startswith(prefix)
            and not np.array_equal(a[k], arrays[0][k])]


def spectral_now(arrays, prefix):
    """{field: array} of the replicated state's ``now`` a rank kept (the
    flattened leaves of {new, now, prev, time}: now's 8 fields second)."""
    names = ("vort", "div", "T", "lnps", "q", "ql", "qi", "a")
    return {k: arrays["%s_%d" % (prefix, 8 + i)] for i, k in enumerate(names)}


def beyond(got, ref, atol, rtol):
    """max |got - ref| and whether any point lies beyond atol + rtol |ref|
    (np.testing.assert_allclose's rule)."""
    err = np.abs(got - ref)
    return float(np.max(err)), bool(np.any(err > atol + rtol * np.abs(ref)))


def phase_gcm_bands(card, single, t159_first, backend="gloo"):
    """The GCM on latitude bands (--gcmprocs), ranks sharing the card over
    gloo (not a scaling number) or under nccl one card a rank (then
    without (b)): (a) the T159/L19 SL GCM on hybrid
    levels, 4 bands of 60 rows, BANDS_STEPS steps against one process
    here: spectral vort, div, T, q and grid T at the JAX tests'
    tolerances, the spectral state the same on every rank, the step's
    CUDA-event walls beside one process's, the collectives a step and
    their bytes; (c) one coupled step of the T159 regional case with
    les = 4 (16 instances a rank) and 4 GCM bands against phase_t159's
    first step (``t159_first``): the per-instance substeps within
    C_SUBSTEP_SLACK, the profiles within PROFILE_TOL[0], each rank's
    lesstage 3 x its batched loop's substeps, its wall and peak memory;
    (b) the bench case through the CLI with --mesh_les 2 --gcmprocs 2
    against phase_mesh's single process (``single``): step 1's substeps,
    rank 0's records within PROFILE_TOL (f_thl with F_ULPS, as
    phase_spatial), each rank lesstage 3 x its own substeps. Every rank's
    grid T must hold nlat / P rows. Every leg runs and is reported; any
    failed check fails the phase after chip_smoke_bands.json is written.
    Returns the ranks' launch counts."""
    import tempfile
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.models.gcm import spharm
    from sp_coupler_tpu_torch.verify.parity import PROFILE_TOL
    t_phase = time.time()
    res, fails, launches = dict(card=card), [], []

    def check_launches(leg, rank, counts, substeps):
        for k, count in counts.items():
            want = 3 * substeps if k == "lesstage" else 0
            if count != want or (k == "lesstage" and count == 0):
                fails.append("bands (%s): rank %d launched %s %d times, want "
                             "%d (3 x its %d substeps)"
                             % (leg, rank, k, count, want, substeps))
        launches.append(counts)

    with tempfile.TemporaryDirectory() as tmp:
        # (a)'s start on the CPU, and one process's steps on the card
        start = gcm_core("cpu", **BANDS_GCM).initial_state(seed=0)
        torch.save(start, os.path.join(tmp, "t159_start.pt"))
        core = gcm_core("cuda", **BANDS_GCM)
        s = interop.gcm_state(interop.to_numpy(start), "cuda")
        one_ms = []
        for i in range(BANDS_STEPS):
            s, ev_ms, _ = cuda_event_ms(lambda: core.step(s, first=i == 0))
            one_ms.append(ev_ms)
        one_split = device_split(lambda: core.step(s))[1]
        ref_now = {k: getattr(s.now, k).cpu().numpy()
                   for k in ("vort", "div", "T", "q")}
        ref_T = s.grid.T.cpu().numpy()
        nlat = core.nlat
        del core, s, start
        torch.cuda.empty_cache()

        report = os.path.join(tmp, "bands")
        tag = "bands" if backend == "gloo" else "cards_bands"
        ranks_wall = run_rank_set(
            tag, BANDS_RANKS, BANDS_TIMEOUT,
            ["--bands-rank", tmp, report], os.path.join(tmp, "store"),
            backend=backend)
        reps, arrays = [], []
        for r in range(BANDS_RANKS):
            with open("%s.%d.json" % (report, r)) as f:
                reps.append(json.load(f))
            arrays.append(dict(np.load("%s.%d.npz" % (report, r))))
        try:
            check_transport(tag, reps, backend)
        except AssertionError as e:
            fails.append(str(e))
        nb = nlat // BANDS_RANKS
        for rep in reps:
            for leg in ("gcm", "regional"):
                if rep[leg]["rows"] != nb:
                    fails.append("bands (%s): rank %d's grid has %d rows, "
                                 "want %d" % (leg, rep["rank"],
                                              rep[leg]["rows"], nb))
        # (a)
        fails += ["bands (a): %s differs" % d
                  for d in same_on_ranks(arrays, "spec_")]
        got = spectral_now(arrays[0], "spec")
        pairs = [(k, got[k], ref, SPEC_TOL) for k, ref in ref_now.items()]
        pairs.append(("grid_T", arrays[0]["gridT"], ref_T, GRID_TOL))
        errs = {}
        for k, g, ref, tol in pairs:
            errs[k], bad = beyond(g, ref, **tol)
            if bad:
                fails.append("bands (a): %s beyond atol %g / rtol %g (max "
                             "abs err %.3g)" % (k, tol["atol"], tol["rtol"],
                                                errs[k]))
        steps = [r["gcm"]["steps"] for r in reps]
        log("%s (a): T159/L19 SL hybrid GCM on %d bands of %d rows (%s), "
            "%d steps from the CPU-built "
            "start, against one process: max abs err %s; spectral state "
            "the same on every rank: %s; %s all_reduces a step moving %s "
            "B; step CUDA-event ms: ranks %s, one process %s on %s"
            % (tag, BANDS_RANKS, nb, where(backend, BANDS_RANKS),
               BANDS_STEPS,
               {k: float("%.3g" % v) for k, v in errs.items()},
               not same_on_ranks(arrays, "spec_"),
               [st["sums"] for st in steps[0]],
               [st["sum_bytes"] for st in steps[0]],
               [["%.1f" % st["cuda_ms"] for st in rs] for rs in steps],
               ["%.1f" % x for x in one_ms], card))
        log("%s (a): a 4th step under torch.profiler: ranks %s; one process "
            "%s" % (tag, "; ".join(split_text(r["gcm"]["split"])
                                   for r in reps), split_text(one_split)))
        res["a"] = dict(errors=errs, one_process_ms=one_ms,
                        one_process_split=one_split, ranks=[
                            dict(band=r["gcm"]["band"],
                                 steps=r["gcm"]["steps"],
                                 split=r["gcm"]["split"]) for r in reps])

        # (c)
        fails += ["bands (c): %s differs" % d
                  for d in same_on_ranks(arrays, "t159_spec_")]
        reg = [r["regional"] for r in reps]
        want = np.asarray(t159_first["nsub"])
        dsub = np.asarray(reg[0]["nsub"]) - want
        if np.any(np.abs(dsub) > C_SUBSTEP_SLACK) or any(
                r["nsub"] != reg[0]["nsub"] for r in reg):
            fails.append("bands (c): substeps %s, phase_t159's %s"
                         % ([r["nsub"] for r in reg], want.tolist()))
        for rep in reps:
            r = rep["regional"]
            check_launches("c", rep["rank"], r["launches"],
                           r["loop_substeps"])
        prof_err = {}
        for k, ref in t159_first["prof"].items():
            g = arrays[0]["prof_" + k]
            scale = float(np.max(np.abs(ref))) + 1e-12
            prof_err[k] = float(np.max(np.abs(g - ref))) / scale
            if prof_err[k] > PROFILE_TOL[0]:
                fails.append("bands (c): profile %s at %.3g of max|ref|, "
                             "beyond PROFILE_TOL %g"
                             % (k, prof_err[k], PROFILE_TOL[0]))
        worst = max(prof_err.items(), key=lambda kv: kv[1])
        log("%s (c): the T159 regional case (T159/L19 SL + 64 x "
            "64x64x160), les = 4 ranks x 16 instances (%s), the GCM on 4 "
            "bands of %d rows, one coupled step: per-instance substeps "
            "against one card's first step: %d of 64 differ (by %s), %d in "
            "all against %d; profiles: largest %s %.3g of max|ref| "
            "(PROFILE_TOL[0] %g); ranks' batched-loop substeps %s, lesstage "
            "%s; step walls %s s (one card's %.2f s), the slowest rank's "
            "own evolve %.2f s (ranks %s s), peak memory %s GiB, %s "
            "all_reduces moving %s B on %s"
            % (tag, where(backend, BANDS_RANKS), nb,
               int(np.count_nonzero(dsub)),
               sorted(set(dsub[dsub != 0].tolist())),
               int(np.sum(reg[0]["nsub"])), int(np.sum(want)), worst[0],
               worst[1], PROFILE_TOL[0],
               [r["loop_substeps"] for r in reg],
               [r["launches"]["lesstage"] for r in reg],
               ["%.2f" % r["wall_s"] for r in reg],
               t159_first.get("wall_s", float("nan")),
               max(r["evolve_s"] for r in reg),
               ["%.2f" % r["evolve_s"] for r in reg],
               ["%.2f" % r["peak_memory_gib"] for r in reg],
               [r["sums"] for r in reg], [r["sum_bytes"] for r in reg],
               card))
        res["c"] = dict(profile_rel_err=prof_err, ranks=reg,
                        substep_diff=dsub.tolist())

        # (b), under gloo only
        cli_wall = None
        if backend == "gloo":
            conf = os.path.join(tmp, "mesh.json")
            with open(conf, "w") as f:
                json.dump(MESH_CONF, f)
            report = os.path.join(tmp, "cli")
            cli_wall = run_rank_set(
                "bands_cli", MESH_RANKS, BANDS_CLI_TIMEOUT,
                ["--bands-cli-rank", os.path.join(tmp, "cli_out"), conf,
                 report],
                os.path.join(tmp, "store_cli"))
            reps, arrays = [], []
            for r in range(MESH_RANKS):
                with open("%s.%d.json" % (report, r)) as f:
                    reps.append(json.load(f))
                arrays.append(dict(np.load("%s.%d.npz" % (report, r))))
            fails += ["bands (b): %s differs" % d
                      for d in same_on_ranks(arrays, "spec_")]
            want_rows = spharm.GRID_FOR_TRUNC[21][1] // MESH_RANKS
            for rep in reps:
                if rep["rows"] != want_rows:
                    fails.append("bands (b): rank %d's grid has %d rows, "
                                 "want %d" % (rep["rank"], rep["rows"],
                                              want_rows))
                if rep["substeps"][0] != single["substeps"][0]:
                    fails.append("bands (b): rank %d's step 1 substeps "
                                 "%s, single %s"
                                 % (rep["rank"], rep["substeps"][0],
                                    single["substeps"][0]))
                check_launches("b", rep["rank"], rep["launches"],
                               rep["own_substeps"])
            try:
                diffs = record_diffs(single["times"], single["groups"],
                                     np.load(report + ".records.npz"))
                worst = max(diffs.items(), key=lambda kv: kv[1])
            except AssertionError as e:
                diffs, worst = {}, ("(failed)", float("nan"))
                fails.append("bands (b): %s" % e)
            log("bands (b): the bench case (T21/L19 + 2 x 64x64x160) "
                "through the CLI with --mesh_les 2 --gcmprocs 2 on 2 gloo "
                "ranks sharing the card, bands %s: substeps %s (single %s), "
                "rank 0's %d records: largest difference %s %.3g of "
                "max|ref|; spectral state the same on both ranks: %s; "
                "lesstage %s, own substeps %s; step walls %s s, single %s s "
                "(not a scaling number) on %s"
                % ([r["band"] for r in reps], reps[0]["substeps"],
                   single["substeps"], len(single["times"]), worst[0],
                   worst[1],
                   not same_on_ranks(arrays, "spec_"),
                   [r["launches"]["lesstage"] for r in reps],
                   [r["own_substeps"] for r in reps],
                   [["%.3f" % w for w in r["walls"]] for r in reps],
                   ["%.3f" % w for w in single["walls"]], card))
            res["b"] = dict(record_diffs=diffs, ranks=reps,
                            single_walls=single["walls"])
        res.update(ranks_wall_s=ranks_wall, cli_wall_s=cli_wall,
                   phase_s=time.time() - t_phase, fails=fails)
    with open(os.path.join(OUT_DIR, "chip_smoke_%s.json" % tag), "w") as f:
        json.dump(res, f, indent=1, default=str)
    log("%s: the phase took %.1f s (the 4 ranks %.1f s, the CLI ranks %s "
        "s)" % (tag, res["phase_s"], ranks_wall, cli_wall))
    if fails:
        raise AssertionError("bands: %d check(s) failed: %s"
                             % (len(fails), "; ".join(fails)))
    return launches


# ---- nccl, one card a rank (--cards N) ---------------------------------

# chip_smoke.py --cards N runs the three distributed layers over nccl, one
# card a rank, each against one process on one card of the same machine:
# (a) the les axis (phase_mesh on 2 cards); (b) the T159 regional case
# with --mesh_les 4 --gcmprocs 4 and (c) the T159 GCM on 4 bands
# (phase_gcm_bands); (d) the x/y blocks (phase_spatial: the bench case
# with --lesprocs 4, config 4's fleet on 2 x 2 blocks, the Smagorinsky
# leg); (e) kernels #1-#3 on every card (phase_card_kernels); (f)
# runtime/scalebench.py at SCALE_SIZES (phase_scaling); (g) BASELINE
# config 4 at its stated size through the CLI (phase_config4). With N = 2,
# (b), (c), (d) and (g), which take 4 ranks, do not run.
CARD_COUNTS = (2, 4)
CARDS_TIMEOUT = 300
# (f): 16 instances of 64x64x160 a card, each size's evolve on every rank
# of the size (weak scaling), against BASELINE.md's >= 80 % target
SCALE_SIZES = (1, 2, 4)
SCALE_ARGV = ["--nx", "64", "--nz", "160", "--per-dev", "16"]
SCALE_TARGET = 0.8


def t159_first_step(card):
    """One card's first coupled step of the T159 regional case
    (t159bench.case, batched), phase_t159's first step without its CPU
    check and later steps: the per-instance substeps, the profiles after
    the step and its wall."""
    from sp_coupler_tpu_torch.runtime import t159bench
    fn, (gs, les, prof, rain) = t159bench.case(torch.device("cuda"),
                                               "batched")
    out, _, host_ms = cuda_event_ms(
        lambda: fn(gs, les, prof, rain, 0, first=True))
    nsub = [int(x) for x in fn.unpack_diag(out[4])["n_substeps"]]
    first = dict(nsub=nsub, wall_s=host_ms / 1e3,
                 prof={k: v.cpu().numpy() for k, v in out[2].items()})
    log("t159 first step on one card: %.2f s, %d instance-substeps (%d..%d "
        "an instance) on %s" % (first["wall_s"], sum(nsub), min(nsub),
                                max(nsub), card))
    del fn, gs, les, prof, rain, out
    torch.cuda.empty_cache()
    return first


def card_kernels_rank(report):
    """One rank of phase_card_kernels (``chip_smoke.py --card-kernels-rank
    REPORT``): on this rank's own card, kernels #1-#3 against their plain
    versions at SPATIAL_GRID, n = SPATIAL_N, for both inputs (check_stage,
    check_arrays), then in halo mode on its 32x32x160 blocks
    (spatial_kernels, which times them); writes REPORT.<rank>.json."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch import card_line
    from sp_coupler_tpu_torch.models.les import grid as lgrid, step as lstep
    from sp_coupler_tpu_torch.ops import lesstage
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    try:
        pmesh.init_distributed(torch.device("cuda"))
        rank = pmesh.rank()
        dev = torch.device("cuda", torch.cuda.current_device())
        card = card_line(dev)
        nx, ny, nz = SPATIAL_GRID
        n = SPATIAL_N
        grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
        reset_launches()
        whole = {"lesstage": 0.0}
        for inputs in (stage_inputs, rough_inputs):
            cur, base, frc, dt = inputs(grid, n, 7 + n)
            out = lesstage.stage_fused_cuda(grid, lstep.LESPhysics(), cur,
                                            base, frc, 0.5, dt)
            if cur.u.device != dev or out[0].device != dev:
                raise AssertionError("rank %d: inputs on %s, outputs on %s, "
                                     "not %s" % (rank, cur.u.device,
                                                 out[0].device, dev))
            err = check_stage(lesstage.stage_fused_cuda, grid,
                              lstep.LESPhysics(), cur, base, frc, dt)[0]
            whole["lesstage"] = max(whole["lesstage"], err)
        for name, launch, plain, args_of, tol, _ in split_kernels():
            if name == "advect":
                continue
            whole[name] = 0.0
            for inputs in (split_inputs, rough_split_inputs):
                args = args_of(inputs(grid, n, 11 + n), grid)
                got, ref = launch(*args), plain(*args)
                if output_arrays(got)[0].device != dev:
                    raise AssertionError("rank %d: %s output on %s"
                                         % (rank, name, got.device))
                check_arrays(name, got, ref, tol)
                whole[name] = max([whole[name]] + [
                    float((a - b).abs().max())
                    for a, b in zip(output_arrays(got), output_arrays(ref))])
        halo = spatial_kernels(card)
        torch.cuda.synchronize()
        rep = dict(rank=rank, device=str(dev), card=card, whole=whole,
                   halo=halo, launches=read_launches(), **transport())
    finally:
        pmesh.shutdown()
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


def phase_card_kernels(card, n_cards):
    """(e): kernels #1-#3 on every card, one rank a card
    (card_kernels_rank): each whole-plane kernel and each halo-mode one
    held against its plain version on the rank's own card, with the halo
    mode's device time there. Returns {card index: report}."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "kern")
        run_rank_set("cards_kernels", n_cards, CARDS_TIMEOUT,
                     ["--card-kernels-rank", report],
                     os.path.join(tmp, "store"), backend="nccl")
        reps = []
        for r in range(n_cards):
            with open("%s.%d.json" % (report, r)) as f:
                reps.append(json.load(f))
    check_transport("cards_kernels", reps, "nccl")
    for rep in reps:
        la = rep["launches"]
        if not all(la[k] > 0 for k in ("lesstage", "lesflat", "lesmom",
                                       "lesstage_halo", "lesflat_halo",
                                       "lesmom_halo")):
            raise AssertionError("cards_kernels: rank %d launches %s"
                                 % (rep["rank"], la))
        log("cards_kernels (e): %s (%s): kernels #1-#3 at %dx%dx%d n=%d "
            "against their plain versions, max abs err %s; in halo mode on "
            "%dx%d blocks, max abs err %s, device ms %s; launches %s"
            % (rep["device"], rep["card"], *SPATIAL_GRID, SPATIAL_N,
               {k: float("%.3g" % v) for k, v in rep["whole"].items()},
               SPATIAL_GRID[0] // SPLIT[0], SPATIAL_GRID[1] // SPLIT[1],
               {k: float("%.3g" % v["max_abs_err"])
                for k, v in rep["halo"].items()},
               {k: float("%.4g" % v["times"][4])
                for k, v in rep["halo"].items()}, la))
    return {r: rep for r, rep in enumerate(reps)}


def phase_scaling(card, n_cards):
    """(f): ``python -m sp_coupler_tpu_torch.runtime.scalebench --sizes
    SCALE_SIZES SCALE_ARGV`` on n_cards ranks, one card a rank (weak
    scaling; sizes up to n_cards): every size's efficiency, recorded
    beside SCALE_TARGET (not claimed). Returns scalebench's result."""
    import tempfile
    sizes = [m for m in SCALE_SIZES if m <= n_cards]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scale.json")
        wall = run_rank_set(
            "cards_scale", n_cards, CARDS_TIMEOUT,
            ["--sizes", ",".join(map(str, sizes))] + SCALE_ARGV
            + ["--out", out], os.path.join(tmp, "store"), backend="nccl",
            module="sp_coupler_tpu_torch.runtime.scalebench")
        with open(out) as f:
            res = json.load(f)
    eff = [res["efficiency"][str(m)] for m in sizes]
    if (res["mode"] != "weak" or res["ranks"] != n_cards
            or res["sizes"] != sizes
            or not all(np.isfinite(e) and e > 0 for e in eff)):
        raise AssertionError("cards_scale: %s" % res)
    log("cards_scale (f): scalebench weak scaling, %d x %s instances a "
        "card, %d substeps: updates/s %s, efficiency %s (BASELINE.md's "
        "target >= %.2f: recorded, not claimed); %.1f s on %s"
        % (res["per_device_instances"], res["grid"], res["substeps"],
           res["updates_per_s"], res["efficiency"], SCALE_TARGET, wall,
           card))
    return res


# ---- (g) BASELINE config 4 at its stated size, one card a les slot -----

# BASELINE.md's config 4, "T255 + 256 LES (128x128x160 each), domain-
# decomposed across one host", through the port's CLI (python -m
# sp_coupler_tpu_torch.spmaster) on CONFIG4_RANKS ranks, one card a rank
# (nccl): --mesh_les 4 --gcmprocs 4, rank r holding positions 64 r ...
# 64 r + 63 (batched) and the T255 GCM's rows 96 r ... 96 r + 95; the
# columns of runtime/t255bench.py (16 longitudes on each of 16 rows of
# |lat| < 15 deg), dt_les 15 s, CONFIG4_STEPS coupled steps (--steps
# CONFIG4_STEPS - 1: the CLI adds the restart overlap). Nothing is cut.
CONFIG4_CONF = {"gcm_truncation": 255, "gcm_levels": 19, "gcm_hybrid": True,
                "gcm_advection": "sl", "les_itot": 128, "les_jtot": 128,
                "les_ktot": 160, "les_xsize": 12800.0, "les_ysize": 12800.0,
                "les_dz": 25.0, "les_schedule": "batched",
                "les_evolve_chunks": 8}
CONFIG4_FLEET, CONFIG4_RANKS, CONFIG4_STEPS = 256, 4, 2
CONFIG4_ARGS = ["--mesh_les", str(CONFIG4_RANKS), "--gcmprocs",
                str(CONFIG4_RANKS)]
CONFIG4_TIMEOUT = 600   # s for the rank set: init, 2 steps, the checkpoint
# (ii): the same --conf on card 0 with the first CONFIG4_REF_N columns and
# no mesh; an instance's start draws from generator(seed, i), so it does
# not depend on the fleet's size, and step 1 comes before any feedback
# from the other columns: rank 0's step-1 records of those instances
# within verify/parity.py's PROFILE_TOL (f_thl: + F_ULPS), their substeps
# within C_SUBSTEP_SLACK (the batch of 64 against 4 rounds the
# projection's products apart, as in phase_gcm_bands (c))
CONFIG4_REF_N = 4
CONFIG4_VARS = ("thl", "qt", "f_T", "f_SH", "A_d", "rain")


def config4_points(n, trunc=None):
    """(columns, --points) of t255bench.columns' first n columns on the
    GCM's grid (CONFIG4_CONF's truncation), each point the grid's own
    lat/lon, so that it selects its column (as bench_argv)."""
    from types import SimpleNamespace
    from sp_coupler_tpu_torch.models.gcm import spharm
    from sp_coupler_tpu_torch.runtime import t255bench
    sht = spharm.SpectralTransform(trunc or CONFIG4_CONF["gcm_truncation"],
                                   device="cpu")
    lats, lons = sht.latitudes_deg(), sht.longitudes_deg()
    cols = t255bench.columns(SimpleNamespace(sht=sht, nlon=len(lons)), n)
    pts = []
    for c in cols:
        pts += ["%.6f" % lats[c // len(lons)], "%.6f" % lons[c % len(lons)]]
    return cols, pts


def config4_argv(odir, conf, n, mesh=True):
    """spmaster's flags of config 4 at n columns (CONFIG4_ARGS with
    mesh)."""
    cols, pts = config4_points(n)
    return cols, (["--points"] + pts
                  + ["--les_dt", "15", "--steps", str(CONFIG4_STEPS - 1),
                     "--conf", conf, "--odir", odir]
                  + (CONFIG4_ARGS if mesh else []))


def row_sums(a):
    """float64 sum of each row of a (instance by instance)."""
    return np.asarray([np.asarray(r, np.float64).sum() for r in a])


def config4_rank(odir, conf, report):
    """One rank of phase_config4 (``chip_smoke.py --config4-rank ODIR CONF
    REPORT``, SPTPU_DIST_* set, CONFIG4_RANKS ranks): config 4 through
    the CLI (cli_leg), the rank's substep calls and evolve seconds
    counted; before finalize the GCM's replicated state checked the same
    on every rank (pmesh.replicate), the float64 sum of each fleet leaf
    for each of the rank's instances written to REPORT.<rank>.sums.npz
    and the peak of device memory read; the checkpoint (restart.save)
    timed. Writes REPORT.<rank>.json, rank 0 REPORT.records.npz."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    from sp_coupler_tpu_torch import card_line
    from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn
    from sp_coupler_tpu_torch.io import restart
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    from sp_coupler_tpu_torch.utils import tree
    cols, argv = config4_argv(odir, conf, CONFIG4_FLEET)
    evolve_s, evolve_to = [0.0], CoupledStepFn._evolve_to

    def timed_evolve(self, *a):
        torch.cuda.synchronize()
        t0 = time.time()
        out = evolve_to(self, *a)
        torch.cuda.synchronize()
        evolve_s[0] += time.time() - t0
        return out

    save_s, save = [], restart.save

    def timed_save(runner):
        torch.cuda.synchronize()
        t0 = time.time()
        save(runner)
        torch.cuda.synchronize()
        save_s.append(time.time() - t0)

    held = {}

    def before_finalize(runner):
        core = runner.gcm.core
        pmesh.replicate(core.replicated(runner.gcm.state), runner.mesh)
        leaves = tree.flatten(runner.fleet.state)[0]
        np.savez("%s.%d.sums.npz" % (report, pmesh.rank()),
                 positions=np.asarray(runner.fleet.positions),
                 **{"les_%d" % i: row_sums(x.cpu().numpy())
                    for i, x in enumerate(leaves)})
        held.update(peak_run_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    bands=[core.bands.P, core.bands.r0, core.bands.r1],
                    rows=int(runner.gcm.state.grid.T.shape[-2]),
                    block=list(runner.fleet.state.u.shape))

    CoupledStepFn._evolve_to, restart.save = timed_evolve, timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        (runner, walls, launches), calls = counted_substeps(
            lambda: cli_leg(argv, tee_writer(), before_finalize))
        rank = pmesh.rank()
        if runner.mesh is None or pmesh.world_size() != CONFIG4_RANKS:
            raise AssertionError("rank %d: no les mesh over %d ranks"
                                 % (rank, CONFIG4_RANKS))
        if runner.sp_cols != cols:
            raise AssertionError("rank %d: the points selected %d columns "
                                 "(%s...), not t255bench.columns' %d"
                                 % (rank, len(runner.sp_cols),
                                    runner.sp_cols[:4], len(cols)))
        pos = runner.fleet.positions
        rep = dict(rank=rank, device=str(runner.device),
                   card=card_line(runner.device), positions=pos,
                   walls=walls, evolve_s=evolve_s[0], save_s=save_s,
                   substeps=runner.substeps, launches=launches,
                   loop_substeps=calls,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   **held, **transport())
        if rank == 0:
            spifs = os.path.join(odir, "spifs.nc")
            times, groups = read_records(spifs)
            np.savez(report + ".records.npz", Time=np.asarray(times),
                     **{"%d/%s" % (c, v): a for c, g in groups.items()
                        for v, a in g.items()})
            path = os.path.join(odir, "restart.npz")
            rep.update(spifs_bytes=os.path.getsize(spifs),
                       timing_rows=timing_rows(odir)[1],
                       checkpoint_bytes=(os.path.getsize(path)
                                         if os.path.exists(path) else None))
    finally:
        CoupledStepFn._evolve_to, restart.save = evolve_to, save
        pmesh.shutdown()
    with open("%s.%d.json" % (report, rank), "w") as f:
        json.dump(rep, f)
    return 0


def check_config4_checkpoint(path, ref_path, sums):
    """(iv): the checkpoint at path holds every fleet leaf at
    [CONFIG4_FLEET, ...], each instance's float64 sums equal to those its
    rank wrote before finalize (sums: one npz a rank), and the GCM's
    leaves of the one-card reference's checkpoint (ref_path: no mesh, the
    whole state) at their shapes. Returns (seconds, leaves)."""
    t0 = time.time()
    if not os.path.exists(path):
        raise AssertionError("config4: no checkpoint at %s" % path)
    with np.load(path) as data, np.load(ref_path) as ref:
        les = [k for k in data.files if k.startswith("les_")]
        want = [k for k in ref.files if k.startswith("les_")]
        if les != want:
            raise AssertionError("config4: checkpoint fleet leaves %s, the "
                                 "reference's %s" % (les, want))
        for k in les:
            arr = data[k]
            if arr.shape[0] != CONFIG4_FLEET:
                raise AssertionError("config4: %s has shape %s"
                                     % (k, arr.shape))
            for r, s in enumerate(sums):
                got = row_sums(arr[s["positions"]])
                if not np.array_equal(got, s[k]):
                    raise AssertionError(
                        "config4: %s of rank %d's instances: file sums %s, "
                        "the rank's %s" % (k, r, got[:3], s[k][:3]))
            del arr
        gcm = [k for k in data.files if k.startswith("gcm_")]
        if gcm != [k for k in ref.files if k.startswith("gcm_")] or any(
                data[k].shape != ref[k].shape for k in gcm):
            raise AssertionError("config4: the checkpoint's GCM leaves are "
                                 "not the whole state of one process's")
    return time.time() - t0, len(les)


def config4_first_step(ref_times, ref_groups, rec, cols):
    """(ii): rank 0's step-1 records of cols against the reference's:
    record_diffs on the first record."""
    ref = {c: {v: ref_groups[c][v][:1] for v in CONFIG4_VARS} for c in cols}
    got = {"Time": np.asarray(rec["Time"][:1])}
    got.update({"%d/%s" % (c, v): rec["%d/%s" % (c, v)][:1] for c in cols
                for v in CONFIG4_VARS})
    return record_diffs(ref_times[:1], ref, got)


def phase_config4(card):
    """(g): BASELINE config 4 at its stated size (CONFIG4_CONF, 256
    columns) through the CLI on CONFIG4_RANKS cards (config4_rank, nccl),
    then its first CONFIG4_REF_N columns through the CLI on card 0 without
    a mesh; holds (i) the GCM's replicated state the same on every rank,
    (ii) step 1 of rank 0's first columns against card 0's run, (iii)
    every instance's records finite on every step and every instance
    substepping, (iv) rank 0's checkpoint against every rank's sums; each
    rank's lesstage launches 3 x its substep calls. The checkpoint lies in
    a temporary directory (its free space printed first) and is removed
    after (iv). Writes chiprun_out/chip_smoke_config4.json."""
    import shutil
    import tempfile
    t_phase = time.time()
    res = dict(card=card, conf=CONFIG4_CONF, args=CONFIG4_ARGS)
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log("config4 (g): temporary directory %s, %.1f GB free" % (
            tmp, free / 1e9))
        conf = os.path.join(tmp, "config4.json")
        with open(conf, "w") as f:
            json.dump(CONFIG4_CONF, f)
        report = os.path.join(tmp, "c4")
        odir = os.path.join(tmp, "run")
        wall = run_rank_set("cards_config4", CONFIG4_RANKS, CONFIG4_TIMEOUT,
                            ["--config4-rank", odir, conf, report],
                            os.path.join(tmp, "store"), backend="nccl")
        reps, sums = [], []
        for r in range(CONFIG4_RANKS):
            with open("%s.%d.json" % (report, r)) as f:
                reps.append(json.load(f))
            sums.append(dict(np.load("%s.%d.sums.npz" % (report, r))))
        check_transport("config4", reps, "nccl")
        per = CONFIG4_FLEET // CONFIG4_RANKS
        nlat = reps[0]["rows"] * CONFIG4_RANKS
        for rep in reps:
            r = rep["rank"]
            if rep["positions"] != list(range(per * r, per * (r + 1))) or \
                    rep["bands"] != [CONFIG4_RANKS, r * nlat // CONFIG4_RANKS,
                                     (r + 1) * nlat // CONFIG4_RANKS]:
                raise AssertionError("config4: rank %d holds positions "
                                     "%s..., GCM band %s" % (
                                         r, rep["positions"][:2],
                                         rep["bands"]))
            check_launches("config4 rank %d" % r, rep["launches"],
                           rep["loop_substeps"])
        r0 = reps[0]
        # (iii)
        sub = np.asarray(r0["substeps"])
        if sub.shape != (CONFIG4_STEPS, CONFIG4_FLEET) or not np.all(sub > 0):
            raise AssertionError("config4: substeps of shape %s, %d "
                                 "instance-steps without one" % (
                                     sub.shape, int(np.sum(sub <= 0))))
        rec = np.load(report + ".records.npz")
        cols = sorted({int(k.split("/")[0]) for k in rec.files
                       if k != "Time"})
        if len(cols) != CONFIG4_FLEET or len(rec["Time"]) != CONFIG4_STEPS:
            raise AssertionError("config4: %d columns, %d records"
                                 % (len(cols), len(rec["Time"])))
        groups = {c: {v: rec["%d/%s" % (c, v)] for v in CONFIG4_VARS}
                  for c in cols}
        check_finite_records("config4", groups, cols, CONFIG4_STEPS,
                             CONFIG4_VARS)
        # (ii) on card 0, no mesh
        ref_dir = os.path.join(tmp, "ref")
        ref_cols, argv = config4_argv(ref_dir, conf, CONFIG4_REF_N,
                                      mesh=False)
        torch.cuda.reset_peak_memory_stats()
        (runner, ref_walls, launches), calls = counted_substeps(
            lambda: cli_leg(argv, tee_writer()))
        check_launches("config4 reference", launches, calls)
        if runner.sp_cols != ref_cols or ref_cols != cols[:CONFIG4_REF_N]:
            raise AssertionError("config4 reference: columns %s, rank 0's "
                                 "first %s" % (runner.sp_cols,
                                               cols[:CONFIG4_REF_N]))
        ref_sub = runner.substeps
        ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del runner
        torch.cuda.empty_cache()
        ref_times, ref_groups = read_records(os.path.join(ref_dir,
                                                          "spifs.nc"))
        diffs = config4_first_step(ref_times, ref_groups, rec,
                                   cols[:CONFIG4_REF_N])
        slack = int(np.max(np.abs(sub[0, :CONFIG4_REF_N]
                                  - np.asarray(ref_sub[0]))))
        if slack > C_SUBSTEP_SLACK:
            raise AssertionError("config4: step 1's substeps %s, card 0's "
                                 "%s" % (sub[0, :CONFIG4_REF_N].tolist(),
                                         ref_sub[0]))
        # (iv)
        path = os.path.join(odir, "restart.npz")
        hold_s, n_leaves = check_config4_checkpoint(
            path, os.path.join(ref_dir, "restart.npz"), sums)
        os.remove(path)
    res.update(
        rank_set_s=wall, ranks=reps, reference=dict(
            walls=ref_walls, substeps=ref_sub, launches=launches,
            loop_substeps=calls, peak_gib=ref_peak),
        step1_diffs=diffs, substep_slack=slack, checkpoint_hold_s=hold_s,
        fleet_leaves=n_leaves, seconds=time.time() - t_phase)
    for rep in reps:
        log("config4 (g) rank %d (%s, %s): positions %d..%d, GCM rows %s, "
            "step walls %s s, own evolve %.1f s, lesstage %d = 3 x %d "
            "substep calls, peak %.2f GiB before the checkpoint and %.2f "
            "GiB after, checkpoint %s s" % (
                rep["rank"], rep["device"], rep["card"], rep["positions"][0],
                rep["positions"][-1], rep["bands"][1:], ["%.2f" % w for w in
                                                        rep["walls"]],
                rep["evolve_s"], rep["launches"]["lesstage"],
                rep["loop_substeps"], rep["peak_run_gib"], rep["peak_gib"],
                ["%.2f" % x for x in rep["save_s"]]))
    log("config4 (g): T255/L19 + %d x 128x128x160 on %d cards, %d steps, "
        "the rank set %.1f s; spifs.nc %d bytes, timing.txt %d step rows, "
        "host-I/O column %s s; "
        "checkpoint %d bytes, written in %.2f s, %d fleet leaves held "
        "against every rank's sums in %.1f s; card 0 alone at %d columns: "
        "step walls %s s, peak %.2f GiB, step-1 records within PROFILE_TOL "
        "(largest %s), substeps within %d; %.1f s in all on %s" % (
            CONFIG4_FLEET, CONFIG4_RANKS, CONFIG4_STEPS, wall,
            r0["spifs_bytes"], len(r0["timing_rows"]),
            [row[-1] for row in r0["timing_rows"]], r0["checkpoint_bytes"],
            r0["save_s"][0], n_leaves, hold_s, CONFIG4_REF_N,
            ["%.2f" % w for w in ref_walls], ref_peak,
            max(diffs.items(), key=lambda kv: kv[1]), slack,
            res["seconds"], card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_config4.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


def cards_main(n_cards):
    """``chip_smoke.py --cards N``: the nccl phases (a)-(f) on N cards,
    one card a rank. Raises without a card or with fewer than N cards
    (never runs on fewer, nor over gloo). The last line is the contract's
    {"ok": true, ...} with the count of cards used."""
    if n_cards not in CARD_COUNTS:
        raise ValueError("--cards %d: 2 or 4" % n_cards)
    phase_env()
    have = torch.cuda.device_count()
    if have < n_cards:
        raise RuntimeError("--cards %d on a machine of %d card(s): the nccl "
                           "phases take one card a rank" % (n_cards, have))
    lines = run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[:n_cards]
    card = "; ".join("cuda:%d %s" % kv for kv in enumerate(lines))
    log("cards:", card)
    t0 = time.time()
    phase_build()
    res, fails = dict(cards=lines), []

    def attempt(name, fn, *args):
        """fn(*args); a failure is printed and recorded, and fails the run
        after the phases that do not need this one's result. Ranks that
        hang end the run at once: the next set would hang too."""
        try:
            return fn(*args)
        except RanksTimedOut:
            raise
        except Exception as e:          # every phase runs; the run fails
            traceback.print_exc()
            fails.append("%s: %s" % (name, e))
            return None

    a = attempt("(a)", phase_mesh, card, "nccl")
    res["a"], single = a if a else (None, None)
    if n_cards >= BANDS_RANKS:
        if single is None:              # (d)'s reference, (a) having failed
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                single = bench_single(tmp)[1]
        first = attempt("t159 first step", t159_first_step, card)
        if first is not None:
            res["bc"] = attempt("(b), (c)", phase_gcm_bands, card, single,
                                first, "nccl")
        res["d"] = attempt("(d)", phase_spatial, card, single, "nccl")
    else:
        log("cards: (b)-(d) take 4 ranks: python3 chip_smoke.py --cards 4")
    res["e"] = attempt("(e)", phase_card_kernels, card, n_cards)
    res["f"] = attempt("(f)", phase_scaling, card, n_cards)
    if n_cards >= CONFIG4_RANKS:
        res["g"] = attempt("(g)", phase_config4, card)
    res.update(seconds=time.time() - t0, fails=fails)
    with open(os.path.join(OUT_DIR, "chip_smoke_cards.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    if fails:
        raise AssertionError("cards: %d phase(s) failed: %s"
                             % (len(fails), "; ".join(fails)))
    log("cards: every phase passed in %.1f s" % res["seconds"])
    print(lines[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n_cards}}))
    return 0


# ---- the golden replay and the columns bench ----------------------------

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden")
TENDENCIES = ("f_U", "f_V", "f_T", "f_SH", "f_QL", "f_QI", "f_A")
REPLAY_TOL = 1e-5        # of each tendency's scale (tests/test_golden.py)
# columnbench's case here: T63/L19 + 64 SP columns of 64x64x160 (RICO,
# TKE), batched, 2 coupled steps (the first builds and warms up)
COLUMNS_ARGV = ["--sizes", "64", "--trunc", "63", "--nlev", "19", "--nx",
                "64", "--ny", "64", "--nz", "160", "--les_schedule",
                "batched", "--steps", "2"]


def phase_replay(card):
    """tests/golden/spifs.nc (gzip + shuffle, 16 columns, 101 records)
    read on this host through the port's reader, and replayed through the
    port's driver on the host as tests/test_torch_replay.py does: every
    column and step compared, each tendency within REPLAY_TOL of its
    scale."""
    import tempfile
    from sp_coupler_tpu_torch.config import SPConfig
    from sp_coupler_tpu_torch.io import spifs
    from sp_coupler_tpu_torch.runtime.driver import SPRunner
    from sp_coupler_tpu_torch.utils import geometry
    t0 = time.time()
    with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
        meta = json.load(f)
    steps = meta["steps"]
    ds = spifs.open_reader(os.path.join(GOLDEN, "spifs.nc"))
    try:
        cols = sorted(int(g) for g in ds.groups)
        n_rec = len(np.asarray(ds.variables["Time"][:]))
        scale = {}
        for g in ds.groups.values():
            for var in ("T", "thl", "u", "Psurf") + TENDENCIES:
                a = np.asarray(g.variables[var][:])
                if not np.all(np.isfinite(a)):
                    raise AssertionError("replay: non-finite %s" % var)
                if var in TENDENCIES:
                    scale[var] = max(scale.get(var, 0.0),
                                     float(np.max(np.abs(a))))
    finally:
        ds.close()
    if cols != meta["columns"] or n_rec < steps:
        raise AssertionError("replay: columns %s, %d records" % (cols, n_rec))
    poly = geometry.Polygon(geometry.parse_lat_lons(
        [float(v) for v in meta["poly_lat_lon"]]))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = SPConfig(gcm_type="ncfile", les_type="ncfile",
                       gcm_input_dir=GOLDEN, les_input_dir=GOLDEN,
                       gcm_steps=steps, cplsurf=True, max_num_les=16,
                       output_dir=os.path.join(tmp, "out"))
        r = SPRunner(cfg, geometries=[poly], device="cpu")
        r.initialize()
        r.run(steps)
        r.finalize(save_restart=False)
    mm = r.gcm.mismatches
    worst = {}
    for _, var, _, d in mm:
        worst[var] = max(worst.get(var, 0.0), d)
    rel = {v: worst[v] / max(scale[v], 1e-30) for v in worst}
    if (len(mm) != len(TENDENCIES) * len(cols) * steps
            or set(worst) != set(TENDENCIES)
            or max(rel.values()) > REPLAY_TOL):
        raise AssertionError("replay: %d comparisons, worst |diff|/scale %s"
                             % (len(mm), rel))
    wall = time.time() - t0
    log("replay: tests/golden/spifs.nc (%d columns, %d records, gzip + "
        "shuffle) read through spifs.open_reader (h5lite) on this host, "
        "%d steps replayed on the host, %d tendency comparisons, largest "
        "|diff| / scale %.3g (%s; limit %g), %.1f s"
        % (len(cols), n_rec, steps, len(mm), max(rel.values()),
           max(rel, key=rel.get), REPLAY_TOL, wall))
    return dict(columns=len(cols), records=n_rec, comparisons=len(mm),
                worst_rel=rel, wall_s=wall)


def phase_columns(card):
    """runtime/columnbench.py at COLUMNS_ARGV on the card: the JSON row
    (with peak_gib), lesstage launched 3 x the substeps of the batched
    loop, and a spifs.nc of 64 groups and 2 records read back through the
    port's reader."""
    import tempfile
    from sp_coupler_tpu_torch.io import spifs
    from sp_coupler_tpu_torch.runtime import columnbench
    with tempfile.TemporaryDirectory() as tmp:
        args = columnbench.parser().parse_args(COLUMNS_ARGV
                                               + ["--workdir", tmp])
        n = int(args.sizes)
        torch.cuda.synchronize()
        reset_launches()
        row, calls = counted_substeps(
            lambda: columnbench.run_size(args, n, torch.device("cuda")))
        torch.cuda.synchronize()
        launches = read_launches()
        path = os.path.join(tmp, "cols_%04d" % n, "spifs.nc")
        ds = spifs.open_reader(path)
        try:
            n_groups = len(ds.groups)
            n_rec = len(np.asarray(ds.variables["Time"][:]))
            finite = all(np.all(np.isfinite(np.asarray(g.variables[v][:])))
                         for g in ds.groups.values()
                         for v in ("thl", "f_T", "rain"))
        finally:
            ds.close()
    check_launches("columns", launches, calls)
    if row["n_cols"] != n or n_groups != n or n_rec != args.steps \
            or not finite:
        raise AssertionError("columns: row %s, spifs.nc %d groups, %d "
                             "records, finite %s" % (row, n_groups, n_rec,
                                                     finite))
    log("columns: T%d/L%d + %d x %dx%dx%d (%s), %d steps: row %s; lesstage "
        "%d = 3 x %d substeps of the batched loop; spifs.nc %d groups, %d "
        "records, read back; peak %s GiB on %s"
        % (args.trunc, args.nlev, n, args.nx, args.ny, args.nz,
           args.les_schedule, args.steps, json.dumps(row),
           launches["lesstage"], calls, n_groups, n_rec,
           row["peak_gib"], card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_columns.json"), "w") as f:
        json.dump(dict(card=card, argv=COLUMNS_ARGV, row=row,
                       launches=launches, loop_substeps=calls), f,
                  indent=1)
    return launches


# ---- BASELINE configs 4 and 5: the GCM to TL639, the T255 fleet ---------

# gcmscale's rows here (truncations, repeats of the timed step and of the
# spectral round-trip), tl639's steps, the T255 fleet (T255/L19 + 4 x
# 128x128x160, batched, a warm and a timed step) and the climate runs'
# model days (Held-Suarez with a day of spin-up, the moist run)
GCM_SCALE, GCM_SCALE_REPEATS = (159, 255, 639), 3
TL639_STEPS = 10
# the card's steps of the same jet run, one row a step (verify/
# tl639_rows.py), held against the port's CPU rows
# (verify/ref/tl639_rows_cpu.json): every row through TL639_AGREE_STEP
# within TL639_ROW_TOL of the CPU's (max|u| and max|v| overall and on
# each level, Tmin, Tmax and the range of lnps, each as a fraction of
# the CPU's). Measured on an H100 80GB HBM3 at 700 W (chip_profile.py
# tl639cpu float64): 3.3e-4 to 6.6e-4 through step 6, 1.77e-3 at step 7,
# 5.1e-3 at step 8; without spharm.card_sums 3.05e-3 at step 1. Float32
# on either device parts from the same run in float64 by step 6, and the
# vertical Courant number passes 1 at step 12: the card goes non-finite
# at step 22, the CPU at step 23, float64 at step 36 (reported, not held)
TL639_ROW_TOL = 2e-3
TL639_AGREE_STEP = 6
T255_ARGV = ["--n", "4", "--les_schedule", "batched", "--steps", "1"]
CLIMATE_DAYS = 2


def phase_gcm_scale(card):
    """runtime/gcmscale.py's rows at GCM_SCALE on the card: finite, each
    with its build time and peak of device memory."""
    from sp_coupler_tpu_torch.runtime import gcmscale
    rows = []
    for trunc in GCM_SCALE:
        row = gcmscale.bench_trunc(trunc, GCM_SCALE_REPEATS, "cuda")
        vals = [row[k] for k in ("step_ms", "spectral_roundtrip_ms",
                                 "init_s", "peak_gib")]
        if not all(v is not None and np.isfinite(v) and v > 0
                   for v in vals):
            raise AssertionError("gcm_scale: row %s" % row)
        log("gcm_scale: T%d/L%d (%dx%d, dt %g s): step %.2f ms, spectral "
            "round-trip %.2f ms, core built in %.1f s, peak %.2f GiB on %s"
            % (trunc, row["nlev"], *row["grid"], row["dt_s"],
               row["step_ms"], row["spectral_roundtrip_ms"], row["init_s"],
               row["peak_gib"], card))
        rows.append(row)
    return rows


def phase_tl639(card):
    """runtime/tl639.py at its defaults (TL639/L60, dt 720 s, +-60 m/s
    jets, split phases) for TL639_STEPS steps: its PASS rule must hold.
    The report goes to chiprun_out/TL639_smoke.md."""
    from sp_coupler_tpu_torch.runtime import tl639
    os.makedirs(OUT_DIR, exist_ok=True)
    line = tl639.main(["--steps", str(TL639_STEPS), "--out",
                       os.path.join(OUT_DIR, "TL639_smoke.md")])
    if not line["ok"] or line["steps"] != TL639_STEPS:
        raise AssertionError("tl639: %s" % line)
    log("tl639: T%d/L%d, dt %g s, %d steps PASS: %.3f s a step, core built "
        "in %.1f s, peak %.2f GiB on %s; the full 600-step run FAILS, "
        "non-finite by step ~22 (verify/TL639_H100.md, chip_profile.py "
        "tl639)"
        % (line["trunc"], line["nlev"], line["dt_s"], line["steps"],
           line["step_s"], line["init_s"], line["peak_gib"], card))
    line["rows_vs_cpu"] = tl639_rows_vs_cpu(card)
    return line


def tl639_rows_vs_cpu(card):
    """The jet run on the card one row a step to its first non-finite
    step, held against the committed CPU rows (TL639_ROW_TOL through
    TL639_AGREE_STEP); both runs' first non-finite steps are reported.
    Writes chiprun_out/tl639_rows_card.json; returns the comparison."""
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    with open(tl639_rows.REF) as f:
        ref = json.load(f)
    core = tl639.build(ref["trunc"], ref["nlev"], ref["dt"], device="cuda")
    analysis = tl639_analysis(card, core, ref["jet"])
    rows = tl639_rows.rows(core, len(ref["rows"]), ref["jet"])
    del core
    diffs, parted = tl639_rows.parted(ref["rows"], rows, TL639_ROW_TOL)
    first = lambda rs: next((r["step"] for r in rs if not r["finite"]),
                            None)
    res = dict(card=card, tol=TL639_ROW_TOL, agree_step=TL639_AGREE_STEP,
               parted=parted, diffs=diffs, first_nonfinite=first(rows),
               cpu_first_nonfinite=first(ref["rows"]), analysis=analysis,
               rows=rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "tl639_rows_card.json"), "w") as f:
        json.dump(res, f, indent=1)
    log("tl639 rows: the card's jet run against the CPU's "
        "(verify/ref/tl639_rows_cpu.json), row difference by step: %s; "
        "parted past %.0e at step %s (must hold through step %d); first "
        "non-finite step %s on the card, %s on the CPU; %.3f s a step on %s"
        % (" ".join("%d:%.2g" % (r["step"], d)
                    for r, d in zip(rows, diffs)),
           TL639_ROW_TOL, parted, TL639_AGREE_STEP, res["first_nonfinite"],
           res["cpu_first_nonfinite"],
           float(np.mean([r["wall_s"] for r in rows])), card))
    if len(rows) < TL639_AGREE_STEP or (parted is not None
                                        and parted <= TL639_AGREE_STEP):
        raise AssertionError("tl639 rows: %d rows; the card parts from the "
                             "CPU at step %s, by step %d" % (
                                 len(rows), parted, TL639_AGREE_STEP))
    return {k: v for k, v in res.items() if k != "rows"}


def tl639_analysis(card, core, jet):
    """The card's TL639 analysis of the jet run's Euler state (vorticity
    and divergence from u and v, and T) against float64, beside the
    CPU's of the same float32 fields (tl639_rows.analysis_vs_float64):
    the card's error must not pass the CPU's. Without spharm.card_sums
    the card's solve lay 3.8x to 11x further from float64 than the
    CPU's (verify/TL639_H100.md)."""
    from sp_coupler_tpu_torch.models.gcm import spharm
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows
    g = core.step(tl639.start(core, jet), first=True).grid
    cpu = spharm.SpectralTransform(core.cfg.trunc, device="cpu")
    res = tl639_rows.analysis_vs_float64(core.sht, cpu, g.u, g.v, g.T)
    del g, cpu
    torch.cuda.empty_cache()
    log("tl639 analysis against float64 (max err / max), card / CPU: %s "
        "on %s" % ("; ".join("%s %.3g / %.3g" % (k, r["device"], r["cpu"])
                             for k, r in res.items()), card))
    bad = [k for k, r in res.items() if not r["device"] <= r["cpu"]]
    if bad:
        raise AssertionError("tl639 analysis: the card's %s further from "
                             "float64 than the CPU's: %s" % (bad, res))
    return res


def phase_t255(card):
    """runtime/t255bench.py at full width with T255_ARGV on the card: the
    stage kernel launches 3 x the substeps of the batched loop (a warm
    step and a timed one), the slab profiles are finite and [4, 160].
    Writes chiprun_out/chip_smoke_t255.json. Returns the launches."""
    from sp_coupler_tpu_torch.runtime import t255bench
    args = t255bench.parser().parse_args(T255_ARGV)
    torch.cuda.synchronize()
    reset_launches()
    (row, extras), calls = counted_substeps(
        lambda: t255bench.run(args, torch.device("cuda")))
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches("t255", launches, calls)
    shape = (args.n, args.nz)
    for k in ("THL", "QT", "U"):
        p = extras["prof"][k]
        if tuple(p.shape) != shape or not bool(torch.isfinite(p).all()):
            raise AssertionError("t255: %s profiles %s, finite %s"
                                 % (k, tuple(p.shape),
                                    bool(torch.isfinite(p).all())))
    log("t255: T%d/L%d + %d x %dx%dx%d (%s): warm step %.1f s, then %s; "
        "lesstage %d = 3 x %d substeps of the batched loop on %s"
        % (args.trunc, args.nlev, args.n, args.nx, args.ny, args.nz,
           args.les_schedule, extras["warm_s"], json.dumps(row),
           launches["lesstage"], calls, card))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_t255.json"), "w") as f:
        json.dump(dict(card=card, argv=T255_ARGV, row=row,
                       warm_s=extras["warm_s"], columns=extras["cols"],
                       launches=launches, loop_substeps=calls), f,
                  indent=1)
    return launches


def phase_climate(card):
    """verify/held_suarez.py and verify/moist_endurance.py for
    CLIMATE_DAYS model days each at T42/L19 on the card, through their
    entry points: finite, with every key of their JSON lines (the
    climatology verdict needs the full runs). Reports go to
    chiprun_out/."""
    from sp_coupler_tpu_torch.verify import held_suarez, moist_endurance
    os.makedirs(OUT_DIR, exist_ok=True)
    days = str(CLIMATE_DAYS)
    hs = held_suarez.main(["--days", days, "--spinup_days", "1", "--out",
                           os.path.join(OUT_DIR, "HELD_SUAREZ_smoke.md")])
    hs_keys = {"held_suarez_ok", "jet_nh_ms", "jet_sh_ms", "jet_nh_lat_deg",
               "u_equator_upper_ms", "u_surface_max_ms",
               "dT_eq_pole_lower_K", "finite", "wall_s"}
    if set(hs) != hs_keys or not hs["finite"]:
        raise AssertionError("climate: held_suarez %s" % hs)
    moist = moist_endurance.main(["--days", days, "--out",
                                  os.path.join(OUT_DIR, "MOIST_smoke.md")])
    moist_keys = {"bench", "backend", "trunc", "nlev", "dt_s", "days",
                  "wall_s", "jet_nh_ms", "jet_sh_ms", "ok"}
    if (set(moist) != moist_keys or moist["days"] != CLIMATE_DAYS
            or moist["backend"] != "cuda"
            or not np.isfinite([moist["jet_nh_ms"], moist["jet_sh_ms"]]).all()):
        raise AssertionError("climate: moist_endurance %s" % moist)
    log("climate: Held-Suarez T42/L19 %d days (1 spin-up) finite, %.1f s; "
        "moist T42/L19 %d days finite, %.1f s, on %s"
        % (CLIMATE_DAYS, hs["wall_s"], CLIMATE_DAYS, moist["wall_s"], card))
    return dict(held_suarez=hs, moist=moist)


def write_scale(rows, tl, climate):
    """chiprun_out/chip_smoke_scale.json: the GCM rows, the TL639 line and
    the climate runs' lines."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_scale.json"), "w") as f:
        json.dump(dict(gcm_scale=rows, tl639=tl, climate=climate), f,
                  indent=1)


def write_t159(gcm_sl, t159):
    """chiprun_out/chip_smoke_t159.json: the T159 leg and the SL GCM's
    times."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_t159.json"), "w") as f:
        json.dump(dict(gcm_sl=gcm_sl, t159=t159), f, indent=1)


def main():
    card = phase_env()
    log("the multi-rank phases here are gloo ranks sharing this card; the "
        "nccl phases, one card a rank, are in `python3 chip_smoke.py "
        "--cards 4`")
    phase_build()
    worst, times = phase_kernel(card)
    split = phase_split_kernels(card)
    runs = [phase_small_coupled(card, *path) for path in SMALL_PATHS]
    tke, main_steps = phase_main(card)
    runs += [tke, phase_main(card, "smagorinsky")[0]]
    runs += phase_split_grids(card)[0]
    runs += phase_cli(card, main_steps)
    phase_seed(card)
    runs.append(phase_parity(card))
    runs.append(phase_chunked(card))
    runs.append(phase_bench(card))
    schedule, launches = phase_schedule(card)
    runs.append(launches)
    batch, launches = phase_batch(card)
    runs.append(launches)
    write_fleet(schedule, batch)
    gcm_sl = phase_gcm_sl(card)
    t159, t159_first = phase_t159(card)
    write_t159(gcm_sl, t159)
    runs.append(t159["launches"])
    mesh_runs, single = phase_mesh(card)
    runs += mesh_runs
    halo_stats, halo_runs = phase_spatial(card, single)
    runs += halo_runs
    runs += phase_gcm_bands(card, single, t159_first)
    phase_replay(card)
    runs.append(phase_columns(card))
    rows = phase_gcm_scale(card)
    tl = phase_tl639(card)
    runs.append(phase_t255(card))
    write_scale(rows, tl, phase_climate(card))
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
    for name, whole in HALO_KERNELS.items():
        source, replaces = KERNELS[whole]
        ms, plain, b_ms, by, dev_ms = halo_stats[name]["times"]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r[name] for r in runs),
            max_abs_err=halo_stats[name]["max_abs_err"], ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=by,
            library_ms=None, device_ms=dev_ms))
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--card-kernels-rank"]:
        sys.exit(card_kernels_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--spatial-rank"]:
        sys.exit(spatial_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--bands-rank"]:
        sys.exit(bands_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--bands-cli-rank"]:
        sys.exit(bands_cli_rank(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--config4-rank"]:
        sys.exit(config4_rank(*sys.argv[2:5]))
    sys.exit(main())
