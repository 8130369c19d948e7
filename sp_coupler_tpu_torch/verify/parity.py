"""Parity harness: one fixed coupled case, its per-step summary, and the
comparison of two summaries.

Port of ``sp_coupler_tpu/verify/parity.py``. ``run`` steps a fixed coupled
configuration on one device and saves per-step summaries to an npz file
with the JAX package's keys, so ``compare`` holds a run of either package
against a run of the other:
  step{s}_prof_THL/QT/U   slab-mean LES profiles [n, nz];
  step{s}_gcm_T/U/SH      the GCM's SP columns [n, L];
  step{s}_std_thl/w       per-level standard deviation of thl and w.

Each device runs its production path: on the card the fused CUDA stage
kernel (``LESPhysics(use_kernel=True)``), on the CPU the plain PyTorch
versions. The LES start is drawn from CPU generators keyed by (seed,
instance), so a seed gives the same start on every device; the JAX
package draws from jax.random, so its start differs (``init`` starts the
port from a given state instead).

Same-device runs are bit-identical. Runs on two devices differ at float32
rounding, which the LES's turbulence amplifies, so ``compare`` holds the
coupled observables (profiles, GCM columns) at per-step tolerances relative
to max|ref| and only reports the standard deviations.

Usage:
    python -m sp_coupler_tpu_torch.verify.parity run out.npz [real [STEPS]]
        [--device cpu]
    python -m sp_coupler_tpu_torch.verify.parity compare a.npz b.npz
"""

import sys
import time

import numpy as np
import torch

from .. import default_device
from ..interop import to_numpy

# Tolerance model (the JAX package's): per-step max|a - b| / max|a| for
# steps 0, 1 and >= 2. One coupled step is ~120 chaotic LES substeps, and
# a device's production path differs from the CPU's in its arithmetic
# (kernel against plain), so the trajectories part at the turbulence's
# rate: the profiles are enforced, the standard deviations reported.
PROFILE_TOL = [1e-2, 2e-2, 5e-2]
STD_TOL = [0.5, 1.0, 1.5]  # informational: std of a chaotic field

# the BASELINE case size: T21/L19 GCM, 2 x 64x64x160 LES at 200 m / 25 m
# (run_T21_sockets.sh + dales-input/namoptions)
REAL = dict(trunc=21, nlev=19, les_n=64, les_nz=160, n_les=2, les_dz=25.0)


def init_les(core, grid, gcm_state, cols, seed):
    """The LES fleet started from the GCM's columns: instance i from the
    noise of a CPU generator keyed by (seed, i) (``LESFleet.init_states``)."""
    from ..coupling import convert
    from ..models.les import model as les_model, step as lstep
    dev = core.device
    prof0 = core.column_profiles(gcm_state, torch.as_tensor(
        np.asarray(cols), dtype=torch.int64, device=dev))
    conv0 = to_numpy(convert.convert_profiles(prof0, grid.zf(dev)))
    fleet = les_model.LESFleet(grid, lstep.LESPhysics(), len(cols), 5.0,
                               seed=seed, device=dev)
    fleet.init_states(conv0["u"], conv0["v"], conv0["thl"], conv0["qt"],
                      conv0["ps"])
    return fleet.state


def run(out_path, n_steps=3, trunc=10, nlev=8, les_n=16, les_nz=24,
        n_les=2, seed=7, les_dz=100.0, les_dx=200.0, device=None,
        init=None):
    """Run the parity configuration and save its per-step summaries.

    device: the card unless given (``default_device``). init: (GCMState,
    fleet LESState) to start from, on that device, instead of the seeded
    start. Returns (the summary dict saved to out_path, the substeps each
    instance took in each step).
    """
    from ..models.gcm import model as gcm_model
    from ..models.les import grid as lgrid, step as lstep, diag as ldiag
    from ..coupling.coupler import CoupledStepFn

    dev = default_device(device)
    print("parity run on device:", dev, file=sys.stderr)
    t0 = time.time()
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=trunc, nlev=nlev,
                                                 dt=600.0), device=dev)
    grid = lgrid.LESGrid(nx=les_n, ny=les_n, nz=les_nz, dx=les_dx,
                         dy=les_dx, dz=les_dz)
    # the production path per device: the CUDA stage kernel on the card,
    # the plain versions elsewhere
    phys = lstep.LESPhysics(use_kernel=dev.type == "cuda")
    cols = np.linspace(100, 350, n_les).astype(np.int32)
    if init is None:
        gcm_state = core.initial_state(seed=seed)
        les_state = init_les(core, grid, gcm_state, cols, seed)
    else:
        gcm_state, les_state = init
    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=5.0,
                            n_substeps=0, seed=seed)
    prof = ldiag.slab_profiles(grid, les_state)
    rain = torch.zeros(n_les, device=dev)

    out, substeps = {}, []
    for s in range(n_steps):
        gcm_state, les_state, prof, rain, diag = step_fn(
            gcm_state, les_state, prof, rain, s, first=(s == 0))
        diag = step_fn.unpack_diag(diag)
        substeps.append([int(x) for x in diag["n_substeps"]])
        p = to_numpy(prof)
        # slab-mean profiles: the coupled observables
        out[f"step{s}_prof_THL"] = p["THL"]
        out[f"step{s}_prof_QT"] = p["QT"]
        out[f"step{s}_prof_U"] = p["U"]
        # GCM column state
        out[f"step{s}_gcm_T"] = diag["gcm"]["T"]
        out[f"step{s}_gcm_U"] = diag["gcm"]["U"]
        out[f"step{s}_gcm_SH"] = diag["gcm"]["SH"]
        # turbulence statistics (chaos-robust): per-level std
        out[f"step{s}_std_thl"] = to_numpy(les_state.thl).std(axis=(2, 3))
        out[f"step{s}_std_w"] = to_numpy(les_state.w).std(axis=(2, 3))
    np.savez_compressed(out_path, **out)
    print("saved %s: %d steps, substeps %s, %.1f s" % (
        out_path, n_steps, substeps, time.time() - t0), file=sys.stderr)
    return out, substeps


def diffs(path_a, path_b):
    """{key: max|b - a| / max|a|} of two runs' npz files, a the
    reference."""
    a = np.load(path_a)
    b = np.load(path_b)
    if set(a.files) != set(b.files):
        raise ValueError("mismatched run configurations: %s against %s"
                         % (path_a, path_b))
    return {key: float(np.abs(a[key] - b[key]).max()
                       / (np.abs(a[key]).max() + 1e-12))
            for key in sorted(a.files)}


def compare(path_a, path_b, verbose=True):
    """Hold run b against run a (the reference): True if every enforced
    field is within its step's tolerance of max|a|."""
    failures = []
    for key, diff in diffs(path_a, path_b).items():
        step = int(key[4:key.index("_")])
        if "_std_" in key:
            tol = STD_TOL[min(step, len(STD_TOL) - 1)]
            enforce = False  # report-only: std of a chaotic field
        else:
            tol = PROFILE_TOL[min(step, len(PROFILE_TOL) - 1)]
            enforce = True
        ok = diff <= tol
        if verbose:
            print(f"{key:24s} max rel diff {diff:9.2e}  tol {tol:7.1e}  "
                  f"{'ok' if ok else ('FAIL' if enforce else 'note')}")
        if not ok and enforce:
            failures.append((key, diff, tol))
    if failures:
        print("PARITY FAIL: %d fields out of tolerance" % len(failures))
        return False
    print("PARITY OK: all enforced fields within tolerance")
    return True


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv and argv[0] == "run":
        if len(argv) > 2 and argv[2] == "real":
            n_steps = int(argv[3]) if len(argv) > 3 else 10
            run(argv[1], n_steps=n_steps, device=device, **REAL)
        else:
            run(argv[1], *(int(x) for x in argv[2:]), device=device)
        return 0
    if argv and argv[0] == "compare":
        return 0 if compare(argv[1], argv[2]) else 1
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
