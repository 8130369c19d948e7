"""The jet run of runtime/tl639.py stepped side by side with the JAX
package's scripts/tl639_endurance.py from one injected state, to the
first non-finite step.

Both packages start from JAX's initial state of seed 1 (carried over
with ``interop``), each injects the +-jet m/s jets with its own
``_inject``, and then each steps its own core (hybrid levels, SL,
split_phases from T400 as both scripts set it, or as SPLIT forces it)
with the grid view and surface fields stripped before every step. Each step prints both
max|u| (and the level of it), the port's vertical Courant number of the
state the step starts from (2 dt x mean |eta-dot| over the layer, as
``chip_profile.py tl639`` reads it) and the largest difference of u and
T between the two, as a fraction of JAX's max. It imports both
packages, as the tests do, and runs on the CPU.

Usage (at T85/L60 both packages go non-finite at step 13 at dt 2160 s,
~2 min on 4 cores, and at step 52 at dt 1440 s, ~6 min):
    JAX_PLATFORMS=cpu python tests/jet_blowup_witness.py \\
        [TRUNC NLEV DT STEPS [JET [SPLIT]]]   (default 85 60 2160 14 60;
                                            SPLIT 1 or 0)
"""

import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from sp_coupler_tpu.models.gcm import model as jmodel
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.models.gcm import semilag
    from sp_coupler_tpu_torch.runtime import tl639

    trunc, nlev, dt, steps = (int(argv[0]), int(argv[1]), float(argv[2]),
                              int(argv[3])) if argv else (85, 60, 2160.0, 14)
    jet = float(argv[4]) if len(argv) > 4 else 60.0
    split = argv[5] == "1" if len(argv) > 5 else trunc >= 400
    path = os.path.join(ROOT, "scripts", "tl639_endurance.py")
    spec = importlib.util.spec_from_file_location("jax_tl639", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    jc = jmodel.GCMCore(jmodel.GCMConfig(
        trunc=trunc, nlev=nlev, dt=dt, hybrid=True, advection="sl",
        split_phases=split))
    tc = tl639.build(trunc, nlev, dt, split_phases=split, device="cpu")
    js = jc.initial_state(seed=1)
    zeta = jnp.asarray(script._jet_zeta(jc, jet), jnp.float32)[..., None]
    strip = lambda s: s._replace(grid=None, sfc=None)
    js = jc.step(strip(jc.apply(script._inject, js, zeta)), first=True)
    ts = tc.step(tl639.start(tc, jet, interop.gcm_state(
        jax.tree.map(np.asarray, jc.initial_state(seed=1)), "cpu")),
        first=True)
    print("T%d/L%d dt %g s, jets +-%g m/s, split_phases %s"
          % (trunc, nlev, dt, jet, tc.cfg.split_phases), flush=True)
    rows = []
    for i in range(steps):
        m = semilag.sl_mid_grid(tc.sht.whole, tc.vc, tc.slg, ts.now)
        sd = m["sdot"].abs()
        cz = float((dt * (sd[1:] + sd[:-1]) / m["dpt_full"])
                   .nan_to_num(0.0).max())
        del m, sd
        js = jc.step(strip(js))
        ts = tc.step(tl639.strip(ts))
        row = dict(step=i + 1, courant_z=cz)
        finite = True
        for name, u, T in (("jax", np.asarray(js.grid.u),
                            np.asarray(js.grid.T)),
                           ("port", ts.grid.u.numpy(), ts.grid.T.numpy())):
            ok = bool(np.isfinite(u).all() and np.isfinite(T).all())
            ua = np.nan_to_num(np.abs(u))
            row[name] = dict(umax=float(ua.max()),
                             level=int(ua.max(axis=(1, 2)).argmax()),
                             finite=ok)
            finite &= ok
        for k in ("u", "T"):
            ref = np.asarray(getattr(js.grid, k), np.float64)
            got = getattr(ts.grid, k).numpy().astype(np.float64)
            with np.errstate(invalid="ignore", over="ignore"):
                row["d" + k] = float(np.nanmax(np.abs(got - ref))
                                     / np.nanmax(np.abs(ref)))
        rows.append(row)
        print("step %2d  max|u| JAX %.6g (level %d), port %.6g (level %d); "
              "vertical Courant %.3f; max|du| %.3g, max|dT| %.3g of JAX's max"
              % (i + 1, row["jax"]["umax"], row["jax"]["level"],
                 row["port"]["umax"], row["port"]["level"], cz, row["du"],
                 row["dT"]), flush=True)
        if not finite:
            break
    print(json.dumps(dict(trunc=trunc, nlev=nlev, dt=dt, jet=jet,
                          split_phases=split, rows=rows)), flush=True)
    return rows


if __name__ == "__main__":
    import torch
    torch.set_num_threads(4)
    main(sys.argv[1:])
