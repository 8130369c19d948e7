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

Mode ``onestep`` takes one state the port's jet run saved
(``python -m sp_coupler_tpu_torch.verify.tl639_rows --save K
--save-dir DIR``), steps JAX's core once from it, frees that core, then
steps the port's once from it, and prints the largest differences of u,
T and lnps as fractions of JAX's max, each with its level, and the peak
RSS after each package's step. One process a state keeps one package's
core in memory at a time.

Usage (at T85/L60 both packages go non-finite at step 13 at dt 2160 s,
~2 min on 4 cores, and at step 52 at dt 1440 s, ~6 min):
    JAX_PLATFORMS=cpu python tests/jet_blowup_witness.py \\
        [TRUNC NLEV DT STEPS [JET [SPLIT]]]   (default 85 60 2160 14 60;
                                            SPLIT 1 or 0)
    JAX_PLATFORMS=cpu python tests/jet_blowup_witness.py onestep \\
        DIR/tl639_state_K.pt [SPLIT]   (SPLIT from the truncation, as
                                       above)
"""

import gc
import importlib.util
import json
import os
import resource
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _peak_gib():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _max_diff(got, ref):
    """tl639_rows.max_diff's fraction and the level (first axis of a 3-D
    field; None for 2-D) where the difference is largest."""
    from sp_coupler_tpu_torch.verify import tl639_rows
    frac, idx = tl639_rows.max_diff(got, ref)
    return frac, idx[0] if len(idx) == 3 else None


def onestep(path, split=None):
    """One step of each package from the port's state saved at path
    (``tl639_rows.save_state``): JAX's first (its core then freed), then
    the port's. Returns a dict: the state's step and size, the largest
    differences (du, dT, dlnps as fractions of JAX's max, with levels),
    both packages' max|u| and finiteness, and the peak RSS (GiB) after
    each step."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from sp_coupler_tpu.models.gcm import dycore as jdycore
    from sp_coupler_tpu.models.gcm import model as jmodel
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows

    saved = torch.load(path)
    trunc, nlev, dt = saved["trunc"], saved["nlev"], saved["dt"]
    del saved
    if split is None:
        split = trunc >= 400
    step_k = int(os.path.basename(path).rsplit("_", 1)[1].split(".")[0])
    tc = tl639.build(trunc, nlev, dt, split_phases=split, device="cpu")
    ts = tl639_rows.load_state(tc, path)
    spec = lambda s: jdycore.SpectralState(**{
        k: jnp.asarray(v.numpy()) for k, v in s._asdict().items()})
    # every leaf its own buffer: JAX's split phases donate the state
    js = jmodel.GCMState(now=spec(ts.now), prev=spec(ts.prev),
                         new=spec(ts.now), grid=None, sfc=None,
                         sp_tend={k: jnp.zeros((), jnp.float32)
                                  for k in jmodel._zero_sp_tend()},
                         vdiff_mask=jnp.asarray(ts.vdiff_mask.numpy()),
                         time=jnp.asarray(ts.time.numpy()))
    del ts, tc
    gc.collect()
    jc = jmodel.GCMCore(jmodel.GCMConfig(
        trunc=trunc, nlev=nlev, dt=dt, hybrid=True, advection="sl",
        split_phases=split))
    js = jc.step(js)
    ref = {k: np.array(getattr(js.grid, k)) for k in ("u", "T", "lnps")}
    jax_peak = _peak_gib()
    del js, jc
    jax.clear_caches()
    gc.collect()

    tc = tl639.build(trunc, nlev, dt, split_phases=split, device="cpu")
    ts = tc.step(tl639_rows.load_state(tc, path))
    got = {k: getattr(ts.grid, k).numpy() for k in ("u", "T", "lnps")}
    row = dict(step=step_k + 1, from_step=step_k, trunc=trunc, nlev=nlev,
               dt=dt, split_phases=split, k_chunk=tc.slg.k_chunk,
               jax_peak_rss_gib=jax_peak, peak_rss_gib=_peak_gib())
    for k in ("u", "T", "lnps"):
        row["d" + k], row["d%s_level" % k] = _max_diff(got[k], ref[k])
    for name, f in (("jax", ref), ("port", got)):
        row[name] = dict(umax=float(np.nanmax(np.abs(f["u"]))),
                         finite=bool(all(np.isfinite(f[k]).all()
                                         for k in f)))
    print("from step %d (T%d/L%d, split_phases %s): max|du| %.3g (level "
          "%s), max|dT| %.3g (level %s), max|dlnps| %.3g of JAX's max; "
          "max|u| JAX %.6g, port %.6g; peak RSS %.2f GiB after JAX's step, "
          "%.2f GiB after the port's"
          % (step_k, trunc, nlev, split, row["du"], row["du_level"],
             row["dT"], row["dT_level"], row["dlnps"], row["jax"]["umax"],
             row["port"]["umax"], jax_peak, row["peak_rss_gib"]),
          flush=True)
    print(json.dumps(row), flush=True)
    return row


def main(argv):
    if argv and argv[0] == "onestep":
        return onestep(argv[1], *([argv[2] == "1"] if len(argv) > 2
                                  else []))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from sp_coupler_tpu.models.gcm import model as jmodel
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.runtime import tl639
    from sp_coupler_tpu_torch.verify import tl639_rows

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
        cz = tl639_rows.courant(tc, ts, dt)[0]
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
            row["d" + k] = _max_diff(getattr(ts.grid, k),
                                     np.asarray(getattr(js.grid, k)))[0]
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
