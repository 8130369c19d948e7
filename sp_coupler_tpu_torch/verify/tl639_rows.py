"""The jet run of ``runtime/tl639.py`` one step at a time, one summary row
a step, to its first non-finite step.

Each row is the step's number (1 after the Euler start), max|u| and its
level, max|v|, Tmin and Tmax, the range of lnps, max|u| and max|v| on
each level, whether u, v, T and lnps are finite, and the vertical Courant number of the state the step starts from
as ``chip_profile.py tl639`` reads it (2 dt x the mean |eta-dot| over the
layer, divided by its pressure depth) with its level. The start is drawn
from CPU generators, so the card and the CPU start bit for bit alike and
their rows can be held against each other (``chip_smoke.py``
``phase_tl639`` holds the card's first steps against the committed CPU
rows, ``ref/tl639_rows_cpu.json``).

``--save K,...`` writes the state after each step K (both time levels,
the spectral triangle only) to ``--save-dir``, for
``tests/jet_blowup_witness.py onestep``, which steps JAX's core and the
port's once from it.

Runs on the card unless --device cpu is given. On the CPU at TL639/L60 a
step takes minutes: see README.md.

    python -m sp_coupler_tpu_torch.verify.tl639_rows --out ROWS.json
        [--trunc 639] [--nlev 60] [--dt 720] [--jet 60] [--steps 30]
        [--save 1,6,12,18 --save-dir DIR] [--device cpu]
"""

import argparse
import copy
import dataclasses
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from .. import clock, default_device, device_name

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ref",
                   "tl639_rows_cpu.json")


def courant(core, state, dt):
    """The largest vertical Courant number of state and its level:
    2 dt x the mean |eta-dot| of the layer's two faces over the layer's
    pressure depth."""
    from ..models.gcm import semilag
    m = semilag.sl_mid_grid(core.sht.whole, core.vc, core.slg, state.now)
    sd = m["sdot"].abs()
    cz = (dt * (sd[1:] + sd[:-1]) / m["dpt_full"]).nan_to_num(0.0)
    cz = cz.expand(core.cfg.nlev, core.nlat, core.nlon)
    level = cz.amax(dim=(1, 2))
    return float(level.max()), int(level.argmax())


def summary(state):
    """The summary of a stepped state's grid view (see the module's
    docstring), without the step's number and Courant number."""
    g = state.grid
    finite = {k: bool(torch.isfinite(getattr(g, k)).all())
              for k in ("u", "v", "T", "lnps")}
    ua = g.u.abs().nan_to_num(0.0).amax(dim=(1, 2))
    va = g.v.abs().nan_to_num(0.0).amax(dim=(1, 2))
    T = g.T.nan_to_num(0.0)
    lnps = g.lnps.nan_to_num(0.0)
    return dict(umax=float(ua.max()), u_level=int(ua.argmax()),
                vmax=float(va.max()), Tmin=float(T.min()),
                Tmax=float(T.max()), lnps_min=float(lnps.min()),
                lnps_max=float(lnps.max()),
                level_umax=[float(x) for x in ua.cpu()],
                level_vmax=[float(x) for x in va.cpu()],
                finite=all(finite.values()), finite_by_field=finite)


def step(core, state, dt, n):
    """Step n of the run from state: (the new state, its row)."""
    from ..runtime import tl639
    cz, cz_level = courant(core, state, dt)
    state = core.step(tl639.strip(state))
    return state, dict(step=n, courant_z=cz, courant_level=cz_level,
                       **summary(state))


def rows(core, steps, jet=60.0, on_row=None, start=None):
    """The run's rows: the Euler start from tl639.start (or from the
    stripped state `start`), then up to `steps` leapfrog steps, stopping
    after the first non-finite one. on_row(state, row) is called after
    each step; each row carries the step's wall time (s) on the device's
    clock."""
    from ..runtime import tl639
    dt = core.cfg.dt
    if start is None:
        start = tl639.start(core, jet)
    state = core.step(start, first=True)
    out = []
    for n in range(1, steps + 1):
        t0 = clock(core.device)
        state, row = step(core, state, dt, n)
        row["wall_s"] = clock(core.device) - t0
        out.append(row)
        if on_row is not None:
            on_row(state, row)
        if not row["finite"]:
            break
    return out


def save_state(core, state, path):
    """Both time levels of state (the spectral triangle m <= n of each
    field), its time and vdiff mask, and the core's size and step, to
    path (torch.save)."""
    tri = core.sht.mask.bool().cpu()
    pack = lambda s: {k: v.cpu()[..., tri, :].clone()
                      for k, v in s._asdict().items()}
    torch.save(dict(now=pack(state.now), prev=pack(state.prev),
                    time=state.time.cpu(),
                    vdiff_mask=state.vdiff_mask.cpu(),
                    trunc=core.cfg.trunc, nlev=core.cfg.nlev,
                    dt=core.cfg.dt), path)


def load_state(core, path):
    """The state save_state wrote, on core's device, ready to step: `new`
    is `now` (as after a step), no grid view, scalar-zero SP
    tendencies."""
    from ..models.gcm import dycore, model as gm
    d = torch.load(path)
    if (d["trunc"], d["nlev"]) != (core.cfg.trunc, core.cfg.nlev):
        raise ValueError("%s holds T%d/L%d, the core is T%d/L%d" % (
            path, d["trunc"], d["nlev"], core.cfg.trunc, core.cfg.nlev))
    tri = core.sht.mask.bool().cpu()

    def unpack(f):
        out = {}
        for k, v in f.items():
            full = torch.zeros(v.shape[:-2] + tri.shape + (2,),
                               dtype=v.dtype)
            full[..., tri, :] = v
            out[k] = full.to(core.device)
        return dycore.SpectralState(**out)

    now = unpack(d["now"])
    return gm.GCMState(now=now, prev=unpack(d["prev"]), new=now, grid=None,
                       sfc=None, sp_tend=gm._zero_sp_tend(core.device),
                       vdiff_mask=d["vdiff_mask"].to(core.device),
                       time=d["time"].to(core.device))


def max_diff(got, ref, device=None):
    """max|got - ref| / max|ref| (max|got - ref| where ref is all 0) in
    float64, NaNs left out, and the index of the largest difference (its
    first entry is the level of a 3-D field). got and ref are tensors or
    arrays; the sums run on device (by default got's)."""
    if device is None:
        device = got.device if torch.is_tensor(got) else "cpu"
    got, ref = (torch.as_tensor(x).to(device, torch.float64)
                for x in (got, ref))
    d = (got - ref).abs().nan_to_num(nan=-1.0)
    scale = float(ref.abs().nan_to_num(nan=0.0).max())
    dmax = float(d.max())
    idx = tuple(int(i) for i in np.unravel_index(int(d.argmax()),
                                                 tuple(d.shape)))
    if dmax < 0:
        return float("nan"), idx
    return dmax / (scale if scale > 0 else 1.0), idx


def as_double(obj):
    """A copy of a GCM core or transform whose float32 tensors (operator
    tables, the cached semi-implicit inverses) are float64: the float32
    object's own coefficients, float64 arithmetic."""
    memo = {}

    def conv(x):
        if id(x) in memo:
            return memo[id(x)]
        if torch.is_tensor(x):
            out = x.double() if x.dtype == torch.float32 else x
        elif isinstance(x, dict):
            out = {k: conv(v) for k, v in x.items()}
        elif isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
            out = type(x)(conv(v) for v in x)
        elif (type(x).__module__.startswith("sp_coupler_tpu_torch")
              and hasattr(x, "__dict__")
              and not dataclasses.is_dataclass(x)):
            out = memo[id(x)] = copy.copy(x)
            for k, v in vars(x).items():
                setattr(out, k, conv(v))
        else:
            out = x
        memo[id(x)] = out
        return out
    return conv(obj)


def analysis_vs_float64(sht, cpu_sht, u, v, T):
    """The analysis of the float32 grid fields u, v and T (vorticity and
    divergence from u and v, and T) by sht and by cpu_sht (the same
    truncation on the CPU), each against the float64 analysis on sht's
    device (as_double(sht)): {"T", "vort", "div": {"device", "cpu":
    max|err| / max}}."""
    s64 = as_double(sht)
    ref = dict(zip(("vort", "div"), s64.vort_div_from_uv(u.double(),
                                                        v.double())))
    ref["T"] = s64.analyze(T.double())
    del s64
    out = {k: {} for k in ref}
    for name, s in (("device", sht), ("cpu", cpu_sht)):
        d = s.mu.device
        got = dict(zip(("vort", "div"), s.vort_div_from_uv(u.to(d),
                                                           v.to(d))))
        got["T"] = s.analyze(T.to(d))
        for k in ref:
            out[k][name] = max_diff(got[k], ref[k], sht.mu.device)[0]
    return out


def row_diff(ref, got):
    """The largest difference of two rows of one step, each number as a
    fraction of the reference's: of max|u|, max|v|, Tmin and Tmax (over
    its own value), of lnps's range (over the larger of |min| and |max|),
    and of max|u| and max|v| on each level (over the largest level's).
    Infinite where one is finite and the other is not."""
    if ref["finite"] != got["finite"]:
        return float("inf")
    fracs = []
    for keys, scale in ((("umax",), None), (("vmax",), None),
                        (("Tmin",), None), (("Tmax",), None),
                        (("lnps_min", "lnps_max"), "range"),
                        (("level_umax",), "levels"),
                        (("level_vmax",), "levels")):
        a = np.asarray([ref[k] for k in keys], np.float64).ravel()
        b = np.asarray([got[k] for k in keys], np.float64).ravel()
        d = np.abs(b - a)
        fracs.append(np.max(d / np.abs(a)) if scale is None
                     else np.max(d) / np.max(np.abs(a)))
    return float(max(fracs))


def parted(ref_rows, rows, tol):
    """(the per-step row_diff of rows against ref_rows, step by step, and
    the first step whose difference passes tol, or None)."""
    diffs = [row_diff(a, b) for a, b in zip(ref_rows, rows)]
    first = next((a["step"] for a, d in zip(ref_rows, diffs) if d > tol),
                 None)
    return diffs, first


def parse_steps(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    """Run, print a line a step and write --out; returns the record."""
    from ..runtime import tl639
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trunc", type=int, default=639)
    ap.add_argument("--nlev", type=int, default=60)
    ap.add_argument("--dt", type=float, default=720.0)
    ap.add_argument("--jet", type=float, default=60.0)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--save", type=parse_steps, default=[])
    ap.add_argument("--save-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.save and not args.save_dir:
        ap.error("--save needs --save-dir")
    device = default_device(args.device)
    t0 = time.time()
    core = tl639.build(args.trunc, args.nlev, args.dt, device=device)
    init_s = time.time() - t0
    print("T%d/L%d dt %g s on %s (%d threads): core built in %.1f s"
          % (args.trunc, args.nlev, args.dt, device_name(device),
             torch.get_num_threads(), init_s), flush=True)

    out = dict(trunc=args.trunc, nlev=args.nlev, dt=args.dt, jet=args.jet,
               split_phases=core.cfg.split_phases,
               k_chunk=core.slg.k_chunk, device=device_name(device),
               threads=torch.get_num_threads(), init_s=init_s)

    def on_row(state, r):
        print("step %d: max|u| %.6g (level %d), T %.6g..%.6g, vertical "
              "Courant %.4g (level %d), finite %s, %.1f s" % (
                  r["step"], r["umax"], r["u_level"], r["Tmin"], r["Tmax"],
                  r["courant_z"], r["courant_level"], r["finite"],
                  r["wall_s"]), flush=True)
        if r["step"] in args.save:
            path = os.path.join(args.save_dir, "tl639_state_%d.pt"
                                % r["step"])
            save_state(core, state, path)
            print("saved", path, flush=True)

    res = rows(core, args.steps, args.jet, on_row=on_row)
    out["rows"] = res
    out["first_nonfinite"] = next(
        (r["step"] for r in res if not r["finite"]), None)
    out["peak_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF)
                           .ru_maxrss / 2 ** 20)
    if device.type == "cuda":
        out["peak_device_gib"] = (torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote %s: first non-finite step %s, peak RSS %.2f GiB"
          % (args.out, out["first_nonfinite"], out["peak_rss_gib"]),
          flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
