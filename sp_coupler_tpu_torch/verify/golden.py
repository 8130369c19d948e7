"""Record, replay and compare spifs.nc recordings of BASELINE configs 1-2.

The port's counterpart of ``scripts/make_golden.py``, the script that
recorded ``tests/golden/spifs.nc`` (BASELINE config 2 on a TPU). It never
writes into ``tests/golden/``: the JAX package's recording there stays the
reference. Run as ``python -m sp_coupler_tpu_torch.verify.golden``:

``record OUTDIR [--steps 100] [--leg 25] [--seed S] [--cases config2]``
    drives ``python -m sp_coupler_tpu_torch.spmaster`` with the case's
    arguments (config2: make_golden.py's, T21 + the 16 columns of POLY,
    gzip 4; config1: run_T21.sh's, T21 + 2 columns) in legs of --leg
    steps: the first leg plain, each later one with --restart, every leg
    with --restart_overlap, so that the legs join without a gap in Time
    and hold the records of one run of --steps. After each leg it checks
    the exit code, the checkpoint's step, the records' Time axis and,
    on the card, that the stage kernel launched 3 x the leg's substeps
    (the run summary spmaster logs). It writes golden_meta.json (the
    fields make_golden.py derives from the recording; platform and device
    are the torch device's) and record.json (every leg's step walls,
    substeps, clamped dts, launches and memory peaks), and removes the
    last checkpoint unless --keep-restart. Without --device the legs take
    the CUDA card, and fail where there is none.
``summary DIR``
    the legs of a recording (its record.json), one line each: step walls
    (min, median, max), substeps an instance-step, dts clamped at
    les_dt_min, launches, peaks; then each step's substeps and clamps.
``replay DIR``
    replays DIR/spifs.nc through the port's driver on the host (the
    ``ncfile`` models, ``models/ncreplay.py``): every tendency of every
    column and step recomputed by the coupling layer and held within
    REPLAY_TOL of its variable's scale (the largest |value| recorded), as
    tests/test_golden.py holds the TPU recording.
``compare A B [C ...]``
    the distance of every pair of recordings, record by record matched by
    Time: for each variable the RMS of A - B over the columns and levels,
    over the variable's scale (the largest |value| in either recording
    over the whole run; a per-step scale blows up on fields that start
    near zero, as U and V do). ``--steps a:b`` picks the steps averaged,
    ``--exact`` requires every variable of every matched record equal bit
    for bit, ``--hold F`` holds the second recording within F x the
    largest distance between two of the second and later ones (the seed
    spread) of the first (the reference) for each of HOLD_VARS.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")

# 1-20N x 58-37.5W: the 16 T21 columns of the recording (make_golden.py)
POLY = ["20", "-58", "1", "-58", "1", "-37.5", "20", "-37.5"]
# run_T21.sh: 10-20N x 50-40W, 2 columns
POLY_T21 = ["20", "-50", "10", "-50", "10", "-40", "20", "-40"]
CASES = {
    "config2": dict(
        name="T21 + 16 SP columns (BASELINE config 2)", poly=POLY,
        argv=["--poly", *POLY, "--numles", "16", "--gcmexp", "TEST",
              "--cplsurf"],
        conf={"output_compress": 4}),
    "config1": dict(
        name="T21 + 2 SP columns, run_T21.sh (BASELINE config 1)",
        poly=POLY_T21,
        argv=["--poly", *POLY_T21, "--numles", "2", "--gcmexp", "TEST",
              "--cplsurf"],
        conf={}),
}
TENDENCIES = ("f_U", "f_V", "f_T", "f_SH", "f_QL", "f_QI", "f_A")
REPLAY_TOL = 1e-5        # of each tendency's scale (tests/test_golden.py)
# the GCM-side profiles and the LES slab means verify/parity.py enforces
HOLD_VARS = ("T", "SH", "U", "V", "thl", "qt")
REPORT_VARS = ("T", "SH", "U", "V", "QL", "A", "thl", "qt", "ql")
LEG_TIMEOUT = 3600       # s a leg


# ---- record -----------------------------------------------------------------

def inside(path, root):
    """Whether path lies in root (or is root), links resolved."""
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def read_summary(log_path):
    """The run summary spmaster logs last (spmaster.SUMMARY)."""
    from ..spmaster import SUMMARY
    found = None
    with open(log_path, errors="replace") as f:
        for line in f:
            if SUMMARY in line:
                found = json.loads(line.split(SUMMARY, 1)[1])
    if found is None:
        raise RuntimeError("%s: spmaster logged no run summary" % log_path)
    return found


def leg_substeps(summary):
    """The stage kernel's calls in a run: each instance's substeps (a
    serial fleet) or the fleet's slowest instance's (a batched one), of
    every step, the unwritten overlap step's included."""
    per = np.sum if summary["serial"] else np.max
    return int(sum(per(s) for s in summary["substeps"]
                   + summary["overlap_substeps"]))


def time_axis(path):
    """The Time values of a spifs.nc."""
    from ..io import spifs
    ds = spifs.open_reader(path)
    try:
        return np.asarray(ds.variables["Time"][:], np.float64)
    finally:
        ds.close()


def leg_plan(steps, leg):
    """--steps of each leg: legs of leg steps, the last the rest."""
    if steps < 1 or leg < 1:
        raise ValueError("--steps and --leg must be >= 1")
    return [min(leg, steps - k) for k in range(0, steps, leg)]


def run_leg(k, argv, log_path, timeout):
    """One leg: spmaster in a process of its own; raises unless it
    exits 0. Returns (seconds, its run summary)."""
    cmd = [sys.executable, "-m", "sp_coupler_tpu_torch.spmaster", *argv]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT, timeout=timeout
                            ).returncode
    wall = time.time() - t0
    if rc != 0:
        with open(log_path, errors="replace") as f:
            tail = f.read()[-4000:]
        raise RuntimeError("leg %d: spmaster %s exited %d after %.1f s; "
                           "log tail:\n%s" % (k, " ".join(argv), rc, wall,
                                              tail))
    return wall, read_summary(log_path)


def leg_argv(case, n, outdir, conf_path, k, device=None):
    """spmaster's flags of leg k (--steps n) of case: the case's, the
    output directory and --conf, --restart_overlap, and --restart after
    the first leg."""
    return (CASES[case]["argv"] + ["--steps", str(n), "--odir", outdir,
                                   "--conf", conf_path, "--restart_overlap"]
            + (["--restart"] if k else [])
            + (["--device", device] if device else []))


def record(outdir, steps=100, leg=25, seed=42, case="config2", device=None,
           conf=None, keep_restart=False, timeout=LEG_TIMEOUT):
    """Record case for steps coupled steps (records 0..steps, steps + 1
    of them) in legs of leg steps into outdir. conf: more --conf keys
    (a dict). Returns record.json's contents."""
    outdir = os.path.abspath(outdir)
    if inside(outdir, GOLDEN_DIR):
        raise ValueError("%s lies in tests/golden/: the JAX package's "
                         "recording there is the reference" % outdir)
    if os.path.exists(outdir) and os.listdir(outdir):
        raise ValueError("%s exists and is not empty" % outdir)
    spec = CASES[case]
    plan = leg_plan(steps, leg)
    work = tempfile.mkdtemp(prefix="golden_")
    conf_path = os.path.join(work, "conf.json")
    with open(conf_path, "w") as f:
        json.dump(dict(spec["conf"], seed=seed, **(conf or {})), f)
    on_card = device is None or str(device).startswith("cuda")
    spifs_path = os.path.join(outdir, "spifs.nc")
    legs, done, t_all = [], 0, time.time()
    try:
        for k, n in enumerate(plan):
            argv = leg_argv(case, n, outdir, conf_path, k, device)
            log_path = os.path.join(work, "leg%d.log" % k)
            wall, summary = run_leg(k, argv, log_path, timeout)
            done += n
            with open(os.path.join(outdir, "restart.json")) as f:
                meta = json.load(f)
            if meta["gcm_step"] != done or not os.path.exists(
                    os.path.join(outdir, "restart.npz")):
                raise RuntimeError(
                    "leg %d: the checkpoint is at step %s, not %d (or "
                    "restart.npz is missing)" % (k, meta["gcm_step"], done))
            times = time_axis(spifs_path)
            dt = times[0]
            if len(times) != done + 1 or not np.array_equal(
                    times, dt * np.arange(1, done + 2)):
                raise RuntimeError("leg %d: Time holds %d records %s..., "
                                   "want %d at %g s apart"
                                   % (k, len(times), times[-3:].tolist(),
                                      done + 1, dt))
            calls = leg_substeps(summary)
            stage = summary["launches"]["lesstage"]
            if on_card and (stage != 3 * calls or stage == 0):
                raise RuntimeError("leg %d: lesstage launched %d times, "
                                   "want 3 x %d substeps" % (k, stage,
                                                             calls))
            legs.append(dict(leg=k, steps=n, argv=argv, wall_s=wall,
                             substep_calls=calls,
                             checkpoint_bytes=os.path.getsize(
                                 os.path.join(outdir, "restart.npz")),
                             spifs_bytes=os.path.getsize(spifs_path),
                             **summary))
            print("golden record: leg %d (%d steps) in %.1f s, lesstage %d "
                  "for %d substeps, peak RSS %.0f MB, card peak %s GiB"
                  % (k, n, wall, stage, calls, summary["peak_rss_mb"],
                     summary["card_peak_gib"]), flush=True)
    finally:
        if os.path.isdir(outdir):
            os.makedirs(os.path.join(outdir, "legs"), exist_ok=True)
            for name in os.listdir(work):
                if name.endswith(".log"):
                    shutil.copy(os.path.join(work, name),
                                os.path.join(outdir, "legs", name))
        shutil.rmtree(work, ignore_errors=True)
    wall = time.time() - t_all
    meta = recording_meta(spifs_path, spec, wall, device)
    meta.update(seed=seed, legs=plan)
    with open(os.path.join(outdir, "golden_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    out = dict(meta=meta, legs=legs)
    with open(os.path.join(outdir, "record.json"), "w") as f:
        json.dump(out, f, indent=1)
    if not keep_restart:
        for name in ("restart.npz", "restart.json"):
            os.remove(os.path.join(outdir, name))
    return out


def recording_meta(path, spec, wall, device):
    """make_golden.py's golden_meta.json fields, from the recording; the
    platform and device of the torch device the legs ran on (the card's
    name and power limit, as nvidia-smi gives them)."""
    import torch
    from ..io import spifs
    ds = spifs.open_reader(path)
    try:
        times = np.asarray(ds.variables["Time"][:])
        les_grid = [int(ds.variables[k].shape[0]) for k in ("x", "y", "zf")]
        columns = sorted(int(g) for g in ds.groups)
    finally:
        ds.close()
    dev = torch.device(device or "cuda")
    name = str(dev)
    if dev.type == "cuda":
        from .. import card_line
        name = card_line(dev)
    return {
        "case": spec["name"], "steps": len(times) - 1,
        "gcm_dt_s": float(times[1] - times[0]) if len(times) > 1 else None,
        "les_grid": les_grid, "poly_lat_lon": spec["poly"],
        "columns": columns, "platform": dev.type, "device": name,
        "wall_s": round(wall, 1),
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def summary(record):
    """The lines ``summary`` prints of record.json's contents."""
    lines, step = [], 0
    for leg in record["legs"]:
        w = np.asarray(leg["step_walls"])
        sub = np.asarray(leg["substeps"])
        lines.append(
            "leg %d (--steps %d): %.1f s; %d step walls %.2f / %.2f / %.2f s "
            "(min / median / max); %d records, substeps an instance-step "
            "%d-%d (%d in all, the overlap step's %s); %d dts clamped; "
            "lesstage %d for %d substep calls; peak RSS %.0f MB, card peak "
            "%s GiB; checkpoint %d B, spifs.nc %d B" % (
                leg["leg"], leg["steps"], leg["wall_s"], len(w), w.min(),
                np.median(w), w.max(), len(sub), sub.min(), sub.max(),
                sub.sum(), [sum(x) for x in leg["overlap_substeps"]],
                int(np.sum(leg["clamped"])), leg["launches"]["lesstage"],
                leg["substep_calls"], leg["peak_rss_mb"],
                leg["card_peak_gib"], leg["checkpoint_bytes"],
                leg["spifs_bytes"]))
    for leg in record["legs"]:
        for sub, clamp in zip(leg["substeps"], leg["clamped"]):
            step += 1
            lines.append("record %d: substeps %s, clamped %d" % (
                step, sub, sum(clamp)))
    # the records' steps (a later leg's first wall is its overlap step's)
    legs = record["legs"]
    walls = np.concatenate([leg["step_walls"][1 if leg["leg"] else 0:]
                            for leg in legs])
    tot = np.asarray([sum(x) for leg in legs for x in leg["substeps"]])
    grid = record["meta"]["les_grid"]
    lines.append(
        "run: %d records; substeps a record %d-%d (records %d, %d), %d in "
        "all; their step walls %.2f / %.2f / %.2f s (min / median / max), "
        "%.1f s in all; %.2f-%.2f ms an instance-substep; %.4g LES "
        "gridpoint-updates/s; each overlap step's substeps those of the "
        "record it recomputes: %s" % (
            len(tot), tot.min(), tot.max(), tot.argmin() + 1,
            tot.argmax() + 1, tot.sum(), walls.min(), np.median(walls),
            walls.max(), walls.sum(), 1e3 * np.min(walls / tot),
            1e3 * np.max(walls / tot),
            np.prod(grid) * tot.sum() / walls.sum(),
            [legs[k]["overlap_substeps"] == [legs[k - 1]["substeps"][-1]]
             for k in range(1, len(legs))]))
    return lines


# ---- read -------------------------------------------------------------------

def read_recording(path, variables=None):
    """(Time, {column: {var: [records, ...]}}) of a spifs.nc (a file, or a
    directory holding one), every variable or those given."""
    from ..io import spifs
    if os.path.isdir(path):
        path = os.path.join(path, "spifs.nc")
    ds = spifs.open_reader(path)
    try:
        times = np.asarray(ds.variables["Time"][:], np.float64)
        groups = {int(name): {v: np.asarray(g.variables[v][...])
                              for v in (variables or g.variables)
                              if v in g.variables}
                  for name, g in ds.groups.items()}
    finally:
        ds.close()
    return times, groups


# ---- replay -----------------------------------------------------------------

def replay(path):
    """Replay the recording at path (a directory holding spifs.nc)
    through the port's driver on the host; raises AssertionError unless
    every variable of every column is finite and every tendency of every
    column and step lies within REPLAY_TOL of its scale. Returns the
    counts, the worst |diff| / scale of each tendency and the seconds
    taken."""
    from ..config import SPConfig
    from ..runtime.driver import SPRunner
    from ..utils import geometry
    t0 = time.time()
    times, groups = read_recording(path)
    cols, n_rec = sorted(groups), len(times)
    scale = {}
    for col, g in groups.items():
        for var, a in g.items():
            if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
                raise AssertionError("replay: column %d %s is not finite"
                                     % (col, var))
            if var in TENDENCIES:
                scale[var] = max(scale.get(var, 0.0),
                                 float(np.max(np.abs(a))))
    steps = n_rec - 1
    with tempfile.TemporaryDirectory() as tmp:
        cfg = SPConfig(gcm_type="ncfile", les_type="ncfile",
                       gcm_input_dir=path, les_input_dir=path,
                       gcm_steps=steps,
                       cplsurf=all("z0m" in g for g in groups.values()),
                       max_num_les=len(cols),
                       output_dir=os.path.join(tmp, "out"))
        everywhere = geometry.Box(-math.inf, -math.inf, math.inf, math.inf)
        r = SPRunner(cfg, geometries=[everywhere], device="cpu")
        r.initialize()
        r.run(steps)
        r.finalize(save_restart=False)
    mm = r.gcm.mismatches
    worst = {}
    for _, var, _, d in mm:
        worst[var] = max(worst.get(var, 0.0), d)
    rel = {v: worst[v] / max(scale[v], 1e-30) for v in worst}
    res = dict(columns=len(cols), records=n_rec, steps=steps,
               comparisons=len(mm), worst_rel=rel, tol=REPLAY_TOL,
               wall_s=time.time() - t0)
    if (len(mm) != len(TENDENCIES) * len(cols) * steps
            or set(worst) != set(TENDENCIES)
            or not max(rel.values()) <= REPLAY_TOL):
        raise AssertionError("replay %s: %d comparisons (want %d), worst "
                             "|diff| / scale %s (limit %g)"
                             % (path, len(mm), len(TENDENCIES) * len(cols)
                                * steps, rel, REPLAY_TOL))
    return res


# ---- compare ----------------------------------------------------------------

def distances(a, b, variables=REPORT_VARS):
    """The distance of recordings a and b (each ``read_recording``'s
    pair), record by record at the Time values both hold: for each
    variable, RMS(a - b) over the columns and levels / the variable's
    scale, the largest |value| in either recording over the whole run.
    Returns (the matched Time values, {var: [distance of each]})."""
    (ta, ga), (tb, gb) = a, b
    if sorted(ga) != sorted(gb):
        raise ValueError("the recordings hold other columns: %s, %s"
                         % (sorted(ga), sorted(gb)))
    times = np.intersect1d(ta, tb)
    ia, ib = np.searchsorted(ta, times), np.searchsorted(tb, times)
    out = {}
    for var in variables:
        if any(var not in ga[c] or var not in gb[c] for c in ga):
            continue
        sa = np.stack([ga[c][var] for c in sorted(ga)], 1).astype(np.float64)
        sb = np.stack([gb[c][var] for c in sorted(ga)], 1).astype(np.float64)
        scale = max(float(np.max(np.abs(sa))), float(np.max(np.abs(sb))))
        diff = sa[ia] - sb[ib]
        rms = np.sqrt(np.mean(diff.reshape(len(times), -1) ** 2, axis=1))
        out[var] = (rms / scale if scale > 0 else rms).tolist()
    return times, out


def exact_diffs(a, b):
    """The (Time, column, var) of a's records that are not b's bit for
    bit at the same Time, and of columns or variables one lacks."""
    (ta, ga), (tb, gb) = a, b
    bad = []
    if sorted(ga) != sorted(gb):
        return [("columns", sorted(ga), sorted(gb))]
    for i, t in enumerate(ta):
        j = np.flatnonzero(tb == t)
        if not len(j):
            continue
        for c in ga:
            if sorted(ga[c]) != sorted(gb[c]):
                bad.append((float(t), c, "variables"))
                continue
            for v, arr in ga[c].items():
                x, y = arr, gb[c][v]
                if x.ndim and len(x) == len(ta) and len(y) == len(tb):
                    x, y = x[i], y[j[0]]
                if x.shape != y.shape or x.tobytes() != y.tobytes():
                    bad.append((float(t), c, v))
    return bad


def window(times, steps):
    """Mask of the matched Time values in the step range steps = (a, b)
    (both included), a record's step being Time / the first record's
    Time."""
    k = np.rint(times / times[0]).astype(int)
    return (k >= steps[0]) & (k <= steps[1])


def compare(paths, steps=None, exact=False, hold=None):
    """Every pair's distances (``distances``, of REPORT_VARS), each
    variable's mean over the steps, and the holds asked for; what failed
    in "failures"."""
    recs = [read_recording(p) for p in paths]
    pairs = []
    for i in range(len(paths)):
        for j in range(i + 1, len(paths)):
            times, d = distances(recs[i], recs[j])
            m = window(times, steps) if steps else np.ones(len(times), bool)
            if not m.any():
                raise AssertionError("%s and %s share no record in steps "
                                     "%s" % (paths[i], paths[j], steps))
            pairs.append(dict(
                a=paths[i], b=paths[j], i=i, j=j,
                steps=np.rint(times[m] / times[0]).astype(int).tolist(),
                mean={v: float(np.mean(np.asarray(x)[m]))
                      for v, x in d.items()},
                series={v: np.asarray(x)[m].tolist() for v, x in d.items()}))
    res = dict(paths=list(paths), steps=steps, pairs=pairs, failures=[])
    if exact:
        res["exact"] = {"%s|%s" % (p["a"], p["b"]): exact_diffs(
            recs[p["i"]], recs[p["j"]])[:20] for p in pairs}
        res["failures"] += ["records differ: %s %s" % kv
                            for kv in res["exact"].items() if kv[1]]
    if hold is not None:
        if len(paths) < 4:
            raise ValueError("--hold: the reference, the subject and at "
                             "least two seeds")
        res["hold"] = seed_hold(pairs, hold)
        res["failures"] += ["hold broken for %s: %s" % kv
                            for kv in res["hold"].items() if not kv[1]["ok"]]
    return res


def check(res):
    """Raise AssertionError on compare's failures; return res."""
    if res["failures"]:
        raise AssertionError("; ".join(res["failures"]))
    return res


def seed_hold(pairs, factor):
    """For each of HOLD_VARS: the subject's (recording 1) mean distance
    from the reference (recording 0) against factor x the largest mean
    distance between two of recordings 1, 2, ... (the seed spread)."""
    ref = next(p for p in pairs if (p["i"], p["j"]) == (0, 1))
    spread = [p for p in pairs if p["i"] >= 1]
    out = {}
    for v in HOLD_VARS:
        if v not in ref["mean"]:
            continue
        widest = max(p["mean"][v] for p in spread)
        out[v] = dict(d_ref=ref["mean"][v], seed_spread=widest,
                      factor=factor, ratio=ref["mean"][v] / widest
                      if widest > 0 else math.inf,
                      ok=bool(ref["mean"][v] <= factor * widest))
    return out


def column_means(path, variables=REPORT_VARS, steps=(51, 100)):
    """{var: the profile averaged over the columns and the records of the
    steps (both included)} of a recording."""
    times, groups = read_recording(path, variables)
    m = window(times, steps)
    return {v: np.mean([groups[c][v][m] for c in groups
                        if v in groups[c]], axis=(0, 1)).tolist()
            for v in variables if all(v in g for g in groups.values())}


# ---- CLI ------------------------------------------------------------------

def parse_steps(text):
    a, b = text.split(":")
    return int(a), int(b)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record", help="record a case through spmaster")
    r.add_argument("outdir")
    r.add_argument("--steps", type=int, default=100)
    r.add_argument("--leg", type=int, default=25)
    r.add_argument("--seed", type=int, default=42)
    r.add_argument("--cases", dest="case", choices=sorted(CASES),
                   default="config2")
    r.add_argument("--device", default=None,
                   help="torch device of the legs (default: the card)")
    r.add_argument("--conf", default=None,
                   help="more --conf keys, as JSON (a small grid on the "
                        "CPU)")
    r.add_argument("--keep-restart", action="store_true")
    m = sub.add_parser("summary", help="a recording's legs")
    m.add_argument("dir")
    y = sub.add_parser("replay", help="replay a recording on the host")
    y.add_argument("dir")
    c = sub.add_parser("compare", help="distances between recordings")
    c.add_argument("paths", nargs="+")
    c.add_argument("--steps", type=parse_steps, default=None,
                   help="a:b, the steps averaged (both included)")
    c.add_argument("--exact", action="store_true",
                   help="every matched record equal bit for bit")
    c.add_argument("--hold", type=float, default=None,
                   help="factor: paths[1] within it x the seed spread of "
                        "paths[0]")
    c.add_argument("--means", default=None, metavar="a:b",
                   help="also each recording's column means over steps")
    c.add_argument("--json", default=None, help="write the result here")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.cmd == "record":
        res = record(args.outdir, args.steps, args.leg, args.seed,
                     args.case, args.device,
                     json.loads(args.conf) if args.conf else None,
                     args.keep_restart)
        print(json.dumps(res["meta"]))
        return 0
    if args.cmd == "summary":
        with open(os.path.join(args.dir, "record.json")) as f:
            print("\n".join(summary(json.load(f))))
        return 0
    if args.cmd == "replay":
        print(json.dumps(replay(args.dir)))
        return 0
    if len(args.paths) < 2:
        raise SystemExit("compare: two recordings at least")
    res = compare(args.paths, args.steps, args.exact, args.hold)
    if args.means:
        res["column_means"] = {p: column_means(p, steps=parse_steps(
            args.means)) for p in args.paths}
    for p in res["pairs"]:
        print("%s vs %s: %s" % (p["a"], p["b"], " ".join(
            "%s %.3g" % kv for kv in p["mean"].items())))
    if "hold" in res:
        print("hold: %s" % json.dumps(res["hold"]))
    for f in res["failures"]:
        print("FAILED: %s" % f)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
