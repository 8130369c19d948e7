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
    are the torch device's), golden_run.json (the case, seed and --conf
    keys, after the first leg) and record.json (every leg's step walls,
    substeps, clamped dts, launches and memory peaks), and removes the
    last checkpoint unless --keep-restart. --keep-joins copies the
    recording and the checkpoint of every join (the end of each leg but
    the last) to joins/spifs_stepN.nc, restart_stepN.npz and .json before
    the next leg writes on.
    Without --device the legs take the CUDA card, and fail where there is
    none.
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
    for bit.
    Against an ensemble (A the reference, B, C, ... its members, seeds of
    one case): ``--windows 1:10,11:50,51:100`` holds, in each window and
    for each of HOLD_VARS, the median of the members' mean distances to A
    within HOLD_FACTOR x the largest mean distance between two members;
    ``--climate 51:100`` holds, for each of REPORT_VARS, A's mean over
    the window's records, the columns and the levels within [lo - r, hi +
    r], lo and hi the members' smallest and largest, r = hi - lo, and
    reports the levels where A's mean profile leaves that envelope (the
    same numbers, not held, for the other windows); both report each
    recording's largest |tendency| and where it lies. A window is held
    only where every recording holds each of its steps: one that a
    recording does not cover fails, with the step where each recording
    ends, and its numbers over the steps all recordings hold are reported
    as ``partial``, not held. ``--json PATH`` writes the result,
    ``--summary PATH`` a small digest of it (every pair's distance
    series, the held window's mean profiles, the holds' verdicts, the
    tendency scales).

``shrink DIR OUT.npz``
    what ``compare`` reads of a recording (Time; REPORT_VARS and
    TENDENCIES of every column), 2.0-2.7 MB of config 2's ~23 MB, which every
    subcommand that reads a recording takes in its place.

``ensemble OUTROOT --seeds 42,43,44,45 [--timeout S]``
    ``record`` of each seed at once, one process a seed, on the card the
    processes see (one card a seed: one ``ensemble`` a seed, each under its
    own ``CUDA_VISIBLE_DEVICES``), into OUTROOT/seedS; the other
    ``record`` flags are passed on (``--keep-joins S,...``: only those
    seeds keep their joins). A seed still running --timeout s after the
    start is stopped with the processes it started, its recording keeping
    the records written; then each recording is shrunk to
    OUTROOT/seedS.npz.
"""

import argparse
import json
import math
import os
import shutil
import signal
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
# 1-10N x 58-47W: 4 of POLY's columns (950, 951, 1014, 1015)
POLY_JOIN = ["10", "-58", "1", "-58", "1", "-47", "10", "-47"]
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
    # config 2's deck on 4 of its columns: chip_smoke.py's restart join
    "config2_join": dict(
        name="T21 + 4 of config 2's SP columns", poly=POLY_JOIN,
        argv=["--poly", *POLY_JOIN, "--numles", "4", "--gcmexp", "TEST",
              "--cplsurf"],
        conf={"output_compress": 4}),
}
TENDENCIES = ("f_U", "f_V", "f_T", "f_SH", "f_QL", "f_QI", "f_A")
REPLAY_TOL = 1e-5        # of each tendency's scale (tests/test_golden.py)
# the GCM-side profiles and the LES slab means verify/parity.py enforces
HOLD_VARS = ("T", "SH", "U", "V", "thl", "qt")
REPORT_VARS = ("T", "SH", "U", "V", "QL", "A", "thl", "qt", "ql")
# the ensemble holds' factor and windows (steps, both ends included)
HOLD_FACTOR = 2.0
WINDOWS = ((1, 10), (11, 50), (51, 100))
CLIMATE = (51, 100)
LEG_TIMEOUT = 3600       # s a leg
RUN_JSON = "golden_run.json"   # record's case, seed and --conf keys


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
           conf=None, keep_restart=False, timeout=LEG_TIMEOUT,
           keep_joins=False):
    """Record case for steps coupled steps (records 0..steps, steps + 1
    of them) in legs of leg steps into outdir. conf: more --conf keys
    (a dict). keep_joins: keep a copy of each join's checkpoint
    (``join_paths``). Returns record.json's contents."""
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
    conf = dict(spec["conf"], seed=seed, **(conf or {}))
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    on_card = device is None or str(device).startswith("cuda")
    spifs_path = os.path.join(outdir, "spifs.nc")
    legs, done, t_all = [], 0, time.time()
    try:
        for k, n in enumerate(plan):
            argv = leg_argv(case, n, outdir, conf_path, k, device)
            log_path = os.path.join(work, "leg%d.log" % k)
            wall, summary = run_leg(k, argv, log_path, timeout)
            done += n
            if not k:   # spmaster makes outdir
                with open(os.path.join(outdir, RUN_JSON), "w") as f:
                    json.dump(dict(case=case, seed=seed, conf=conf), f)
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
            if keep_joins and k < len(plan) - 1:
                # the .json last, each whole when it appears
                for src, dst in zip([spifs_path] + restart_paths(outdir),
                                    join_paths(outdir, done)):
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copyfile(src, dst + ".part")
                    os.replace(dst + ".part", dst)
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
        for path in restart_paths(outdir):
            os.remove(path)
    return out


def restart_paths(outdir):
    """restart.npz and restart.json of a run's directory."""
    return [os.path.join(outdir, "restart." + x) for x in ("npz", "json")]


def join_paths(outdir, step):
    """Where ``record --keep-joins`` keeps the join after step: the
    recording as it stood then, the checkpoint's .npz and .json."""
    d = os.path.join(outdir, "joins")
    return [os.path.join(d, "spifs_step%d.nc" % step)] + [
        os.path.join(d, "restart_step%d.%s" % (step, x))
        for x in ("npz", "json")]


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
    directory holding one) or of ``shrink``'s .npz, every variable or
    those given."""
    from ..io import spifs
    if path.endswith(".npz"):
        with np.load(path) as d:
            groups = {}
            for key in d.files:
                if ":" in key:
                    col, var = key.split(":")
                    if variables is None or var in variables:
                        groups.setdefault(int(col), {})[var] = d[key]
            return np.asarray(d["Time"], np.float64), groups
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


def shrink(path, out):
    """Write what ``compare`` reads of a recording (Time and, of every
    column, REPORT_VARS and TENDENCIES) into the .npz out, which
    ``read_recording`` reads as it reads the recording."""
    times, groups = read_recording(path, REPORT_VARS + TENDENCIES)
    np.savez_compressed(out, Time=times, **{
        "%d:%s" % (c, v): a for c, g in groups.items() for v, a in g.items()})


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


def in_window(paths, pair, steps, keep=None):
    """A pair's distances (i, j, the matched Time values, {var: series})
    cut to the steps (a, b), or all of them, and to the Time values keep
    where given: the steps, each variable's series and its mean."""
    i, j, times, d = pair
    m = window(times, steps) if steps else np.ones(len(times), bool)
    if keep is not None:
        m &= np.isin(times, keep)
    if not m.any():
        raise AssertionError("%s and %s share no record in steps %s"
                             % (paths[i], paths[j], steps))
    return dict(a=paths[i], b=paths[j], i=i, j=j,
                steps=np.rint(times[m] / times[0]).astype(int).tolist(),
                mean={v: float(np.mean(np.asarray(x)[m]))
                      for v, x in d.items()},
                series={v: np.asarray(x)[m].tolist() for v, x in d.items()})


def compare(paths, steps=None, exact=False, windows=(), climate=None):
    """Every pair's distances (``distances``, of REPORT_VARS), each
    variable's mean over the steps, and the ensemble's holds asked for:
    windows, the distance hold in each window (``seed_hold``); climate,
    the climate hold over those steps (``climate_hold``), with the
    climate of every other window reported and each recording's tendency
    scales. A window that a recording does not cover whole is not held
    (``coverage``): it fails, and its numbers over the steps every
    recording holds go to "partial". What failed in "failures"."""
    recs = [read_recording(p) for p in paths]
    full = [(i, j) + distances(recs[i], recs[j])
            for i in range(len(paths)) for j in range(i + 1, len(paths))]
    pairs = [in_window(paths, f, steps) for f in full]
    res = dict(paths=list(paths), steps=steps, pairs=pairs, failures=[])
    if exact:
        res["exact"] = {"%s|%s" % (p["a"], p["b"]): exact_diffs(
            recs[p["i"]], recs[p["j"]])[:20] for p in pairs}
        res["failures"] += ["records differ: %s %s" % kv
                            for kv in res["exact"].items() if kv[1]]
    if (windows or climate) and len(paths) < 3:
        raise ValueError("--windows, --climate: the reference and at least "
                         "two members")
    # the records at the Time values every recording holds: all of a
    # covered window's, those of a partial window that all reached
    common = recs[0][0]
    for t, _ in recs[1:]:
        common = np.intersect1d(common, t)
    used = lambda w: np.rint(common[window(common, w)] / common[0]).astype(
        int).tolist()

    def verdict(w, what, h):
        """The window's entry: its hold where every recording covers it,
        else its numbers as partial and a failure."""
        cov = coverage(recs, w)
        out = dict(steps=list(w), steps_used=used(w), covered=not cov)
        if cov:
            out["partial"] = h
            out["ends"] = {name(paths[i]): e for i, e in cov.items()}
            res["failures"].append(
                "steps %d-%d: not covered, no %s hold (%s)" % (
                    w[0], w[1], what, ", ".join(
                        "%s ends at step %d" % (name(paths[i]), e)
                        for i, e in sorted(cov.items()))))
        else:
            out["hold"] = h
            res["failures"] += ["steps %d-%d: %s hold broken for %s"
                                % (w[0], w[1], what, v)
                                for v in h if not h[v]["ok"]]
        return out

    res["windows"] = [verdict(w, "distance", seed_hold(
        [in_window(paths, f, w, common) for f in full], HOLD_FACTOR))
                      for w in windows]
    if climate:
        res["climate"] = []
        for w in [climate] + [w for w in windows if tuple(w) !=
                              tuple(climate)]:
            means = [profile_means(r, steps=w, keep=common) for r in recs]
            h = climate_hold(means[0], means[1:])
            if tuple(w) == tuple(climate):
                c = dict(verdict(w, "climate", h), held=True)
            else:
                c = dict(steps=list(w), steps_used=used(w),
                         covered=not coverage(recs, w), held=False, hold=h)
            res["climate"].append(dict(c, profiles=means))
        res["tendency_scales"] = [tendency_scales(r) for r in recs]
    return res


def coverage(recs, steps):
    """{index: its last step} of the recordings (``read_recording``'s
    pairs) that lack a step of steps = (a, b), both included; empty where
    every recording holds each of them. A record's step is Time / the
    first record's Time."""
    want = np.arange(steps[0], steps[1] + 1)
    out = {}
    for i, (times, _) in enumerate(recs):
        k = np.rint(times / times[0]).astype(int)
        if not np.isin(want, k).all():
            out[i] = int(k.max())
    return out


def name(path):
    """A recording's name in reports: its directory's or file's stem."""
    return os.path.splitext(os.path.basename(os.path.normpath(path)))[0]


def check(res):
    """Raise AssertionError on compare's failures; return res."""
    if res["failures"]:
        raise AssertionError("; ".join(res["failures"]))
    return res


def seed_hold(pairs, factor):
    """For each of HOLD_VARS: the median of the members' (recordings 1, 2,
    ...) mean distances from the reference (recording 0) against factor x
    the largest mean distance between two members (the seed spread)."""
    spread = [p for p in pairs if p["i"] >= 1]
    ref = [p for p in pairs if p["i"] == 0]
    out = {}
    for v in HOLD_VARS:
        if v not in ref[0]["mean"]:
            continue
        d = [p["mean"][v] for p in ref]
        subject = float(np.median(d))
        widest = max(p["mean"][v] for p in spread)
        out[v] = dict(d_ref=subject, seed_spread=widest,
                      factor=factor, ratio=subject / widest
                      if widest > 0 else math.inf,
                      ok=bool(subject <= factor * widest), d_members=d)
    return out


def climate_hold(ref, members):
    """For each variable of the profile means ref (the reference's) and
    members (a list of them), level means: the reference's against the
    envelope [lo - r, hi + r] of the members' (lo, hi their smallest and
    largest, r = hi - lo), and the levels where the reference's profile
    leaves the same envelope taken level by level."""
    out = {}
    for v in ref:
        if not all(v in m for m in members):
            continue
        prof = np.asarray(ref[v], np.float64)
        mem = np.asarray([m[v] for m in members], np.float64)
        vals = mem.mean(axis=1)
        lo, hi = float(vals.min()), float(vals.max())
        r = hi - lo
        lo_k, hi_k = mem.min(axis=0), mem.max(axis=0)
        r_k = hi_k - lo_k
        out[v] = dict(ref=float(prof.mean()), members=vals.tolist(), lo=lo,
                      hi=hi, r=r,
                      ok=bool(lo - r <= prof.mean() <= hi + r),
                      levels=len(prof),
                      levels_outside=np.flatnonzero(
                          (prof < lo_k - r_k) | (prof > hi_k + r_k)).tolist())
    return out


def tendency_scales(rec):
    """For each of TENDENCIES in a recording (``read_recording``'s pair):
    its largest |value| over the run and the column, step and level where
    it lies (a record's step as ``window`` counts it)."""
    times, groups = rec
    out = {}
    for v in TENDENCIES:
        cols = [c for c in sorted(groups) if v in groups[c]
                and groups[c][v].size]
        if not cols:
            continue
        a = np.abs(np.stack([groups[c][v] for c in cols]).astype(np.float64))
        c, k, lev = np.unravel_index(int(np.argmax(a)), a.shape)
        out[v] = dict(max=float(a[c, k, lev]), column=cols[c],
                      step=int(np.rint(times[k] / times[0])), level=int(lev))
    return out


def profile_means(rec, variables=REPORT_VARS, steps=CLIMATE, keep=None):
    """{var: the profile averaged over the columns and the records of the
    steps (both included; those at the Time values keep, where given)} of
    a recording (``read_recording``'s pair)."""
    times, groups = rec
    m = window(times, steps)
    if keep is not None:
        m &= np.isin(times, keep)
    return {v: np.mean([groups[c][v][m] for c in groups
                        if v in groups[c]], axis=(0, 1)).tolist()
            for v in variables if all(v in g for g in groups.values())}


def column_means(path, variables=REPORT_VARS, steps=CLIMATE):
    """``profile_means`` of the recording at path."""
    return profile_means(read_recording(path, variables), variables, steps)


def rounded(x, digits=6):
    """x (nested dicts, lists, numbers) with every float to digits
    significant digits."""
    if isinstance(x, dict):
        return {k: rounded(v, digits) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [rounded(v, digits) for v in x]
    if isinstance(x, float) and math.isfinite(x):
        return float("%.*g" % (digits, x))
    return x


def digest(res):
    """The small record of an ensemble ``compare``: the recordings, every
    pair's distance series over all matched steps, the windows' distance
    holds, the climate holds with the held window's mean profiles of each
    recording, the tendency scales and the failures."""
    out = dict(paths=[name(p) for p in res["paths"]],
               hold_factor=HOLD_FACTOR,
               pairs=[dict(i=p["i"], j=p["j"], steps=p["steps"],
                           series=p["series"]) for p in res["pairs"]],
               windows=res.get("windows", []),
               failures=res["failures"])
    if "climate" in res:
        out["climate"] = [{k: v for k, v in c.items() if k != "profiles"}
                          for c in res["climate"]]
        out["profiles"] = dict(steps=res["climate"][0]["steps"],
                               steps_used=res["climate"][0]["steps_used"],
                               means=res["climate"][0]["profiles"])
        out["tendency_scales"] = res["tendency_scales"]
    return rounded(out)


def write_digest(res, path):
    """``digest(res)`` as JSON at path."""
    with open(path, "w") as f:
        json.dump(digest(res), f, indent=None, separators=(",", ":"))
        f.write("\n")


# ---- CLI ------------------------------------------------------------------

def parse_steps(text):
    a, b = text.split(":")
    return int(a), int(b)


def parse_windows(text):
    return [parse_steps(w) for w in text.split(",")]


def ensemble(outroot, seeds, args=(), keep_joins=(), timeout=None):
    """``record`` of each seed at once, one process a seed (and its own
    process group), into outroot/seedS (its log outroot/seedS.log); args:
    more ``record`` flags. A seed still running timeout s after the start
    is stopped, its legs with it. Then each recording is shrunk to
    outroot/seedS.npz. Returns {seed: exit code} (-9: stopped)."""
    os.makedirs(outroot, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    deadline = None if timeout is None else time.time() + timeout
    procs = {}
    for seed in seeds:
        cmd = [sys.executable, "-m", "sp_coupler_tpu_torch.verify.golden",
               "record", os.path.join(outroot, "seed%d" % seed), "--seed",
               str(seed), *args] + (["--keep-joins"] if seed in keep_joins
                                    else [])
        log = open(os.path.join(outroot, "seed%d.log" % seed), "w")
        procs[seed] = (subprocess.Popen(
            cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True), log)
    codes = {}
    for seed, (proc, log) in procs.items():
        try:
            codes[seed] = proc.wait(None if deadline is None
                                    else max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            codes[seed] = proc.wait()
        log.close()
    for seed in seeds:
        rec = os.path.join(outroot, "seed%d" % seed, "spifs.nc")
        if os.path.exists(rec):
            shrink(rec, os.path.join(outroot, "seed%d.npz" % seed))
    return codes


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
    r.add_argument("--keep-joins", action="store_true",
                   help="keep each join's checkpoint in joins/")
    e = sub.add_parser("ensemble", help="record several seeds at once")
    e.add_argument("outroot")
    e.add_argument("--seeds", default="42,43,44,45")
    e.add_argument("--timeout", type=float, default=None,
                   help="s: a seed still running then is stopped")
    e.add_argument("--keep-joins", default="",
                   help="the seeds whose joins are kept, e.g. 42")
    k = sub.add_parser("shrink", help="what compare reads, as an .npz")
    k.add_argument("path")
    k.add_argument("out")
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
    c.add_argument("--means", default=None, metavar="a:b",
                   help="also each recording's column means over steps")
    c.add_argument("--windows", type=parse_windows, default=(),
                   help="a:b,c:d,...: the ensemble's distance hold in each")
    c.add_argument("--climate", type=parse_steps, default=None,
                   help="a:b: the ensemble's climate hold over these steps")
    c.add_argument("--json", default=None, help="write the result here")
    c.add_argument("--summary", default=None,
                   help="write the result's digest here")
    return p


def main(argv=None):
    args, rest = parser().parse_known_args(argv)
    if args.cmd == "ensemble":
        seeds = [int(x) for x in args.seeds.split(",")]
        keep = [int(x) for x in args.keep_joins.split(",") if x]
        codes = ensemble(args.outroot, seeds, rest, keep, args.timeout)
        print("golden ensemble: exit codes %s" % json.dumps(codes))
        return 0 if not any(codes.values()) else 1
    if rest:
        raise SystemExit("unrecognized arguments: %s" % " ".join(rest))
    if args.cmd == "record":
        res = record(args.outdir, args.steps, args.leg, args.seed,
                     args.case, args.device,
                     json.loads(args.conf) if args.conf else None,
                     args.keep_restart, keep_joins=args.keep_joins)
        print(json.dumps(res["meta"]))
        return 0
    if args.cmd == "shrink":
        shrink(args.path, args.out)
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
    res = compare(args.paths, args.steps, args.exact, args.windows,
                  args.climate)
    if args.means:
        res["column_means"] = {p: column_means(p, steps=parse_steps(
            args.means)) for p in args.paths}
    for p in res["pairs"]:
        print("%s vs %s: %s" % (p["a"], p["b"], " ".join(
            "%s %.3g" % kv for kv in p["mean"].items())))
    for w in res["windows"]:
        print("steps %d-%d, distance hold%s: %s" % (
            *w["steps"], "" if w["covered"] else
            " NOT COVERED (steps %d-%d partial)" % (w["steps_used"][0],
                                                    w["steps_used"][-1]),
            " ".join("%s %.3g/%.3g %s" % (v, h["d_ref"], h["seed_spread"],
                                          "ok" if h["ok"] else "BROKEN")
                     for v, h in w.get("hold", w.get("partial")).items())))
    for c in res.get("climate", []):
        print("steps %d-%d, climate (%s): %s" % (
            *c["steps"], ("held" if c["covered"] else "NOT COVERED, "
                          "partial") if c["held"] else "reported", " ".join(
                "%s %.4g in [%.4g, %.4g] %s" % (
                    v, h["ref"], h["lo"] - h["r"], h["hi"] + h["r"],
                    "ok" if h["ok"] else "OUTSIDE")
                for v, h in c.get("hold", c.get("partial")).items())))
    for path, t in zip(res["paths"], res.get("tendency_scales", [])):
        print("%s tendency scales: %s" % (path, " ".join(
            "%s %.3g (column %d, step %d, level %d)" % (
                v, x["max"], x["column"], x["step"], x["level"])
            for v, x in t.items())))
    if args.summary:
        write_digest(res, args.summary)
    for f in res["failures"]:
        print("FAILED: %s" % f)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1, default=str)
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
