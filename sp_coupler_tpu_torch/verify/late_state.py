"""The LES state of a coupled run where it rains, cut from a checkpoint,
and a raining, deep-cloud state built by construction.

Deep convection reaches code paths the start of a run does not: rain and
its sedimentation, tall clouds, large w, a short adaptive dt. Two inputs
of such a state, for holding the port against the JAX package there
(``tests/late_state_parity.py`` on the CPU, ``tests/test_torch_late_state.py``)
and the stage kernel against its plain version (``chip_smoke.py``):

``raining_state(nx, ny, nz, n, seed)``
    numpy arrays of an LES state and its forcing, made from a seed: a
    saturated layer from 0.5 to 3 km, rain water up to 1e-3 below 3 km,
    divergence-free drafts of up to ~3 m/s, e12 varying by point, over a
    hydrostatic base state.

``python -m sp_coupler_tpu_torch.verify.late_state cut RECDIR --step N
--out PATH``
    from ``golden record --keep-joins``'s copy of the join after step N in
    RECDIR (the recording and the checkpoint as they stood then; it may
    run while the recording goes on): resumes the run in this process
    (the case's flags, its seed and --conf keys from golden_run.json) and
    runs the overlap step, step N + 1, capturing the input of every
    instance's adaptive evolve, the dts it took and the SP tendencies
    handed to the GCM. The instance with the largest LES ql (the mean over
    its levels of the slab-mean ql) is cut: its LESState and forcing for
    step N + 1, the dt its loop took first there (the adaptive dt of that
    state), every dt of the step, its substeps and end profiles on the
    device, with the GCM state of the checkpoint, the step's tendencies of
    every column (the captured ones, and those the recording holds for
    that step) and the run's settings, into one deflated npz (17-18 MB at
    64x64x160). Without --device it takes the card.

``pick_step(summary)``
    the join to cut from an ensemble's ``golden compare --summary``: the
    join nearest the steps where the broken holds part most, 50 when every
    hold holds.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from . import golden

JOINS = (25, 50, 75)
STATE_FIELDS = ("u", "v", "w", "thl", "qt", "qr", "e12", "ps", "pbf", "pbh",
                "rhobf", "rhobh", "rain", "ustar", "time")
FORCING_FIELDS = ("f_u", "f_v", "f_thl", "f_qt", "f_ql", "f_ps", "ql_ref",
                  "wthl", "wqt", "z0m", "z0h")
# RICO's surface pressure (Pa)
PS = 101540.0


# ---- by construction --------------------------------------------------------

def _exner(p):
    from .. import constants as c
    return (p / c.pref0) ** (c.rd / c.cp)


def _qsat(T, p):
    from .. import constants as c
    es = np.minimum(c.es0 * np.exp(c.at_liq * (T - c.tmelt)
                                   / (T - c.bt_liq)), 0.9 * p)
    return (c.rd / c.rv) * es / (p - (1.0 - c.rd / c.rv) * es)


def hydrostatic(thl0, qt0, ps, dz):
    """(pbf, pbh, rhobf, rhobh) of the profiles thl0, qt0 [n, nz] over ps
    [n], in float64: the anelastic base state's formula (models/les/
    state.py::base_state)."""
    from .. import constants as c
    thv0 = thl0 * (1.0 + c.eps_i * qt0)
    thvh = np.concatenate([thv0[:, :1], 0.5 * (thv0[:, 1:] + thv0[:, :-1]),
                           thv0[:, -1:]], axis=1)
    incr = c.grav * dz / (c.cp * thv0)
    pih = _exner(ps)[:, None] - np.concatenate(
        [np.zeros_like(ps)[:, None], np.cumsum(incr, axis=1)], axis=1)
    pif = pih[:, :-1] - 0.5 * incr
    pbf = c.pref0 * pif ** (c.cp / c.rd)
    pbh = c.pref0 * pih ** (c.cp / c.rd)
    return pbf, pbh, pbf / (c.rd * thv0 * pif), pbh / (c.rd * thvh * pih)


def raining_state(nx, ny, nz, n, seed, dz=25.0, dx=200.0, dy=200.0):
    """(state, forcing): dicts of float32 numpy arrays, fields [n, nz(+1),
    ny, nx], profiles [n, nz(+1)], scalars [n], in the LESState and
    LESForcing field order. By construction from the seed:

    - thl rising 3 K/km from 297 K, +-0.1 K at every point; instance i
      0.05 i K warmer;
    - qt 1.1 x the saturation humidity of thl x Exner from 0.5 to 3 km (a
      cloud of a few 1e-4 kg/kg liquid water) and 0.7 x it elsewhere,
      +-2.5e-5;
    - qr uniform in [0, 1e-3] below 3 km, 0 above;
    - e12 uniform in [0.05, 0.6] m/s at every point;
    - the winds anelastic-divergence-free, as a run's are after each
      projection: updrafts and downdrafts of up to ~3 m/s in every column
      (w from two streamfunctions A(z) R(x, y), A rising as sin(pi z /
      3.5 km) to 160 kg/m/s and 0 above 3.5 km, R uniform in +-1 a
      column), their return flow in u and v, and horizontal eddies of ~1
      m/s (a streamfunction uniform in +-100 m^2/s at every point) on u =
      -8 + 2 m/s per km and v = -1 m/s;
    - the hydrostatic base state of the thl and qt profiles over 101540 Pa.

    The forcing: -2.5e-5 K/s radiative cooling, -1e-8 /s drying, the winds
    pushed by +-1e-5 m/s^2, surface fluxes of 0.01 K m/s and 5e-5 m/s, z0
    2e-4 m."""
    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) * dz
    zh = np.arange(nz + 1) * dz
    thl0 = (297.0 + 3e-3 * z)[None] + 0.05 * np.arange(n)[:, None]
    ps = np.full(n, PS)
    # the saturation humidity of the dry profile on its own pressures
    pbf0 = hydrostatic(thl0, np.full((n, nz), 0.01), ps, dz)[0]
    qs = _qsat(thl0 * _exner(pbf0), pbf0)
    cloud = (z >= 500.0) & (z <= 3000.0)
    qt0 = np.where(cloud, 1.1, 0.7)[None] * qs
    pbf, pbh, rhobf, rhobh = hydrostatic(thl0, qt0, ps, dz)
    shp = (n, nz, ny, nx)
    col = lambda p: p[:, :, None, None]
    unif = lambda a, b, s=shp: rng.uniform(a, b, s)
    # streamfunctions at the cell corners: psi_x, psi_y at (z-face, x- or
    # y-face), chi at (y-face, x-face); u[i] sits on cell i's west face,
    # so each discrete divergence (advect.divergence) cancels exactly
    amp = np.where(zh <= 3500.0, 160.0 * np.sin(np.pi * zh / 3500.0), 0.0)
    px = amp[None, :, None, None] * unif(-1.0, 1.0, (n, 1, ny, nx))
    py = amp[None, :, None, None] * unif(-1.0, 1.0, (n, 1, ny, nx))
    chi = unif(-100.0, 100.0)
    up = lambda a, ax: np.roll(a, -1, ax)
    rf, rh = col(rhobf), col(rhobh)
    u = (col(np.broadcast_to(-8.0 + 2e-3 * z, (n, nz)))
         - (up(chi, 2) - chi) / dy - (px[:, 1:] - px[:, :-1]) / (dz * rf))
    v = (-1.0 + (up(chi, 3) - chi) / dx
         - (py[:, 1:] - py[:, :-1]) / (dz * rf))
    w = ((up(px, 3) - px) / dx + (up(py, 2) - py) / dy) / rh
    qr = np.where((z < 3000.0)[None, :, None, None], unif(0.0, 1e-3), 0.0)
    state = dict(
        u=u, v=v, w=w, thl=col(thl0) + unif(-0.1, 0.1),
        qt=np.maximum(col(qt0) + unif(-2.5e-5, 2.5e-5), 0.0),
        qr=qr, e12=unif(0.05, 0.6), ps=ps, pbf=pbf, pbh=pbh, rhobf=rhobf,
        rhobh=rhobh, rain=np.zeros(n), ustar=np.full(n, 0.3),
        time=np.zeros(n))
    prof = lambda v: np.full((n, nz), v)
    scal = lambda v: np.full(n, v)
    forcing = dict(f_u=prof(1e-5), f_v=prof(-1e-5), f_thl=prof(-2.5e-5),
                   f_qt=prof(-1e-8), f_ql=prof(0.0), f_ps=scal(0.0),
                   ql_ref=prof(0.0), wthl=scal(0.01), wqt=scal(5e-5),
                   z0m=scal(2e-4), z0h=scal(2e-4))
    f32 = lambda d: {k: np.ascontiguousarray(v, np.float32)
                     for k, v in d.items()}
    return f32(state), f32(forcing)


def adaptive_dt(grid, state, dt_max=15.0, cfl=0.7, dt_min=0.2, peclet=0.1):
    """The dt ``evolve_adaptive`` takes first from state (an LESState of
    float32 tensors), per instance, before it is cut to the step's end."""
    from ..models.les import step as lstep
    kmax = lstep.start_kmax(grid, state)
    return lstep.stable_dt(grid, state, kmax, cfl, peclet).clamp(dt_min,
                                                                 dt_max)


# ---- from a run -------------------------------------------------------------

def pick_step(summary):
    """The join (JOINS) nearest the step where the holds of an ensemble's
    digest (``golden.digest``) part most; 50 when every hold holds. A
    broken distance hold parts most at the step of its window where the
    members' median distance to the reference over the largest distance
    between two members is largest; a broken climate hold at its window's
    middle."""
    worst = None
    for w in summary.get("windows", []):
        for v, h in w.get("hold", {}).items():     # none: not covered
            if h["ok"]:
                continue
            ref = [p for p in summary["pairs"] if p["i"] == 0]
            mem = [p for p in summary["pairs"] if p["i"] >= 1]
            steps = np.asarray(ref[0]["steps"])
            m = (steps >= w["steps"][0]) & (steps <= w["steps"][1])
            d = np.median([np.asarray(p["series"][v])[m] for p in ref], 0)
            s = np.max([np.asarray(p["series"][v])[m] for p in mem], 0)
            k = int(np.argmax(d / np.maximum(s, 1e-30)))
            ratio = float(d[k] / max(s[k], 1e-30))
            if worst is None or ratio > worst[0]:
                worst = (ratio, int(steps[m][k]))
    for c in summary.get("climate", []):
        if c["held"] and not all(h["ok"] for h in c.get("hold",
                                                        {}).values()):
            mid = 0.5 * (c["steps"][0] + c["steps"][1])
            worst = worst or (0.0, mid)
    if worst is None:
        return 50
    return min(JOINS, key=lambda j: (abs(j - worst[1]), j != 50))


def _np(t):
    return t.detach().cpu().numpy()


def cut(recdir, step, out, device=None):
    """Cut the raining instance of the run recorded in recdir at the join
    after step (see the module's docstring) into the npz out; returns
    its metadata."""
    import torch
    from .. import card_line, spmaster
    from ..io import restart
    from ..models.les import diag as ldiag, step as lstep
    recdir = os.path.abspath(recdir)
    with open(os.path.join(recdir, golden.RUN_JSON)) as f:
        meta = json.load(f)
    work = tempfile.mkdtemp(prefix="late_state_")
    evolves, calls, tends = [], [], []
    orig_evolve, orig_substep = lstep.evolve_adaptive, lstep.substep

    def evolve(grid, phys, state, forcing, t_end, **kw):
        rec = dict(grid=grid, phys=phys, state=state, forcing=forcing,
                   t_end=t_end, kw=kw, dts=[])
        calls.append(rec["dts"])
        out_ = orig_evolve(grid, phys, state, forcing, t_end, **kw)
        rec.update(out=out_[0], n=out_[1], clamped=out_[2])
        evolves.append(rec)
        return out_

    def substep(grid, phys, state, forcing, dt, **kw):
        calls[-1].append(dt.clone())
        return orig_substep(grid, phys, state, forcing, dt, **kw)

    try:
        joined = golden.join_paths(recdir, step)
        for src, name in zip(joined, ("spifs.nc", "restart.npz",
                                      "restart.json")):
            shutil.copyfile(src, os.path.join(work, name))
        conf_path = os.path.join(work, "conf.json")
        with open(conf_path, "w") as f:
            json.dump(meta["conf"], f)
        argv = golden.leg_argv(meta["case"], 1, work, conf_path, 1, device)
        runner = spmaster.build_runner(argv)
        runner.initialize()
        core = runner.coupled.core
        orig_tend = core.with_sp_tendencies

        def with_sp_tendencies(state, cols, tend):
            tends.append((cols, tend))
            return orig_tend(state, cols, tend)

        core.with_sp_tendencies = with_sp_tendencies
        lstep.evolve_adaptive, lstep.substep = evolve, substep
        try:
            runner.step()
        finally:
            lstep.evolve_adaptive, lstep.substep = orig_evolve, orig_substep
            del core.with_sp_tendencies
        runner.finalize(save_restart=False)
        # one evolve an instance (serial pacing) or one for the fleet
        inst = [(e, j) for e in evolves for j in range(e["n"].shape[0])]
        if len(inst) != runner.coupled.n or len(tends) != 1:
            raise RuntimeError("the step evolved %d instances (want %d) and "
                               "handed over %d tendencies" % (
                                   len(inst), runner.coupled.n, len(tends)))
        grid = evolves[0]["grid"]
        ql = np.concatenate([_np(ldiag.slab_profiles(grid, e["state"])["QL"]
                                 .mean(dim=1)) for e in evolves])
        subs = np.concatenate([_np(e["n"]) for e in evolves])
        i = int(np.argmax(ql))
        e, j = inst[i]
        one = lambda t: t[j:j + 1]
        # every dt of the instance's loop where it ran alone; its first
        # where the fleet stepped together
        dts_i = e["dts"] if e["n"].shape[0] == 1 else e["dts"][:1]
        cols, tend = tends[0]
        cols = _np(torch.as_tensor(cols))
        times, groups = golden.read_recording(joined[0], golden.TENDENCIES)
        k = int(np.flatnonzero(np.rint(times / times[0]) == step + 1)[0])
        recorded = {v: np.stack([groups[int(c)][v][k] for c in
                                 sorted(groups)]) for v in golden.TENDENCIES}
        # the checkpoint's columns are in sp_cols order; the recording's
        # groups in column order
        order = np.argsort(np.asarray(runner.sp_cols))
        card = card_line(torch.device(device or "cuda")) if (
            device is None or str(device).startswith("cuda")) else str(device)
        info = dict(
            recording=recdir, step=step, seed=meta["seed"], instance=i,
            column=int(runner.sp_cols[i]), card=card,
            ql_mean=ql.tolist(), substeps=subs.tolist(),
            most_substeps=int(np.argmax(subs)),
            grid=dict(nx=grid.nx, ny=grid.ny, nz=grid.nz, dx=grid.dx,
                      dy=grid.dy, dz=grid.dz),
            phys=dict(e["phys"]._asdict(), mphys=e["phys"].mphys._asdict()),
            evolve=e["kw"],
            gcm={k: v._asdict() if hasattr(v, "_asdict") else v
                 for k, v in core.cfg.__dict__.items()},
            sp_cols=[int(c) for c in runner.sp_cols],
            tend_equals_recorded={v: bool(np.array_equal(
                _np(tend[v[2:]])[order], recorded[v])) for v in recorded})
        arrays = {"les_" + k: _np(one(getattr(e["state"], k))) for k in
                  STATE_FIELDS}
        arrays.update({"frc_" + k: _np(one(getattr(e["forcing"], k)))
                       for k in FORCING_FIELDS})
        card_prof = ldiag.slab_profiles(grid, e["out"].index(slice(j, j + 1)))
        arrays.update({"card_" + k: _np(card_prof[k]) for k in
                       ("U", "V", "THL", "QT", "QL", "QR", "T")})
        arrays.update(
            t_end=_np(one(e["t_end"])), n_substeps=_np(one(e["n"])),
            dts=np.asarray([_np(one(d)) for d in dts_i],
                           np.float32).reshape(-1),
            cols=cols.astype(np.int64),
            **{"tend_" + v: _np(tend[v]) for v in tend},
            **{"recorded_" + v: recorded[v] for v in recorded})
        with restart.NpzReader(os.path.join(work, "restart.npz")) as data:
            for key in data.files:
                if key.startswith("gcm_"):
                    arrays[key] = data.get(key)
        info["dt_first"] = float(arrays["dts"][0])
        arrays["info"] = np.asarray(json.dumps(info))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(out, **arrays)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return info


def load(path):
    """(arrays, info) of a cut npz."""
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files if k != "info"}
        info = json.loads(str(d["info"]))
    return arrays, info


def les_physics(info):
    """The LESPhysics of a cut's run."""
    from ..models.les import micro, step as lstep
    phys = dict(info["phys"])
    return lstep.LESPhysics(**dict(phys, mphys=micro.MicroParams(
        **phys["mphys"])))


def les_inputs(arrays, device):
    """(LESState, LESForcing) of a cut's instance on device."""
    import torch
    from ..models.les.state import LESForcing, LESState
    t = lambda k: torch.as_tensor(arrays[k], device=device)
    return (LESState(*[t("les_" + k) for k in LESState._fields]),
            LESForcing(*[t("frc_" + k) for k in LESForcing._fields]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cut", help="cut the raining instance of a join")
    c.add_argument("recdir")
    c.add_argument("--step", type=int, default=None,
                   help="the join (default: pick_step of --summary)")
    c.add_argument("--summary", default=None,
                   help="an ensemble's golden compare --summary")
    c.add_argument("--out", required=True)
    c.add_argument("--device", default=None)
    args = p.parse_args(argv)
    step = args.step
    if step is None:
        with open(args.summary) as f:
            step = pick_step(json.load(f))
    info = cut(args.recdir, step, args.out, args.device)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
