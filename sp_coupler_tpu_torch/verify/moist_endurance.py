"""Moist production-physics endurance run.

Port of ``scripts/moist_endurance.py``. The HS94 run validates the dycore
under the published dry forcing; production coupled runs use the default
moist tropical-marine PhysicsParams (Sundqvist cloud scheme, K-diffusion
PBL, bulk surface fluxes). This runs that configuration, without SP
columns, for --days model days at T42/L19 and gates on long-run
boundedness: the state finite throughout, surface pressure, temperature
and moisture inside physical bounds, time-mean jets sane. The flags,
GATES, the table and the JSON line are the script's; the report goes to
sp_coupler_tpu_torch/verify/MOIST_T42_H100.md (or --out).

The script's jitted ``lax.scan`` chunk becomes a Python loop of steps
that adds the zonal-mean wind to an accumulator on the device; the
chunk's extrema are reduced on the device and read with it, one host
read a chunk (a model day by default).

Runs on the card unless --device cpu is given, and raises where there is
no card.

    python -m sp_coupler_tpu_torch.verify.moist_endurance [--days 100]
        [--trunc 42] [--dt 1800] [--chunk 0] [--device cpu] [--out OUT.md]
"""

import argparse
import json
import os

import numpy as np
import torch

from .. import clock, constants as cns, default_device, device_name
from ..models.gcm import model as gm

VERIFY = os.path.dirname(os.path.abspath(__file__))

GATES = {
    "u_max_ms": 150.0,
    "T_K": (150.0, 340.0),
    "ps_hpa": (800.0, 1100.0),
    "q_max": 0.05,
    "jet_ms": (5.0, 60.0),
}


def run(trunc=42, nlev=19, dt=1800.0, days=100, seed=3, chunk=0,
        device=None, state=None, log=print):
    """The moist run (default physics, hybrid levels, SL); state: a
    GCMState of this configuration to start from in place of the initial
    state of `seed`. Returns (hist, ubar of the second half [L, nlat],
    core, wall, bad_at)."""
    cfg = gm.GCMConfig(trunc=trunc, nlev=nlev, dt=dt, hybrid=True,
                       advection="sl")
    core = gm.GCMCore(cfg, device=device)
    dev = core.device
    if state is None:
        state = core.initial_state(seed=seed)
    state = core.step(state, first=True)

    steps_per_day = int(round(86400.0 / dt))
    CHUNK = chunk or steps_per_day
    acc_u = np.zeros((nlev, core.nlat))
    cnt = 0.0
    hist = []
    bad_at = None
    t0 = clock(dev)
    n_chunks = days * steps_per_day // CHUNK
    for i in range(n_chunks):
        au = torch.zeros((nlev, core.nlat), device=dev)
        for _ in range(CHUNK):
            state = core.step(state)
            au = au + state.grid.u.mean(dim=2)
        g = state.grid
        ps = cns.pref0 * torch.exp(g.lnps)
        stats = torch.stack([g.u.abs().max(), g.T.min(), g.T.max(),
                             g.q.max(), ps.min(), ps.max()])
        stats, au = stats.cpu().numpy(), au.cpu().numpy()   # one host read
        day = (i + 1) * CHUNK / steps_per_day
        finite = bool(np.all(np.isfinite(stats)))
        row = {"day": round(day, 1),
               "umax": round(float(stats[0]), 1),
               "Tmin": round(float(stats[1]), 1),
               "Tmax": round(float(stats[2]), 1),
               "qmax": round(float(stats[3]), 5),
               "ps_min_hpa": round(float(stats[4]) / 100.0, 1),
               "ps_max_hpa": round(float(stats[5]) / 100.0, 1),
               "finite": finite}
        if (i + 1) % 5 == 0 or not finite or i + 1 == n_chunks:
            log(row)
        hist.append(row)
        if not finite:
            bad_at = day
            break
        # the second half contributes to the time-mean jet statistics
        if i >= n_chunks // 2:
            acc_u += au
            cnt += CHUNK
    wall = clock(dev) - t0
    return hist, acc_u / max(cnt, 1.0), core, wall, bad_at


def jets(core, ubar):
    """(NH, SH) maxima of the time-mean zonal wind between sigma 0.15 and
    0.45 poleward of 10 deg."""
    lat = np.degrees(np.arcsin(core.sht.mu.cpu().numpy()))
    sig = core.vc.sf.cpu().numpy()
    upper = (sig > 0.15) & (sig < 0.45)
    return (float(ubar[np.ix_(upper, lat > 10)].max()),
            float(ubar[np.ix_(upper, lat < -10)].max()))


def passed(hist, jet_nh, jet_sh, bad_at):
    tlo, thi = GATES["T_K"]
    plo, phi_g = GATES["ps_hpa"]
    jlo, jhi = GATES["jet_ms"]
    return (bad_at is None
            and all(h["umax"] <= GATES["u_max_ms"] for h in hist)
            and all(tlo <= h["Tmin"] and h["Tmax"] <= thi for h in hist)
            and all(plo <= h["ps_min_hpa"] and h["ps_max_hpa"] <= phi_g
                    for h in hist)
            and all(h["qmax"] <= GATES["q_max"] for h in hist)
            and jlo <= jet_nh <= jhi and jlo <= jet_sh <= jhi)


def main(argv=None):
    """Run, print the JSON line and write the report; returns the line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", type=int, default=100)
    ap.add_argument("--trunc", type=int, default=42)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    name = device_name(device)
    print("device:", name, " T%d/L%d dt=%.0f moist default physics"
          % (args.trunc, args.nlev, args.dt), flush=True)
    hist, ubar, core, wall, bad_at = run(
        args.trunc, args.nlev, args.dt, args.days, args.seed, args.chunk,
        device, log=lambda row: print(row, flush=True))
    jet_nh, jet_sh = jets(core, ubar)
    ok = passed(hist, jet_nh, jet_sh, bad_at)
    line = {"bench": "moist_endurance", "backend": device.type,
            "trunc": args.trunc, "nlev": args.nlev, "dt_s": args.dt,
            "days": bad_at or args.days, "wall_s": round(wall, 1),
            "jet_nh_ms": round(jet_nh, 1), "jet_sh_ms": round(jet_sh, 1),
            "ok": ok}
    print(json.dumps(line), flush=True)

    tlo, thi = GATES["T_K"]
    plo, phi_g = GATES["ps_hpa"]
    jlo, jhi = GATES["jet_ms"]
    out = args.out or os.path.join(VERIFY, "MOIST_T42_H100.md")
    with open(out, "w") as f:
        f.write("# Moist production-physics endurance (default "
                "PhysicsParams)\n\n")
        f.write("T%d/L%d, dt=%.0f s, %g days, device %s, %.0f s wall. "
                "Default moist tropical-marine physics (Sundqvist cloud "
                "scheme, K-diffusion PBL, bulk surface fluxes): the "
                "configuration production coupled runs use, which the "
                "dry HS94 run does not cover.\n\n" % (
                    args.trunc, args.nlev, args.dt, line["days"], name,
                    wall))
        f.write("Time-mean upper-level jets (second half): NH %.1f m/s, "
                "SH %.1f m/s (moist subtropical jets; gate %.0f-%.0f "
                "m/s).\n\n" % (jet_nh, jet_sh, jlo, jhi))
        f.write("| day | max|u| | Tmin | Tmax | qmax | ps min (hPa) | "
                "ps max (hPa) | finite |\n|---|---|---|---|---|---|---|---|\n")
        step = max(len(hist) // 25, 1)
        shown = hist[::step]
        if hist[-1] is not shown[-1]:
            shown.append(hist[-1])
        for h in shown:
            f.write("| %.1f | %.1f | %.1f | %.1f | %.5f | %.1f | %.1f | "
                    "%s |\n" % (h["day"], h["umax"], h["Tmin"], h["Tmax"],
                                h["qmax"], h["ps_min_hpa"],
                                h["ps_max_hpa"], h["finite"]))
        f.write("\nGates: finite throughout; max|u| <= %.0f m/s; T in "
                "[%.0f, %.0f] K; ps in [%.0f, %.0f] hPa; q <= %.2f; "
                "time-mean jets in [%.0f, %.0f] m/s.\n" % (
                    GATES["u_max_ms"], tlo, thi, plo, phi_g,
                    GATES["q_max"], jlo, jhi))
        f.write("\n**Verdict: %s**\n" % ("PASS" if ok else "FAIL"))
    print("wrote", out, flush=True)
    return line


if __name__ == "__main__":
    import sys
    sys.exit(0 if main()["ok"] else 1)
