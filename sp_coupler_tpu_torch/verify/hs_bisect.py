"""Held-Suarez instability bisection harness.

Port of ``scripts/hs_bisect.py``. Runs the canonical dry HS94 T42/L19
configuration (``verify/held_suarez.py``) under a chosen (advection,
vertical coordinate) pair, checks finiteness and the field extrema every
model day, and reports the first bad day with the level and latitude of
the first non-finite value. The flags, the daily JSON rows and the
report lines are the script's. The script's jitted ``lax.scan`` of a day
(one compiled program a day, which the TPU needed) is a Python loop of
steps here; nothing else of the script served only the TPU.

Runs on the card unless --device cpu is given, and raises where there is
no card.

    python -m sp_coupler_tpu_torch.verify.hs_bisect --advection sl
        --hybrid 1 --days 150 [--trunc 42] [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from .. import default_device
from .held_suarez import dry_start, hs94_core


def day_row(day, u, T, lnps):
    """The day's JSON row from the host grid fields: max|u|, the
    temperature and surface-pressure extrema (hPa) and finiteness."""
    fin = bool(np.isfinite(u).all() and np.isfinite(T).all()
               and np.isfinite(lnps).all())
    return {"day": day,
            "umax": round(float(np.nanmax(np.abs(u))), 1),
            "Tmin": round(float(np.nanmin(T)), 1),
            "Tmax": round(float(np.nanmax(T)), 1),
            "ps_min": round(float(1e5 * np.exp(np.nanmin(lnps))) / 100, 1),
            "ps_max": round(float(1e5 * np.exp(np.nanmax(lnps))) / 100, 1),
            "finite": fin}


def first_bad(u, T, mu, nlev, prev=None):
    """The report lines of a non-finite day: the first non-finite u and T
    (level, latitude from the sine-latitudes mu, longitude index for u)
    and the previous day's extrema (prev: its host (u, T) or None)."""
    lines = []
    bad = ~np.isfinite(u)
    if bad.any():
        lev, lat, lon = np.unravel_index(np.argmax(bad), bad.shape)
        lines.append("first bad u at level %d/%d, lat %.1f deg, lon idx %d"
                     % (lev, nlev, float(np.degrees(np.arcsin(mu[lat]))),
                        lon))
    badT = ~np.isfinite(T)
    if badT.any():
        lev, lat, lon = np.unravel_index(np.argmax(badT), badT.shape)
        lines.append("first bad T at level %d/%d, lat %.1f deg"
                     % (lev, nlev, float(np.degrees(np.arcsin(mu[lat])))))
    if prev is not None:
        pu, pT = prev
        lines.append("previous day: umax %.1f Tmin %.1f Tmax %.1f"
                     % (np.abs(pu).max(), pT.min(), pT.max()))
    return lines


def main(argv=None):
    """Run day by day until --days or the first non-finite day; returns
    the daily rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--advection", default="sl")
    ap.add_argument("--hybrid", type=int, default=1)
    ap.add_argument("--days", type=int, default=150)
    ap.add_argument("--trunc", type=int, default=42)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    core = hs94_core(args.trunc, args.nlev, args.dt, args.advection,
                     hybrid=bool(args.hybrid), device=device)
    state = core.initial_state(seed=args.seed)
    state = core.step(dry_start(core, state), first=True)
    spd = int(round(86400.0 / args.dt))
    mu = core.sht.mu.cpu().numpy()

    t0 = time.time()
    prev_np = None
    rows = []
    for d in range(args.days):
        for _ in range(spd):
            state = core.step(state)
        g = state.grid
        u, T = g.u.cpu().numpy(), g.T.cpu().numpy()
        row = day_row(d + 1, u, T, g.lnps.cpu().numpy())
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not row["finite"]:
            for line in first_bad(u, T, mu, args.nlev, prev_np):
                print(line, flush=True)
            break
        prev_np = (u, T)
    print("wall %.1f s" % (time.time() - t0), flush=True)
    return rows


if __name__ == "__main__":
    main()
