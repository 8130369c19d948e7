"""GCM step-time table across truncations, up to TL639 (BASELINE config 5).

Port of ``scripts/bench_gcm_scale.py``. Times the full semi-implicit step
(transforms + dycore + physics) and the bare spectral round-trip per
truncation, and prints a table and one JSON line. The truncations' level
counts and time steps are the script's (``NLEV``, ``DT``), and so are the
row keys; each row adds the time of building the core (``init_s``: the
host's Legendre and SL tables and their copy to the device) and, on the
card, the peak of device memory over the row (``peak_gib``). With
--profile a row also gives the share of one step's device time spent in
the zonal Fourier transforms (the dense einsums against ``Ffwd``/``Finv``)
and in the Legendre einsums, from ``torch.profiler``.

Every clock is read after a device synchronise. The script's
``core.apply`` (the JAX package's jit-argument threading of the spectral
tables, which a TPU's remote compile needed) is a plain call here. The
port runs on the card unless --device cpu is given, and raises where
there is no card.

    python -m sp_coupler_tpu_torch.runtime.gcmscale [trunc ...]
        [--repeats 10] [--nlev L] [--profile] [--device cpu]
"""

import argparse
import json
import sys

import torch

from .. import clock, default_device, device_name
from ..models.gcm import model as gm

# OpenIFS-like level counts: coupling cases run L19/L60; TL639 production
# uses L91. L60 exercises the same per-level transform batch
NLEV = {159: 60, 255: 60, 639: 60}
# dt per truncation: vertical advection and the physics coupling are
# explicit midpoint terms, unstable on L60's thin layers beyond ~1800 s
# whatever the truncation; TL639 runs its production 720 s step
DT = {159: 1800.0, 255: 1800.0, 639: 720.0}


def _roundtrip(core, x):
    return core.sht.synthesize(core.sht.analyze(x))


def _gemm(e):
    """(batch, rows, k, n) of a profiler average of ``aten::bmm`` or
    ``aten::mm`` (the GEMMs an einsum runs), else None."""
    shp = [tuple(x) for x in e.input_shapes if x]
    if e.key == "aten::bmm" and len(shp) >= 2 and len(shp[0]) == 3:
        return shp[0] + shp[1][2:]
    if e.key == "aten::mm" and len(shp) >= 2 and len(shp[0]) == 2:
        return (1,) + shp[0] + shp[1][1:]
    return None


def _device_us(e, self_only):
    """A profiler average's device time in us (the attribute's name
    differs between torch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(e, n):
            return float(getattr(e, n))
    raise AttributeError("no device time on %r" % (e,))


def transform_shares(core, state):
    """(Fourier share, Legendre share) of one step's device time, from
    torch.profiler: the device time of the GEMMs (``aten::bmm``/``mm``,
    which the einsums run) whose shapes are the zonal DFT's (one batch,
    contracting nlon into 2M or back) or the Legendre transforms' (a batch
    a zonal wavenumber m, contracting the Ke packed degrees or the jn rows
    of the folded grid into the other), over the device time of every kernel of the
    step. On the card only (None, None elsewhere)."""
    from torch.profiler import ProfilerActivity, profile
    if core.device.type != "cuda":
        return None, None
    sht = core.sht
    dft = {sht.nlon, 2 * sht.M}
    leg = {sht.Ke, sht.jn}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as p:
        core.step(state)
        torch.cuda.synchronize()
    total = f_us = l_us = 0.0
    for e in p.key_averages(group_by_input_shape=True):
        total += _device_us(e, True)
        g = _gemm(e)
        if g is None:
            continue
        b, r, k, n = g
        if b == 1 and {k, n} <= dft:
            f_us += _device_us(e, False)
        elif b == sht.M and k in leg and leg <= {r, k, n}:
            l_us += _device_us(e, False)
    if total <= 0.0:
        raise RuntimeError("the profiler saw no device time in a step")
    return f_us / total, l_us / total


def bench_trunc(trunc, repeats=10, device=None, profile=False, nlev=None):
    """One row of the table at this truncation (semi-Lagrangian, hybrid
    levels, DT and NLEV unless nlev is given)."""
    device = default_device(device)
    nlev = nlev or NLEV.get(trunc, 60)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = clock(device)
    cfg = gm.GCMConfig(trunc=trunc, nlev=nlev, dt=DT.get(trunc, 900.0),
                       hybrid=True, advection="sl")
    core = gm.GCMCore(cfg, device=device)
    init_s = clock(device) - t0
    state = core.initial_state(seed=1)

    state = core.step(state, first=True)    # the Euler start
    t0 = clock(device)
    for _ in range(repeats):
        state = core.step(state)
    step_ms = (clock(device) - t0) / repeats * 1e3
    if not bool(torch.isfinite(state.now.vort).all()):
        raise FloatingPointError("non-finite state at T%d" % trunc)

    # bare spectral round-trip at the same batch size (nlev fields)
    sht = core.sht
    r = torch.ones((nlev, sht.nlat, sht.nlon), dtype=torch.float32,
                   device=device)
    r = _roundtrip(core, r)
    t0 = clock(device)
    for _ in range(repeats):
        r = _roundtrip(core, r)
    rt_ms = (clock(device) - t0) / repeats * 1e3
    row = {"trunc": trunc, "nlev": nlev, "grid": [sht.nlat, sht.nlon],
           "dt_s": cfg.dt, "step_ms": step_ms,
           "spectral_roundtrip_ms": rt_ms, "init_s": init_s,
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if device.type == "cuda" else None)}
    if profile:
        row["fourier_share"], row["legendre_share"] = transform_shares(
            core, state)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("truncs", nargs="*", type=int, default=[159, 255, 639])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--nlev", type=int, default=0,
                    help="levels at every truncation (0: NLEV's)")
    ap.add_argument("--profile", action="store_true",
                    help="add the Fourier and Legendre shares of a step's "
                         "device time (torch.profiler; the card only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    rows = []
    for t in args.truncs:
        r = bench_trunc(t, args.repeats, device, args.profile,
                        args.nlev or None)
        rows.append(r)
        print("T%-4d L%d %4dx%-4d  step %8.2f ms   sht-roundtrip %8.2f ms"
              "   init %6.1f s   peak %s GiB"
              % (r["trunc"], r["nlev"], r["grid"][0], r["grid"][1],
                 r["step_ms"], r["spectral_roundtrip_ms"], r["init_s"],
                 "n/a" if r["peak_gib"] is None else "%.2f" % r["peak_gib"]),
              flush=True)
    print(json.dumps({"backend": device.type, "device": device_name(device),
                      "rows": rows}),
          flush=True)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
