"""Write the parity report of the port at the real case size.

Port of ``scripts/parity_real_report.py``. It takes two summaries of
``python -m sp_coupler_tpu_torch.verify.parity run <out.npz> real 3``:
the port's CPU run (``verify/ref/parity_real_torch_cpu.npz``) and its
run on the card (``parity_real_h100.npz``, which ``chip_smoke.py``'s
phase_parity writes), and optionally the JAX package's CPU run
(``verify/ref/parity_real_jax_cpu.npz``). It writes
sp_coupler_tpu_torch/verify/PARITY_H100.md (or --out): the verdict and
the script's per-field table of the card against the port's CPU run, and
a table of every pair with the JAX run, with the card's name and power
limit.

Nothing of the script served only the TPU; its verdict and table are
kept, the TPU's prose goes. The report is computed on the host from the
two files, so it takes no device. The card's line is --card, else
nvidia-smi's on this machine; where nvidia-smi does not answer it raises
and asks for --card.

    python -m sp_coupler_tpu_torch.verify.parity_report CPU.npz CARD.npz
        [--jax JAX.npz] [--card "NAME, LIMIT"] [--out OUT.md]
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from .. import card_line
from . import parity

VERIFY = os.path.dirname(os.path.abspath(__file__))

HEADER = """# Parity at the real case size on the H100 (the port's PARITY_REAL.md)

Configuration: the parity harness's `real` case
(`python -m sp_coupler_tpu_torch.verify.parity run <out> real 3`):
T21/L19 GCM (dt 600 s) coupled to 2 LES instances of 64 x 64 x 160
(200 m / 25 m), `dt_les` 5 s, CFL-adaptive substeps, 3 coupled steps.
Each device runs its production path: the CUDA stage kernel on the card,
the plain PyTorch versions on the CPU. The enforced observables are the
coupled quantities (slab profiles, GCM columns) at per-step tolerances
{tols} of max|ref|; the per-level standard deviations of the turbulent
fields are reported only (`sp_coupler_tpu/verify/PARITY_REAL.md`'s
tolerance model). Written by `sp_coupler_tpu_torch/verify/parity_report.py`.

Card: {card}.

## Result: **{verdict}** (the card against the port's CPU run)

| field | max rel diff | tol | status |
|---|---|---|---|
{rows}
"""

PAIRS = """
## Every pair

The JAX run starts from other draws (`jax.random` for the GCM's vorticity
perturbation and the LES noise), so it is reported, not enforced: at
T21/L19 the two GCM starts differ by up to 43 m/s in u and v
(`tests/test_torch_parity.py::test_gcm_start_differs_from_jax`), and the
winds and the moisture they carry differ from step 0. From JAX's GCM
start with its own LES draws the port's CPU run stays inside PROFILE_TOL
of JAX's on all enforced fields but `prof_U`
(`tests/parity_from_jax_gcm.py`). The card starts from the port's CPU
state bit for bit (`chip_smoke.py` phase_seed).

| field | tol | card vs port CPU | port CPU vs JAX CPU | card vs JAX CPU |
|---|---|---|---|---|
{rows}
"""


def table(a_path, b_path):
    """The script's per-field rows of b against a and the number of
    enforced fields beyond their tolerance."""
    a = np.load(a_path)
    b = np.load(b_path)
    if set(a.files) != set(b.files):
        raise ValueError("%s and %s hold other keys" % (a_path, b_path))
    rows = []
    failures = 0
    for key in sorted(a.files):
        xa, xb = a[key], b[key]
        scale = np.abs(xa).max() + 1e-12
        diff = np.abs(xa - xb).max() / scale
        step = int(key[4])
        if "_std_" in key:
            tol = parity.STD_TOL[min(step, len(parity.STD_TOL) - 1)]
            status = "note" if diff > tol else "ok (note)"
        else:
            tol = parity.PROFILE_TOL[min(step, len(parity.PROFILE_TOL) - 1)]
            status = "ok" if diff <= tol else "FAIL"
            failures += diff > tol
        rows.append("| %s | %.2e | %.1e | %s |" % (key, diff, tol, status))
    return rows, failures


def pair_rows(cpu, card, jax):
    """One row a field: its tolerance and the max rel diff of each pair."""
    pairs = [parity.diffs(cpu, card), parity.diffs(jax, cpu),
             parity.diffs(jax, card)]
    rows = []
    for key in sorted(pairs[0]):
        step = int(key[4])
        std = "_std_" in key
        tols = parity.STD_TOL if std else parity.PROFILE_TOL
        tol = tols[min(step, len(tols) - 1)]
        mark = lambda d: "%.2e%s" % (d, "" if d <= tol else
                                     " (note)" if std else " **FAIL**")
        rows.append("| %s | %.1e%s | %s |" % (
            key, tol, " (report)" if std else "",
            " | ".join(mark(p[key]) for p in pairs)))
    return rows


def card_name(card):
    """The card's line: --card, else nvidia-smi's name and power limit of
    the first card on this machine."""
    if card:
        return card
    try:
        return card_line(torch.device("cuda", 0))
    except (OSError, subprocess.CalledProcessError, IndexError):
        raise ValueError("nvidia-smi names no card here: name the card of "
                         "the run with --card") from None


def write(out, cpu, card_npz, card, jax=None):
    """Write the report; returns the number of enforced fields beyond
    their tolerance."""
    rows, failures = table(cpu, card_npz)
    verdict = "PASS" if failures == 0 else "FAIL (%d fields)" % failures
    text = HEADER.format(tols=parity.PROFILE_TOL, card=card,
                         verdict=verdict, rows="\n".join(rows))
    if jax:
        text += PAIRS.format(rows="\n".join(pair_rows(cpu, card_npz, jax)))
    with open(out, "w") as f:
        f.write(text)
    print("wrote", out, "verdict:", verdict, flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cpu", help="the port's CPU parity summary (.npz)")
    ap.add_argument("card_npz", help="the port's card parity summary (.npz)")
    ap.add_argument("--jax", default="",
                    help="the JAX package's CPU parity summary (.npz)")
    ap.add_argument("--card", default="",
                    help="the card's name and power limit (default: "
                         "nvidia-smi on this machine)")
    ap.add_argument("--out", default=os.path.join(VERIFY, "PARITY_H100.md"))
    args = ap.parse_args(argv)
    card = card_name(args.card)
    return write(args.out, args.cpu, args.card_npz, card, args.jax or None)


if __name__ == "__main__":
    sys.exit(0 if main() == 0 else 1)
