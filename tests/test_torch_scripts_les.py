"""The port's LES-side scripts against the JAX package's:
``runtime/t255bench.py`` (``scripts/bench_t255.py``) and
``verify/parity_report.py`` (``scripts/parity_real_report.py``), on the
CPU. The JAX scripts are loaded from ``scripts/`` and run unchanged;
the column picks are lines 90-96 of ``bench_t255.py`` run as they are.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from sp_coupler_tpu.models.gcm import spharm as jsph
from sp_coupler_tpu_torch.models.gcm import spharm as tsph
from sp_coupler_tpu_torch.runtime import t255bench
from sp_coupler_tpu_torch.verify import parity_report

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "sp_coupler_tpu_torch", "verify", "ref")
CPU, JAX = (os.path.join(REF, "parity_real_%s_cpu.npz" % k)
            for k in ("torch", "jax"))


def script(name):
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Core:
    """The part of a GCM core the column picks read."""

    def __init__(self, sht):
        self.sht, self.nlon = sht, sht.nlon


def jax_columns(core, n_les):
    """bench_t255.py's column picks: its statements from
    ``lats = ...`` to ``assert len(cols) == n_les``, run as they are."""
    src = open(os.path.join(ROOT, "scripts", "bench_t255.py")).read()
    lines = src.splitlines()
    i0 = next(i for i, ln in enumerate(lines) if "lats = np.asarray(" in ln)
    i1 = next(i for i, ln in enumerate(lines)
              if "assert len(cols) == n_les" in ln)
    body = "\n".join(ln[4:] for ln in lines[i0:i1 + 1])
    ns = dict(np=np, core=core, n_les=n_les)
    exec(compile(ast.parse(body), "bench_t255.py", "exec"), ns)
    return ns["cols"].tolist()


@pytest.fixture(scope="module")
def t255_cores():
    return (Core(jsph.SpectralTransform(255)),
            Core(tsph.SpectralTransform(255, device="cpu")))


@pytest.mark.parametrize("n", [1, 4, 32, 256])
def test_columns_match_the_script_at_t255(t255_cores, n):
    jc, tc = t255_cores
    got = t255bench.columns(tc, n)
    assert got == jax_columns(jc, n)
    assert len(set(got)) == n


def test_columns_raise_beyond_the_rows(t255_cores):
    with pytest.raises(ValueError):
        t255bench.columns(t255_cores[1], 257)


def jax_line_keys():
    """The keys of bench_t255.py's JSON line."""
    src = open(os.path.join(ROOT, "scripts", "bench_t255.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["line"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no line dict in bench_t255.py")


def test_coupled_step_row_and_report(tmp_path, capsys):
    """A warm step and one coupled step at T10/L8 + 2 x 8x8x16: finite
    profiles of [2, 16], the script's keys plus les_schedule and peak_gib,
    and the report, which keeps its section on four cards."""
    args = t255bench.parser().parse_args(
        ["--n", "2", "--steps", "1", "--trunc", "10", "--nlev", "8",
         "--nx", "8", "--ny", "8", "--nz", "16", "--les_schedule",
         "batched", "--device", "cpu", "--report", str(tmp_path / "r.md")])
    assert args.chunks == 8
    row, extras = t255bench.run(args, torch.device("cpu"))
    assert list(row) == jax_line_keys() + ["les_schedule", "peak_gib"]
    assert row["n_les"] == 2 and row["les_grid"] == [8, 8, 16]
    assert row["les_schedule"] == "batched" and row["peak_gib"] is None
    assert row["substeps"] >= 2 and row["step_s"] > 0
    assert row["les_updates_per_s"] == pytest.approx(
        8 * 8 * 16 * row["substeps"] / row["step_s"])
    for k in ("THL", "QT", "U"):
        p = extras["prof"][k]
        assert tuple(p.shape) == (2, 16) and bool(torch.isfinite(p).all())
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == [row]
    t255bench.write_report(args.report, args, row, extras,
                           torch.device("cpu"))
    text = open(args.report).read()
    assert "Card: cpu." in text and "not measured" in text
    assert "2 instances of 8x8x16" in text and json.dumps(row) in text
    # the section on four cards (chip_smoke.py --cards 4) stays
    cards = t255bench.CARDS_SECTION + "\n\nThe whole config.\n"
    with open(args.report, "a") as f:
        f.write(cards)
    t255bench.write_report(args.report, args, row, extras,
                           torch.device("cpu"))
    assert open(args.report).read() == text + cards


def test_defaults_are_the_scripts():
    args = t255bench.parser().parse_args([])
    assert (args.n, args.steps, args.chunks, args.les_schedule) == (
        32, 2, 8, "serial")
    assert (args.trunc, args.nlev, args.nx, args.ny, args.nz) == (
        255, 19, 128, 128, 160)
    assert args.device is None and args.report is None and args.fit == []


def test_fit_attempts_bracket_the_fleet(monkeypatch, tmp_path):
    """--fit runs each size batched, a warm and a timed step, and records
    an out-of-memory error (raised here for n = 3) as the size that did
    not fit; the report names the largest that fit and the smallest that
    did not."""
    args = t255bench.parser().parse_args(
        ["--n", "1", "--steps", "1", "--trunc", "10", "--nlev", "8",
         "--nx", "8", "--ny", "8", "--nz", "16", "--device", "cpu",
         "--fit", "1", "3", "2"])
    run = t255bench.run
    seen = []

    def run_or_oom(a, device):
        seen.append((a.n, a.steps, a.les_schedule))
        if a.n == 3:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return run(a, device)

    monkeypatch.setattr(t255bench, "run", run_or_oom)
    tried = t255bench.fits(args, torch.device("cpu"), args.fit)
    assert seen == [(1, 1, "batched"), (3, 1, "batched"), (2, 1, "batched")]
    assert tried == [(1, None), (3, "out of memory"), (2, None)]
    text = t255bench.fit_text(tried)
    assert "n = 3 ran out of memory" in text and "n = 1 fits" in text
    assert text.endswith("the largest that fit is n = 2, the smallest "
                         "that did not n = 3")
    assert t255bench.fit_text([]) == "not tried (--fit)"
    assert t255bench.fit_text([(120, 74.38)]) == (
        "n = 120 fits (peak 74.38 GiB): the largest that fit is n = 120, "
        "none ran out of memory")


def test_entry_points_need_the_card_or_cpu():
    """Without --device each module takes the card, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t255bench.main(["--n", "1"])


# ---- the parity report ---------------------------------------------------

def table_rows(path):
    return [ln for ln in open(path).read().splitlines()
            if ln.startswith("| step")]


def test_parity_report_table_matches_the_script(tmp_path):
    """The per-field table of one run against another, as
    parity_real_report.py writes it for the same two files."""
    mod = script("parity_real_report")
    saved = sys.argv
    sys.argv = ["parity_real_report.py", CPU, JAX, str(tmp_path / "j.md")]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = mod.main()
    finally:
        sys.argv = saved
    fails = parity_report.main([CPU, JAX, "--card",
                                "test card, 700.00 W", "--out",
                                str(tmp_path / "t.md")])
    want = table_rows(tmp_path / "j.md")
    got = table_rows(tmp_path / "t.md")
    assert len(want) == 24 and got == want
    assert (rc == 0) == (fails == 0) and fails == 12
    text = open(tmp_path / "t.md").read()
    assert "Card: test card, 700.00 W." in text
    assert "**FAIL (12 fields)**" in text


def test_parity_report_pairs(tmp_path):
    """With the JAX run, a row a field for each pair; the card's file is
    here the port's CPU file itself, so its pair with it differs by 0."""
    out = tmp_path / "p.md"
    assert parity_report.main([CPU, CPU, "--jax", JAX, "--card", "c",
                               "--out", str(out)]) == 0
    rows = [ln for ln in open(out).read().splitlines()
            if ln.startswith("| step") and ln.count("|") == 6]
    assert len(rows) == 24
    d = json.loads(json.dumps(parity_report.parity.diffs(JAX, CPU)))
    first = rows[0].split("|")
    assert first[1].strip() == "step0_gcm_SH"
    assert first[3].strip() == "0.00e+00"
    assert first[4].strip().startswith("%.2e" % d["step0_gcm_SH"])


def test_parity_report_needs_the_card_name_off_the_card(tmp_path,
                                                       monkeypatch):
    """Where nvidia-smi is missing or names no card, the report asks for
    --card; with --card it never asks nvidia-smi."""
    def no_smi(device):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(parity_report, "card_line", no_smi)
    with pytest.raises(ValueError, match="--card"):
        parity_report.main([CPU, CPU, "--out", str(tmp_path / "x.md")])
    assert not os.path.exists(tmp_path / "x.md")
    assert parity_report.main([CPU, CPU, "--card", "c", "--out",
                               str(tmp_path / "y.md")]) == 0
