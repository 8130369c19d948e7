"""The port's columns-axis bench (``runtime/columnbench.py``) against the
JAX package's ``scripts/bench_columns.py``: the same columns for the same
truncation and count, the same row keys, and a spifs.nc h5py reads."""

import ast
import importlib.util
import json
import os

import h5py
import numpy as np
import pytest

from sp_coupler_tpu_torch.runtime import columnbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "bench_columns.py")


def jax_script():
    spec = importlib.util.spec_from_file_location("bench_columns", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_row_keys():
    """The keys of the row dict bench_columns.run_size prints."""
    for node in ast.walk(ast.parse(open(SCRIPT).read())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["row"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no row dict in " + SCRIPT)


@pytest.mark.parametrize("trunc", [21, 63])
@pytest.mark.parametrize("n", [3, 64, 256])
def test_pick_points_match(trunc, n):
    got = columnbench.pick_points(trunc, n)
    want = jax_script().pick_points(trunc, n)
    assert len(got) == len(set(got)) == n
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_small_run_row_and_file(tmp_path, capsys):
    rows = columnbench.main(
        ["--sizes", "3", "--trunc", "10", "--nlev", "8", "--nx", "8",
         "--ny", "8", "--nz", "16", "--steps", "2", "--device", "cpu",
         "--workdir", str(tmp_path), "--out", str(tmp_path / "cols.md")])
    assert len(rows) == 1
    row = rows[0]
    assert list(row) == jax_row_keys() + ["peak_gib"]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == [row]
    assert row["n_cols"] == 3 and row["gridpoints"] == 3 * 8 * 8 * 16
    assert row["peak_gib"] is None            # no card: no device memory
    assert row["step_s"] > 0 and row["io_s_mean"] >= 0
    with h5py.File(str(tmp_path / "cols_0003" / "spifs.nc"), "r") as f:
        groups = [k for k in f if isinstance(f[k], h5py.Group)]
        assert len(groups) == 3 and f["Time"].shape == (2,)
        for g in groups:
            thl = f[g]["thl"][()]
            assert thl.shape == (2, 16) and np.all(np.isfinite(thl))
    table = open(tmp_path / "cols.md").read()
    assert "| 3 |" in table and "8x8x16" in table
