"""tests/jet_blowup_witness.py (the TL639 jet run of both packages side
by side from one injected state) at T10/L5 for 2 steps: each step's row
has both packages' max|u|, finite, and their u and T within 1e-3 of
JAX's max (the endurance test of test_torch_scripts_gcm.py holds them
at 1e-4 at T21; this guards the script, not the numerics)."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_witness_steps_both_packages_from_one_state(capsys):
    path = os.path.join(ROOT, "tests", "jet_blowup_witness.py")
    spec = importlib.util.spec_from_file_location("jet_blowup_witness", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = mod.main(["10", "5", "720", "2"])
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert r["jax"]["finite"] and r["port"]["finite"]
        assert abs(r["port"]["umax"] - r["jax"]["umax"]) <= (
            1e-3 * r["jax"]["umax"])
        assert r["du"] <= 1e-3 and r["dT"] <= 1e-3
        assert r["courant_z"] >= 0.0
    out = capsys.readouterr().out
    assert "T10/L5 dt 720 s, jets +-60 m/s, split_phases False" in out
