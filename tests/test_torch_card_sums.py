"""spharm.card_sums: the analysis sums and the semi-implicit product.

On the CPU a float32 contraction is torch.einsum's own, bit for bit, so
the CPU path (and every CPU test against the JAX package) is as it was.
On the card it sums in float64 from the same float32 values: the card's
TL639 analysis of the jet run's Euler state is then no further from
float64 than the CPU's (the test marked ``cuda``, which skips without a
card; chip_smoke.py's phase_tl639 makes the same check). Before the
repair the card's TL639 solve lay 3.8x to 11x further from float64 than
the CPU's (verify/TL639_H100.md)."""

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.models.gcm import spharm
from sp_coupler_tpu_torch.runtime import tl639
from sp_coupler_tpu_torch.verify import tl639_rows


@pytest.mark.parametrize("eq, xs, ts", [
    ("...i,imc->...mc", (3, 5, 16), (16, 4, 2)),
    ("...jmc,jmk->...mkc", (3, 8, 4, 2), (8, 4, 5)),
    ("nlj,jmnc->lmnc", (6, 3, 3), (3, 4, 6, 2)),
])
def test_card_sums_on_the_cpu_is_einsum(eq, xs, ts):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(xs), dtype=torch.float32)
    t = torch.as_tensor(rng.standard_normal(ts), dtype=torch.float32)
    got = spharm.card_sums(eq, x, t)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.einsum(eq, x, t), rtol=0, atol=0)
    got64 = spharm.card_sums(eq, x.double(), t.double())
    assert got64.dtype == torch.float64


def test_analysis_vs_float64_on_the_cpu():
    """analysis_vs_float64 at T21 on the CPU: both sides are the same
    transform, within a few float32 roundings of float64."""
    torch.set_num_threads(1)
    core = tl639.build(21, 19, 720.0, device="cpu")
    g = core.step(tl639.start(core, 60.0), first=True).grid
    res = tl639_rows.analysis_vs_float64(
        core.sht, spharm.SpectralTransform(21, device="cpu"), g.u, g.v, g.T)
    assert sorted(res) == ["T", "div", "vort"]
    for r in res.values():
        assert r["device"] == r["cpu"] and 0.0 < r["cpu"] < 1e-5


@pytest.mark.cuda
def test_card_analysis_no_further_from_float64_than_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    core = tl639.build(device="cuda")
    g = core.step(tl639.start(core, 60.0), first=True).grid
    res = tl639_rows.analysis_vs_float64(
        core.sht, spharm.SpectralTransform(core.cfg.trunc, device="cpu"),
        g.u, g.v, g.T)
    for k, r in res.items():
        assert r["device"] <= r["cpu"], (k, r)
