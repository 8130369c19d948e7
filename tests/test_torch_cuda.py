"""The CUDA stage kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card. The file
imports no JAX, so it also runs where JAX is not installed; there,
tests/conftest.py (which imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts= --noconftest
"""

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.models.les import (grid as lgrid, state as lstate,
                                             step as lstep)
from sp_coupler_tpu_torch.ops import lesstage

NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")
# a base of constants for holding the increments out - base on their own
# (chip_smoke.py, INC_BASE): float32 keeps base + increment to ~1e-6 of
# the increment and no clip acts
INC_BASE = dict(u=0.0, v=0.0, w=0.0, thl=0.0, qt=1e-3, qr=1e-4, e12=0.1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(grid, n, dev, seed=7):
    """A physical fleet (init_state) with perturbed w and qr, the stage
    setup of tests/test_ops.py:139-154."""
    nz = grid.nz
    gen = torch.Generator(device=dev).manual_seed(seed)
    rep = lambda a: torch.tensor(np.tile(np.asarray(a, np.float32), (n, 1)),
                                 device=dev)
    base = lstate.init_state(
        grid, rep(np.linspace(-5, 5, nz)), rep(np.zeros(nz)),
        rep(np.linspace(298, 312, nz)), rep(np.linspace(0.016, 0.002, nz)),
        101300.0, gen)
    w = base.w.clone()
    w[:, 1:-1] = 0.1 * torch.randn((n, nz - 1, grid.ny, grid.nx),
                                   generator=gen, device=dev)
    qr = 1e-4 * torch.rand(base.qr.shape, generator=gen, device=dev)
    base = base._replace(w=w, qr=qr)
    cur = base._replace(thl=base.thl + 0.05, u=base.u * 1.01)
    full = lambda v: torch.full((n, nz), v, device=dev)
    frc = lstate.LESForcing.zeros(n, nz, device=dev)
    frc = frc._replace(wthl=frc.wthl + 0.01, wqt=frc.wqt + 1e-5,
                       f_thl=full(1e-5), f_qt=full(-1e-9), f_u=full(1e-5),
                       f_v=full(-1e-5))
    return cur, base, frc, torch.full((n,), 2.0, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_kernel_matches_plain_on_card(dev, n):
    """16x16x32: the outputs at the tolerances of tests/test_ops.py:171-178,
    then the increments out - base, which those tolerances cannot see for
    w, qt, qr and e12, at 2e-3 of max|increment| (float32 rounding of the
    buoyancy puts the plain version 3e-4 of max|dw| off float64). The calm
    input (u = v = w = qr = 0) leaves scalar diffusion, surface fluxes and
    sponge as the whole thl and qt increments."""
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    cur, base, frc, dt = _inputs(grid, n, dev)
    args = (grid, lstep.LESPhysics(), cur, base, frc, 0.5, dt)
    n0 = lesstage.launches
    got = lesstage.stage_fused(*args)
    assert lesstage.launches == n0 + 1
    ref = lesstage.stage_fused_reference(*args)
    torch.cuda.synchronize()
    for k, a, b in zip(NAMES, got[:7], ref[:7]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=1e-4, msg=k)
    torch.testing.assert_close(got[7], ref[7], atol=0.0, rtol=1e-4)
    torch.testing.assert_close(got[8], ref[8], atol=0.0, rtol=1e-3)
    torch.testing.assert_close(got[9], ref[9], atol=1e-10, rtol=1e-3)

    z = torch.zeros_like
    calm = cur._replace(u=z(cur.u), v=z(cur.v), w=z(cur.w), qr=z(cur.qr))
    for case, c in (("stirred", cur), ("calm", calm)):
        b = c._replace(**{k: torch.full_like(getattr(c, k), v)
                          for k, v in INC_BASE.items()})
        a_ = (grid, lstep.LESPhysics(), c, b, frc, 0.5, dt)
        got = lesstage.stage_fused(*a_)
        ref = lesstage.stage_fused_reference(*a_)
        for k, x, y in zip(NAMES, got[:7], ref[:7]):
            b0 = b.w[:, :-1] if k == "w" else getattr(b, k)
            d_ref = y - b0
            torch.testing.assert_close(
                x - b0, d_ref, atol=2e-3 * float(d_ref.abs().max()),
                rtol=1e-3, msg="%s %s increment" % (case, k))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    cur, base, frc, dt = _inputs(grid, 1, dev)
    bad = cur._replace(thl=cur.thl.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        lesstage.stage_fused(grid, lstep.LESPhysics(), bad, base, frc, 0.5,
                             dt)
    with pytest.raises(ValueError, match="float32"):
        lesstage.stage_fused(grid, lstep.LESPhysics(),
                             cur._replace(qt=cur.qt.double()), base, frc,
                             0.5, dt)
