"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card. The file
imports no JAX, so it also runs where JAX is not installed; there,
tests/conftest.py (which imports JAX) is left out:

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts= --noconftest
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
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


# grids a tiled kernel can get wrong (chip_smoke.py, STAGE_SHAPES): a
# ragged last tile wider than the plane, nx = ny = 4, z-chunks that do not
# divide nz, one-level chunks, and the default geometry; for the stage
# kernel and kernels #2-#4
TILED_SHAPES = [((12, 10, 20), 3, 6), ((12, 10, 20), 3, None),
                ((4, 4, 9), 1, 4), ((16, 16, 32), 1, 5),
                ((16, 16, 32), 2, None), ((16, 16, 33), 1, 10),
                ((20, 12, 23), 2, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["stage_inputs", "rough_inputs"])
@pytest.mark.parametrize("shape, n, tz", TILED_SHAPES)
def test_tiled_kernel_matches_plain_on_card(dev, shape, n, tz, inputs):
    """chip_smoke.py's check of the stage kernel (check_stage): outputs,
    kmax against the plain version and its float64 run, u*^2, rain, and
    the increments of a stirred and a calm input."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    cur, base, frc, dt = getattr(cs, inputs)(grid, n, 7 + n)
    kern = lambda *a: lesstage.stage_fused_cuda(*a, tz=tz)
    cs.check_stage(kern, grid, lstep.LESPhysics(), cur, base, frc, dt)
    torch.cuda.synchronize()


# the T255 case's LES plane (runtime/t255bench.py) in the default launch
# geometry: one instance, and chip_smoke.py phase_t255's batch of 4 (one
# z-chunk a column, chip_smoke.FLEET_SHAPES)
WIDE = (128, 128, 160)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("inputs", ["stage_inputs", "rough_inputs"])
def test_kernel_matches_plain_at_128_planes_on_card(dev, inputs, n):
    """chip_smoke.py's check of the stage kernel (check_stage) at
    128x128x160: 16 x 4 column tiles of a plane, n = 1 (4 z-chunks of 40
    levels) and n = 4 (one chunk of 160)."""
    grid = lgrid.LESGrid(nx=WIDE[0], ny=WIDE[1], nz=WIDE[2])
    assert lesstage.stage_geometry(n, *WIDE[::-1]).tz == {1: 40, 4: 160}[n]
    cur, base, frc, dt = getattr(cs, inputs)(grid, n, 7 + n)
    cs.check_stage(lesstage.stage_fused_cuda, grid, lstep.LESPhysics(), cur,
                   base, frc, dt)
    torch.cuda.synchronize()


# the fleets' batches (chip_smoke.FLEET_SHAPES): of 64x64x160 the fleet
# benches' (chip_smoke.FLEET_N), of 128x128x160 phase_t255's 4 and
# BASELINE config 4's 64 a card (phase_config4); the default launch
# geometry's levels per z-chunk at each
FLEET_TZ = {(64, 3): 32, (64, 4): 40, (64, 8): 80, (64, 16): 160,
            (64, 32): 160, (64, 64): 160, (128, 4): 160, (128, 64): 160}


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n", [(s, n) for s, n, _ in cs.FLEET_SHAPES],
                         ids=["%dx%dx%d-%d" % (*s, n)
                              for s, n, _ in cs.FLEET_SHAPES])
def test_kernel_matches_plain_at_fleet_batches_on_card(dev, shape, n):
    """chip_smoke.py's check of the stage kernel (check_stage) at the
    batches of schedulebench (n = 3, 4), batchbench (8, 16, 32, 64), the
    T159 leg (64), phase_t255 (4 of 128x128x160) and a card of config 4
    (64 of 128x128x160, its references 4 instances at a time), each in
    its default launch geometry."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    assert lesstage.stage_geometry(n, nz, ny, nx).tz == FLEET_TZ[(nx, n)]
    assert cs.ref_chunk(grid, n) == (4 if (nx, n) == (128, 64) else None)
    cur, base, frc, dt = cs.stage_inputs(grid, n, 7 + n)
    cs.check_stage(lesstage.stage_fused_cuda, grid, lstep.LESPhysics(), cur,
                   base, frc, dt)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_matches_plain_on_raining_state_on_card(dev):
    """chip_smoke.py's check of the stage kernel (check_stage) on the
    raining, deep-cloud state (chip_smoke.RAIN_SHAPE, raining_inputs: rain
    up to 1e-3, drafts of ~3 m/s, a cloud from 0.5 to 3 km) at its
    adaptive dt."""
    (nx, ny, nz), n, _ = cs.RAIN_SHAPE
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    cur, base, frc, dt = cs.raining_inputs(grid, n, 9)
    cs.check_stage(lesstage.stage_fused_cuda, grid, lstep.LESPhysics(), cur,
                   base, frc, dt)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["split_inputs", "rough_split_inputs"])
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom", "advect"])
def test_split_kernel_matches_plain_at_128_planes_on_card(dev, kernel,
                                                          inputs):
    """chip_smoke.py's check of kernels #2-#4 (check_arrays) at
    128x128x160, n = 1."""
    grid = lgrid.LESGrid(nx=WIDE[0], ny=WIDE[1], nz=WIDE[2])
    name, launch, plain, args_of, tol, _ = next(
        k for k in cs.split_kernels() if k[0] == kernel)
    args = args_of(getattr(cs, inputs)(grid, 1, 12), grid)
    got = launch(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    cs.check_arrays(name, got, ref, tol)


# the full-width grids of chip_smoke.py's phase_split_grids off the TPU's
# lane rule: nz = 150 (not a multiple of 16; default z-chunks that do not
# divide it), and 60x60 (3,600 points a plane, ragged 32x8 tiles)
SPLIT_GRIDS = [(64, 64, 150), (60, 60, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["split_inputs", "rough_split_inputs"])
@pytest.mark.parametrize("shape", SPLIT_GRIDS)
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom"])
def test_split_kernel_matches_plain_off_the_lane_grids_on_card(
        dev, kernel, shape, inputs):
    """chip_smoke.py's check of kernels #2-#3 (check_arrays) at
    SPLIT_GRIDS, n = 2 (the bench fleet), in the default launch
    geometry."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    name, launch, plain, args_of, tol, _ = next(
        k for k in cs.split_kernels() if k[0] == kernel)
    args = args_of(getattr(cs, inputs)(grid, 2, 13), grid)
    got = launch(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    cs.check_arrays(name, got, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n, tz", [((16, 16, 32), 2, None),
                                          ((12, 10, 20), 3, 6)])
def test_kernel_options_match_plain_on_card(dev, shape, n, tz):
    """f_coriolis != 0 and each qt forcing mode (chip_smoke.py,
    STAGE_OPTIONS), each held by its own effect on the outputs."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    cur, _, frc, dt = cs.rough_inputs(grid, n, 7 + n)
    kern = lambda *a: lesstage.stage_fused_cuda(*a, tz=tz)
    cs.check_options(kern, grid, cur, frc, dt)


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


def _split_inputs(grid, n, dev, seed=13):
    """The stage state's scalar stack, its Smagorinsky K and Km, as the
    split path hands them to the scalar and momentum kernels."""
    from sp_coupler_tpu_torch.models.les import subgrid
    cur = _inputs(grid, n, dev, seed)[0]
    Km, Kh = subgrid.eddy_viscosity(grid, cur, lstep.thermodynamics(cur)[3])
    return dict(u=cur.u, v=cur.v, w=cur.w,
                Ks=torch.stack([Kh, Kh, Kh, 2.0 * Km], dim=1),
                scalars=torch.stack([cur.thl, cur.qt, cur.qr, cur.e12], dim=1),
                rhobf=cur.rhobf, rhobh=cur.rhobh, Km=Km)


def _split_call(kernel, a, grid, cuda):
    """(outputs of the kernel or its plain version as a list of arrays,
    tolerance of tests/test_ops.py, the wrapper's module)."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom, advect
    sp = (grid.dx, grid.dy, grid.dz)
    if kernel == "lesmom":
        fn = (lesmom.momentum_tendencies if cuda
              else lesmom.momentum_tendencies_reference)
        out = fn(a["u"], a["v"], a["w"], a["Km"], a["rhobf"], a["rhobh"], *sp)
        return list(out), dict(atol=5e-5, rtol=1e-4), lesmom
    mod = lesflat if kernel == "lesflat" else advect
    fn = (mod.advect_diffuse_scalars if cuda
          else mod.advect_diffuse_scalars_reference)
    out = fn(a["u"], a["v"], a["w"], a["Ks"], a["scalars"], a["rhobf"],
             a["rhobh"], *sp)
    return list(out.unbind(1)), dict(atol=2e-4, rtol=1e-4), mod


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom", "advect"])
def test_split_kernel_matches_plain_on_card(dev, kernel, n):
    """16x16x32: each output array (each scalar of the stack; du, dv, dw) at
    the tolerance of tests/test_ops.py and within 1e-4 of its own max|ref|
    (chip_smoke.py, ARRAY_FRAC)."""
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    a = _split_inputs(grid, n, dev)
    mod = _split_call(kernel, a, grid, cuda=False)[2]
    n0 = mod.launches
    got, tol, _ = _split_call(kernel, a, grid, cuda=True)
    assert mod.launches == n0 + 1
    ref = _split_call(kernel, a, grid, cuda=False)[0]
    torch.cuda.synchronize()
    for j, (x, y) in enumerate(zip(got, ref)):
        torch.testing.assert_close(x, y, msg="array %d" % j, **tol)
        torch.testing.assert_close(x, y, atol=1e-4 * float(y.abs().max()),
                                   rtol=0.0, msg="array %d, max|ref|" % j)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom", "advect"])
def test_split_kernel_rejects_what_it_does_not_take(dev, kernel):
    grid = lgrid.LESGrid(nx=16, ny=16, nz=32)
    a = _split_inputs(grid, 1, dev)
    bad = dict(a, u=a["u"].transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        _split_call(kernel, bad, grid, cuda=True)
    bad = dict(a, w=a["w"].double())
    with pytest.raises(ValueError, match="float32"):
        _split_call(kernel, bad, grid, cuda=True)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["split_inputs", "rough_split_inputs"])
@pytest.mark.parametrize("shape, n, tz", TILED_SHAPES)
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom", "advect"])
def test_tiled_split_kernel_matches_plain_on_card(dev, kernel, shape, n, tz,
                                                  inputs):
    """chip_smoke.py's check of kernels #2-#4 (check_arrays) at the grids a
    tiled kernel can get wrong, for the split path's inputs and a rough
    one (s and K per point, u and v of both signs with zero faces)."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    name, launch, plain, args_of, tol, _ = next(
        k for k in cs.split_kernels() if k[0] == kernel)
    args = args_of(getattr(cs, inputs)(grid, n, 11 + n), grid)
    got = launch(*args, tz=tz)
    ref = plain(*args)
    torch.cuda.synchronize()
    cs.check_arrays(name, got, ref, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("kernel", ["lesflat", "advect"])
def test_scalar_kernel_takes_any_stack_on_card(dev, kernel, S):
    """A stack of 1 scalar, and of 6 (two groups of blocks, the second of
    2 scalars), on a ragged grid with z-chunks of 6 levels, each scalar
    held by chip_smoke.check_arrays."""
    grid = lgrid.LESGrid(nx=12, ny=10, nz=20)
    name, launch, plain, args_of, tol, _ = next(
        k for k in cs.split_kernels() if k[0] == kernel)
    a = cs.rough_split_inputs(grid, 3, 14, str(dev))
    rep = -(-S // 4)
    a["scalars"] = torch.cat([a["scalars"] + i for i in range(rep)],
                             dim=1)[:, :S].contiguous()
    a["Ks"] = torch.cat([a["Ks"] * (1.0 + 0.1 * i) for i in range(rep)],
                        dim=1)[:, :S].contiguous()
    args = args_of(a, grid)
    got = launch(*args, tz=6)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert got.shape[1] == S
    cs.check_arrays(name, got, ref, tol)


# ---- the halo mode (a rank's block of a plane split over ranks) ----------

HALO_SHAPES = [((32, 32, 32), 2), ((24, 16, 20), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n", HALO_SHAPES)
def test_halo_stage_matches_whole_plane_on_card(dev, shape, n):
    """The stage kernel on 2 x 2 padded blocks (the plane-means kernel's
    sums added across them) against the whole-plane kernel: the
    increments at chip_smoke.py's INC_FRAC of max|increment|, kmax at
    KMAX_RTOL (blocks of 16x16 and of 12x8: tiles wider than the block)."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    cur, base, frc, dt = _inputs(grid, n, dev)
    args = (grid, lstep.LESPhysics(), cur, base, frc, 0.5, dt)
    got = cs.stage_blocks(cs.split_planes(ny, nx), *args)
    ref = lesstage.stage_fused_cuda(*args)
    for k, a, b in zip(NAMES, got[:7], ref[:7]):
        b_k = base.w[:, :-1] if k == "w" else getattr(base, k)
        cs.check_increment(k, a, b, b_k, cs.INC_FRAC, cs.INC_RTOL)
    cs.check_close("kmax", got[7], ref[7], 0.0, cs.KMAX_RTOL)
    cs.check_close("ustar2", got[8], ref[8], 0.0, cs.USTAR2_RTOL)
    cs.check_close("rain", got[9], ref[9], **cs.RAIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n", HALO_SHAPES)
@pytest.mark.parametrize("kernel", ["lesflat", "lesmom"])
def test_halo_split_kernel_matches_plain_on_card(dev, kernel, shape, n):
    """The scalar and momentum kernels on each padded block against their
    plain versions on the same block and against the whole-plane
    kernel's block, at chip_smoke.py's tolerances."""
    nx, ny, nz = shape
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    name, launch, plain, args_of, tol, _ = next(
        k for k in cs.split_kernels() if k[0] == kernel)
    args = args_of(cs.split_inputs(grid, n, 11, dev="cuda"), grid)
    whole = launch(*args)
    planes = cs.split_planes(ny, nx)
    for q, pa in zip(planes, cs.split_blocks(planes, name, args,
                                             lesstage.HALO)):
        got = launch(*pa, halo=lesstage.HALO)
        cs.check_arrays(name, got, plain(*pa, halo=lesstage.HALO), tol)
        cut = (q.block(whole) if torch.is_tensor(whole)
               else tuple(q.block(x) for x in whole))
        cs.check_arrays(name + " vs whole", got, cut, tol)
