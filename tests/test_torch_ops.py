"""Port's fused LES stage (sp_coupler_tpu_torch/ops/lesstage.py) vs JAX.

The plain PyTorch version ``stage_fused_reference`` is held against the
JAX package's Pallas stage kernel (interpret mode on the CPU) at the
setup and tolerances of tests/test_ops.py. The CUDA kernel itself runs
only on a card, against this plain version: tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke as cs

from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, subgrid as jsg)
from sp_coupler_tpu.ops import lesstage_pallas as jls
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.les import grid as tgrid, step as tstep
from sp_coupler_tpu_torch.ops import lesstage, tiling, _build

torch.set_num_threads(1)

NZ = 32
JG = jgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)
TG = tgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)
NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")


def _state(x):
    """JAX LESState (one instance or a fleet) -> the port's, on the CPU."""
    return interop.les_state(jax.tree.map(np.asarray, x), "cpu")


def _forcing(x):
    """JAX LESForcing (one instance or a fleet) -> the port's, on the CPU."""
    return interop.les_forcing(jax.tree.map(np.asarray, x), "cpu")


def _stage_setup():
    """tests/test_ops.py::test_stage_fused_matches_xla_stage inputs."""
    rng = np.random.default_rng(7)
    base = jstate.init_state(
        JG, jnp.asarray(np.linspace(-5, 5, NZ), jnp.float32),
        jnp.zeros(NZ, jnp.float32),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(1))
    base = base._replace(
        w=base.w.at[1:-1].set(jnp.asarray(
            rng.normal(0, 0.1, (NZ - 1, JG.ny, JG.nx)), jnp.float32)),
        qr=jnp.asarray(rng.uniform(0, 1e-4, (NZ, JG.ny, JG.nx)),
                       jnp.float32))
    cur = base._replace(thl=base.thl + 0.05, u=base.u * 1.01)
    frc = jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        f_thl=jnp.full(NZ, 1e-5), f_qt=jnp.full(NZ, -1e-9),
        f_u=jnp.full(NZ, 1e-5), f_v=jnp.full(NZ, -1e-5),
        z0m=jnp.asarray(0.1))
    return cur, base, frc


def _check_stage(got, ref, idx=0):
    """tests/test_ops.py:171-178 tolerances; got: port outputs [n, ...],
    ref: JAX outputs of instance idx."""
    for k, a, b in zip(NAMES, got[:7], ref[:7]):
        np.testing.assert_allclose(a[idx].numpy(), np.asarray(b),
                                   atol=5e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got[7][idx]), float(ref[7]), rtol=1e-4)
    np.testing.assert_allclose(float(got[9][idx]), float(ref[9]),
                               rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(float(got[8][idx]), float(ref[8]),
                               rtol=1e-3)


def test_stage_reference_matches_jax_pallas_stage():
    """stage_fused_reference == JAX lesstage_pallas.stage_fused."""
    cur, base, frc = _stage_setup()
    dt, frac = 2.0, 0.5
    ref = jls.stage_fused(JG, jstep.LESPhysics(), cur, base, frc, frac, dt)
    got = lesstage.stage_fused_reference(
        TG, tstep.LESPhysics(), _state(cur),
        _state(base), _forcing(frc), frac,
        torch.tensor([dt]))
    _check_stage(got, ref)


def test_stage_fleet_matches_jax_vmapped_stage():
    """A fleet of 2 through the port == JAX's custom-vmapped kernel."""
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    st = jax.vmap(lambda k: jstate.init_state(
        JG, jnp.full(NZ, 4.0), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        jnp.asarray(101300.0), k))(keys)
    frc = jax.vmap(lambda _: jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        z0m=jnp.asarray(0.1)))(jnp.arange(2))
    dt, frac = 2.0, 1.0 / 3.0
    ref = jax.vmap(lambda s, f: jls.stage_fused(
        JG, jstep.LESPhysics(), s, s, f, frac, dt))(st, frc)
    ts, tf = _state(st), _forcing(frc)
    got = lesstage.stage_fused(TG, tstep.LESPhysics(), ts, ts, tf, frac,
                               torch.full((2,), dt))
    for i in range(2):
        _check_stage(got, [r[i] for r in ref], idx=i)


def test_substep_through_fused_entry_matches_jax_split():
    """Port substep (use_kernel=True -> plain version on the CPU) == JAX
    substep(use_pallas=False), tests/test_ops.py:209-233."""
    st = jstate.init_state(
        JG, jnp.full(NZ, 4.0), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(3))
    frc = jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        z0m=jnp.asarray(0.1), z0h=jnp.asarray(0.02))
    dt = 2.0
    s_x, k_x = jstep.substep(JG, jstep.LESPhysics(use_pallas=False), st,
                             frc, dt)
    lesstage.launches = 0
    s_t, k_t = tstep.substep(TG, tstep.LESPhysics(use_kernel=True),
                             _state(st),
                             _forcing(frc),
                             torch.tensor([dt]))
    assert lesstage.launches == 0          # CPU tensors: no kernel launch
    for f in ("u", "v", "w", "thl", "qt", "qr", "e12", "rain", "ustar"):
        a, b = getattr(s_t, f)[0].numpy(), np.asarray(getattr(s_x, f))
        scale = max(np.max(np.abs(b)), 1e-12)
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(float(k_t[0]), float(k_x), rtol=1e-3)


def test_stage_on_cpu_never_launches():
    cur, base, frc = _stage_setup()
    lesstage.launches = 0
    lesstage.stage_fused(TG, tstep.LESPhysics(), _state(cur),
                         _state(base),
                         _forcing(frc), 1.0,
                         torch.tensor([1.0]))
    assert lesstage.launches == 0


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("lesstage.cu", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-O3" in cmd and "-shared" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert open(_build.CSRC_DIR + "/lesstage.cu").read().count(
        'extern "C" int lesstage_stage(') == 1


def test_ctypes_args_mirror_cuda_struct():
    """The ctypes mirror lists the CUDA struct's fields in order."""
    src = open(_build.CSRC_DIR + "/lesstage.cu").read()
    body = src[src.index("struct StageArgs {"):]
    body = body[:body.index("};")]
    decl = [part.strip()
            for line in body.splitlines()[1:]
            if line.strip() and not line.strip().startswith("//")
            for part in line.split(";")[0].replace("const ", "")
            .split(None, 1)[1].replace("*", "").split(",")]
    py = [f[0] for f in lesstage._StageArgs._fields_]
    assert decl == py


def test_fall_speed_exponents_must_be_positive():
    from sp_coupler_tpu_torch.models.les import micro
    phys = tstep.LESPhysics(mphys=micro.MicroParams(sed_b=0.0))
    cur, base, frc = _stage_setup()
    with pytest.raises(ValueError, match="exponents"):
        lesstage.stage_fused_cuda(
            TG, phys, _state(cur),
            _state(base), _forcing(frc),
            1.0, torch.tensor([1.0]))


def test_cuda_wrapper_rejects_cpu_tensors():
    cur, base, frc = _stage_setup()
    with pytest.raises(ValueError, match="CUDA"):
        lesstage.stage_fused_cuda(
            TG, tstep.LESPhysics(), _state(cur),
            _state(base), _forcing(frc),
            1.0, torch.tensor([1.0]))


def _raise(*a, **k):
    raise AssertionError("a split-path kernel wrapper was called")


def test_stage_reference_stays_plain(monkeypatch):
    """The stage kernel's plain version runs the plain split path even
    under use_kernel=True: the scalar and momentum kernel wrappers, which
    tendencies() takes on this grid under use_kernel, are never called."""
    from sp_coupler_tpu_torch.ops import lesflat, lesmom
    cur, base, frc = _stage_setup()
    args = (TG, tstep.LESPhysics(use_kernel=True),
            _state(cur), _state(base),
            _forcing(frc), 0.5, torch.tensor([2.0]))
    monkeypatch.setattr(lesflat, "advect_diffuse_scalars", _raise)
    monkeypatch.setattr(lesmom, "momentum_tendencies", _raise)
    with pytest.raises(AssertionError, match="split-path kernel"):
        tstep.tendencies(TG, args[1], args[2], args[4], args[6])
    lesstage.stage_fused_reference(*args)


@pytest.mark.parametrize("subgrid, scheme", [("smagorinsky", "hybrid52"),
                                             ("tke", "cd2"),
                                             ("tke", "hybrid62")])
def test_stage_refuses_physics_it_does_not_implement(monkeypatch, subgrid,
                                                     scheme):
    """stage_fused raises for physics outside lesstage.supported (on the
    CPU too, and before any CUDA work); substep then takes the split
    path and never calls it."""
    phys = tstep.LESPhysics(subgrid=subgrid, scheme=scheme)
    assert not lesstage.supported(phys)
    assert lesstage.supported(tstep.LESPhysics())
    cur, base, frc = _stage_setup()
    args = (TG, phys, _state(cur),
            _state(base), _forcing(frc),
            0.5, torch.tensor([2.0]))
    for fn in (lesstage.stage_fused, lesstage.stage_fused_cuda):
        with pytest.raises(ValueError, match="implements subgrid='tke'"):
            fn(*args)
    monkeypatch.setattr(lesstage, "stage_fused", _raise)
    s, kmax = tstep.substep(TG, phys, args[2], args[4], args[6])
    assert bool(torch.isfinite(s.thl).all()) and float(kmax[0]) >= 0.0


# ---- launch geometry of the stage kernel ---------------------------------

def _block_region(geom, nz, ny, nx, bx, by, bz):
    """The points block (bx, by, bz) updates, as csrc/lesstage.cu's k_stage
    maps its block index: (instance, level range, y range, x range), each
    range [lo, hi) clipped to the grid."""
    x0, y0 = (bx % geom.tiles_x) * geom.tx, (bx // geom.tiles_x) * geom.ty
    k0 = by * geom.tz
    return (bz, (k0, min(nz, k0 + geom.tz)), (y0, min(ny, y0 + geom.ty)),
            (x0, min(nx, x0 + geom.tx)))


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 3), nz=st.integers(2, 48), ny=st.integers(4, 40),
       nx=st.integers(4, 40), tz=st.one_of(st.none(), st.integers(1, 50)))
def test_stage_geometry_covers_every_point_once(n, nz, ny, nx, tz):
    """The blocks of the launch, as the kernel maps them to points
    (_block_region), update every (instance, level, column) exactly once,
    and a block's shared memory stays within what sm_90 allows."""
    g = lesstage.stage_geometry(n, nz, ny, nx, tz)
    assert g.smem <= tiling.SMEM_LIMIT == 227 * 1024
    assert (g.tiles_x, g.tiles_y) == (-(-nx // g.tx), -(-ny // g.ty))
    assert g.chunks == -(-nz // g.tz) and (tz is None or g.tz == tz)
    hits = np.zeros((n, nz, ny, nx), np.int32)
    for bz in range(n):
        for by in range(g.chunks):
            for bx in range(g.tiles_x * g.tiles_y):
                b, (k0, k1), (y0, y1), (x0, x1) = _block_region(
                    g, nz, ny, nx, bx, by, bz)
                assert k0 < k1   # no chunk is empty
                hits[b, k0:k1, y0:y1, x0:x1] += 1
    assert (hits == 1).all()


def test_stage_geometry_of_the_main_path():
    """64x64x160: 32x8 tiles, one wave of 256 blocks (2 on each of 132
    SMs hold 264) for n = 1 and 2; at nz = 157 the last chunk is short."""
    g1 = lesstage.stage_geometry(1, 160, 64, 64)
    g2 = lesstage.stage_geometry(2, 160, 64, 64)
    assert (g1.tx, g1.ty, g1.tz, g1.blocks) == (32, 8, 10, 256)
    assert (g2.tz, g2.blocks) == (20, 256)
    g3 = lesstage.stage_geometry(2, 157, 64, 64)
    assert (g3.tz, g3.chunks, 157 % g3.tz) == (20, 8, 17)
    assert g1.smem == lesstage.shared_bytes() == 91008


def test_stage_geometry_default_chunks():
    """On a small grid every block fits in one wave at any tz, so the
    default chunk is one level (a block marches several levels there only
    with tz given); the chunk search runs once per shape."""
    assert lesstage.stage_geometry(3, 20, 10, 12).tz == 1
    assert lesstage.stage_geometry(2, 32, 16, 16).tz == 1
    lesstage.stage_geometry(1, 160, 64, 64)
    before = tiling.chunk_levels.cache_info()
    g = lesstage.stage_geometry(1, 160, 64, 64)
    after = tiling.chunk_levels.cache_info()
    assert g.tz == 10
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)


def test_stage_geometry_refuses(monkeypatch):
    with pytest.raises(ValueError, match="tz must be"):
        lesstage.stage_geometry(1, 32, 16, 16, tz=0)
    monkeypatch.setattr(tiling, "SMEM_LIMIT", 48 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        lesstage.stage_geometry(1, 32, 64, 64)


# ---- the on-card option check of the stage must be able to fail ----------

def _mutant(change):
    """The plain stage with its physics options changed by change(phys):
    a stand-in for a kernel that gets an option wrong."""
    def kern(grid, phys, *rest):
        return lesstage.stage_fused_reference(grid, change(phys), *rest)
    return kern


OPTION_MUTANTS = {
    "coriolis sign": lambda p: p._replace(f_coriolis=-p.f_coriolis),
    "coriolis dropped": lambda p: p._replace(f_coriolis=0.0),
    "qt mode 3 as 2": lambda p: p._replace(
        qt_forcing=2 if p.qt_forcing == 3 else p.qt_forcing),
    "qt mode 2 as 0": lambda p: p._replace(
        qt_forcing=0 if p.qt_forcing == 2 else p.qt_forcing),
}


@pytest.fixture(scope="module")
def rough():
    grid = tgrid.LESGrid(nx=16, ny=16, nz=32)
    cur, _, frc, dt = cs.rough_inputs(grid, 2, 9, "cpu")
    return grid, cur, frc, dt


@pytest.mark.parametrize("mutant", sorted(OPTION_MUTANTS))
def test_option_check_rejects_a_wrong_option(rough, mutant):
    with pytest.raises(AssertionError, match="out of tolerance"):
        cs.check_options(_mutant(OPTION_MUTANTS[mutant]), *rough)


def test_option_check_accepts_the_plain_version(rough):
    res = cs.check_options(lesstage.stage_fused_reference, *rough)
    assert set(res) == {"f_coriolis=0.0001", "qt_forcing=1", "qt_forcing=2",
                        "qt_forcing=3"}
