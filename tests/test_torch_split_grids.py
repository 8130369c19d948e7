"""The split stage's kernel branch on every grid, against the JAX package.

``models/les/step.py::tendencies`` takes the scalar and momentum kernel
wrappers (``ops/lesflat.py``, ``ops/lesmom.py``) under ``use_kernel`` on
every grid: the physics alone picks the branch. The JAX package takes its
Pallas kernels only on the TPU's lane grids (ny*nx a multiple of 128, nz
of 16); elsewhere it runs its plain split path, which adds the surface
fluxes inside ``diffuse_scalar`` where the kernel branch adds them on
plane 0 afterwards: the same sum in another order.

- ``test_split_tendencies_on_grid``: on grids inside and outside the lane
  rule (the bench's 64x64x160, the T255 case's 128x128x160, 16x16x32, a
  10x10 plane, nz = 24, a ragged 12x10x20 and 8x8x9), the port's
  tendencies with use_kernel (the wrappers' plain versions on the CPU)
  against JAX's plain split tendencies from the same numpy state, for
  Smagorinsky/hybrid52, TKE/cd2 and TKE/hybrid62, at the split path's
  tolerances (tests/test_torch_les.py::test_split_tendencies_match_jax;
  kmax at its closure's, KMAX_TOL), and against the port's own plain
  branch (use_kernel=False). The wrappers are counted: the scalar one
  runs with hybrid52 alone, the momentum one with every scheme.
- ``test_coupled_step_off_the_lane_grid``: one coupled step (T10/L8 + 2 x
  12x10x20, Smagorinsky, adaptive) of the port against the JAX
  CoupledStepFn, at tests/test_torch_coupling.py's bounds.

The blocked case (a Smagorinsky evolve on a 16x12 plane on 2 x 1 blocks)
is a case of tests/test_torch_spatial.py::test_blocked_evolve_matches;
the kernels themselves at 64x64x150 and 60x60x160 are in
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.coupling.coupler import CoupledStepFn as JStepFn
from sp_coupler_tpu.coupling import convert as jconv
from sp_coupler_tpu.models.gcm import model as jmodel
from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, diag as jdiag)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn as TStepFn
from sp_coupler_tpu_torch.models.gcm import model as tmodel
from sp_coupler_tpu_torch.models.les import grid as tgrid, step as tstep
from sp_coupler_tpu_torch.ops import lesflat, lesmom
from test_torch_coupling import close

torch.set_num_threads(2)

# (nx, ny, nz): the lane grids 64x64x160, 128x128x160 and 16x16x32; off
# the rule 10x10x160 (100 points a plane), 16x16x24 (nz), 12x10x20 (both;
# a ragged 32x8 tile on the card) and 8x8x9
GRIDS = [(64, 64, 160), (128, 128, 160), (16, 16, 32), (10, 10, 160),
         (16, 16, 24), (12, 10, 20), (8, 8, 9)]
PATHS = [("smagorinsky", "hybrid52"), ("tke", "cd2"), ("tke", "hybrid62")]
FIELD_TOL = dict(atol=5e-5, rtol=1e-4)     # test_split_tendencies_match_jax
# kmax is the largest Km, so it carries the closure's own bound against
# JAX: the TKE closure's rtol 1e-3 (test_split_tendencies_match_jax), the
# Smagorinsky closure's 5e-3 of max|Km| (tests/test_torch_les.py::
# test_eddy_viscosity: its stability factor sqrt(1 - Ri/Ri_c) moves
# steeply with the last bits of N^2 near its clip; at 64x64x160 the
# largest Km lies 4.1e-3 off JAX's on the kernel and the plain branch
# alike)
KMAX_TOL = {"tke": dict(rtol=1e-3, atol_frac=1e-6),
            "smagorinsky": dict(rtol=0.0, atol_frac=5e-3)}


def lane_rule(nx, ny, nz):
    """Where the JAX package takes its Pallas kernels
    (sp_coupler_tpu/ops/lesflat_pallas.py::supported)."""
    return (nx * ny) % 128 == 0 and nz % 16 == 0


@functools.lru_cache(maxsize=1)
def _case(nx, ny, nz):
    """A physical JAX state on the grid with w, qr and e12 perturbed, and
    a forcing with surface fluxes, roughness and profile tendencies (the
    setup of tests/test_torch_les.py::make_case). Its column is one in
    height on every grid: make_case's 16x16x32 profiles (thl 298 -> 312 K,
    qt 0.016 -> 0.002, u -5 -> 5 m/s over the levels at 12.5 ... 787.5 m),
    thl's gradient continued above 800 m, qt and u constant there."""
    g = jgrid.LESGrid(nx=nx, ny=ny, nz=nz, dz=25.0)
    rng = np.random.default_rng(nx * 1000 + ny * 10 + nz)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    s = (np.asarray(g.zf()) - 12.5) / 775.0
    low = np.minimum(s, 1.0)
    st = jax.jit(lambda *a: jstate.init_state(g, *a, 101300.0,
                                              jax.random.PRNGKey(5)))(
        f32(-5.0 + 10.0 * low), jnp.full(nz, 2.0, jnp.float32),
        f32(298.0 + 14.0 * s), f32(0.016 - 0.014 * low))
    st = st._replace(
        w=st.w.at[1:-1].set(f32(rng.normal(0, 0.1, (nz - 1, ny, nx)))),
        qr=f32(rng.uniform(0, 1e-4, (nz, ny, nx))),
        e12=f32(rng.uniform(0.05, 0.3, (nz, ny, nx))))
    frc = jstate.LESForcing.zeros(nz)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        f_thl=jnp.full(nz, 1e-5), f_qt=jnp.full(nz, -1e-9),
        f_u=jnp.full(nz, 1e-5), f_v=jnp.full(nz, -1e-5),
        z0m=jnp.asarray(0.1))
    return g, st, frc


def count_split_calls(mp):
    """Calls of the split path's two kernel wrappers, by name, counted
    through the monkeypatch mp."""
    calls = dict(lesflat=0, lesmom=0)
    for name, mod, fn in (("lesflat", lesflat, "advect_diffuse_scalars"),
                          ("lesmom", lesmom, "momentum_tendencies")):
        def wrap(*a, _orig=getattr(mod, fn), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        mp.setattr(mod, fn, wrap)
    return calls


@pytest.fixture
def counted(monkeypatch):
    return count_split_calls(monkeypatch)


@pytest.mark.parametrize("subgrid, scheme", PATHS)
@pytest.mark.parametrize("nx, ny, nz", GRIDS)
def test_split_tendencies_on_grid(counted, nx, ny, nz, subgrid, scheme):
    g, st, frc = _case(nx, ny, nz)
    phys = jstep.LESPhysics(subgrid=subgrid, scheme=scheme)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda s, f: jstep.tendencies(g, phys, s, f, 1.0))(st, frc))
    tg = tgrid.LESGrid(nx=nx, ny=ny, nz=nz, dz=25.0)
    args = (interop.les_state(jax.tree.map(np.asarray, st), "cpu"),
            interop.les_forcing(jax.tree.map(np.asarray, frc), "cpu"),
            torch.tensor([1.0]))
    got = tstep.tendencies(
        tg, tstep.LESPhysics(subgrid=subgrid, scheme=scheme), *args)
    assert counted == dict(lesflat=int(scheme == "hybrid52"), lesmom=1), \
        "the kernel branch on %dx%dx%d (lane rule: %s)" % (
            nx, ny, nz, lane_rule(nx, ny, nz))
    plain = tstep.tendencies(
        tg, tstep.LESPhysics(subgrid=subgrid, scheme=scheme,
                             use_kernel=False), *args)
    assert counted == dict(lesflat=int(scheme == "hybrid52"), lesmom=1)
    for k in ("thl", "qt", "qr", "e12", "u", "v", "w"):
        np.testing.assert_allclose(got[k][0].numpy(), ref[k], err_msg=k,
                                   **FIELD_TOL)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                   err_msg=k + " against the plain branch",
                                   **FIELD_TOL)
    assert torch.equal(got["kmax"], plain["kmax"])
    close(got["kmax"], np.reshape(ref["kmax"], (1,)), msg="kmax",
          **KMAX_TOL[subgrid])
    for k in ("ustar", "surf_rain"):
        close(got[k], np.reshape(ref[k], (1,) + np.shape(ref[k])),
              rtol=1e-3, atol_frac=1e-6, msg=k)


# ---- one coupled step off the lane rule -----------------------------------

C_TRUNC, C_NLEV, C_DT = 10, 8, 300.0
C_COLS = np.asarray([100, 200], np.int32)
C_SHAPE = (12, 10, 20)


def test_coupled_step_off_the_lane_grid(counted):
    """One coupled step (first=True) of T10/L8 + 2 x 12x10x20 with the
    Smagorinsky closure: the port (use_kernel: the split path through the
    kernel wrappers' plain versions, 3 calls a substep each) against the
    JAX CoupledStepFn (its plain split path on this grid), from the same
    start: equal substep counts, the THL/QT/U/V profiles and the GCM's T
    and q at tests/test_torch_coupling.py's 2e-3 of max|ref| and rtol
    2e-3."""
    nx, ny, nz = C_SHAPE
    assert not lane_rule(nx, ny, nz)
    jg = jgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    tg = tgrid.LESGrid(nx=nx, ny=ny, nz=nz)
    core_j = jmodel.GCMCore(jmodel.GCMConfig(trunc=C_TRUNC, nlev=C_NLEV,
                                             dt=C_DT))
    gs_j = core_j.initial_state(seed=0)
    prof = core_j.column_profiles(gs_j, jnp.asarray(C_COLS))
    conv = jax.vmap(lambda p: jconv.convert_profiles(p, jg.zf()))(prof)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(42), i))(
        jnp.arange(len(C_COLS)))
    les_j = jax.vmap(lambda u, v, thl, qt, ps, k: jstate.init_state(
        jg, u, v, thl, qt, ps, k))(conv.u, conv.v, conv.thl, conv.qt,
                                    conv.ps, keys)
    prof_j = jax.vmap(lambda s: jdiag.slab_profiles(jg, s))(les_j)
    np_ = lambda x: jax.tree.map(np.asarray, x)
    gs_t = interop.gcm_state(np_(gs_j), "cpu")
    les_t = interop.les_state(np_(les_j), "cpu")
    prof_t = interop.les_profiles(np_(prof_j), "cpu")

    fn_j = JStepFn(core_j, jg, jstep.LESPhysics(subgrid="smagorinsky"),
                   C_COLS, dt_les=15.0, n_substeps=0)
    core_t = tmodel.GCMCore(tmodel.GCMConfig(trunc=C_TRUNC, nlev=C_NLEV,
                                             dt=C_DT), device="cpu")
    fn_t = TStepFn(core_t, tg, tstep.LESPhysics(subgrid="smagorinsky"),
                   C_COLS, dt_les=15.0, n_substeps=0)
    gs_j, _, prof_j, _, d_j = jax.block_until_ready(fn_j(
        gs_j, les_j, prof_j, np.zeros(len(C_COLS), np.float32), 0,
        first=True))
    gs_t, _, prof_t, _, d_t = fn_t(gs_t, les_t, prof_t,
                                   torch.zeros(len(C_COLS)), 0, first=True)
    n_j = fn_j.unpack_diag(np.asarray(d_j))["n_substeps"]
    n_t = fn_t.unpack_diag(d_t)["n_substeps"]
    np.testing.assert_array_equal(n_t, n_j)
    assert np.all(n_t > 0)
    # the fleet steps together: every call covers both instances
    assert counted["lesflat"] == counted["lesmom"] == 3 * int(np.max(n_t))
    prof_j, prof_t = np_(prof_j), interop.to_numpy(prof_t)
    for k in ("THL", "QT", "U", "V"):
        close(prof_t[k], prof_j[k], rtol=2e-3, atol_frac=2e-3,
              msg="profile " + k, floor=1e-12)
    grid_j, grid_t = np_(gs_j.grid)._asdict(), interop.to_numpy(gs_t.grid)
    for k in ("T", "q"):
        close(grid_t[k], grid_j[k], rtol=2e-3, atol_frac=2e-3,
              msg="grid " + k, floor=1e-12)
