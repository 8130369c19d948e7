"""Coupling modules of the PyTorch port vs the JAX package, and the slice as
a whole: the port's CoupledStepFn against the JAX CoupledStepFn.

Inputs are real GCM columns (T10/L8, columns 100 and 200 as in
tests/test_gcm.py and tests/test_parallel.py) and LES fleets of 16x16x32
seeded from them, all built in JAX and carried over as numpy. Single
functions agree within rtol 1e-5, atol 1e-6 max|ref| (both sides are
float32 on the CPU and differ only in the order of operations).
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from sp_coupler_tpu.coupling import convert as jconv
from sp_coupler_tpu.coupling.coupler import CoupledStepFn as JStepFn
from sp_coupler_tpu.models.gcm import model as jmodel
from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, diag as jdiag)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.coupling import convert as tconv
from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn as TStepFn
from sp_coupler_tpu_torch.models.gcm import model as tmodel
from sp_coupler_tpu_torch.parallel import mesh as pmesh
from sp_coupler_tpu_torch.models.les import (grid as tgrid, step as tstep,
                                             diag as tdiag)

torch.set_num_threads(2)

TRUNC, NLEV, DT = 10, 8, 300.0
COLS = np.asarray([100, 200], np.int32)
JG = jgrid.LESGrid(nx=16, ny=16, nz=32)
TG = tgrid.LESGrid(nx=16, ny=16, nz=32)
# the bench column depth (160 x 25 m): GCM layers lie inside it, so the
# remaps onto GCM levels have non-zero rows
JG_TALL = jgrid.LESGrid(nx=16, ny=16, nz=160)
TG_TALL = tgrid.LESGrid(nx=16, ny=16, nz=160)


def _np(x):
    return jax.tree.map(np.asarray, x)


def close(got, ref, rtol=1e-5, atol_frac=1e-6, msg="", floor=1e-30):
    """|got - ref| <= atol_frac max(max|ref|, floor) + rtol |ref|."""
    ref = np.asarray(ref, np.float64)
    got = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float64)
    scale = max(float(np.max(np.abs(ref))), floor)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


@pytest.fixture(scope="module")
def case():
    """JAX GCM state, post-cloud column profiles, and an LES fleet seeded
    from them (bench.py:49-61), with some cloud added at low levels."""
    core = jmodel.GCMCore(jmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT))
    gs = core.initial_state(seed=0)
    gs_half = core.phase_cloud(core._phase_a_body(gs, True))
    prof = core.column_profiles(gs_half, jnp.asarray(COLS))
    conv = jax.vmap(lambda p: jconv.convert_profiles(p, JG.zf()))(prof)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(42), i))(
        jnp.arange(len(COLS)))
    les = jax.vmap(lambda u, v, thl, qt, ps, k: jstate.init_state(
        JG, u, v, thl, qt, ps, k))(conv.u, conv.v, conv.thl, conv.qt,
                                    conv.ps, keys)
    rng = np.random.default_rng(1)
    wet = rng.uniform(0.0, 6e-3, les.qt.shape).astype(np.float32)
    wet[:, 8:] = 0.0
    cloudy = les._replace(qt=les.qt + jnp.asarray(wet),
                          qr=jnp.asarray(rng.uniform(
                              0, 1e-4, les.qr.shape).astype(np.float32)))
    return dict(core=core, gs=gs, prof=prof, conv=conv, les=les,
                cloudy=cloudy)


def _tall_conv(case):
    return jax.vmap(lambda p: jconv.convert_profiles(p, JG_TALL.zf()))(
        case["prof"])


@pytest.mark.parametrize("tall", [False, True])
def test_convert_profiles(case, tall):
    ref = _tall_conv(case) if tall else case["conv"]
    conv = tconv.convert_profiles(
        interop.les_profiles(_np(case["prof"]), "cpu"),
        (TG_TALL if tall else TG).zf("cpu"))
    for k, r in ref._asdict().items():
        close(getattr(conv, k), r, msg=k)


def test_slab_profiles(case):
    ref = jax.vmap(lambda s: jdiag.slab_profiles(JG, s))(case["cloudy"])
    got = tdiag.slab_profiles(
        TG, interop.les_state(_np(case["cloudy"]), "cpu"))
    assert float(jnp.max(ref["QL"])) > 0.0
    assert sorted(got) == sorted(ref)
    for k in ref:
        close(got[k], ref[k], msg=k)


def test_cloud_fraction_on_gcm_levels(case):
    rng = np.random.default_rng(2)
    cf = rng.uniform(0, 1, (len(COLS), JG_TALL.nz)).astype(np.float32)
    zh = _tall_conv(case).Zh
    ref = jax.vmap(lambda c, z: jdiag.cloud_fraction_on_gcm_levels(
        JG_TALL, c, z))(jnp.asarray(cf), zh)
    got = tdiag.cloud_fraction_on_gcm_levels(
        TG_TALL, torch.tensor(cf), torch.tensor(np.asarray(zh)))
    assert float(jnp.max(ref)) > 0.0
    close(got, ref)


def _les_prof(case):
    return jax.vmap(lambda s: jdiag.slab_profiles(JG, s))(case["cloudy"])


def test_les_forcings(case):
    lp = {k: v for k, v in _les_prof(case).items()
          if k in ("U", "V", "THL", "QT", "QL", "PS")}
    ref = jax.vmap(lambda cv, p: jconv.les_forcings(cv, p, DT, 0.5))(
        case["conv"], lp)
    conv_t = tconv.ConvertedProfiles(
        **interop.les_profiles(_np(case["conv"]), "cpu"))
    got = tconv.les_forcings(conv_t, interop.les_profiles(_np(lp), "cpu"),
                             DT, 0.5)
    assert sorted(got) == sorted(ref)
    for k in ref:
        close(got[k], ref[k], msg=k)


def _tall_les_prof(case):
    """LES slab means on the tall grid: the GCM column interpolated to it
    plus seeded numpy noise, with a cloud layer."""
    conv = _tall_conv(case)
    rng = np.random.default_rng(3)
    z = np.asarray(JG_TALL.zf())
    n = len(COLS)
    noise = lambda s: rng.normal(0, s, (n, z.size)).astype(np.float32)
    ql = np.where((z > 600) & (z < 1500), 3e-4, 0.0).astype(np.float32)
    prof = dict(U=np.asarray(conv.u) + noise(0.5),
                V=np.asarray(conv.v) + noise(0.5),
                THL=np.asarray(conv.thl) + noise(0.2),
                QT=np.asarray(conv.qt) + noise(1e-4),
                QL=np.tile(ql, (n, 1)), QL_ice=np.tile(0.1 * ql, (n, 1)),
                T=np.asarray(conv.thl) - 9.8e-3 * z + noise(0.2),
                Rhobf=np.tile(1.2 * np.exp(-z / 8000.0), (n, 1)))
    return conv, {k: v.astype(np.float32) for k, v in prof.items()}


@pytest.mark.parametrize("conservative", [False, True])
def test_gcm_tendencies(case, conservative):
    conv, lp = _tall_les_prof(case)
    A_d = np.random.default_rng(4).uniform(
        0, 1, (len(COLS), NLEV)).astype(np.float32)
    ref_t, ref_d = jax.vmap(lambda p, cv, l, a: jconv.gcm_tendencies(
        p, cv, l, a, JG_TALL.zf(), JG_TALL.zh(), DT,
        conservative=conservative))(
        case["prof"], conv, {k: jnp.asarray(v) for k, v in lp.items()},
        jnp.asarray(A_d))
    got_t, got_d = tconv.gcm_tendencies(
        interop.les_profiles(_np(case["prof"]), "cpu"),
        tconv.ConvertedProfiles(**interop.les_profiles(_np(conv), "cpu")),
        interop.les_profiles(lp, "cpu"), torch.tensor(A_d),
        TG_TALL.zf("cpu"), TG_TALL.zh("cpu"), DT, conservative=conservative)
    assert np.count_nonzero(np.asarray(ref_t["T"])) >= 2 * len(COLS)
    for ref, got in ((ref_t, got_t), (ref_d, got_d)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            close(got[k], ref[k], msg=k)


# ---- the slice as a whole -------------------------------------------------

# Bounds of the whole-step comparison: atol 2e-3 max(max|ref|, 1e-12),
# rtol 2e-3 (the rule of tests/test_ops.py:231), except for two
# diagnostics that are small differences of large float32 values. The
# measured errors below are the largest |got - ref| - 2e-3 |ref| over
# both steps, as a fraction of max|ref|:
#   forcing f_thl = (thl_GCM - <thl>_LES)/dt: two ~300 K values 0.02 K
#     apart, so one float32 ulp of thl (3e-5 K) is 1.5e-3 of max|f_thl|;
#     the GCM's spectral transforms, summed in another order, leave a few
#     ulps in thl_GCM. Measured 2.0e-2.
#   les qt_std: the slab standard deviation of qt (1e-6 against qt ~1e-2,
#     one ulp of qt is 8e-4 of it), grown by the LES's chaotic dynamics
#     over 2 x 300 s. Measured 6.4e-3.
# Everything else stays within the rule (largest: f_qt, 1.5e-3).
LOOSE = {("forcing", "f_thl"): 5e-2, ("les", "qt_std"): 2e-2}


@pytest.fixture(scope="module", params=["tke", "smagorinsky"])
def coupled(case, request):
    """Two coupled steps (first=True, then first=False), adaptive, through
    the JAX CoupledStepFn (use_pallas=False) and the port's, from the same
    states, for each LES closure. The port runs with use_kernel: on the
    CPU, the fused stage's plain version (TKE) or the split path through
    the scalar and momentum kernel modules' plain versions (Smagorinsky)."""
    subgrid = request.param
    core_t = tmodel.GCMCore(tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT),
                            device="cpu")
    fn_j = JStepFn(case["core"], JG,
                   jstep.LESPhysics(subgrid=subgrid, use_pallas=False),
                   COLS, dt_les=15.0, n_substeps=0)
    fn_t = TStepFn(core_t, TG, tstep.LESPhysics(subgrid=subgrid), COLS,
                   dt_les=15.0, n_substeps=0)
    gs_j, les_j = case["gs"], case["les"]
    prof_j = jax.vmap(lambda s: jdiag.slab_profiles(JG, s))(les_j)
    gs_t = interop.gcm_state(_np(gs_j), "cpu")
    les_t = interop.les_state(_np(les_j), "cpu")
    prof_t = interop.les_profiles(_np(prof_j), "cpu")
    rain_j = np.zeros(len(COLS), np.float32)
    rain_t = torch.zeros(len(COLS))
    steps = []
    for step, first in ((0, True), (1, False)):
        gs_j, les_j, prof_j, rain_j, d_j = jax.block_until_ready(
            fn_j(gs_j, les_j, prof_j, rain_j, step, first=first))
        gs_t, les_t, prof_t, rain_t, d_t = fn_t(gs_t, les_t, prof_t, rain_t,
                                                step, first=first)
        steps.append(dict(
            prof_j=_np(prof_j), prof_t=interop.to_numpy(prof_t),
            grid_j=_np(gs_j.grid)._asdict(), grid_t=interop.to_numpy(gs_t.grid),
            diag_j=fn_j.unpack_diag(np.asarray(d_j)),
            diag_t=fn_t.unpack_diag(d_t)))
    return steps


@pytest.mark.parametrize("step", [0, 1])
def test_coupled_substep_counts_equal(coupled, step):
    s = coupled[step]
    for k in ("n_substeps", "n_dtmin_clamped"):
        np.testing.assert_array_equal(s["diag_t"][k], s["diag_j"][k])
    assert np.all(s["diag_t"]["n_substeps"] > 0)


@pytest.mark.parametrize("step", [0, 1])
def test_coupled_profiles_and_gcm_grid(coupled, step):
    s = coupled[step]
    for k in ("THL", "QT", "U", "V"):
        close(s["prof_t"][k], s["prof_j"][k], rtol=2e-3, atol_frac=2e-3,
              msg="profile " + k, floor=1e-12)
    for k in ("T", "q"):
        close(s["grid_t"][k], s["grid_j"][k], rtol=2e-3, atol_frac=2e-3,
              msg="grid " + k, floor=1e-12)


@pytest.mark.parametrize("step", [0, 1])
def test_coupled_diag_matches(coupled, step):
    """The unpacked diag: same tree, same leaves, within the bounds above."""
    s = coupled[step]
    leaves_j = jtu.tree_flatten_with_path(s["diag_j"])[0]
    leaves_t = jtu.tree_flatten_with_path(s["diag_t"])[0]
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    for (path, b), (_, a) in zip(leaves_j, leaves_t):
        key = tuple(getattr(p, "key", getattr(p, "name", None))
                    for p in path)
        assert np.shape(a) == np.shape(b), key
        close(a, b, rtol=2e-3, atol_frac=LOOSE.get(key, 2e-3), msg=str(key),
              floor=1e-12)


def test_unported_coupler_settings_raise():
    """A spatial mesh is ported: the coupled step takes this rank's block
    of the planes (tests/test_torch_spatial.py steps it on 4 ranks), and
    refuses a plane the mesh does not divide."""
    core = tmodel.GCMCore(tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT),
                          device="cpu")
    fn = TStepFn(core, TG, tstep.LESPhysics(), COLS, 15.0, 0,
                 mesh=pmesh.LesMesh(1, 1, x=2, y=1))
    assert fn.mesh is not None and fn.mesh.shape == {"les": 1, "x": 2,
                                                     "y": 1}
    assert (fn.plane.y0, fn.plane.by, fn.plane.x0, fn.plane.bx) == (
        0, 16, 8, 8)
    with pytest.raises(ValueError, match="does not split into 1 x 3"):
        TStepFn(core, TG, tstep.LESPhysics(), COLS, 15.0, 0,
                mesh=pmesh.LesMesh(1, 0, x=3, y=1))
    # the surface coupling, the nudge, the phased step, the chunked
    # evolve and a les mesh of one slot (no mesh) are ported
    assert TStepFn(core, TG, tstep.LESPhysics(), COLS, 15.0, 0,
                   mesh=pmesh.LesMesh(1, 0)).mesh is None
    fn = TStepFn(core, TG, tstep.LESPhysics(), COLS, 15.0, 0, cplsurf=True,
                 qt_variance=True, evolve_chunks=3)
    assert fn.cplsurf and fn.qt_variance and callable(fn.call_phased)
    assert fn.evolve_chunks == 3
