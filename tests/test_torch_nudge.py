"""The coupler branches of the port against the JAX package: the
variability nudge (``fields_3d``, ``variability_nudge``), the surface
coupling (``surface_fields``, ``convert_surface_fluxes``), whole coupled
steps with ``cplsurf`` and with ``qt_variance``, and ``call_phased``.

Inputs are real GCM columns (T10/L8, columns 100 and 200) and LES fleets
of 16x16x32 seeded from them, built in JAX and carried over as numpy; the
nudge's normal draws are JAX's, injected into the port. Single functions
agree within rtol 1e-5 and 1e-6 of max|ref|, as in test_torch_coupling.py,
except where stated.
"""

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch

from sp_coupler_tpu.coupling import convert as jconv, nudge as jnudge
from sp_coupler_tpu.coupling.coupler import CoupledStepFn as JStepFn
from sp_coupler_tpu.models.gcm import model as jmodel
from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, diag as jdiag)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.coupling import convert as tconv, nudge as tnudge
from sp_coupler_tpu_torch.coupling.coupler import CoupledStepFn as TStepFn
from sp_coupler_tpu_torch.models.gcm import model as tmodel
from sp_coupler_tpu_torch.models.les import (grid as tgrid, step as tstep,
                                             diag as tdiag)

torch.set_num_threads(2)

TRUNC, NLEV, DT = 10, 8, 300.0
COLS = np.asarray([100, 200], np.int32)
JG = jgrid.LESGrid(nx=16, ny=16, nz=32)
TG = tgrid.LESGrid(nx=16, ny=16, nz=32)
SEED = 42


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


def jax_draws(seed, step_idx, n, ny, nx):
    """The JAX coupler's nudge draws for step step_idx (coupler.py:191-
    199): one key per instance split from fold_in(PRNGKey(seed + 1), step)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step_idx)
    keys = jax.random.split(key, n)
    return jax.vmap(lambda k: jax.random.normal(k, (ny, nx),
                                                jnp.float32))(keys)


@pytest.fixture(scope="module")
def case():
    """JAX GCM state after the first half step, its column profiles and
    an LES fleet seeded from them with cloud at low levels."""
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
    cloudy = les._replace(qt=les.qt + jnp.asarray(wet))
    return dict(core=core, gs=gs, gs_half=gs_half, prof=prof, conv=conv,
                les=les, cloudy=cloudy)


def test_fields_3d(case):
    ref = jax.vmap(jdiag.fields_3d)(case["cloudy"])
    got = tdiag.fields_3d(interop.les_state(_np(case["cloudy"]), "cpu"))
    assert sorted(got) == sorted(ref)
    assert float(jnp.max(ref["QL"])) > 0.0
    for k in ref:
        close(got[k], ref[k], msg=k)


def nudge_inputs(case):
    """Fields of the fleet with qsat flattened to its plane means and qt
    set as qsat (1 + s), s drawn per level, so that the nudge takes every
    branch, and the GCM reference ql_ref: at levels 0-1
    more condensate than scaling the fluctuations can give (additive
    noise); at 2-5 1.5x the LES's (a multiplicative beta); at 6-7, mostly
    unsaturated with a few cloudy cells, none (scaled to barely
    unsaturated); above, LES and GCM clear (no nudge)."""
    f = _np(jax.vmap(jdiag.fields_3d)(case["cloudy"]))
    qs = f["Qsat"] = np.broadcast_to(
        f["Qsat"].mean(axis=(2, 3), keepdims=True), f["Qsat"].shape).copy()
    rng = np.random.default_rng(5)
    lo = np.full(qs.shape[1], -0.3)
    hi = np.full(qs.shape[1], -0.1)
    lo[:6], hi[:6] = -0.05, 0.15
    hi[6:8] = 0.02
    s = rng.uniform(0, 1, qs.shape) * (hi - lo)[:, None, None] \
        + lo[:, None, None]
    f["QT"] = (qs * (1.0 + s)).astype(np.float32)
    ql_mean = np.maximum(f["QT"] - qs, 0.0).mean(axis=(2, 3))
    ql_ref = np.zeros_like(ql_mean)
    ql_ref[:, 0:2] = 0.5 * qs[:, 0:2].mean(axis=(2, 3))
    ql_ref[:, 2:6] = 1.5 * ql_mean[:, 2:6]
    return f, ql_ref.astype(np.float32), ql_mean


@pytest.mark.parametrize("constant_T", [False, True])
def test_variability_nudge(case, constant_T):
    f, ql_ref, ql_mean = nudge_inputs(case)
    p = np.asarray(case["cloudy"].pbf)
    n = len(COLS)
    R = jax_draws(SEED, 3, n, JG.ny, JG.nx)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), 3)
    ref = _np(jax.vmap(
        lambda qt, thl, qs, qlr, pp, k: jnudge.variability_nudge(
            qt, thl, qs, qlr, pp, k, DT, constant_T=constant_T))(
        f["QT"], f["THL"], f["Qsat"], ql_ref, p, jax.random.split(key, n)))
    t = lambda a: torch.tensor(np.asarray(a))
    got = tnudge.variability_nudge(t(f["QT"]), t(f["THL"]), t(f["Qsat"]),
                                   t(ql_ref), t(p), DT, R=t(R),
                                   constant_T=constant_T)
    # every branch was taken: additive levels keep beta = 1 and change qt,
    # multiplicative ones scale it, GCM-clear cloudy levels shrink it
    beta = ref.beta
    assert np.all(beta[:, 0:2] == 1.0) and np.all(beta[:, 2:6] > 1.0)
    assert np.all(beta[:, 6:8] < 1.0) and np.all(beta[:, 8:] == 1.0)
    assert np.all(ql_mean[:, 6:8] > 0.0) and np.all(ql_mean[:, 8:] == 0.0)
    assert np.all(np.abs(ref.qt - f["QT"])[:, 0:2].max(axis=(2, 3)) > 0)
    if constant_T:
        assert np.abs(ref.thl - f["THL"]).max() > 0.0
    for k in ("qt", "thl", "beta", "alpha", "qt_std"):
        close(getattr(got, k), getattr(ref, k), msg=k)


def test_variability_nudge_draws_from_generator(case):
    """Without R the nudge draws its noise from the generator: the same
    generator state gives the same result as the R it would draw."""
    f, ql_ref, _ = nudge_inputs(case)
    t = lambda a: torch.tensor(np.asarray(a))
    args = (t(f["QT"]), t(f["THL"]), t(f["Qsat"]), t(ql_ref),
            t(np.asarray(case["cloudy"].pbf)), DT)
    R = torch.randn((len(COLS), TG.ny, TG.nx),
                    generator=torch.Generator().manual_seed(7))
    a = tnudge.variability_nudge(*args, generator=torch.Generator()
                                 .manual_seed(7))
    b = tnudge.variability_nudge(*args, R=R)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_convert_surface_fluxes(case):
    cols_j = jnp.asarray(COLS)
    surf_j = case["core"].surface_fields(case["gs_half"], cols_j)
    prof = case["prof"]
    ref = jax.vmap(jconv.convert_surface_fluxes)(
        surf_j, prof["Phalf"][:, -1], prof["T"][:, -1])
    core_t = tmodel.GCMCore(tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT),
                            device="cpu")
    gs_t = interop.gcm_state(_np(case["gs_half"]), "cpu")
    surf_t = core_t.surface_fields(gs_t, torch.as_tensor(COLS,
                                                         dtype=torch.int64))
    assert sorted(surf_t) == sorted(surf_j)
    for k in surf_j:
        close(surf_t[k], surf_j[k], rtol=0.0, atol_frac=0.0, msg=k)
    pt = interop.les_profiles(_np(prof), "cpu")
    got = tconv.convert_surface_fluxes(surf_t, pt["Phalf"][:, -1],
                                       pt["T"][:, -1])
    assert float(jnp.max(jnp.abs(ref[2]))) > 0.0      # wthl
    assert float(jnp.max(jnp.abs(ref[3]))) > 0.0      # wqt
    for name, a, b in zip(("z0m", "z0h", "wthl", "wqt"), got, ref):
        close(a, b, msg=name)


# ---- whole coupled steps with the branches on ------------------------------

# the bounds of test_torch_coupling.py (2e-3 rule, f_thl and the LES
# qt_std at their stated 5e-2 and 2e-2), for the same state and steps
LOOSE = {("forcing", "f_thl"): 5e-2, ("les", "qt_std"): 2e-2}


@pytest.fixture(scope="module")
def branch_steps(case):
    """Two coupled steps (first=True, then first=False) through the JAX
    CoupledStepFn and the port's from the same carried state, with both
    branches on; the port's nudge draws are the JAX coupler's. The GCM
    starts with 1.6x its humidity, so that its lowest layer holds cloud
    water: the nudge's ql_ref is significant at every LES level, where the
    LES is clear, and the nudge adds noise (its additive branch)."""
    core_t = tmodel.GCMCore(tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT),
                            device="cpu")
    kw = dict(cplsurf=True, qt_variance=True, seed=SEED)
    fn_j = JStepFn(case["core"], JG, jstep.LESPhysics(use_pallas=False),
                   COLS, dt_les=15.0, n_substeps=0, **kw)
    fn_t = TStepFn(core_t, TG, tstep.LESPhysics(), COLS, dt_les=15.0,
                   n_substeps=0, **kw)
    fn_t.nudge_noise = lambda step_idx: torch.tensor(np.asarray(
        jax_draws(SEED, step_idx, len(COLS), TG.ny, TG.nx)))
    moist = lambda sp: sp._replace(q=1.6 * sp.q)
    gs_j = case["gs"]
    gs_j = gs_j._replace(now=moist(gs_j.now), prev=moist(gs_j.prev),
                         new=moist(gs_j.new))
    les_j = case["les"]
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
        steps.append(dict(diag_j=fn_j.unpack_diag(np.asarray(d_j)),
                          diag_t=fn_t.unpack_diag(d_t)))
    return steps


@pytest.mark.parametrize("step", [0, 1])
def test_branch_step_diag_matches(branch_steps, step):
    """The unpacked diag of each step: same tree, same leaves, within the
    bounds of test_torch_coupling.py; the surface fluxes reach the LES and
    the nudge acts on the second step only."""
    s = branch_steps[step]
    leaves_j = jtu.tree_flatten_with_path(s["diag_j"])[0]
    leaves_t = jtu.tree_flatten_with_path(s["diag_t"])[0]
    assert [p for p, _ in leaves_t] == [p for p, _ in leaves_j]
    assert np.all(s["diag_j"]["wthl"] != 0.0)
    assert np.all(s["diag_j"]["wqt"] != 0.0)
    beta = s["diag_j"]["qt_beta"]
    if step == 0:
        assert np.all(beta == 0.0)
    else:
        # additive noise: beta 1 where ql_ref is significant, and the
        # nudged qt spreads more than the state it started from (as much
        # where the LES already holds ql_ref)
        assert np.all(s["diag_j"]["conv"].ql > 1e-9) and np.all(beta == 1.0)
        std0 = branch_steps[0]["diag_j"]["les"]["qt_std"]
        assert np.all(s["diag_j"]["qt_std"] >= std0)
        assert np.mean(s["diag_j"]["qt_std"] > std0) > 0.5
    np.testing.assert_array_equal(s["diag_t"]["n_substeps"],
                                  s["diag_j"]["n_substeps"])
    for (path, b), (_, a) in zip(leaves_j, leaves_t):
        key = tuple(getattr(p, "key", getattr(p, "name", None))
                    for p in path)
        assert np.shape(a) == np.shape(b), key
        close(a, b, rtol=2e-3, atol_frac=LOOSE.get(key, 2e-3), msg=str(key),
              floor=1e-12)


def test_call_phased_equals_call(case):
    """call_phased runs the same step as __call__, in three phases: the
    same outputs from the same inputs, and three phase times."""
    core_t = tmodel.GCMCore(tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT),
                            device="cpu")
    fn = TStepFn(core_t, TG, tstep.LESPhysics(), COLS, dt_les=15.0,
                 n_substeps=3, cplsurf=True, qt_variance=True)
    gs = interop.gcm_state(_np(case["gs"]), "cpu")
    les = interop.les_state(_np(case["cloudy"]), "cpu")
    prof = tdiag.slab_profiles(TG, les)
    rain = torch.zeros(len(COLS))
    for first in (True, False):
        a = fn(gs, les, prof, rain, 5, first=first)
        b, times = fn.call_phased(gs, les, prof, rain, 5, first=first)
        assert len(times) == 3 and all(x >= 0.0 for x in times)
        la = [interop.to_numpy(x) for x in a[:4]] + [fn.unpack_diag(a[4])]
        lb = [interop.to_numpy(x) for x in b[:4]] + [fn.unpack_diag(b[4])]
        for x, y in zip(jtu.tree_leaves(la), jtu.tree_leaves(lb)):
            np.testing.assert_array_equal(x, y)
