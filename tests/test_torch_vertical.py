"""Hybrid vertical coordinates of the PyTorch port vs the JAX package.

The host tables come from the same float64 numpy code cast to float32,
so they must be identical; the per-column coefficients, pressures and
geopotentials are float32 on both sides from the same numpy inputs (a
log or a division in another order: rtol 1e-6 with atol 1e-6 of
max|ref|, measured <= 1 ulp). The property tests of
tests/test_gcm.py:57-130 run on the port. The hybrid Eulerian dycore
takes one step at T21/L8 from a JAX state carried over with
``interop.gcm_state``: the grid fields within rtol 1e-4 plus 1e-5 of
max|ref| (transforms summed in another order; measured <= 1e-5; lnps,
a ~1e-3 field, at 1e-4 of max|ref|), the
spectral tendencies within 1e-4 of max|ref| (small differences of large
grid values at the smallest scales).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu import constants as c
from sp_coupler_tpu.models.gcm import (dycore as jdycore, model as jmodel,
                                       spharm as jsph, vertical as jvert)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.gcm import (dycore as tdycore,
                                             model as tmodel, spharm as tsph,
                                             vertical as tvert)

torch.set_num_threads(2)

TABLES = ("A", "B", "dA", "dB", "sh", "sf", "ds", "lnr", "alpha", "G",
          "Pmat", "W", "b")
# the level sets: sigma, hybrid, and each explicit-table argument
LEVELS = {
    "sigma": dict(),
    "hybrid": dict(hybrid=True),
    "sigma_half": dict(sigma_half=np.linspace(0.0, 1.0, 13) ** 1.4),
    "A_B_half": dict(A_half=jvert.hybrid_ab(12, stretch=1.3)[0],
                     B_half=jvert.hybrid_ab(12, stretch=1.3)[1]),
}


def close(got, ref, rtol, atol_frac, msg=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


def pair(name):
    kw = LEVELS[name]
    return (jvert.VerticalCoords(12, **kw),
            tvert.VerticalCoords(12, device="cpu", **kw))


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_tables_identical(name):
    jv, tv = pair(name)
    assert tv.hybrid == jv.hybrid
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tv, k).numpy(),
                                      np.asarray(getattr(jv, k)), err_msg=k)


def test_hybrid_ab_identical():
    for a, b in zip(jvert.hybrid_ab(19), tvert.hybrid_ab(19)):
        np.testing.assert_array_equal(a, b)


def test_implicit_inverse_holds_every_dt():
    """The SL core asks for five dt's: each equals JAX's and stays
    cached (the same tensor on a second call)."""
    jv, tv = pair("hybrid")
    dts = (900.0 / 4, 900.0 / 2, 900.0, 1.1 * 900.0 / 2, 1.1 * 900.0)
    first = [tv.implicit_inverse(dt, 21) for dt in dts]
    for dt, m in zip(dts, first):
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(jv.implicit_inverse(dt, 21)))
        assert tv.implicit_inverse(dt, 21) is m


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_pressures_and_hybrid_coeffs(name):
    jv, tv = pair(name)
    ps = np.asarray([[7.0e4, 9.5e4], [1.0e5, 1.04e5]], np.float32)
    for a, b in zip(tv.pressures(torch.tensor(ps)),
                    jv.pressures(jnp.asarray(ps))):
        close(a, b, 1e-6, 1e-6)
    hj = jv.hybrid_coeffs(jnp.asarray(ps))
    ht = tv.hybrid_coeffs(torch.tensor(ps))
    assert sorted(ht) == sorted(hj)
    for k in hj:
        close(ht[k], hj[k], 1e-6, 1e-6, k)


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_geopotentials(name):
    """Both geopotentials, with the reference constants and with the
    per-column lnr/alpha of hybrid_coeffs."""
    jv, tv = pair(name)
    rng = np.random.default_rng(1)
    T = rng.uniform(200.0, 300.0, (5, 12)).astype(np.float32)
    ps = rng.uniform(7.0e4, 1.04e5, 5).astype(np.float32)
    hj = jv.hybrid_coeffs(jnp.asarray(ps))
    ht = tv.hybrid_coeffs(torch.tensor(ps))
    Tj, Tt = jnp.asarray(T), torch.tensor(T)
    close(tv.geopotential_full(Tt), jv.geopotential_full(Tj), 1e-6, 1e-6)
    close(tv.geopotential_half(Tt), jv.geopotential_half(Tj), 1e-6, 1e-6)
    close(tv.geopotential_half(Tt, 50.0, lnr=ht["lnr"].T),
          jv.geopotential_half(Tj, 50.0, lnr=hj["lnr"].T), 1e-6, 1e-6)
    close(tv.geopotential_full(Tt, lnr=ht["lnr"].T, alpha=ht["alpha"].T),
          jv.geopotential_full(Tj, lnr=hj["lnr"].T, alpha=hj["alpha"].T),
          1e-6, 1e-6)


# ---- tests/test_gcm.py:57-130 on the port ---------------------------------

def test_ab_reference_state_matches_sigma():
    vs = tvert.VerticalCoords(19, device="cpu")
    vh = tvert.VerticalCoords(19, device="cpu", hybrid=True)
    ps = torch.tensor(c.pref0)
    np.testing.assert_allclose(vh.pressures(ps)[0].numpy(),
                               vs.pressures(ps)[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(vh.G.numpy(), vs.G.numpy(), rtol=1e-5)


def test_pressure_monotone_and_top_pure_pressure():
    vc = tvert.VerticalCoords(19, device="cpu", hybrid=True)
    for ps in (7.0e4, 1.0e5, 1.04e5):
        ph = vc.pressures(torch.tensor(ps))[0].numpy()
        assert ph[0] == 0.0 and np.isclose(ph[-1], ps)
        assert np.all(np.diff(ph) > 0)
    lo = vc.pressures(torch.tensor(7.0e4))[0].numpy()
    hi = vc.pressures(torch.tensor(1.0e5))[0].numpy()
    k = 19 // 3
    assert (hi[k] - lo[k]) / hi[k] < 0.12
    assert (hi[-2] - lo[-2]) / hi[-2] > 0.25


def test_hybrid_coeffs_reduce_to_sigma_constants():
    vc = tvert.VerticalCoords(12, device="cpu", hybrid=True)
    hc = vc.hybrid_coeffs(torch.tensor([c.pref0]))
    np.testing.assert_allclose(hc["lnr"][1:, 0].numpy(), vc.lnr[1:].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(hc["alpha"][1:, 0].numpy(),
                               vc.alpha[1:].numpy(), rtol=1e-4)
    np.testing.assert_allclose(hc["dpt"][:, 0].numpy(), vc.ds.numpy(),
                               rtol=1e-5)


def test_geopotential_actual_coeffs_match_matrix_on_sigma():
    vc = tvert.VerticalCoords(12, device="cpu")
    T = torch.tensor(np.linspace(220.0, 290.0, 12), dtype=torch.float32)[None]
    np.testing.assert_allclose(
        vc.geopotential_full(T).numpy(),
        vc.geopotential_full(T, lnr=vc.lnr[None],
                             alpha=vc.alpha[None]).numpy(), rtol=1e-5)


def test_hybrid_dycore_stable_and_profiles_consistent():
    """5 hybrid steps at T10/L8 stay bounded; the column profiles are
    ordered top first with full levels between their half levels."""
    m = tmodel.GCMModel(tmodel.GCMConfig(trunc=10, nlev=8, dt=1800.0,
                                         hybrid=True), device="cpu")
    for _ in range(5):
        m.evolve_model_until_cloud_scheme()
        m.evolve_model_cloud_scheme()
        m.evolve_model_from_cloud_scheme()
    g = m.state.grid
    assert bool(torch.isfinite(g.T).all())
    assert float(g.u.abs().max()) < 150.0
    assert 150.0 < float(g.T.min()) and float(g.T.max()) < 350.0
    m.evolve_model_until_cloud_scheme()
    m.evolve_model_cloud_scheme()
    prof = {v: m.get_profile_fields(v, [3, 100])
            for v in ("Pfull", "Phalf", "Zgfull", "Zghalf")}
    assert np.all(np.diff(prof["Phalf"], axis=1) > 0)
    assert np.all(np.diff(prof["Zghalf"], axis=1) < 0)
    assert np.all(prof["Zgfull"] <= prof["Zghalf"][:, :-1] + 1e-3)
    assert np.all(prof["Zgfull"] >= prof["Zghalf"][:, 1:] - 1e-3)


# ---- the hybrid Eulerian dycore against JAX --------------------------------

@pytest.fixture(scope="module")
def hybrid_cores():
    kw = dict(trunc=21, nlev=8, dt=900.0, hybrid=True)
    jc = jmodel.GCMCore(jmodel.GCMConfig(**kw))
    tc = tmodel.GCMCore(tmodel.GCMConfig(**kw), device="cpu")
    gj = jc.step(jc.initial_state(seed=5), first=True)
    return jc, tc, jax.tree.map(np.asarray, gj)


def test_hybrid_grid_view_and_tendencies(hybrid_cores):
    """to_grid (omega/p through the hybrid coefficients) and the explicit
    tendencies from the same spectral state."""
    jc, tc, gj = hybrid_cores
    now_t = interop.spectral_state(gj.now, "cpu")
    now_j = jax.tree.map(jnp.asarray, gj.now)
    Nj, g_j = jdycore.tendencies(jc.sht, jc.vc, now_j, jc.fcor)
    Nt, g_t = tdycore.tendencies(tc.sht, tc.vc, now_t, tc.fcor)
    for k in ("u", "v", "T", "lnps", "omega_p", "div"):
        close(getattr(g_t, k), getattr(g_j, k), 1e-4, 1e-5, k)
    for k in Nj._fields:
        close(getattr(Nt, k), getattr(Nj, k), 0.0, 1e-4, "N." + k)
    gd = tdycore.to_grid(tc.sht, tc.vc, now_t, diag=False)
    assert gd.omega_p is None and gd.vort is None and gd.div is None


def test_hybrid_step_matches_jax(hybrid_cores):
    """One leapfrog step (phase A, cloud scheme, phase B) of the hybrid
    Eulerian core: the grid fields of both packages."""
    jc, tc, gj = hybrid_cores
    gt = interop.gcm_state(gj, "cpu")
    gj = jc.step(jax.tree.map(jnp.asarray, gj))
    gt = tc.step(gt)
    for k in ("u", "v", "T", "q"):
        close(getattr(gt.grid, k), getattr(gj.grid, k), 1e-4, 1e-5, k)
    # lnps = ln(ps/pref) is a ~1e-3 field, rounded at the size of a step's
    # tendencies (measured 1.9e-5 of max|ref|)
    close(gt.grid.lnps, gj.grid.lnps, 1e-4, 1e-4, "lnps")
    close(gt.now.lnps, gj.now.lnps, 0.0, 1e-4, "lnps spectrum")


@pytest.mark.parametrize("damp_lnps", [False, True])
def test_hyperdiffuse_damp_lnps(hybrid_cores, damp_lnps):
    jc, tc, gj = hybrid_cores
    a = tdycore.hyperdiffuse(tc.sht, interop.spectral_state(gj.now, "cpu"),
                             900.0, damp_lnps=damp_lnps)
    b = jdycore.hyperdiffuse(jc.sht, jax.tree.map(jnp.asarray, gj.now),
                             900.0, damp_lnps=damp_lnps)
    for k in b._fields:
        close(getattr(a, k), getattr(b, k), 1e-6, 1e-7, k)
    assert torch.equal(a.lnps, torch.tensor(gj.now.lnps)) != damp_lnps


def test_spectral_transform_lat_lon_match_jax():
    js, ts = jsph.SpectralTransform(21), tsph.SpectralTransform(21,
                                                                device="cpu")
    np.testing.assert_array_equal(ts.latitudes_deg(), js.latitudes_deg())
    np.testing.assert_array_equal(ts.longitudes_deg(), js.longitudes_deg())
