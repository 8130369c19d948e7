"""GCM modules of the PyTorch port vs the JAX package (T10/L8, dt=1800).

The spectral tables come from the same host-numpy code and must be
identical; transforms and the Eulerian step run on the CPU in float32 on
both sides from a JAX-built state carried over as numpy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.models.gcm import (model as jmodel, spharm as jsph,
                                       vertical as jvert)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.gcm import (dycore as tdycore,
                                             model as tmodel, spharm as tsph,
                                             vertical as tvert)

torch.set_num_threads(1)

TRUNC, NLEV, DT = 10, 8, 1800.0


def close(got, ref, rtol, atol_frac, msg=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


@pytest.fixture(scope="module")
def sht_pair():
    return (jsph.SpectralTransform(TRUNC),
            tsph.SpectralTransform(TRUNC, device="cpu"))


def test_legendre_and_dft_tables_identical(sht_pair):
    js, ts = sht_pair
    for a, b in zip(jsph.legendre_tables(TRUNC, 16),
                    tsph.legendre_tables(TRUNC, 16)):
        np.testing.assert_array_equal(a, b)
    for k in ("Pe", "Po", "Ffwd", "Finv", "mask", "laplacian",
              "inv_laplacian", "mu", "w", "cosl"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)


def test_vertical_operators_identical():
    jv = jvert.VerticalCoords(NLEV)
    tv = tvert.VerticalCoords(NLEV, device="cpu")
    for k in ("sh", "sf", "ds", "lnr", "alpha", "G", "Pmat", "W", "b"):
        np.testing.assert_array_equal(getattr(tv, k).numpy(),
                                      np.asarray(getattr(jv, k)), err_msg=k)
    np.testing.assert_array_equal(tv.implicit_inverse(DT, TRUNC).numpy(),
                                  np.asarray(jv.implicit_inverse(DT, TRUNC)))


def test_analyze_synthesize(sht_pair):
    """Scalar and vector transforms; einsum summation order differs, so
    rtol 1e-4, atol 1e-5 max|ref| (measured < 1e-6 max|ref|)."""
    js, ts = sht_pair
    rng = np.random.default_rng(0)
    f = rng.normal(280.0, 10.0, (NLEV, js.nlat, js.nlon)).astype(np.float32)
    u = rng.normal(0.0, 10.0, (NLEV, js.nlat, js.nlon)).astype(np.float32)
    v = rng.normal(0.0, 10.0, (NLEV, js.nlat, js.nlon)).astype(np.float32)
    spec = js.analyze(jnp.asarray(f))
    close(ts.analyze(torch.tensor(f)), spec, 1e-4, 1e-5, "analyze")
    close(ts.synthesize(torch.tensor(np.asarray(spec))),
          js.synthesize(spec), 1e-4, 1e-5, "synthesize")
    vd_j = js.vort_div_from_uv(jnp.asarray(u), jnp.asarray(v))
    vd_t = ts.vort_div_from_uv(torch.tensor(u), torch.tensor(v))
    for name, a, b in zip(("vort", "div"), vd_t, vd_j):
        close(a, b, 1e-4, 1e-5, name)
    uv_j = js.uv_from_vort_div(*vd_j)
    uv_t = ts.uv_from_vort_div(*[torch.tensor(np.asarray(x)) for x in vd_j])
    for name, a, b in zip(("u", "v"), uv_t, uv_j):
        close(a, b, 1e-4, 1e-5, name)


@pytest.fixture(scope="module")
def cores():
    cfg_j = jmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT)
    cfg_t = tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT)
    return jmodel.GCMCore(cfg_j), tmodel.GCMCore(cfg_t, device="cpu")


def test_initial_state(cores):
    """T and q match JAX; the vorticity noise comes from a torch.Generator
    (1e-6 amplitude, so it differs from JAX's threefry draw)."""
    jc, tc = cores
    gj, gt = jc.initial_state(seed=0), tc.initial_state(seed=0)
    close(gt.now.T, gj.now.T, 1e-4, 1e-5, "T")
    close(gt.now.q, gj.now.q, 1e-4, 1e-5, "q")
    close(gt.grid.T, gj.grid.T, 1e-5, 1e-6, "grid T")
    assert float(gt.now.vort.abs().max()) < 1e-5
    assert torch.equal(tc.initial_state(seed=0).now.vort, gt.now.vort)


def _tend(n, L, k):
    rng = np.random.default_rng(k)
    return {v: rng.normal(0, s, (n, L)).astype(np.float32)
            for v, s in (("T", 1e-4), ("SH", 1e-8), ("U", 1e-4),
                         ("V", 1e-4), ("QL", 1e-9), ("QI", 1e-10),
                         ("A", 1e-6))}


def _leaves(state):
    """Leaves of a GCMState of either package, in the same order."""
    if not isinstance(state, tmodel.GCMState):
        state = jax.tree.map(np.asarray, state)
    return jax.tree.leaves(interop.to_numpy(state))


def test_eulerian_step_first_and_leapfrog(cores):
    """Phase A -> cloud scheme -> SP tendencies -> phase B, first with the
    Euler start (first=True), then a leapfrog step (first=False), from a
    carried-over JAX state.

    Tolerance: rtol 1e-3 with atol 1e-4 max|ref| per state leaf. Two
    steps of spectral transforms summed in another order leave ~1e-6
    relative differences in the grid fields; spectral coefficients of
    the smallest scales and the zero-mean tendency-like leaves are small
    differences of large grid values, where those reach ~1e-5 of the
    leaf's largest entry (measured max 6e-6)."""
    jc, tc = cores
    gj = jc.initial_state(seed=3)
    gt = interop.gcm_state(jax.tree.map(np.asarray, gj), "cpu")
    cols = np.asarray([5, 100, 200])
    for step, first in enumerate((True, False)):
        gj = jc.phase_cloud(jc._phase_a_body(gj, first))
        gt = tc.phase_cloud(tc._phase_a_body(gt, first))
        tend = _tend(len(cols), NLEV, step)
        gj = jc.with_sp_tendencies(gj, jnp.asarray(cols),
                                   {k: jnp.asarray(v) for k, v in tend.items()})
        gt = tc.with_sp_tendencies(gt, torch.tensor(cols),
                                   {k: torch.tensor(v) for k, v in tend.items()})
        pj = jc.column_profiles(gj, jnp.asarray(cols))
        pt = tc.column_profiles(gt, torch.tensor(cols))
        for k in pj:
            close(pt[k], pj[k], 1e-4, 1e-5, "profile %s step %d" % (k, step))
        gj = jc._phase_b_body(gj, first)
        gt = tc._phase_b_body(gt, first)
        lj, lt = _leaves(gj), _leaves(gt)
        assert len(lj) == len(lt)
        for i, (a, b) in enumerate(zip(lt, lj)):
            close(a, b, 1e-3, 1e-4, "leaf %d step %d" % (i, step))
        for k in ("T", "q", "u"):
            close(getattr(gt.grid, k), getattr(gj.grid, k), 1e-4, 1e-5, k)


@pytest.mark.parametrize("kw", [dict(advection="sl"),
                                dict(split_phases=True),
                                dict(hybrid=True)])
def test_gcm_settings_run(kw):
    """The settings the port once refused run: two GCMCore.steps (the
    Euler start, then a leapfrog step) from a carried-over JAX state match
    JAX's. The dynamical grid fields at rtol 1e-4 plus 1e-4 of max|ref|,
    the condensate at 1e-5 of max|q| and the cloud fraction at 5e-3
    absolute (the bounds of tests/test_torch_semilag.py and their
    reasons)."""
    cfg = dict(trunc=TRUNC, nlev=NLEV, dt=DT, **kw)
    jc = jmodel.GCMCore(jmodel.GCMConfig(**cfg))
    tc = tmodel.GCMCore(tmodel.GCMConfig(**cfg), device="cpu")
    gj = jc.initial_state(seed=4)
    gt = interop.gcm_state(jax.tree.map(np.asarray, gj), "cpu")
    for first in (True, False):
        gj, gt = jc.step(gj, first=first), tc.step(gt, first=first)
    for k in ("u", "v", "T", "q", "lnps"):
        close(getattr(gt.grid, k), getattr(gj.grid, k), 1e-4, 1e-4, k)
    qmax = float(np.abs(np.asarray(gj.grid.q)).max())
    for k, atol in (("ql", 1e-5 * qmax), ("qi", 1e-5 * qmax), ("a", 5e-3)):
        np.testing.assert_allclose(getattr(gt.grid, k).numpy(),
                                   np.asarray(getattr(gj.grid, k)), rtol=0.0,
                                   atol=atol, err_msg=k)
    assert float(gt.time) == float(gj.time) == 2 * DT


def test_entry_points_default_to_the_card(monkeypatch):
    """GCMCore, SpectralTransform and VerticalCoords with no device ask
    for the CUDA card: with none (as here) they raise and do not fall back
    to the CPU; device="cpu" runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmodel.GCMConfig(trunc=TRUNC, nlev=NLEV, dt=DT)
    for make in (lambda: tmodel.GCMCore(cfg),
                 lambda: tsph.SpectralTransform(TRUNC),
                 lambda: tvert.VerticalCoords(NLEV)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    assert tvert.VerticalCoords(NLEV, device="cpu").device.type == "cpu"


# the GCM conversion functions and tensor factory, each called with the
# given keywords (device or none) on a JAX GCMState as numpy
GCM_MAKERS = {
    "interop.gcm_state": lambda g, **kw: interop.gcm_state(g, **kw).now.T,
    "interop.spectral_state": lambda g, **kw: interop.spectral_state(
        g.now, **kw).T,
    "interop.grid_fields": lambda g, **kw: interop.grid_fields(g.grid,
                                                               **kw).T,
    "SpectralState.zeros": lambda g, **kw: tdycore.SpectralState.zeros(
        NLEV, 3, 4, **kw).T,
}


@pytest.mark.parametrize("maker", sorted(GCM_MAKERS))
def test_conversions_default_to_the_card(cores, monkeypatch, maker):
    """With no device they ask for the CUDA card: with none (as here) they
    raise and say to pass device='cpu'; device="cpu" runs on the CPU."""
    g = jax.tree.map(np.asarray, cores[0].initial_state(seed=0))
    make = GCM_MAKERS[maker]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        make(g)
    assert make(g, device="cpu").device.type == "cpu"
