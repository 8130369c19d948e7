"""Semi-Lagrangian GCM of the PyTorch port vs the JAX package.

SLGrid's window bands and node tables are host numpy on both sides and
must be identical at T21/T42/T63/T159. The interpolation, from the same
numpy fields and targets, sums the same taps with the same weights in the
same order, so both methods equal JAX's to float32 rounding (measured
bitwise; held at 1e-6 of max|ref|). The trajectories are float32
arcsin/atan2 of normalized Cartesian vectors: from smooth winds they
agree to 1e-5 rad (measured 6e-6 in latitude near the poles, 5e-7 in
longitude).

The SL step and the GCM steps start from a JAX state carried over with
``interop.gcm_state``. The dynamical fields are held at rtol 1e-4 plus
1e-4 of max|ref| (transforms summed in another order, through up to 5
steps; measured <= 2e-5). The condensate and cloud fraction leave the
cloud scheme through its relative-humidity threshold, which turns
last-bit differences of T and q into finite ones: ql and qi are held at
1e-5 of max|q| (the vapor scale; measured 4e-9 kg/kg against max q of
~2e-2) and the cloud fraction at 5e-3 absolute (measured 4.3e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.models.gcm import (model as jmodel, semilag as jsl,
                                       spharm as jsph)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.gcm import (dycore as tdycore,
                                             model as tmodel, physics as tphys,
                                             semilag as tsl, spharm as tsph)

torch.set_num_threads(2)

DYN = ("u", "v", "T", "q", "lnps")
DT = 900.0


def close(got, ref, rtol, atol_frac, msg=""):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


_SHT = {}


def sht_pair(trunc):
    if trunc not in _SHT:
        _SHT[trunc] = (jsph.SpectralTransform(trunc),
                       tsph.SpectralTransform(trunc, device="cpu"))
    return _SHT[trunc]


def grid_angles(sht):
    lam = 2 * np.pi * np.arange(sht.nlon) / sht.nlon
    phi = np.arcsin(np.asarray(sht.mu))
    L = (phi[:, None] * 0 + lam[None, :]).astype(np.float32)
    M = (phi[:, None] + 0 * lam[None, :]).astype(np.float32)
    return L, M


def targets(sht, K, seed, dlon=0.1, dlat=0.05):
    """Random in-window targets around the grid points [K, nlat, nlon]."""
    L, M = grid_angles(sht)
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-dlon, dlon, (K,) + L.shape).astype(np.float32)
    dp = rng.uniform(-dlat, dlat, (K,) + L.shape).astype(np.float32)
    lam_t = np.asarray(jnp.remainder(jnp.asarray(L[None] + dl), 2 * np.pi))
    phi_t = np.clip(M[None] + dp, -np.pi / 2 + 1e-4,
                    np.pi / 2 - 1e-4).astype(np.float32)
    return lam_t, phi_t


def interp_both(method, dt, fields, lam_t, phi_t, trunc=42, **kw):
    js, ts = sht_pair(trunc)
    a = jsl.SLGrid(js, method=method, dt=dt).interp(
        jnp.asarray(fields), jnp.asarray(lam_t), jnp.asarray(phi_t), **kw)
    b = tsl.SLGrid(ts, method=method, dt=dt).interp(
        torch.tensor(fields), torch.tensor(lam_t), torch.tensor(phi_t), **kw)
    return b, np.asarray(a)


# ---- geometry ---------------------------------------------------------------

@pytest.mark.parametrize("trunc, dt", [(21, 900.0), (42, 1800.0),
                                       (63, 1200.0), (159, 900.0)])
def test_slgrid_geometry_identical(trunc, dt):
    js, ts = sht_pair(trunc)
    for d in (None, dt):
        g1, g2 = jsl.SLGrid(js, method="gather", dt=d), tsl.SLGrid(ts, dt=d)
        assert (g2.ng, g2.S_lat, g2.S_lon, g2.lon_bands) == (
            g1.ng, g1.S_lat, g1.S_lon, g1.lon_bands)
        for k in ("phi_ext", "r", "e", "n"):
            np.testing.assert_array_equal(getattr(g2, k).numpy(),
                                          np.asarray(getattr(g1, k)),
                                          err_msg=k)
        assert g2.dlon == g1.dlon


def test_default_method_is_gather_off_tpu():
    assert tsl.SLGrid(sht_pair(21)[1]).method == "gather"


def test_extend_matches_jax():
    js, ts = sht_pair(21)
    f = np.random.default_rng(3).standard_normal(
        (2, 3, js.nlat, js.nlon)).astype(np.float32)
    a = jsl.SLGrid(js).extend(jnp.asarray(f))
    b = tsl.SLGrid(ts).extend(torch.tensor(f))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---- interpolation ----------------------------------------------------------

@pytest.mark.parametrize("method, dt", [("gather", None), ("window", None),
                                        ("window", 1800.0)])
@pytest.mark.parametrize("cubic", [True, False])
def test_interp_matches_jax(method, dt, cubic):
    js, _ = sht_pair(42)
    fields = np.random.default_rng(0).standard_normal(
        (3, 4, js.nlat, js.nlon)).astype(np.float32)
    lam_t, phi_t = targets(js, 4, 1)
    got, ref = interp_both(method, dt, fields, lam_t, phi_t, cubic=cubic)
    close(got, ref, 0.0, 1e-6, "%s dt=%s cubic=%s" % (method, dt, cubic))


@pytest.mark.parametrize("coriolis", ["midpoint", "trapezoid"])
def test_sl_arrivals_level_chunks(coriolis):
    """split_phases' level chunks (k_chunk) of the window interpolation
    and of the arrival combination give the whole computation's result
    exactly (levels are independent), and sl_arrivals matches JAX's."""
    js, ts = sht_pair(21)
    rng = np.random.default_rng(4)
    shp = (4, js.nlat, js.nlon)
    mid = rng.standard_normal((8,) + shp).astype(np.float32)
    dep = rng.standard_normal((8,) + shp).astype(np.float32)
    n_pi = rng.standard_normal((1,) + shp[1:]).astype(np.float32)
    pi_dep = rng.standard_normal((1, 1) + shp[1:]).astype(np.float32)
    lam_m, phi_m = targets(js, 4, 5)
    lam_m2, phi_m2 = targets(js, 1, 6)
    args = (mid, n_pi, lam_m, phi_m, lam_m2, phi_m2, dep, pi_dep)
    outs = []
    for method, kc in (("gather", None), ("window", None), ("window", 2)):
        slg = tsl.SLGrid(ts, method=method, dt=DT)
        slg.k_chunk = kc
        outs.append(tsl.sl_arrivals(slg, *[torch.tensor(a) for a in args],
                                    2 * DT, coriolis=coriolis))
    ref = jsl.sl_arrivals(jsl.SLGrid(js, method="gather", dt=DT),
                          *[jnp.asarray(a) for a in args], 2 * DT,
                          coriolis=coriolis)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(outs[2][i].numpy(), outs[1][i].numpy())
        assert float((outs[1][i] - outs[0][i]).abs().max()) < 1e-5 * max(
            float(outs[0][i].abs().max()), 1.0)
        close(outs[0][i], r, 1e-6, 1e-6, "arrival %d" % i)


@pytest.mark.parametrize("method", ["gather", "window"])
def test_interp_crosses_pole(method):
    """Targets 1.5 rings poleward of the first ring interpolate
    sin(phi) through the pole-mirrored ghost rows (test_gcm.py:342)."""
    js, ts = sht_pair(21)
    L, M = grid_angles(js)
    dphi = float(np.arcsin(np.asarray(js.mu))[0]
                 - np.arcsin(np.asarray(js.mu))[1])
    phi_t = np.minimum(M[None] + 1.5 * dphi,
                       np.float32(np.pi / 2 * 0.9999)).astype(np.float32)
    fields = np.sin(M)[None, None].astype(np.float32)
    got, ref = interp_both(method, None, fields, L[None], phi_t, trunc=21)
    close(got, ref, 0.0, 1e-6)
    assert np.abs(got.numpy()[0, 0] - np.sin(phi_t[0])).max() < 5e-3


def test_window_truncates_instead_of_extrapolating():
    """A quarter turn in longitude and 30 degrees in latitude, beyond the
    window: the result stays in the field's range, equals JAX's, and
    clamp_stats reports the truncation as JAX's does (test_gcm.py:469)."""
    js, ts = sht_pair(21)
    L, M = grid_angles(js)
    field = (np.cos(M) * np.sin(3 * L))[None].astype(np.float32)
    lam_t = np.remainder(L + np.pi / 2, 2 * np.pi)[None].astype(np.float32)
    phi_t = np.clip(M + np.radians(30.0), -1.55, 1.55)[None].astype(
        np.float32)
    got, ref = interp_both("window", 900.0, field[None], lam_t, phi_t,
                           trunc=21)
    close(got, ref, 0.0, 1e-6)
    assert got.min() >= field.min() - 1e-3
    assert got.max() <= field.max() + 1e-3
    g1 = jsl.SLGrid(js, method="window", dt=900.0)
    g2 = tsl.SLGrid(ts, method="window", dt=900.0)
    c1 = g1.clamp_stats(jnp.asarray(lam_t), jnp.asarray(phi_t))
    c2 = g2.clamp_stats(torch.tensor(lam_t), torch.tensor(phi_t))
    for k in ("lon", "lat"):
        assert float(c2[k]) == float(c1[k]) and float(c2[k]) > 0.5, k


def test_window_matches_gather():
    """The port's window path (one band and the dt-sized ladder, whole
    and level-chunked) against its gather path, at the bounds of
    tests/test_gcm.py:424-467."""
    _, ts = sht_pair(42)
    fields = torch.tensor(np.random.default_rng(0).standard_normal(
        (3, 4, ts.nlat, ts.nlon)).astype(np.float32))
    lam_t, phi_t = [torch.tensor(x) for x in targets(ts, 4, 0)]
    slg_g = tsl.SLGrid(ts, method="gather")
    slg_b = tsl.SLGrid(ts, method="window", dt=1800.0)
    rows = sorted((r0, r1) for segs, _ in slg_b.lon_bands
                  for r0, r1 in segs)
    assert rows[0][0] == 0 and rows[-1][1] == ts.nlat
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    for cubic in (True, False):
        a = slg_g.interp(fields, lam_t, phi_t, cubic=cubic)
        for slg in (tsl.SLGrid(ts, method="window"), slg_b):
            assert float((a - slg.interp(fields, lam_t, phi_t,
                                         cubic=cubic)).abs().max()) < 1e-5
    cs = slg_b.clamp_stats(lam_t, phi_t)
    assert float(cs["lon"]) == 0.0 and float(cs["lat"]) == 0.0
    ref = slg_b.interp(fields, lam_t, phi_t)
    slg_b.k_chunk = 2
    assert float((ref - slg_b.interp(fields, lam_t, phi_t)).abs().max()) \
        < 1e-4


def test_solid_body_rotation_large_cfl():
    """A blob carried once round the sphere by solid-body rotation at ~4
    grid points a step comes back with small shape error and mass drift
    (the port's run of test_gcm.py:364)."""
    _, ts = sht_pair(21)
    slg = tsl.SLGrid(ts)
    L, M = [torch.tensor(x) for x in grid_angles(ts)]
    blob = lambda lam, phi: torch.exp(-(torch.arccos(torch.clamp(
        torch.cos(phi) * torch.cos(lam - np.pi / 2), -1, 1)) / 0.4) ** 2)
    q = blob(L, M)[None, None]
    n_steps = 16
    u = (2 * np.pi / n_steps * ts.radius * torch.cos(M))[None]
    for _ in range(n_steps):
        (ld, pd), _ = slg.trajectories(u, torch.zeros_like(u), 0.5,
                                       ts.radius)
        q = slg.interp(q, ld, pd, cubic=True)
    q, q0 = q[0, 0].numpy(), blob(L, M).numpy()
    assert np.abs(q - q0).max() / q0.max() < 0.15
    w = ts.w.numpy()[:, None]
    assert abs((q * w).sum() - (q0 * w).sum()) / (q0 * w).sum() < 0.035


def test_trajectories_match_jax():
    js, ts = sht_pair(42)
    L, M = grid_angles(js)
    k = np.arange(4)[:, None, None]
    u = ((40 * np.cos(M) ** 2 + 10 * np.sin(3 * L) * np.cos(M))
         * (1 + 0.1 * k)).astype(np.float32)
    v = (8 * np.cos(2 * L) * np.cos(M) * (1 - 0.1 * k)).astype(np.float32)
    rj = jsl.SLGrid(js).trajectories(jnp.asarray(u), jnp.asarray(v), 1800.0,
                                     js.radius)
    rt = tsl.SLGrid(ts).trajectories(torch.tensor(u), torch.tensor(v),
                                     1800.0, ts.radius)
    for (lj, pj), (lt, pt) in zip(rj, rt):
        d = np.abs(lt.numpy() - np.asarray(lj))
        assert np.minimum(d, 2 * np.pi - d).max() < 1e-5
        assert np.abs(pt.numpy() - np.asarray(pj)).max() < 1e-5


# ---- the SL step and the core -----------------------------------------------

def core_pair(**kw):
    kw = dict(dict(trunc=21, nlev=8, dt=DT), **kw)
    return (jmodel.GCMCore(jmodel.GCMConfig(**kw)),
            tmodel.GCMCore(tmodel.GCMConfig(**kw), device="cpu"))


def close_grid(gt, gj, msg):
    for k in DYN:
        close(getattr(gt, k), getattr(gj, k), 1e-4, 1e-4, "%s %s" % (msg, k))
    qmax = float(np.abs(np.asarray(gj.q)).max())
    for k in ("ql", "qi"):
        np.testing.assert_allclose(getattr(gt, k).numpy(),
                                   np.asarray(getattr(gj, k)), rtol=0.0,
                                   atol=1e-5 * qmax, err_msg=msg + " " + k)
    np.testing.assert_allclose(gt.a.numpy(), np.asarray(gj.a), rtol=0.0,
                               atol=5e-3, err_msg=msg + " a")


@pytest.fixture(scope="module")
def sl_start():
    """A JAX SL core (sigma levels) one Euler step in, so that now and
    prev differ."""
    jc, tc = core_pair(advection="sl")
    gj = jc.step(jc.initial_state(seed=3), first=True)
    return jc, tc, jax.tree.map(np.asarray, gj)


@pytest.mark.parametrize("coriolis", ["midpoint", "trapezoid"])
def test_sl_step_matches_jax(sl_start, coriolis):
    """One leapfrog sl_step (tau = 2 dt) in each Coriolis mode: the
    spectral state, and its grid view."""
    jc, tc, gj = sl_start
    now_t = interop.spectral_state(gj.now, "cpu")
    prev_t = interop.spectral_state(gj.prev, "cpu")
    a = tsl.sl_step(tc.sht, tc.vc, tc.slg, now_t, prev_t, 2 * DT,
                    coriolis=coriolis)
    b = jax.jit(lambda now, prev: jsl.sl_step(
        jc.sht, jc.vc, jc.slg, now, prev, 2 * DT, coriolis=coriolis))(
        jax.tree.map(jnp.asarray, gj.now), jax.tree.map(jnp.asarray, gj.prev))
    for k in ("vort", "div", "T", "lnps", "q"):
        close(getattr(a, k), getattr(b, k), 0.0, 1e-4, "%s %s" % (coriolis,
                                                                 k))
    # both results' grid views through the port's transforms
    ga = tdycore.to_grid(tc.sht, tc.vc, a)
    gb = tdycore.to_grid(tc.sht, tc.vc, interop.spectral_state(
        jax.tree.map(np.asarray, b), "cpu"))
    for k in DYN:
        close(getattr(ga, k), getattr(gb, k).numpy(), 1e-4, 1e-4,
              "%s grid %s" % (coriolis, k))


@pytest.mark.parametrize("hybrid", [False, True])
def test_five_sl_steps_match_jax(hybrid):
    """5 GCMCore.steps (the Euler start, then 4 leapfrog steps) of the SL
    core at T21/L8 on sigma and on hybrid levels."""
    jc, tc = core_pair(advection="sl", hybrid=hybrid)
    gj = jc.initial_state(seed=3)
    gt = interop.gcm_state(jax.tree.map(np.asarray, gj), "cpu")
    for s in range(5):
        gj = jc.step(gj, first=s == 0)
        gt = tc.step(gt, first=s == 0)
    close_grid(gt.grid, gj.grid, "hybrid=%s" % hybrid)
    for k in ("vort", "div", "T", "lnps", "q"):
        close(getattr(gt.now, k), getattr(gj.now, k), 0.0, 1e-4, "now " + k)
    assert float(gt.time) == float(gj.time) == 5 * DT


def test_split_phases_matches_fused():
    """split_phases=True (the SL stages as separate calls, the departure
    values in level blocks) reproduces the fused run over 3 steps within
    1e-5 of each field's scale (tests/test_gcm.py:509-530)."""
    states = {}
    for split in (False, True):
        core = tmodel.GCMCore(tmodel.GCMConfig(
            trunc=21, nlev=8, dt=DT, advection="sl", split_phases=split),
            device="cpu")
        assert (core.slg.k_chunk == 4) == split
        s = core.step(core.initial_state(seed=3), first=True)
        for _ in range(2):
            s = core.step(s)
        states[split] = {k: getattr(s.grid, k).numpy() for k in DYN}
    for k in DYN:
        a, b = states[False][k], states[True][k]
        assert np.all(np.isfinite(b)), k
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1e-12), k


def test_option_validation():
    """Misspelled scheme options raise, as in JAX (test_gcm.py:490)."""
    ts = sht_pair(21)[1]
    with pytest.raises(ValueError):
        tsl.SLGrid(ts, method="Window")
    with pytest.raises(ValueError):
        tmodel.GCMCore(tmodel.GCMConfig(trunc=10, nlev=5,
                                        advection="semilag"), device="cpu")
    with pytest.raises(ValueError):
        tmodel.GCMCore(tmodel.GCMConfig(trunc=10, nlev=5, advection="sl",
                                        sl_coriolis="trapezoidal"),
                       device="cpu")


@pytest.mark.parametrize("dt, want", [(900.0, "midpoint"),
                                      (7200.0, "trapezoid")])
def test_auto_coriolis_rule(dt, want):
    """auto takes the trapezoid where 2 Omega * 2 dt > 1.5, as JAX."""
    kw = dict(trunc=10, nlev=5, dt=dt, advection="sl")
    jc = jmodel.GCMCore(jmodel.GCMConfig(**kw))
    tc = tmodel.GCMCore(tmodel.GCMConfig(**kw), device="cpu")
    assert tc.sl_cor == jc.sl_cor == want


# ---- the JAX package's 10-day T42 guards (slow, as JAX marks them) ---------

def _ten_days(phys=None, dry=False):
    kw = dict(trunc=42, nlev=19, dt=1800.0, hybrid=True, advection="sl")
    if phys is not None:
        kw["phys"] = phys
    core = tmodel.GCMCore(tmodel.GCMConfig(**kw), device="cpu")
    state = core.initial_state(seed=3)
    if dry:
        state = state._replace(vdiff_mask=torch.zeros_like(state.vdiff_mask))
        z = torch.zeros_like
        d = state.now._replace(q=z(state.now.q), ql=z(state.now.ql),
                               qi=z(state.now.qi), a=z(state.now.a))
        state = state._replace(now=d, prev=d, new=d)
    state = core.step(state, first=True)
    for day in range(10):
        for _ in range(48):
            state = core.step(state)
        assert bool(torch.isfinite(state.now.vort).all()), day + 1
    return state.grid


@pytest.mark.slow
def test_hs94_10day_T42_finite():
    """tests/test_gcm.py:166 on the port: dry Held-Suarez, T42/L19,
    hybrid, SL, dt 1800 s, 480 steps, with its bounds."""
    g = _ten_days(tphys.PhysicsParams(dtheta_z=10.0, tau_rad=40.0 * 86400.0,
                                      tau_rad_sfc=4.0 * 86400.0,
                                      rayleigh_tau=86400.0), dry=True)
    for name in ("u", "v", "T"):
        assert bool(torch.isfinite(getattr(g, name)).all()), name
    assert 140.0 < float(g.T.min()) and float(g.T.max()) < 350.0
    assert float(g.u.abs().max()) < 200.0


@pytest.mark.slow
def test_moist_10day_T42_finite():
    """tests/test_gcm.py:209 on the port: the default moist physics."""
    g = _ten_days()
    for name in ("u", "v", "T", "q"):
        assert bool(torch.isfinite(getattr(g, name)).all()), name
    assert 150.0 < float(g.T.min()) and float(g.T.max()) < 340.0
    assert float(g.u.abs().max()) < 150.0
    assert float(g.q.max()) < 0.05
