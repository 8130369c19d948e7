"""LES modules of the PyTorch port vs the JAX package, function by function.

Both sides run on the CPU in float32 from the same inputs (a JAX-built
state carried over as numpy), so they differ only in the order of
operations: single functions agree within rtol 1e-5, atol 1e-6 max|ref|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.utils import thermo as jthermo
from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, advect as jadv,
                                       subgrid as jsg, micro as jmicro,
                                       poisson as jpois)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.utils import thermo as tthermo
from sp_coupler_tpu_torch.models.les import (grid as tgrid, state as tstate,
                                             step as tstep, advect as tadv,
                                             subgrid as tsg, micro as tmicro,
                                             poisson as tpois)

torch.set_num_threads(1)

NZ = 32
JG = jgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)
TG = tgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)


def close(got, ref, rtol=1e-5, atol_frac=1e-6, msg=""):
    """got: port tensor (fleet of 1 or plain), ref: JAX array."""
    ref = np.asarray(ref)
    got = got.detach().numpy().reshape(ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_frac * scale,
                               err_msg=msg)


def t(x):
    """JAX array -> tensor with a leading fleet axis of 1."""
    return torch.tensor(np.asarray(x))[None]


def make_case():
    """A physical JAX state with w and qr perturbed (tests/test_ops.py)."""
    rng = np.random.default_rng(11)
    st = jstate.init_state(
        JG, jnp.asarray(np.linspace(-5, 5, NZ), jnp.float32),
        jnp.full(NZ, 2.0, jnp.float32),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(5))
    st = st._replace(
        w=st.w.at[1:-1].set(jnp.asarray(
            rng.normal(0, 0.1, (NZ - 1, JG.ny, JG.nx)), jnp.float32)),
        qr=jnp.asarray(rng.uniform(0, 1e-4, (NZ, JG.ny, JG.nx)),
                       jnp.float32),
        e12=jnp.asarray(rng.uniform(0.05, 0.3, (NZ, JG.ny, JG.nx)),
                        jnp.float32))
    frc = jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        f_thl=jnp.full(NZ, 1e-5), f_qt=jnp.full(NZ, -1e-9),
        f_u=jnp.full(NZ, 1e-5), f_v=jnp.full(NZ, -1e-5),
        z0m=jnp.asarray(0.1))
    np_ = lambda x: jax.tree.map(np.asarray, x)
    return st, frc, interop.les_state(np_(st)), interop.les_forcing(np_(frc))


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.mark.parametrize("n_iter", [2, 3])
def test_sat_adjust(n_iter):
    rng = np.random.default_rng(n_iter)
    thl = rng.uniform(280, 320, 4096).astype(np.float32)
    qt = rng.uniform(0.0, 0.025, 4096).astype(np.float32)
    p = rng.uniform(6e4, 1.02e5, 4096).astype(np.float32)
    ref = jthermo.sat_adjust(jnp.asarray(thl), jnp.asarray(qt),
                             jnp.asarray(p), n_iter=n_iter)
    got = tthermo.sat_adjust(torch.tensor(thl), torch.tensor(qt),
                             torch.tensor(p), n_iter=n_iter)
    for name, a, b in zip(("T", "ql", "qs"), got, ref):
        close(a, b, msg=name)


def test_base_state():
    thl0 = np.linspace(297, 315, NZ).astype(np.float32)
    qt0 = np.linspace(0.017, 0.001, NZ).astype(np.float32)
    ref = jstate.base_state(JG, jnp.asarray(thl0), jnp.asarray(qt0),
                            jnp.float32(101500.0))
    got = tstate.base_state(TG, t(thl0), t(qt0), torch.tensor([101500.0]))
    for name, a, b in zip(("pbf", "pbh", "rhobf", "rhobh"), got, ref):
        close(a, b, msg=name)


def test_advect_scalar_hybrid52(case):
    st, _, ts, _ = case
    for name in ("thl", "qt", "qr", "e12"):
        ref = jadv.advect_scalar(JG, st.rhobf, st.rhobh, st.u, st.v, st.w,
                                 getattr(st, name), "hybrid52")
        got = tadv.advect_scalar(TG, ts.rhobf, ts.rhobh, ts.u, ts.v, ts.w,
                                 getattr(ts, name), "hybrid52")
        close(got, ref, msg=name)


@pytest.mark.parametrize("fn", ["advect_u", "advect_v", "advect_w",
                                "divergence"])
def test_momentum_advection_and_divergence(case, fn):
    st, _, ts, _ = case
    ref = getattr(jadv, fn)(JG, st.rhobf, st.rhobh, st.u, st.v, st.w)
    got = getattr(tadv, fn)(TG, ts.rhobf, ts.rhobh, ts.u, ts.v, ts.w)
    close(got, ref)


def _thv(st):
    _, _, _, thv = jstep.thermodynamics(st)
    return thv, jnp.mean(thv, axis=(1, 2), keepdims=True)


def test_tke_viscosity(case):
    st, _, ts, _ = case
    thv, thv_m = _thv(st)
    ref = jsg.tke_viscosity(JG, st, thv, thv_m)
    got = tsg.tke_viscosity(TG, ts, t(thv), t(thv_m))
    for name, a, b in zip(("Km", "Kh", "lam", "S2", "N2"), got, ref):
        close(a, b, msg=name)


def test_tke_sources(case):
    st, _, ts, _ = case
    thv, thv_m = _thv(st)
    Km, Kh, lam, S2, N2 = jsg.tke_viscosity(JG, st, thv, thv_m)
    ref = jsg.tke_sources(JG, Km, Kh, lam, S2, N2, st.e12)
    got = tsg.tke_sources(TG, t(Km), t(Kh), t(lam), t(S2), t(N2), ts.e12)
    close(got, ref)


def test_diffuse_scalar_and_momentum(case):
    st, frc, ts, tf = case
    thv, thv_m = _thv(st)
    Km, Kh = jsg.tke_viscosity(JG, st, thv, thv_m)[:2]
    ref = jsg.diffuse_scalar(JG, st.rhobf, st.rhobh, Kh, st.thl,
                             surf_flux=frc.wthl)
    got = tsg.diffuse_scalar(TG, ts.rhobf, ts.rhobh, t(Kh), ts.thl,
                             surf_flux=tf.wthl)
    close(got, ref, msg="diffuse_scalar")
    ref = jsg.diffuse_momentum(JG, st.rhobf, st.rhobh, Km, st, frc.z0m)
    got = tsg.diffuse_momentum(TG, ts.rhobf, ts.rhobh, t(Km), ts, tf.z0m)
    for name, a, b in zip(("tu", "tv", "tw", "ustar"), got, ref):
        close(a, b, msg=name)


def test_rain_tendencies(case):
    st, _, ts, _ = case
    T, ql, _, _ = jstep.thermodynamics(st)
    p = st.pbf[:, None, None]
    ref = jmicro.rain_tendencies(JG, jmicro.MicroParams(), st.rhobf, T, p,
                                 st.qt - ql, ql, st.qr, 2.0)
    got = tmicro.rain_tendencies(TG, tmicro.MicroParams(), ts.rhobf, t(T),
                                 ts.pbf[:, :, None, None], t(st.qt - ql),
                                 t(ql), ts.qr, 2.0)
    for name, a, b in zip(("dqt", "dqr", "dthl", "surf_rain"), got, ref):
        close(a, b, msg=name)


def test_tendencies(case):
    """The whole split tendency assembly. Buoyancy g (thv - <thv>)/<thv>
    and N^2 (adjacent slab means of thv) are differences of ~300 K
    values: one float32 ulp of thv (3e-5 K) moves the buoyancy by ~1e-6
    m/s^2. Measured against JAX: w 5.0e-4 max|ref|, kmax 1.7e-4 relative,
    e12 3.2e-5 max|ref|, the rest below 2e-6 max|ref|; the bound is
    rtol 1e-3, atol 1e-3 max|ref|."""
    st, frc, ts, tf = case
    ref = jstep.tendencies(JG, jstep.LESPhysics(), st, frc, 2.0)
    got = tstep.tendencies(TG, tstep.LESPhysics(), ts, tf,
                           torch.tensor([2.0]))
    for k in ("u", "v", "w", "thl", "qt", "qr", "e12", "ustar",
              "surf_rain", "kmax"):
        close(got[k], ref[k], rtol=1e-3, atol_frac=1e-3, msg=k)


def test_project(case):
    """Projected velocities agree; the port's residual divergence is at
    most twice JAX's (the eigenvector signs of eigh may differ, so V
    itself is not compared)."""
    st, _, ts, _ = case
    dt = 2.0
    rng = np.random.default_rng(3)
    du = rng.normal(0, 0.05, st.u.shape).astype(np.float32)
    u = st.u + du
    w = st.w.at[1:-1].add(jnp.asarray(
        rng.normal(0, 0.05, (NZ - 1, JG.ny, JG.nx)), jnp.float32))
    ref = jpois.project(JG, st.rhobf, st.rhobh, u, st.v, w, dt)
    got = tpois.project(TG, ts.rhobf, ts.rhobh, t(u), ts.v, t(w), dt)
    for name, a, b in zip(("u", "v", "w"), got[:3], ref[:3]):
        close(a, b, rtol=1e-4, atol_frac=1e-5, msg=name)
    div_j = float(jnp.max(jnp.abs(jadv.divergence(
        JG, st.rhobf, st.rhobh, *ref[:3]))))
    div_t = float(torch.max(torch.abs(tadv.divergence(
        TG, ts.rhobf, ts.rhobh, *got[:3]))))
    assert div_t <= 2.0 * div_j, (div_t, div_j)


def test_eigh_ascending_pin(case):
    _, _, ts, _ = case
    solver = tpois.build_solver(TG, ts.rhobf, ts.rhobh)
    assert float(solver.inv[0, -1, 0, 0]) == 0.0


@pytest.fixture(scope="module")
def fleet():
    """Two instances, one calm and one windy (CFL-limited), JAX-built."""
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    u0 = jnp.asarray([4.0, 20.0])
    st = jax.vmap(lambda k, uu: jstate.init_state(
        JG, jnp.full(NZ, uu), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        jnp.asarray(101300.0), k))(keys, u0)
    frc = jax.vmap(lambda _: jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        f_thl=jnp.full(NZ, 2e-5)))(jnp.arange(2))
    return st, frc


@pytest.mark.parametrize("serial", [False, True])
def test_evolve_adaptive_substep_counts(fleet, serial):
    """Adaptive evolve: n_substeps and n_dtmin_clamped equal JAX's, in
    batched (masked lock-step) and serial fleet modes; dt_min is set so
    the windy instance gets clamped."""
    st, frc = fleet
    span, kw = 60.0, dict(dt_max=15.0, dt_min=8.0)
    run_j = jax.jit(lambda s, f: jstep.map_fleet(
        lambda si, fi: jstep.evolve_adaptive(
            JG, jstep.LESPhysics(), si, fi, si.time + span, **kw),
        s, f, serial))
    s_j, n_j, c_j = run_j(st, frc)
    np_ = lambda x: jax.tree.map(np.asarray, x)
    s_t, n_t, c_t = tstep.map_fleet(
        lambda si, fi: tstep.evolve_adaptive(
            TG, tstep.LESPhysics(), si, fi, si.time + span, **kw),
        interop.les_state(np_(st)), interop.les_forcing(np_(frc)), serial)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert np.asarray(n_j)[0] != np.asarray(n_j)[1]
    assert np.asarray(c_j)[1] > 0
    for f in ("u", "w", "thl", "qt", "time"):
        a, b = getattr(s_t, f).numpy(), np.asarray(getattr(s_j, f))
        scale = max(np.max(np.abs(b)), 1e-12)
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=2e-3,
                                   err_msg=f)


def test_unported_settings_raise(case):
    _, _, ts, tf = case
    for phys in (tstep.LESPhysics(subgrid="smagorinsky"),
                 tstep.LESPhysics(scheme="cd2")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tstep.tendencies(TG, phys, ts, tf, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpois.project(TG, ts.rhobf, ts.rhobh, ts.u, ts.v, ts.w, 1.0,
                      method="thomas")


def test_init_state_is_seeded():
    prof = lambda a: torch.tensor(np.tile(np.asarray(a, np.float32), (2, 1)))
    args = (TG, prof(np.zeros(NZ)), prof(np.zeros(NZ)),
            prof(np.linspace(298, 312, NZ)), prof(np.full(NZ, 0.01)),
            101300.0)
    a = tstate.init_state(*args, torch.Generator().manual_seed(4))
    b = tstate.init_state(*args, torch.Generator().manual_seed(4))
    assert torch.equal(a.u, b.u) and not torch.equal(a.u[0], a.u[1])
    assert float(a.u.abs().max()) <= 0.5 and a.w.shape == (2, NZ + 1, 16, 16)
