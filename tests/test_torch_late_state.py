"""The port against the JAX package in a raining, deep-cloud LES state, and
JAX's TPU recording of BASELINE config 2 against the card's seed ensemble.

The state (``verify/late_state.py::raining_state``, 16x16x160, two
instances) is built from a seed with numpy: a saturated layer from 0.5 to
3 km, rain water up to 1e-3 below 3 km, divergence-free drafts of up to
~3 m/s and e12 varying by point. It reaches what the start of a run
does not: rain and its sedimentation, a deep cloud, large w, a short
adaptive dt. One RK stage
and 20 substeps of the JAX package's plain path and of the port's plain
path (what its stage kernel is held to on the card) from the same numpy
inputs; JAX's Pallas stage kernel in interpret mode on the same state is
tests/test_torch_late_state_pallas.py.

The ensemble: ``verify/ref/config2_seeds.json`` holds the card's seeds
42-45 of config 2 against ``tests/golden/spifs.nc`` (``golden compare
--windows --climate --summary``). The seeds ended at steps 98, 76, 81 and
72, so window 51-100 is not covered and not held; the windows they cover
must stay held, and the TPU recording, read here, is held again against
the members' climate envelope over those windows.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, subgrid as jsg)
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.les import (advect, grid as tgrid,
                                             step as tstep)
from sp_coupler_tpu_torch.ops import lesstage
from sp_coupler_tpu_torch.verify import golden, late_state

torch.set_num_threads(2)

NX, NY, NZ, N, SEED = 16, 16, 160, 2, 5
JG = jgrid.LESGrid(nx=NX, ny=NY, nz=NZ, dz=25.0)
TG = tgrid.LESGrid(nx=NX, ny=NY, nz=NZ, dz=25.0)
NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")
FRAC = 1.0 / 3.0
SUBSTEPS = 20
# one stage: tests/test_ops.py's tolerances of the Pallas stage against the
# plain path (outputs atol 5e-4, rtol 1e-4; kmax rtol 1e-4; the rain flux
# rtol 1e-3, atol 1e-10; u*^2 rtol 1e-3). The outputs' atol is far above
# the increments of w, qr and e12 here, so the increments are held on
# their own from a base of constants (chip_smoke.INC_BASE, where float32
# holds base + increment to ~1e-6 of the increment) at chip_smoke's
# INC_FRAC of their max plus INC_RTOL, what the card's kernel is held to
FIELD_TOL = dict(atol=5e-4, rtol=1e-4)
# 20 substeps at DT_FRAC x the state's adaptive dt (at the whole adaptive
# dt the drafts accelerate past the CFL limit by substep 15 and instance 1
# blows up at substep 19, alike in both packages): tests/test_torch_ops.py's
# tolerance of one substep, 2e-3 of each field's max|ref| plus rtol 2e-3
# (kmax rtol 1e-3). Measured: at most 1.6e-4 of max (e12; u, v, w within
# 4.5e-5, thl, qt, qr within 5e-6)
SUBSTEP_FRAC = 2e-3
DT_FRAC = 0.5
ENSEMBLE = os.path.join(os.path.dirname(golden.__file__), "ref",
                        "config2_seeds.json")


@pytest.fixture(scope="module")
def case():
    """The raining state as numpy, JAX and port trees, and its adaptive
    dt (the port's ``late_state.adaptive_dt``, per instance): a stage's
    dt."""
    st, fr = late_state.raining_state(NX, NY, NZ, N, SEED)
    js = jstate.LESState(**{k: jnp.asarray(v) for k, v in st.items()})
    jf = jstate.LESForcing(**{k: jnp.asarray(v) for k, v in fr.items()})
    ts, tf = interop.les_state(st, "cpu"), interop.les_forcing(fr, "cpu")
    dt = late_state.adaptive_dt(TG, ts)
    return js, jf, ts, tf, dt


def test_raining_state_rains():
    """The builder's state is what it says: a cloud of liquid water between
    0.5 and 3 km and none above, rain up to 1e-3, drafts of 2-3.5 m/s
    whose anelastic divergence vanishes to float32 rounding, and a
    CFL-limited dt of a few seconds."""
    st, fr = late_state.raining_state(NX, NY, NZ, N, SEED)
    ts = interop.les_state(st, "cpu")
    ql = tstep.thermodynamics(ts)[1].mean(dim=(2, 3)).numpy()
    z = (np.arange(NZ) + 0.5) * 25.0
    assert ql[:, (z > 600) & (z < 2900)].min() > 2e-4
    assert ql[:, z > 3100].max() == 0.0
    assert 5e-4 < st["qr"].max() <= 1e-3 and 2 < np.abs(st["w"]).max() <= 3.5
    assert np.all(st["w"][:, [0, -1]] == 0.0)
    div = advect.divergence(TG, ts.rhobf, ts.rhobh, ts.u, ts.v, ts.w)
    assert float(div.abs().max()) < 1e-6
    assert all(v.dtype == np.float32 for v in (*st.values(), *fr.values()))
    dt = late_state.adaptive_dt(TG, ts).numpy()
    assert np.all((dt > 1.0) & (dt < 10.0))


def _jax_plain_stage(cur, base, frc, dt):
    """tests/test_ops.py's plain stage: tendencies() + the RK axpy, one
    instance (vmapped by the caller)."""
    t = jstep.tendencies(JG, jstep.LESPhysics(use_pallas=False), cur, frc,
                         dt)
    f = FRAC * dt
    out = (base.u + f * t["u"], base.v + f * t["v"],
           (base.w + f * t["w"])[:-1], base.thl + f * t["thl"],
           jnp.maximum(base.qt + f * t["qt"], 0.0),
           jnp.maximum(base.qr + f * t["qr"], 0.0),
           jnp.maximum(base.e12 + f * t["e12"], jsg.E12_MIN))
    return out + (t["kmax"], jnp.mean(t["ustar"] ** 2), t["surf_rain"])


def check_stage(got, ref, base=None):
    """The port's stage outputs against JAX's (numpy, [n, ...]): outputs
    at FIELD_TOL, kmax, u*^2 and the rain flux; with base, the
    increments out - base at INC_FRAC of their max."""
    for k, a, b in zip(NAMES, got[:7], ref[:7]):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, err_msg=k, **FIELD_TOL)
        if base is not None:
            bk = getattr(base, k).numpy()
            bk = bk[:, :-1] if k == "w" else bk
            scale = np.abs(b - bk).max()
            np.testing.assert_allclose(
                a - bk, b - bk, rtol=cs.INC_RTOL, atol=cs.INC_FRAC * scale,
                err_msg=k + " increment")
    np.testing.assert_allclose(got[7].numpy(), np.asarray(ref[7]), rtol=1e-4,
                               err_msg="kmax")
    np.testing.assert_allclose(got[8].numpy(), np.asarray(ref[8]), rtol=1e-3,
                               err_msg="ustar2")
    np.testing.assert_allclose(got[9].numpy(), np.asarray(ref[9]), rtol=1e-3,
                               atol=1e-10, err_msg="rain")


@pytest.mark.parametrize("base", ["state", "constants"])
def test_stage_matches_jax_plain(case, base):
    """One stage (frac 1/3) from the raining state, base the state itself
    (a substep's first stage) or chip_smoke's base of constants (the
    increments held on their own)."""
    js, jf, ts, tf, dt = case
    tb = ts if base == "state" else cs.increment_base(ts)
    jb = jstate.LESState(**{k: jnp.asarray(v.numpy()) for k, v in
                            tb._asdict().items()})
    ref = jax.jit(jax.vmap(_jax_plain_stage))(js, jb, jf,
                                              jnp.asarray(dt.numpy()))
    got = lesstage.stage_fused_reference(TG, tstep.LESPhysics(), ts, tb, tf,
                                         FRAC, dt)
    check_stage(got, ref, None if base == "state" else tb)
    # the state rains: the surface flux and the qr increment are not 0
    assert float(np.min(np.asarray(ref[9]))) > 0


def check_substeps(s, k, ref, ref_k):
    for f in NAMES + ("rain", "ustar", "time"):
        a, b = getattr(s, f).numpy(), np.asarray(getattr(ref, f))
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a, b, rtol=SUBSTEP_FRAC,
                                   atol=SUBSTEP_FRAC * scale, err_msg=f)
    np.testing.assert_allclose(k.numpy(), np.asarray(ref_k), rtol=1e-3)


def port_substeps(ts, tf, dt):
    """SUBSTEPS of the port's kernel path at dt (its plain version on the
    CPU: no launch); returns (state, kmax)."""
    n0 = lesstage.launches
    s = ts
    for _ in range(SUBSTEPS):
        s, k = tstep.substep(TG, tstep.LESPhysics(), s, tf, dt)
    assert lesstage.launches == n0
    return s, k


def test_substeps_match_jax_plain(case):
    """20 substeps at half the state's adaptive dt: JAX's plain path
    (jitted, vmapped over the two instances) against the port's; the
    adaptive dt stays above it throughout."""
    js, jf, ts, tf, dt = case
    dt = DT_FRAC * dt
    phys = jstep.LESPhysics(use_pallas=False)

    def loop(s, f, d):
        def body(i, c):
            return jstep.substep(JG, phys, c[0], f, d)
        return jax.lax.fori_loop(0, SUBSTEPS, body,
                                 (s, jnp.zeros((), jnp.float32)))

    ref, ref_k = jax.jit(jax.vmap(loop))(js, jf, jnp.asarray(dt.numpy()))
    s, k = port_substeps(ts, tf, dt)
    check_substeps(s, k, ref, ref_k)
    assert float(s.rain.min()) > 0
    assert bool((late_state.adaptive_dt(TG, s) > dt).all())


def _ensemble():
    with open(ENSEMBLE) as f:
        return json.load(f)


# what the ensemble covered: each seed's last step, and the windows every
# recording holds whole (their distance holds, and the reference's climate
# means inside the members' envelope, all passed)
ENDS = {"seed42": 98, "seed43": 76, "seed44": 81, "seed45": 72}
COVERED = ((1, 10), (11, 50))


def test_tpu_recording_inside_the_ensemble():
    """JAX's TPU recording (tests/golden/spifs.nc, read only) against the
    card's ensemble (config2_seeds.json). In each window the seeds cover,
    every distance hold passes (the median of the members' distances
    within HOLD_FACTOR x their widest pair) and each of REPORT_VARS has
    the TPU's climate mean, recomputed here from the recording, inside
    [lo - r, hi + r] of the members'. Window 51-100, which no seed
    covers, holds nothing: it stands as a failure with each seed's end,
    its numbers only partial."""
    ens = _ensemble()
    assert ens["paths"] == ["golden"] + sorted(ENDS)
    assert [w["steps"] for w in ens["windows"]] == [list(w) for w in
                                                    golden.WINDOWS]
    for w in ens["windows"]:
        if tuple(w["steps"]) not in COVERED:
            assert not w["covered"] and "hold" not in w
            assert w["ends"] == ENDS
            continue
        assert w["covered"] and w["steps_used"] == list(
            range(w["steps"][0], w["steps"][1] + 1))
        assert set(w["hold"]) == set(golden.HOLD_VARS)
        for v, h in w["hold"].items():
            assert len(h["d_members"]) == 4
            med = float(np.median(h["d_members"]))
            np.testing.assert_allclose(med, h["d_ref"], rtol=1e-5)
            assert med <= golden.HOLD_FACTOR * h["seed_spread"], (w, v)
            assert h["ok"], (w["steps"], v)
    climate = {tuple(c["steps"]): c for c in ens["climate"]}
    held = climate[golden.CLIMATE]
    assert held["held"] and not held["covered"] and "hold" not in held
    for steps in COVERED:
        c = climate[steps]
        assert c["covered"] and set(c["hold"]) == set(golden.REPORT_VARS)
        means = golden.column_means(golden.GOLDEN_DIR, steps=steps)
        for v, h in c["hold"].items():
            tpu = float(np.mean(means[v]))
            np.testing.assert_allclose(tpu, h["ref"], rtol=1e-5, err_msg=v)
            assert h["lo"] - h["r"] <= tpu <= h["hi"] + h["r"], (steps, v)
            assert h["ok"], (steps, v)
    last = min(ENDS.values())
    assert ens["failures"] == [
        "steps %d-%d: not covered, no %s hold (%s)" % (
            *golden.CLIMATE, what, ", ".join(
                "%s ends at step %d" % kv for kv in sorted(ENDS.items())))
        for what in ("distance", "climate")]
    assert held["steps_used"] == list(range(golden.CLIMATE[0], last + 1))
