"""JAX's Pallas stage kernel (``lesstage_pallas``, in interpret mode on the
CPU, as tests/test_ops.py runs it) against the port in the raining,
deep-cloud LES state of tests/test_torch_late_state.py, which holds the
JAX package's plain path against the port on the same state.

One RK stage (the kernel against the port's plain version of its stage
kernel, ``stage_fused_reference``) and 20 substeps (JAX's substep through
the kernel against the port's kernel path, its plain version on the
CPU), at that file's tolerances. JAX compiles the interpreted kernel once
for each RK fraction (~8 s each here), which is most of this file's time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sp_coupler_tpu.models.les import step as jstep
from sp_coupler_tpu.ops import lesstage_pallas as jls
from sp_coupler_tpu_torch.models.les import step as tstep
from sp_coupler_tpu_torch.ops import lesstage

import test_torch_late_state as late

case = late.case


def test_pallas_stage_matches_port(case):
    """One stage (frac 1/3) from the raining state: JAX's kernel (vmapped
    over the two instances: its custom vmap rule) against the port."""
    js, jf, ts, tf, dt = case
    phys = jstep.LESPhysics(use_pallas=True)
    assert jls.supported(late.JG, phys)
    ref = jax.jit(jax.vmap(lambda s, f, d: jls.stage_fused(
        late.JG, phys, s, s, f, late.FRAC, d)))(js, jf,
                                                jnp.asarray(dt.numpy()))
    got = lesstage.stage_fused_reference(late.TG, tstep.LESPhysics(), ts, ts,
                                         tf, late.FRAC, dt)
    late.check_stage(got, ref)
    assert float(np.min(np.asarray(ref[9]))) > 0


def test_pallas_substeps_match_port(case):
    """20 substeps at half the adaptive dt through JAX's kernel (jitted,
    vmapped) against the port's kernel path."""
    js, jf, ts, tf, dt = case
    dt = late.DT_FRAC * dt
    phys = jstep.LESPhysics(use_pallas=True)

    def loop(s, f, d):
        def body(i, c):
            return jstep.substep(late.JG, phys, c[0], f, d)
        return jax.lax.fori_loop(0, late.SUBSTEPS, body,
                                 (s, jnp.zeros((), jnp.float32)))

    ref, ref_k = jax.jit(jax.vmap(loop))(js, jf, jnp.asarray(dt.numpy()))
    s, k = late.port_substeps(ts, tf, dt)
    late.check_substeps(s, k, ref, ref_k)
