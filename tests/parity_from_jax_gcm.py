"""The port's parity run started from the JAX package's GCM state, with
the port's own LES draws or with JAX's LES start as well.

The port's GCMCore.initial_state(seed) draws its vorticity perturbation
from a torch.Generator and JAX's from jax.random, so the two packages'
parity runs start from different GCM states. This run takes JAX's GCM
start (carried over with ``interop``) and, by default, seeds the LES from
it with the port's CPU generators, so that ``compare`` against JAX's run
shows what the LES draws alone do. With ``--les-from-jax`` it takes the
LES start of JAX's ``parity.run`` too (its ``init_les``: the columns
``linspace(100, 350, n_les)``, one ``fold_in(PRNGKey(seed), i)`` key an
instance), so the two runs start from one state and differ only in their
arithmetic. It imports both packages, as the tests do.

Usage (on the CPU, ~20 min for the real case's 3 steps on 6 cores):
    JAX_PLATFORMS=cpu python tests/parity_from_jax_gcm.py OUT.npz [STEPS]
        [--les-from-jax]
    python -m sp_coupler_tpu_torch.verify.parity compare \\
        sp_coupler_tpu_torch/verify/ref/parity_real_jax_cpu.npz OUT.npz
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 7


def jax_start(trunc, nlev, les_n, les_nz, n_les, les_dz, les_dx=200.0,
              seed=SEED, **_):
    """The GCM and LES states JAX's ``parity.run`` starts from (its
    ``initial_state`` and ``init_les``), as numpy trees."""
    import jax
    import jax.numpy as jnp
    from sp_coupler_tpu.coupling import convert
    from sp_coupler_tpu.models.gcm import model as jmodel
    from sp_coupler_tpu.models.les import grid as jgrid, state as jstate
    core = jmodel.GCMCore(jmodel.GCMConfig(trunc=trunc, nlev=nlev, dt=600.0))
    grid = jgrid.LESGrid(nx=les_n, ny=les_n, nz=les_nz, dx=les_dx,
                         dy=les_dx, dz=les_dz)
    gs = core.initial_state(seed=seed)
    cols = np.linspace(100, 350, n_les).astype(np.int32)

    @jax.jit
    def init_les(gstate):
        prof0 = core.column_profiles(gstate, jnp.asarray(cols))
        conv0 = jax.vmap(lambda p: convert.convert_profiles(
            p, grid.zf()))(prof0)
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(seed), i))(jnp.arange(n_les))
        return jax.vmap(lambda u, v, thl, qt, ps, k: jstate.init_state(
            grid, u, v, thl, qt, ps, k))(
            conv0.u, conv0.v, conv0.thl, conv0.qt, conv0.ps, keys)

    return [jax.tree.map(np.asarray, s) for s in (gs, init_les(gs))]


def start(case, les_from_jax):
    """(GCMState, fleet LESState) of the port on the CPU: JAX's GCM start,
    and JAX's LES start or the port's draws from it."""
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.models.gcm import model as tmodel
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    from sp_coupler_tpu_torch.verify import parity
    jgs, jles = jax_start(**case)
    gs = interop.gcm_state(jgs, "cpu")
    if les_from_jax:
        return gs, interop.les_state(jles, "cpu")
    core = tmodel.GCMCore(tmodel.GCMConfig(
        trunc=case["trunc"], nlev=case["nlev"], dt=600.0), device="cpu")
    grid = lgrid.LESGrid(nx=case["les_n"], ny=case["les_n"],
                         nz=case["les_nz"], dx=200.0, dy=200.0,
                         dz=case["les_dz"])
    cols = np.linspace(100, 350, case["n_les"]).astype(np.int32)
    return gs, parity.init_les(core, grid, gs, cols, SEED)


def main(argv):
    from sp_coupler_tpu_torch.verify import parity
    les_from_jax = "--les-from-jax" in argv
    argv = [a for a in argv if a != "--les-from-jax"]
    parity.run(argv[0], n_steps=int(argv[1]) if len(argv) > 1 else 3,
               device="cpu", init=start(parity.REAL, les_from_jax),
               seed=SEED, **parity.REAL)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
