"""The port's parity run started from the JAX package's GCM state, with the
port's own LES draws.

The port's GCMCore.initial_state(seed) draws its vorticity perturbation
from a torch.Generator and JAX's from jax.random, so the two packages'
parity runs start from different GCM states. This run takes JAX's GCM
start (carried over with ``interop``) and seeds the LES from it with the
port's CPU generators, so that ``compare`` against JAX's run shows what
the LES draws alone do. It imports both packages, as the tests do.

Usage (on the CPU, ~20 min for the real case's 3 steps on 6 cores):
    JAX_PLATFORMS=cpu python tests/parity_from_jax_gcm.py OUT.npz [STEPS]
    python -m sp_coupler_tpu_torch.verify.parity compare \\
        sp_coupler_tpu_torch/verify/ref/parity_real_jax_cpu.npz OUT.npz
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 7


def main(argv):
    import jax
    from sp_coupler_tpu.models.gcm import model as jmodel
    from sp_coupler_tpu_torch import interop
    from sp_coupler_tpu_torch.models.gcm import model as tmodel
    from sp_coupler_tpu_torch.models.les import grid as lgrid
    from sp_coupler_tpu_torch.verify import parity
    r = parity.REAL
    cfg = dict(trunc=r["trunc"], nlev=r["nlev"], dt=600.0)
    gs = interop.gcm_state(jax.tree.map(np.asarray, jmodel.GCMCore(
        jmodel.GCMConfig(**cfg)).initial_state(seed=SEED)), "cpu")
    core = tmodel.GCMCore(tmodel.GCMConfig(**cfg), device="cpu")
    grid = lgrid.LESGrid(nx=r["les_n"], ny=r["les_n"], nz=r["les_nz"],
                         dx=200.0, dy=200.0, dz=r["les_dz"])
    cols = np.linspace(100, 350, r["n_les"]).astype(np.int32)
    les = parity.init_les(core, grid, gs, cols, SEED)
    parity.run(argv[0], n_steps=int(argv[1]) if len(argv) > 1 else 3,
               device="cpu", init=(gs, les), seed=SEED, **r)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
