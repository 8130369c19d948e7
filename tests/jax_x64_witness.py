"""The JAX driver's coupled steps in float64 from a float32 start: the
witness of float64 that tests/test_torch_driver.py holds config 5's f_T
against.

    JAX_PLATFORMS=cpu python tests/jax_x64_witness.py START.pkl OUT_DIR STEPS

START.pkl holds (config dict, [(lon, lat)], GCM state, LES state), the
states as numpy pytrees taken from a float32 runner's initialize. Under
jax_enable_x64 the runner is initialized from the same config (its tables
in float64), its GCM and LES states are replaced by the float32 start cast
to float64 (a float64 initialize would draw other start noise), and it
takes STEPS coupled steps; OUT_DIR/spifs.nc holds the records (float32 on
disk, as every run's).
"""

import pickle
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sp_coupler_tpu.config import SPConfig  # noqa: E402
from sp_coupler_tpu.runtime.driver import SPRunner  # noqa: E402
from sp_coupler_tpu.utils import geometry  # noqa: E402


def as_float64(tree):
    """Every floating leaf of tree as a float64 array."""
    def up(x):
        x = np.asarray(x)
        return jnp.asarray(x, jnp.float64 if np.issubdtype(
            x.dtype, np.floating) else x.dtype)
    return jax.tree.map(up, tree)


def main(start, out_dir, steps):
    with open(start, "rb") as f:
        cfg, points, gcm, les = pickle.load(f)
    r = SPRunner(SPConfig(output_dir=out_dir, **cfg),
                 [geometry.Point(p) for p in points])
    r.initialize()
    r.gcm.state, r.fleet.state = as_float64(gcm), as_float64(les)
    r.run(steps)
    r.finalize()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
