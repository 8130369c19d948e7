"""The chunked evolve (``les_evolve_chunks`` > 1) of the port's coupled
step, against the unchunked step and against the JAX package's chunked
run, through the drivers at T10/L8 + one 16x16x24 LES column.

With les_dt 5 s and gcm_dt 600 s, 3 chunks of 200 s split the evolve
exactly: the adaptive loop takes the same substeps, so k = 3 and k = 1
agree at tests/test_driver.py:395-400's tolerances (THL rtol 2e-6, atol
2e-4; QT rtol 2e-5, atol 1e-8). The port's chunked run and JAX's, from
the same state, agree within 2e-3 of max|ref| plus 2e-3 |ref|, the bound
of tests/test_torch_driver.py.
"""

import os

import numpy as np
import jax
import pytest
import torch

from sp_coupler_tpu.config import SPConfig as JConfig
from sp_coupler_tpu.runtime.driver import SPRunner as JRunner
from sp_coupler_tpu.utils import geometry as jgeom
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.config import SPConfig
from sp_coupler_tpu_torch.interop import to_numpy
from sp_coupler_tpu_torch.runtime.driver import SPRunner
from sp_coupler_tpu_torch.utils import geometry

torch.set_num_threads(2)

SMALL = dict(gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
             les_itot=16, les_jtot=16, les_ktot=24, les_xsize=3200.0,
             les_ysize=3200.0, les_dz=100.0, les_dt=5.0)
POINT = (300.0, 15.0)


def _port(start, odir, **kw):
    """The port's driver from start (numpy GCM and LES states): 2 coupled
    steps. Returns the runner, its profiles (numpy) and model time."""
    r = SPRunner(SPConfig(output_dir=odir, **dict(SMALL, **kw)),
                 [geometry.Point(POINT)], device="cpu")
    r.initialize()
    r.gcm.state = interop.gcm_state(start[0], "cpu")
    r.fleet.state = interop.les_state(start[1], "cpu")
    r.run(2)
    r.finalize(save_restart=False)
    return r, to_numpy(r.fleet.get_profiles()), r.gcm.get_model_time()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's chunked run (k = 3); the port's k = 3 (through call_phased's
    cadence, timing_phases 1) and k = 1 from its start state."""
    d = lambda k: str(tmp_path_factory.mktemp(k) / "run")
    rj = JRunner(JConfig(output_dir=d("jax"), les_evolve_chunks=3, **SMALL),
                 [jgeom.Point(POINT)])
    rj.initialize()
    start = [jax.tree.map(np.asarray, s)
             for s in (rj.gcm.state, rj.fleet.state)]
    rj.run(2)
    jprof = jax.tree.map(np.asarray, rj.fleet.get_profiles())
    jtime = rj.gcm.get_model_time()
    rj.finalize(save_restart=False)
    return dict(jax=(rj, jprof, jtime),
                k3=_port(start, d("k3"), les_evolve_chunks=3,
                         timing_phases=1),
                k1=_port(start, d("k1"), timing_phases=0))


def test_chunked_matches_unchunked(runs):
    (r3, p3, t3), (r1, p1, t1) = runs["k3"], runs["k1"]
    assert r3.coupled.evolve_chunks == 3 and r1.coupled.evolve_chunks == 1
    assert t3 == t1 == 1200.0
    # 200 s chunks of a 5 s step: the same substeps, summed over chunks
    assert r3.substeps == r1.substeps and min(r3.substeps[0]) > 0
    np.testing.assert_allclose(p3["THL"], p1["THL"], rtol=2e-6, atol=2e-4)
    np.testing.assert_allclose(p3["QT"], p1["QT"], rtol=2e-5, atol=1e-8)


def test_chunked_matches_jax(runs):
    (rj, pj, tj), (r3, p3, t3) = runs["jax"], runs["k3"]
    assert t3 == tj and r3.sp_cols == rj.sp_cols
    for k in ("THL", "QT", "U", "V"):
        scale = max(float(np.max(np.abs(pj[k]))), 1e-12)
        np.testing.assert_allclose(p3[k], pj[k], rtol=2e-3,
                                   atol=2e-3 * scale, err_msg=k)


def test_chunked_step_is_not_phased(runs):
    """timing_phases 1 phases every step after the first, but a chunked
    step never goes through call_phased (JAX driver.py:706-709): its
    timing row keeps the pre and post columns at zero."""
    r3 = runs["k3"][0]
    with open(os.path.join(r3.cfg.output_dir, "timing.txt")) as f:
        rows = [ln.split() for ln in f if not ln.startswith("#")][1:]
    assert len(rows) == 2
    for row in rows:
        assert float(row[1]) == 0.0 and float(row[5]) == 0.0
