"""Port's fused LES stage (sp_coupler_tpu_torch/ops/lesstage.py) vs JAX.

The plain PyTorch version ``stage_fused_reference`` is held against the
JAX package's Pallas stage kernel (interpret mode on the CPU) at the
setup and tolerances of tests/test_ops.py. The CUDA kernel itself runs
only on a card, against this plain version: tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sp_coupler_tpu.models.les import (grid as jgrid, state as jstate,
                                       step as jstep, subgrid as jsg)
from sp_coupler_tpu.ops import lesstage_pallas as jls
from sp_coupler_tpu_torch import interop
from sp_coupler_tpu_torch.models.les import grid as tgrid, step as tstep
from sp_coupler_tpu_torch.ops import lesstage, _build

torch.set_num_threads(1)

NZ = 32
JG = jgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)
TG = tgrid.LESGrid(nx=16, ny=16, nz=NZ, dz=25.0)
NAMES = ("u", "v", "w", "thl", "qt", "qr", "e12")


def _np(x):
    return jax.tree.map(np.asarray, x)


def _stage_setup():
    """tests/test_ops.py::test_stage_fused_matches_xla_stage inputs."""
    rng = np.random.default_rng(7)
    base = jstate.init_state(
        JG, jnp.asarray(np.linspace(-5, 5, NZ), jnp.float32),
        jnp.zeros(NZ, jnp.float32),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(1))
    base = base._replace(
        w=base.w.at[1:-1].set(jnp.asarray(
            rng.normal(0, 0.1, (NZ - 1, JG.ny, JG.nx)), jnp.float32)),
        qr=jnp.asarray(rng.uniform(0, 1e-4, (NZ, JG.ny, JG.nx)),
                       jnp.float32))
    cur = base._replace(thl=base.thl + 0.05, u=base.u * 1.01)
    frc = jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        f_thl=jnp.full(NZ, 1e-5), f_qt=jnp.full(NZ, -1e-9),
        f_u=jnp.full(NZ, 1e-5), f_v=jnp.full(NZ, -1e-5),
        z0m=jnp.asarray(0.1))
    return cur, base, frc


def _check_stage(got, ref, idx=0):
    """tests/test_ops.py:171-178 tolerances; got: port outputs [n, ...],
    ref: JAX outputs of instance idx."""
    for k, a, b in zip(NAMES, got[:7], ref[:7]):
        np.testing.assert_allclose(a[idx].numpy(), np.asarray(b),
                                   atol=5e-4, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got[7][idx]), float(ref[7]), rtol=1e-4)
    np.testing.assert_allclose(float(got[9][idx]), float(ref[9]),
                               rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(float(got[8][idx]), float(ref[8]),
                               rtol=1e-3)


def test_stage_reference_matches_jax_pallas_stage():
    """stage_fused_reference == JAX lesstage_pallas.stage_fused."""
    cur, base, frc = _stage_setup()
    dt, frac = 2.0, 0.5
    ref = jls.stage_fused(JG, jstep.LESPhysics(), cur, base, frc, frac, dt)
    got = lesstage.stage_fused_reference(
        TG, tstep.LESPhysics(), interop.les_state(_np(cur)),
        interop.les_state(_np(base)), interop.les_forcing(_np(frc)), frac,
        torch.tensor([dt]))
    _check_stage(got, ref)


def test_stage_fleet_matches_jax_vmapped_stage():
    """A fleet of 2 through the port == JAX's custom-vmapped kernel."""
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    st = jax.vmap(lambda k: jstate.init_state(
        JG, jnp.full(NZ, 4.0), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        jnp.asarray(101300.0), k))(keys)
    frc = jax.vmap(lambda _: jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        z0m=jnp.asarray(0.1)))(jnp.arange(2))
    dt, frac = 2.0, 1.0 / 3.0
    ref = jax.vmap(lambda s, f: jls.stage_fused(
        JG, jstep.LESPhysics(), s, s, f, frac, dt))(st, frc)
    ts, tf = interop.les_state(_np(st)), interop.les_forcing(_np(frc))
    got = lesstage.stage_fused(TG, tstep.LESPhysics(), ts, ts, tf, frac,
                               torch.full((2,), dt))
    for i in range(2):
        _check_stage(got, [r[i] for r in ref], idx=i)


def test_substep_through_fused_entry_matches_jax_split():
    """Port substep (use_kernel=True -> plain version on the CPU) == JAX
    substep(use_pallas=False), tests/test_ops.py:209-233."""
    st = jstate.init_state(
        JG, jnp.full(NZ, 4.0), jnp.full(NZ, -2.0),
        jnp.asarray(np.linspace(298, 312, NZ), jnp.float32),
        jnp.asarray(np.linspace(0.016, 0.002, NZ), jnp.float32),
        101300.0, jax.random.PRNGKey(3))
    frc = jstate.LESForcing.zeros(NZ)._replace(
        wthl=jnp.asarray(0.01), wqt=jnp.asarray(1e-5),
        z0m=jnp.asarray(0.1), z0h=jnp.asarray(0.02))
    dt = 2.0
    s_x, k_x = jstep.substep(JG, jstep.LESPhysics(use_pallas=False), st,
                             frc, dt)
    lesstage.launches = 0
    s_t, k_t = tstep.substep(TG, tstep.LESPhysics(use_kernel=True),
                             interop.les_state(_np(st)),
                             interop.les_forcing(_np(frc)),
                             torch.tensor([dt]))
    assert lesstage.launches == 0          # CPU tensors: no kernel launch
    for f in ("u", "v", "w", "thl", "qt", "qr", "e12", "rain", "ustar"):
        a, b = getattr(s_t, f)[0].numpy(), np.asarray(getattr(s_x, f))
        scale = max(np.max(np.abs(b)), 1e-12)
        np.testing.assert_allclose(a, b, atol=2e-3 * scale, rtol=2e-3,
                                   err_msg=f)
    np.testing.assert_allclose(float(k_t[0]), float(k_x), rtol=1e-3)


def test_stage_on_cpu_never_launches():
    cur, base, frc = _stage_setup()
    lesstage.launches = 0
    lesstage.stage_fused(TG, tstep.LESPhysics(), interop.les_state(_np(cur)),
                         interop.les_state(_np(base)),
                         interop.les_forcing(_np(frc)), 1.0,
                         torch.tensor([1.0]))
    assert lesstage.launches == 0


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("lesstage.cu", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-O3" in cmd and "-shared" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert open(_build.CSRC_DIR + "/lesstage.cu").read().count(
        'extern "C" int lesstage_stage(') == 1


def test_ctypes_args_mirror_cuda_struct():
    """The ctypes mirror lists the CUDA struct's fields in order."""
    src = open(_build.CSRC_DIR + "/lesstage.cu").read()
    body = src[src.index("struct StageArgs {"):]
    body = body[:body.index("};")]
    decl = [part.strip()
            for line in body.splitlines()[1:]
            if line.strip() and not line.strip().startswith("//")
            for part in line.split(";")[0].replace("const ", "")
            .split(None, 1)[1].replace("*", "").split(",")]
    py = [f[0] for f in lesstage._StageArgs._fields_]
    assert decl == py


def test_fall_speed_exponents_must_be_positive():
    from sp_coupler_tpu_torch.models.les import micro
    phys = tstep.LESPhysics(mphys=micro.MicroParams(sed_b=0.0))
    cur, base, frc = _stage_setup()
    with pytest.raises(ValueError, match="exponents"):
        lesstage.stage_fused_cuda(
            TG, phys, interop.les_state(_np(cur)),
            interop.les_state(_np(base)), interop.les_forcing(_np(frc)),
            1.0, torch.tensor([1.0]))


def test_cuda_wrapper_rejects_cpu_tensors():
    cur, base, frc = _stage_setup()
    with pytest.raises(ValueError, match="CUDA"):
        lesstage.stage_fused_cuda(
            TG, tstep.LESPhysics(), interop.les_state(_np(cur)),
            interop.les_state(_np(base)), interop.les_forcing(_np(frc)),
            1.0, torch.tensor([1.0]))
