"""sp_coupler_tpu_torch — PyTorch/CUDA port of sp_coupler_tpu.

The coupled T21 GCM + embedded-LES step of the JAX package, rewritten on
torch tensors: the same modules, the same [n, z, y, x] layouts and float32
at every public function. The one TPU kernel on that path (the fused LES
RK stage, ``sp_coupler_tpu/ops/lesstage_pallas.py``) is a hand-written
CUDA kernel for Hopper (``csrc/lesstage.cu``, bound in ``ops/lesstage``).

The package imports neither ``jax`` nor the JAX package; its physical
constants are a copy of ``sp_coupler_tpu.constants``. Float32 products stay exact float32 (the
JAX package asks for HIGHEST precision on the spectral transforms and
the pressure projection), so TF32 is switched off on import. Its entry
points run on the CUDA card unless the caller asks for another device
(``default_device``).
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device(device=None):
    """``torch.device(device)``, or the CUDA card when device is None.
    Raises RuntimeError for None where there is no card: pass
    device="cpu" to run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")
