"""sp_coupler_tpu_torch — PyTorch/CUDA port of sp_coupler_tpu.

The coupled GCM + embedded-LES step of the JAX package (the spectral
GCM Eulerian or semi-Lagrangian, on sigma or hybrid levels), its run
driver and CLI (``runtime/driver.py``, ``python -m
sp_coupler_tpu_torch.spmaster``), rewritten on torch tensors: the same
modules, the same [n, z, y, x] layouts and float32 at every public
function. The TPU kernels (the fused LES RK stage and the split path's
scalar and momentum kernels) are hand-written CUDA kernels for Hopper
(``csrc/*.cu``, bound in ``ops/``).

The package imports neither ``jax`` nor the JAX package; its physical
constants, configuration, geometry, input-deck and spifs.nc modules are
copies of the JAX package's. Float32 products stay exact float32 (the
JAX package asks for HIGHEST precision on the spectral transforms and
the pressure projection), so TF32 is switched off on import. Its entry
points run on the CUDA card unless the caller asks for another device
(``default_device``).
"""

import subprocess
import time

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


def clock(device):
    """The host clock (time.time()) after the device's queue has drained:
    a synchronise first on a CUDA device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def device_name(device):
    """The CUDA card's name, or the device's type ("cpu")."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def card_line(device):
    """The CUDA card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them: of
    device's card, or for ``torch.device("cuda")`` of the current card (a
    rank's own)."""
    index = device.index
    if index is None and torch.cuda.is_available():
        index = torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[index or 0]


def generator(*key):
    """A CPU torch.Generator seeded from the integers of key (e.g. a run
    seed and an instance or step counter) through numpy's SeedSequence, so
    that keys that differ give unrelated streams. Callers draw on the CPU
    and move the draws to their device: a CUDA generator of the same seed
    gives another stream, and a seed must give one run on every device
    (as the JAX package's threefry keys do)."""
    import numpy as np
    seed = int(np.random.SeedSequence([int(k) for k in key])
               .generate_state(1)[0])
    return torch.Generator().manual_seed(seed)
