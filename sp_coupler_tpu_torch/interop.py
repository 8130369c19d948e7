"""Carry state between the JAX package and the port as numpy.

The JAX package's pytrees come in as ``jax.tree.map(np.asarray, x)``
NamedTuples or their ``_asdict()`` dicts of numpy arrays (no jax import is
needed here); they become the port's tensors on a given device.
``to_numpy`` turns the port's objects back into nested dicts of numpy
arrays. A single LES instance (fields [nz, ny, nx]) becomes a fleet of 1.
"""

import numpy as np
import torch

from .models.gcm.dycore import SpectralState, GridFields
from .models.gcm.model import GCMState
from .models.les.state import LESState, LESForcing


def _as_dict(x):
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def tensor(a, device=None):
    """numpy (or array-like) -> tensor on device, dtype kept."""
    return torch.as_tensor(np.array(a), device=device)


def _tensors(d, device):
    return {k: (None if v is None else tensor(v, device))
            for k, v in _as_dict(d).items()}


def spectral_state(d, device=None) -> SpectralState:
    return SpectralState(**_tensors(d, device))


def grid_fields(d, device=None) -> GridFields:
    return GridFields(**_tensors(d, device))


def gcm_state(d, device=None) -> GCMState:
    """GCMState (nested SpectralState / GridFields / dicts) -> port."""
    d = _as_dict(d)
    return GCMState(
        now=spectral_state(d["now"], device),
        prev=spectral_state(d["prev"], device),
        new=spectral_state(d["new"], device),
        grid=grid_fields(d["grid"], device),
        sfc=_tensors(d["sfc"], device),
        sp_tend=_tensors(d["sp_tend"], device),
        vdiff_mask=tensor(d["vdiff_mask"], device),
        time=tensor(d["time"], device))


def les_state(d, device=None) -> LESState:
    """LESState of one instance or a fleet -> fleet LESState."""
    t = _tensors(d, device)
    if t["u"].dim() == 3:
        t = {k: v[None] for k, v in t.items()}
    return LESState(**t)


def les_forcing(d, device=None) -> LESForcing:
    """LESForcing of one instance or a fleet -> fleet LESForcing."""
    t = _tensors(d, device)
    if t["f_u"].dim() == 1:
        t = {k: v[None] for k, v in t.items()}
    return LESForcing(**t)


def les_profiles(d, device=None):
    """LES slab-profile dict -> dict of tensors."""
    return _tensors(d, device)


def to_numpy(x):
    """Port objects (tensors, NamedTuples, dicts) -> numpy / nested dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
