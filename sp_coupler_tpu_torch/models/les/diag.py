"""LES diagnostics: slab-mean profiles and cloud fraction on GCM levels.

Port of ``slab_profiles`` and ``cloud_fraction_on_gcm_levels`` from
``sp_coupler_tpu/models/les/diag.py``, for a whole fleet at once.
"""

import torch

from sp_coupler_tpu_torch import constants as c
from ...utils import interp as _interp
from . import micro, step as _step
from .advect import sp, col, X, Y

QL_CLOUD_THRESHOLD = 1e-8  # kg/kg; a cell with more condensate is "cloudy"


def slab_profiles(grid, state):
    """Dict of [n, nz] slab-mean profiles + [n] scalars."""
    T, ql, qs, thv = _step.thermodynamics(state)
    mean = lambda f: torch.mean(f, dim=(Y, X))
    uc = 0.5 * (state.u + sp(state.u, X))
    vc = 0.5 * (state.v + sp(state.v, Y))
    ql_w, ql_i = micro.ice_split(T, ql)
    Tv = T * (1.0 + (c.rv / c.rd - 1.0) * (state.qt - ql) - ql)
    rhof = mean(col(state.pbf) / (c.rd * Tv))
    return {
        "U": mean(uc),
        "V": mean(vc),
        "THL": mean(state.thl),
        "QT": mean(state.qt),
        "QL": mean(ql),
        "QL_ice": mean(ql_i),
        "QL_water": mean(ql_w),
        "QR": mean(state.qr),
        "T": mean(T),
        "presf": state.pbf,
        "Rhof": rhof,
        "Rhobf": state.rhobf,
        "PS": state.ps,
        "Rain": state.rain,
        "cloudfrac_z": mean((ql > QL_CLOUD_THRESHOLD).to(state.qt.dtype)),
        "qt_std": torch.std(state.qt, dim=(Y, X), unbiased=False),
    }


def cloud_fraction_on_gcm_levels(grid, cloudfrac_z, gcm_Zh_desc):
    """Thickness-weighted mean LES cloud fraction inside each GCM layer,
    top-first; layers above the LES top get 0. cloudfrac_z [n, nz],
    gcm_Zh_desc [n, L+1] -> [n, L]."""
    zh = grid.zh(cloudfrac_z.device)
    W = _interp.conservative_matrix(gcm_Zh_desc, zh,
                                    torch.ones_like(cloudfrac_z))
    return torch.matmul(W, cloudfrac_z[..., None])[..., 0]
