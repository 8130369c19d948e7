"""LES diagnostics: slab-mean profiles and cloud fraction on GCM levels.

Port of ``slab_profiles``, ``cloud_fraction_on_gcm_levels`` and
``fields_3d`` from ``sp_coupler_tpu/models/les/diag.py``, for a whole
fleet at once.
"""

import torch

from sp_coupler_tpu_torch import constants as c
from ...parallel.plane import reducer
from ...utils import interp as _interp
from . import micro, step as _step
from .advect import sp, col, X, Y

QL_CLOUD_THRESHOLD = 1e-8  # kg/kg; a cell with more condensate is "cloudy"


def slab_profiles(grid, state, plane=None):
    """Dict of [n, nz] slab-mean profiles + [n] scalars; plane: this
    rank's block of the planes (``parallel.plane.Plane``), whose means
    and standard deviation are over the whole plane, or None."""
    red = reducer(plane)
    T, ql, qs, thv = _step.thermodynamics(state)
    mean = red.mean
    if plane is None:
        uc = 0.5 * (state.u + sp(state.u, X))
        vc = 0.5 * (state.v + sp(state.v, Y))
    else:   # the centred winds need the next block's u and v
        pad = plane.padded(1)
        u, v = plane.halo([state.u, state.v], 1)
        uc = pad.crop(0.5 * (u + sp(u, X)))
        vc = pad.crop(0.5 * (v + sp(v, Y)))
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
        "qt_std": red.std(state.qt),
    }


def cloud_fraction_on_gcm_levels(grid, cloudfrac_z, gcm_Zh_desc):
    """Thickness-weighted mean LES cloud fraction inside each GCM layer,
    top-first; layers above the LES top get 0. cloudfrac_z [n, nz],
    gcm_Zh_desc [n, L+1] -> [n, L]."""
    zh = grid.zh(cloudfrac_z.device)
    W = _interp.conservative_matrix(gcm_Zh_desc, zh,
                                    torch.ones_like(cloudfrac_z))
    return torch.matmul(W, cloudfrac_z[..., None])[..., 0]


def fields_3d(state):
    """3-D diagnostic fields [n, nz, ny, nx] for the variability nudge
    (get_field access, spcpl.py:627-636)."""
    T, ql, qs, thv = _step.thermodynamics(state)
    return {"QT": state.qt, "THL": state.thl, "QL": ql, "Qsat": qs, "T": T}
