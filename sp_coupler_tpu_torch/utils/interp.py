"""Vertical-grid interpolation and conservative remapping on torch tensors.

Port of ``sp_coupler_tpu/utils/interp.py``. Every function takes optional
leading batch dimensions (one per column), so the coupler calls them once
for the whole set of SP columns instead of once per column.
"""

import numpy as np
import torch


def interp(x, xp, fp):
    """Linear interpolation on ascending xp with numpy.interp edge
    semantics (clamped to the end values outside the range).

    x [..., m]; xp, fp [..., k] (xp may be 1-D and shared). Mirrors the
    arithmetic of ``jnp.interp`` step for step.
    """
    xp = xp.expand(fp.shape).contiguous()
    x = x.expand(fp.shape[:-1] + x.shape[-1:]).contiguous()
    k = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, k - 1)
    xp0, xp1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fp0, fp1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = x - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp0,
                    fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def interp_desc(x, xp_desc, fp_desc):
    """Linear interpolation where xp is in descending order."""
    return interp(x, torch.flip(xp_desc, (-1,)), torch.flip(fp_desc, (-1,)))


def overlap_lengths(Zh_desc, zh):
    """[..., nlev, nz] overlap of coarse cells (descending edges Zh_desc
    [..., nlev+1]) with fine cells (ascending edges zh [nz+1])."""
    top = Zh_desc[..., :-1, None]
    bot = Zh_desc[..., 1:, None]
    flo = zh[..., None, :-1]
    fhi = zh[..., None, 1:]
    return torch.clamp_min(torch.minimum(top, fhi) - torch.maximum(bot, flo),
                           0.0)


def conservative_matrix(Zh_desc, zh, rho):
    """Weight matrix W with (W @ q)[I] = rho-weighted mean of q in GCM
    cell I; rows of cells whose top is not below the LES top are zero."""
    ov = overlap_lengths(Zh_desc, zh)
    wrow = ov * rho[..., None, :]
    denom = torch.sum(wrow, dim=-1, keepdim=True)
    W = wrow / torch.where(denom > 0, denom, torch.ones_like(denom))
    inside = (Zh_desc[..., :-1] < zh[..., -1:])[..., None]
    return torch.where(inside, W, torch.zeros_like(W))
