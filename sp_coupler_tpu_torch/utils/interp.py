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


def searchsorted(a, v, side="left"):
    """Indices where v would be inserted into ascending a
    (``jnp.searchsorted``; int64 here, int32 there)."""
    return torch.searchsorted(a, v, right=side == "right")


def integral(a, b, z, q, w=None):
    """Integral over [a, b] of piecewise-constant q on ascending edges z
    (q[..., i] on [z[i], z[i+1]]); with weights w the w-weighted mean of q
    over [a, b] (sputils.py:94-161). a, b: numbers or [...] tensors."""
    a = torch.as_tensor(a, dtype=z.dtype, device=z.device)
    b = torch.as_tensor(b, dtype=z.dtype, device=z.device)
    a, b = torch.minimum(a, b)[..., None], torch.maximum(a, b)[..., None]
    lo = torch.maximum(z[..., :-1], a)
    hi = torch.minimum(z[..., 1:], b)
    overlap = torch.clamp_min(hi - lo, 0.0)
    if w is None:
        return torch.sum(q * overlap, dim=-1)
    return (torch.sum(w * q * overlap, dim=-1)
            / torch.sum(w * overlap, dim=-1))


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


def interp_c(Zh_desc, zh, q, rho):
    """Conservative coarse-graining of fine-grid q [..., nz] onto the
    descending GCM cells: one matvec with conservative_matrix
    (sputils.interp_c, sputils.py:173-189)."""
    return torch.matmul(conservative_matrix(Zh_desc, zh, rho),
                        q[..., None])[..., 0]


def interp_rho(Zh_desc, zh, rho):
    """Coarse-grid density: plain (unweighted) cell means of rho
    (sputils.py:191-197); zero in cells not below the LES top."""
    num = torch.matmul(overlap_lengths(Zh_desc, zh), rho[..., None])[..., 0]
    cell = Zh_desc[..., :-1] - Zh_desc[..., 1:]
    inside = Zh_desc[..., :-1] < zh[..., -1:]
    return torch.where(inside, num / torch.where(cell > 0, cell, 1.0), 0.0)
