"""Latitude bands of the GCM's Gaussian grid over the mesh's ranks (--gcmprocs).

The JAX package lays the grid space of its GCM out in latitude bands over
the whole mesh, ``P(("les", "x", "y"))`` on the latitude axis of every
grid-space array and zonal spectrum, and keeps the spectral coefficients
replicated (``SpectralTransform.constrain_grid`` / ``constrain_spec``,
``sp_coupler_tpu/models/gcm/spharm.py``); GSPMD then turns the Legendre
analysis into partial sums and an all-reduce. Here rank r of the mesh
(rank = slot * x * y + ix * y + iy, ``parallel/mesh.py``) holds latitude
rows ``[r nlat / P, (r + 1) nlat / P)``, north to south: the shard GSPMD
gives device r. The bands are equal: P must divide nlat (GSPMD would pad
instead).

- ``sum_``: an ``all_reduce`` SUM in place (the analysis's partial sums);
  one collective gives every rank the same sum, so the spectral state
  stays the same on every rank, bit for bit;
- ``gather``: the whole grid from the bands, on every rank (restart);
- ``columns``: grid columns from the ranks whose bands hold their rows,
  zeros from the others, summed: exact, so equal to one process's
  extraction bit for bit.

Every operation is a collective of the group: every rank calls it, in the
same order. Under gloo a CUDA tensor goes through host memory; under nccl
it stays on the card (``mesh.staged``).
"""

import torch
import torch.distributed as dist

from .mesh import staged


class Bands:
    """Rank r's band of an nlat-row grid split into P equal latitude bands
    over the ranks of group (None: the world), in rank order."""

    def __init__(self, nlat, P, r, group=None):
        if nlat % P:
            raise ValueError(
                "a Gaussian grid of nlat = %d latitude rows does not split "
                "into P = %d equal bands: give a --gcmprocs mesh whose size "
                "divides nlat" % (nlat, P))
        self.nlat, self.P, self.r = int(nlat), int(P), int(r)
        self.nb = self.nlat // self.P
        self.r0 = self.r * self.nb
        self.r1 = self.r0 + self.nb
        self.group = group

    def cut(self, f):
        """This rank's rows of whole-grid f [..., nlat, nlon]."""
        return f[..., self.r0:self.r1, :]

    # ---- collectives -----------------------------------------------------

    def sum_(self, t):
        """t summed over the bands' ranks, in place (t contiguous)."""
        if staged(t, self.group):
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, f):
        """The whole grid [..., nlat, nlon] of the bands f [..., nb, nlon],
        on every rank."""
        host = staged(f, self.group)
        src = (f.cpu() if host else f).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.P)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=-2)
        return out.to(f.device) if host else out

    def columns(self, fields, col_idx):
        """Each of fields [..., nb, nlon] (this rank's band) at the flat
        lat-major column indices col_idx [n] of the whole grid: [..., n],
        each value from the rank whose band holds its row; one all_reduce
        for all the fields."""
        nlon = fields[0].shape[-1]
        j, i = col_idx // nlon, col_idx % nlon
        mine = (j >= self.r0) & (j < self.r1)
        jl = torch.clamp(j - self.r0, 0, self.nb - 1)
        n = col_idx.shape[0]
        taken = [f[..., jl, i] for f in fields]
        packed = torch.cat([t.reshape(-1, n) for t in taken])
        packed = torch.where(mine, packed, torch.zeros_like(packed))
        self.sum_(packed)
        out, off = [], 0
        for t in taken:
            w = t.numel() // n
            out.append(packed[off:off + w].reshape(t.shape))
            off += w
        return out


def for_mesh(mesh, nlat):
    """The Bands of this rank for an nlat-row grid over every rank of mesh
    (the JAX driver's shard axis ("les", "x", "y")), or None without a
    mesh or on one rank. Raises ValueError where the ranks do not divide
    nlat."""
    if mesh is None:
        return None
    P = mesh.les * mesh.x * mesh.y
    return None if P == 1 else Bands(nlat, P, mesh.rank)
