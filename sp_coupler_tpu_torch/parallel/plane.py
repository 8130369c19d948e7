"""One rank's block of an LES plane split over the ``x`` and ``y`` mesh axes.

The JAX package lays a fleet out as ``P("les", None, "y", "x")`` and lets
GSPMD turn the stencils' rolls into halo permutes and the slab means into
psums (``sp_coupler_tpu/parallel/sharding.py``). Here a rank holds its
block of every plane, ``[n, nz(+1), ny / n_y, nx / n_x]`` (y split over
the ``y`` axis, x over ``x``), and the ranks of a plane (the mesh's
plane group, ``LesMesh.plane_group``) move data explicitly:

- ``mean`` and ``amax``: plane means (float64 sums, one ``all_reduce`` SUM,
  divided by the whole plane's points) and maxima (``all_reduce`` MAX,
  exact, so an adaptive dt is the same on every rank);
- ``halo``: the block padded with h points a side from its periodic
  neighbours, corners included: x first, then y over rows that already
  carry their x halo, by point-to-point exchanges; with n_x = 1 the x halo
  is the block's own wrap (likewise y);
- ``gather`` and ``block``: the whole plane on every rank of the group,
  and this rank's cut of a whole plane.

Every operation is a collective of the plane group: every rank of it calls
it, in the same order. Under gloo a CUDA tensor goes through host memory;
under nccl it stays on the card (``mesh.staged``).

``WHOLE`` offers the same reductions on a whole plane in one tensor: the
plain torch reductions, so a run without spatial blocks is today's code,
bit for bit. ``Padded`` offers them on a block carrying a halo (the
interior only: a mean over a padded block must not count the halo).
"""

import torch
import torch.distributed as dist

from .mesh import staged

Y, X = -2, -1


def _argmax_take(key, vals):
    """vals at the first maximum of key over its last two dims."""
    flat = key.reshape(key.shape[:-2] + (-1,))
    imax = torch.argmax(flat, dim=-1, keepdim=True)
    return [torch.gather(v.reshape(flat.shape), -1, imax)[..., 0]
            for v in vals]


class WholePlane:
    """The whole plane in one tensor: torch's reductions over (Y, X)."""

    h = 0

    def crop(self, f):
        return f

    def mean(self, f, keepdim=False):
        return torch.mean(f, dim=(Y, X), keepdim=keepdim)

    def amax(self, f):
        """Per-instance maximum [n] of f [n, ...]."""
        return torch.amax(f, dim=tuple(range(1, f.dim())))

    def std(self, f):
        return torch.std(f, dim=(Y, X), unbiased=False)

    def argmax_take(self, key, *vals):
        """Each of vals at the first maximum of key over the plane (the
        flattened plane's order)."""
        return _argmax_take(key, vals)


WHOLE = WholePlane()


def reducer(plane):
    """plane, or WHOLE for None (the whole plane in one tensor)."""
    return WHOLE if plane is None else plane


class Plane:
    """This rank's block of an ny x nx plane split into n_y x n_x equal
    blocks, at block (ix, iy), among the ranks ``ranks`` of ``group`` (None:
    the world), ordered by ix * n_y + iy."""

    def __init__(self, ny, nx, n_y, n_x, iy, ix, group=None, ranks=None):
        if ny % n_y or nx % n_x:
            raise ValueError(
                "a plane of ny x nx = %d x %d does not split into %d x %d "
                "equal blocks (y over %d ranks, x over %d): give extents "
                "the mesh divides" % (ny, nx, n_y, n_x, n_y, n_x))
        self.ny, self.nx, self.n_y, self.n_x = ny, nx, n_y, n_x
        self.iy, self.ix = iy, ix
        self.by, self.bx = ny // n_y, nx // n_x
        self.y0, self.x0 = iy * self.by, ix * self.bx
        self.points = ny * nx
        self.group = group
        self.ranks = (list(ranks) if ranks is not None
                      else list(range(n_x * n_y)))

    # ---- collectives -----------------------------------------------------

    def _all_reduce(self, t, op):
        if staged(t, self.group):
            h = t.cpu()
            dist.all_reduce(h, op=op, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum_(self, t):
        """t summed over the plane's ranks, in place (float64 sums)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def max_(self, t):
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def _all_gather(self, t):
        """[G, *t.shape]: t of every rank of the plane, in group order."""
        host = staged(t, self.group)
        src = (t.cpu() if host else t).contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        out = torch.stack(parts)
        return out.to(t.device) if host else out

    # ---- reductions over the plane ---------------------------------------

    def mean(self, f, keepdim=False):
        """The plane mean of the blocks f [..., by, bx]: the block's sum in
        float64, summed over the ranks, over the whole plane's points."""
        s = torch.sum(f.to(torch.float64), dim=(Y, X), keepdim=keepdim)
        return (self.sum_(s.contiguous()) / self.points).to(f.dtype)

    def amax(self, f):
        """Per-instance maximum [n] of f [n, ...] over the whole plane."""
        return self.max_(torch.amax(f, dim=tuple(range(1, f.dim())))
                         .contiguous())

    def std(self, f):
        """Population standard deviation over the plane, in two passes
        over the plane mean."""
        d = f - self.mean(f, keepdim=True)
        return torch.sqrt(self.mean(d * d))

    def argmax_take(self, key, *vals):
        """Each of vals at the first maximum of key over the whole plane,
        in the whole plane's flattened order (torch.argmax's tie rule)."""
        flat = key.reshape(key.shape[:-2] + (-1,))
        imax = torch.argmax(flat, dim=-1, keepdim=True)
        ly, lx = imax // self.bx, imax % self.bx
        gidx = (self.y0 + ly) * self.nx + self.x0 + lx
        local = [torch.gather(flat, -1, imax)] + [
            torch.gather(v.reshape(flat.shape), -1, imax) for v in vals]
        packed = torch.cat([gidx.to(torch.float64)]
                           + [x.to(torch.float64) for x in local], dim=-1)
        allp = self._all_gather(packed)                 # [G, ..., 2 + V]
        best = torch.amax(allp[..., 1], dim=0)
        idx = torch.where(allp[..., 1] == best, allp[..., 0],
                          torch.full_like(allp[..., 0], float("inf")))
        pick = torch.argmin(idx, dim=0)[None, ..., None]
        won = torch.gather(allp, 0, pick.expand((1,) + allp.shape[1:]))[0]
        return [won[..., 2 + j].to(v.dtype) for j, v in enumerate(vals)]

    def padded(self, h):
        """The reductions on this plane's blocks padded with h points."""
        return Padded(self, h)

    # ---- moving blocks ---------------------------------------------------

    def _rank(self, ix, iy):
        return self.ranks[(ix % self.n_x) * self.n_y + iy % self.n_y]

    def _swap(self, lo, hi, to_lo, to_hi, tag):
        """Send lo (this block's low edge) to rank to_lo and hi to to_hi;
        return (what to_lo sent as its hi, what to_hi sent as its lo).

        One batch of point-to-point operations. nccl ignores tags and
        matches the messages between two ranks in the order they were
        posted, so the receives follow the peers' sends: every rank sends
        its lo, then its hi, and so receives first from to_hi (that
        rank's lo), then from to_lo (its hi). This holds where to_lo and
        to_hi are one rank (2 blocks on the axis); gloo matches the same
        messages by their tags."""
        host = staged(lo, self.group)
        lo_s, hi_s = ((x.cpu() if host else x).contiguous()
                      for x in (lo, hi))
        from_lo, from_hi = torch.empty_like(hi_s), torch.empty_like(lo_s)
        ops = [dist.P2POp(dist.isend, lo_s, to_lo, self.group, tag),
               dist.P2POp(dist.isend, hi_s, to_hi, self.group, tag + 1),
               dist.P2POp(dist.irecv, from_hi, to_hi, self.group, tag),
               dist.P2POp(dist.irecv, from_lo, to_lo, self.group, tag + 1)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        if host:
            from_lo, from_hi = (x.to(lo.device) for x in (from_lo, from_hi))
        return from_lo, from_hi

    def _pad_axis(self, f, h, axis):
        n = self.n_x if axis == X else self.n_y
        size = f.shape[axis]
        lo, hi = f.narrow(axis, 0, h), f.narrow(axis, size - h, h)
        if n == 1:                       # the block is the whole axis
            return torch.cat([hi, f, lo], dim=axis)
        if axis == X:
            left, right = self._rank(self.ix - 1, self.iy), \
                self._rank(self.ix + 1, self.iy)
            tag = 0
        else:
            left, right = self._rank(self.ix, self.iy - 1), \
                self._rank(self.ix, self.iy + 1)
            tag = 2
        from_lo, from_hi = self._swap(lo, hi, left, right, tag)
        return torch.cat([from_lo, f, from_hi], dim=axis)

    def halo(self, fields, h):
        """Each of fields [..., by, bx] padded with h points a side of the
        periodic neighbours' values, corners included: [..., by + 2h,
        bx + 2h]. One exchange for all the fields."""
        if h > self.by or h > self.bx:
            raise ValueError("a halo of %d points on a block of %d x %d"
                             % (h, self.by, self.bx))
        flat = torch.cat([f.reshape(-1, self.by, self.bx) for f in fields])
        out = self._pad_axis(self._pad_axis(flat, h, X), h, Y)
        parts, off = [], 0
        for f in fields:
            m = f.numel() // (self.by * self.bx)
            parts.append(out[off:off + m].reshape(
                f.shape[:-2] + (self.by + 2 * h, self.bx + 2 * h)))
            off += m
        return parts

    def gather(self, f):
        """The whole planes [..., ny, nx] of the blocks f [..., by, bx],
        on every rank of the plane."""
        parts = self._all_gather(f)
        rows = [torch.cat([parts[ix * self.n_y + iy]
                           for ix in range(self.n_x)], dim=X)
                for iy in range(self.n_y)]
        return torch.cat(rows, dim=Y)

    def block(self, f, h=0):
        """This rank's block of whole planes f [..., ny, nx], with h points
        of periodic halo a side."""
        if h == 0:
            return f[..., self.y0:self.y0 + self.by,
                     self.x0:self.x0 + self.bx].contiguous()
        dev = f.device
        rows = torch.arange(self.y0 - h, self.y0 + self.by + h,
                            device=dev) % self.ny
        cols = torch.arange(self.x0 - h, self.x0 + self.bx + h,
                            device=dev) % self.nx
        return f.index_select(Y % f.dim(), rows).index_select(X % f.dim(),
                                                              cols)

    def block_fields(self, tree_):
        """tree_ (a NamedTuple or dict of the fleet's tensors) with every
        field of 4 dims [n, nz(+1), ny, nx] cut to this rank's block."""
        cut = lambda x: (self.block(x) if torch.is_tensor(x) and x.dim() == 4
                         else x)
        if isinstance(tree_, dict):
            return {k: cut(v) for k, v in tree_.items()}
        return type(tree_)(*[cut(x) for x in tree_])

    def gather_fields(self, tree_):
        """tree_ with every field of 4 dims gathered into whole planes."""
        cat = lambda x: (self.gather(x) if torch.is_tensor(x) and x.dim() == 4
                         else x)
        if isinstance(tree_, dict):
            return {k: cat(v) for k, v in tree_.items()}
        return type(tree_)(*[cat(x) for x in tree_])


class Padded:
    """The reductions of a Plane on its blocks padded with h points a side:
    over the interior only."""

    def __init__(self, plane, h):
        self.plane, self.h = plane, h

    def crop(self, f):
        h = self.h
        return f[..., h:-h, h:-h]

    def mean(self, f, keepdim=False):
        return self.plane.mean(self.crop(f), keepdim)

    def amax(self, f):
        return self.plane.amax(self.crop(f))

    def std(self, f):
        return self.plane.std(self.crop(f))

    def argmax_take(self, key, *vals):
        return self.plane.argmax_take(self.crop(key),
                                      *[self.crop(v) for v in vals])


def for_mesh(mesh, ny, nx):
    """The Plane of this rank for an ny x nx plane on mesh, or None where
    the mesh does not split the plane (no mesh, x = y = 1). Raises
    ValueError where the mesh does not divide the plane."""
    if mesh is None or mesh.x * mesh.y == 1:
        return None
    return Plane(ny, nx, mesh.y, mesh.x, mesh.iy, mesh.ix,
                 mesh.plane_group, mesh.plane_ranks())
