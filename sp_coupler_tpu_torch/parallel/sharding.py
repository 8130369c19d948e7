"""Rows of the fleet across the les axis.

Port of ``sp_coupler_tpu/parallel/sharding.py`` for instance parallelism.
The JAX package declares shardings and lets XLA insert the collectives;
here a rank holds its block of the fleet and the coupled step moves rows
explicitly:

- ``local_rows`` cuts tensors of the whole fleet ([n, ...], computed the
  same on every rank) to this rank's block: the counterpart of
  ``constrain_fleet`` / ``constrain_columns`` on a les-only mesh;
- ``gather_rows`` joins every rank's block into the whole fleet, in
  position order, with one ``all_gather`` for a whole tree of tensors: the
  counterpart of ``replicated`` on les-sharded data (XLA's all-gather
  over the les axis in the coupled step's ``_post``).

Under gloo a CUDA tensor goes through host memory (gloo gathers CPU
tensors); under nccl it stays on the card (``mesh.staged``).
"""

import math

import torch
import torch.distributed as dist

from ..utils import tree as tree_util
from .mesh import staged


def spatial_axes(mesh):
    """Whether the mesh carves the LES horizontal plane (reference P2,
    --lesprocs / DALES nprocx x nprocy)."""
    return mesh is not None and (
        mesh.shape.get("x", 1) > 1 or mesh.shape.get("y", 1) > 1)


def local_rows(tree, mesh, n):
    """tree with every tensor of leading extent n cut to this rank's
    block of the fleet; other leaves unchanged. Identity without a
    mesh."""
    if mesh is None:
        return tree
    b = mesh.block(n)
    leaves, spec = tree_util.flatten(tree)
    return tree_util.unflatten(spec, iter(
        x[b] if torch.is_tensor(x) and x.dim() and x.shape[0] == n else x
        for x in leaves))


def all_rows(x, mesh):
    """[L, *x.shape]: x of every slot of the mesh, in slot order, on x's
    device. Every slot's x has the same shape and dtype."""
    host = staged(x, mesh.group)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.les)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts)
    return out.to(x.device) if host else out


def _as_f32(x):
    if x.dtype == torch.float32:
        return x
    if x.dtype == torch.int32:
        return x.view(torch.float32)    # the bits, not the value
    raise TypeError("gather_rows takes float32 and int32 tensors, not %s"
                    % x.dtype)


def gather_rows(tree, mesh, n):
    """The whole fleet's rows of a tree of [n / L, ...] tensors (this
    rank's block of n instances, L dividing n), in position order, on
    every rank; one all_gather for the whole tree. float32 and int32
    leaves cross bit for bit. Identity without a mesh or on one slot."""
    if mesh is None or mesh.les == 1:
        return tree
    if n % mesh.les:
        raise ValueError("%d instances on %d slots: gather_rows takes "
                         "equal blocks" % (n, mesh.les))
    leaves, spec = tree_util.flatten(tree)
    rows = n // mesh.les
    widths = [math.prod(x.shape[1:]) for x in leaves]
    packed = torch.cat([_as_f32(x).reshape(rows, w)
                        for x, w in zip(leaves, widths)], dim=1)
    whole = all_rows(packed, mesh).reshape(n, -1)
    out, off = [], 0
    for x, w in zip(leaves, widths):
        part = whole[:, off:off + w].contiguous()
        if x.dtype == torch.int32:
            part = part.view(torch.int32)
        out.append(part.reshape((n,) + tuple(x.shape[1:])))
        off += w
    return tree_util.unflatten(spec, iter(out))
