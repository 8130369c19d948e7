"""The ``les`` mesh axis over torch.distributed ranks.

Port of ``sp_coupler_tpu/parallel/mesh.py`` for instance parallelism
(the reference's P1: one process per LES instance, the coupler gathering
their profiles). Each rank is one slot of the ``les`` axis and owns one
device; it holds the block of LES instances the JAX package's GSPMD
layout gives that slot, ``ceil(n / L)`` instances a slot, and runs the
small GCM replicated, as the JAX package's default does. Intra-LES
spatial decomposition (``x``/``y``, --lesprocs) and the GCM's latitude
bands (--gcmprocs) are not ported (ROADMAP.md, open items: spatial and
GCM decomposition).

Bring-up (``init_distributed``): the JAX package's own variables
``SPTPU_DIST_COORD`` (``host:port``, or an ``init_method`` URL such as
``file:///path``), ``SPTPU_DIST_NPROCS`` and ``SPTPU_DIST_PROC_ID``, or
torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``. On the
card the backend is ``nccl`` with one card per rank (``cuda:LOCAL_RANK``);
on the CPU it is ``gloo``. ``SPTPU_DIST_BACKEND=gloo`` on the card lets
ranks share cards; the collectives then go through host memory
(``sharding.gather_rows``).
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# how long a collective waits for the other ranks before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def pick_backend(device_type, requested, local_ranks, n_cards):
    """The process group's backend for ranks on device_type.

    requested: ``SPTPU_DIST_BACKEND`` (None or "" for the default).
    local_ranks: ranks on this host; n_cards: CUDA cards on it. nccl, the
    default on the card, needs a card for each rank and raises where
    there are fewer; gloo is the only backend on the CPU."""
    requested = requested or None
    if device_type != "cuda":
        if requested not in (None, "gloo"):
            raise ValueError("backend %r on %s: only gloo runs on the CPU"
                             % (requested, device_type))
        return "gloo"
    backend = requested or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError("unknown backend %r (nccl or gloo)" % backend)
    if backend == "nccl" and local_ranks > n_cards:
        raise ValueError(
            "nccl needs a card for each rank: %d ranks on this host, %d "
            "cards (SPTPU_DIST_BACKEND=gloo lets ranks share a card)"
            % (local_ranks, n_cards))
    return backend


def init_distributed(device):
    """Bring up the process group from the environment, once.

    device: the run's torch device (its type picks the backend). On the
    card each rank takes its own card as the current device (``cuda:
    LOCAL_RANK``; under gloo ``LOCAL_RANK`` modulo the cards). Returns
    whether a world of more than one rank is up; False, and nothing
    done, outside a multi-process launch."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coord = env.get("SPTPU_DIST_COORD")
    if coord:
        world = int(env.get("SPTPU_DIST_NPROCS", "1"))
        rank = int(env.get("SPTPU_DIST_PROC_ID", "0"))
        init = coord if "://" in coord else "tcp://" + coord
    elif all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        world, rank, init = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        return False
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = pick_backend(device.type, env.get("SPTPU_DIST_BACKEND"),
                           local_ranks, n_cards)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    log.info("process group up: rank %d of %d, backend %s", rank, world,
             backend)
    return world > 1


def shutdown():
    """Tear the process group down, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


class LesMesh:
    """The ``les`` axis: ``les`` slots, one a rank of ``group`` (None: the
    whole world), this process at slot ``rank``. ``shape`` has the JAX
    mesh's axis names, x and y of extent 1."""

    def __init__(self, les, rank, group=None):
        self.les = int(les)
        self.rank = int(rank)
        self.group = group
        self.shape = {"les": self.les, "x": 1, "y": 1}

    def per_slot(self, n):
        """Instances a slot holds: GSPMD's block rule, ceil(n / L)."""
        return -(-n // self.les)

    def block(self, n):
        """slice of the fleet positions this rank's slot holds."""
        per = self.per_slot(n)
        return slice(min(self.rank * per, n), min((self.rank + 1) * per, n))

    def positions(self, n):
        b = self.block(n)
        return list(range(b.start, b.stop))


def make_mesh(n_les=None):
    """The les axis over the world's ranks; n_les must be the world's
    size (one slot a rank)."""
    n_les = world_size() if n_les is None else int(n_les)
    if n_les != world_size():
        raise ValueError("a les axis of %d slots on %d ranks (one slot a "
                         "rank)" % (n_les, world_size()))
    return LesMesh(n_les, rank())


def local_les_positions(mesh, n_les):
    """Fleet positions this rank owns (all of them without a mesh)."""
    return list(range(n_les)) if mesh is None else mesh.positions(n_les)


def shard_fleet(state, mesh):
    """This rank's block of a whole fleet state (LESState or any tree of
    tensors with the fleet axis first)."""
    from . import sharding
    from ..utils import tree as tree_util
    n = tree_util.flatten(state)[0][0].shape[0]
    return sharding.local_rows(state, mesh, n)


def replicate(tree, mesh):
    """Check that every tensor of tree is the same on every rank of the
    mesh, bit for bit (the replicated GCM state); raises naming the first
    leaf that differs. Returns tree."""
    if mesh is None or mesh.les == 1:
        return tree
    from . import sharding
    from ..utils import tree as tree_util
    leaves, _ = tree_util.flatten(tree)
    for i, leaf in enumerate(leaves):
        if not torch.is_tensor(leaf):
            continue
        rows = sharding.all_rows(leaf.reshape(1, -1), mesh)
        for slot in range(1, mesh.les):
            if not torch.equal(rows[slot], rows[0]):
                raise RuntimeError(
                    "replicated leaf %d (shape %s) differs between slot 0 "
                    "and slot %d" % (i, tuple(leaf.shape), slot))
    return tree
