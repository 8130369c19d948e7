"""The ``(les, x, y)`` mesh over torch.distributed ranks.

Port of ``sp_coupler_tpu/parallel/mesh.py``: instance parallelism (the
``les`` axis, the reference's P1: one process per LES instance, the
coupler gathering their profiles) and intra-LES spatial decomposition
(the ``x`` and ``y`` axes, the reference's P2: --lesprocs, DALES's
nprocx x nprocy). Each rank owns one device. The ranks are laid out as
the JAX package's ``make_mesh`` lays out its devices,
``reshape(les, x, y)``: rank = slot * x * y + ix * y + iy. A rank holds,
for the instances of its les slot (``ceil(n / L)`` a slot, GSPMD's block
rule), its block of their horizontal plane: y split over the ``y`` axis
and x over ``x``, as ``P("les", None, "y", "x")`` does
(``parallel/plane.py``). Every rank runs the small GCM replicated, as the
JAX package's default does, or with --gcmprocs its latitude band of the
GCM's grid, the bands over every rank of the mesh in rank order
(``parallel/bands.py``).

Bring-up (``init_distributed``): the JAX package's own variables
``SPTPU_DIST_COORD`` (``host:port``, or an ``init_method`` URL such as
``file:///path``), ``SPTPU_DIST_NPROCS`` and ``SPTPU_DIST_PROC_ID``, or
torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``. On the
card the backend is ``nccl`` with one card per rank (``cuda:LOCAL_RANK``);
on the CPU it is ``gloo``. ``SPTPU_DIST_BACKEND=gloo`` on the card lets
ranks share cards; the collectives then go through host memory
(``staged``). Under nccl every tensor of a collective stays on the rank's
card: a CPU tensor, or one on another card, raises (``staged``).
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
    LOCAL_RANK``; under gloo ``LOCAL_RANK`` modulo the cards). nccl with
    fewer cards than ranks raises; it never falls back to gloo. Returns
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
        if backend == "nccl" and local_rank >= n_cards:
            raise ValueError("nccl: local rank %d on a host of %d cards (one "
                             "card a rank)" % (local_rank, n_cards))
        torch.cuda.set_device(local_rank % n_cards)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    log.info("process group up: rank %d of %d, backend %s", rank, world,
             backend)
    return world > 1


# CUDA tensors the collectives took through host memory (gloo) in this
# process since the count was last set to 0; under nccl it stays 0
staged_tensors = 0


def staged(x, group=None):
    """Whether a collective of group takes the tensor x through host
    memory: a CUDA tensor under gloo, which moves CPU tensors only. Under
    any other backend (nccl) x stays where it is, and must lie on this
    rank's card: a CPU tensor, or one on another card, raises ValueError
    (nccl moves neither)."""
    global staged_tensors
    backend = dist.get_backend(group)
    if backend == "gloo":
        staged_tensors += int(x.is_cuda)
        return x.is_cuda
    if not x.is_cuda or x.device.index != torch.cuda.current_device():
        raise ValueError("a %s collective takes tensors on this rank's card, "
                         "not a %s tensor on %s"
                         % (backend, x.dtype, x.device))
    return False


def barrier(group=None):
    """dist.barrier over group (None: the world); under nccl on this
    rank's card."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def shutdown():
    """Tear the process group down, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


class LesMesh:
    """The mesh ``(les, x, y)`` seen from one rank: ``les`` slots of ``x
    * y`` ranks each, this process at mesh rank ``rank`` (slot ``rank //
    (x * y)``, then ``ix``, ``iy``). ``group``: the les group, the ranks
    at this rank's (ix, iy) in every slot (None: the whole world), over
    which the fleet's rows cross (``sharding.gather_rows``);
    ``plane_group``: the ranks of this rank's slot (None: the whole world),
    which share the planes of its instances (``plane.Plane``). ``shape``
    has the JAX mesh's axis names."""

    def __init__(self, les, rank, group=None, x=1, y=1, plane_group=None):
        self.les, self.x, self.y = int(les), int(x), int(y)
        self.rank = int(rank)
        self.slot, within = divmod(self.rank, self.x * self.y)
        self.ix, self.iy = divmod(within, self.y)
        self.group = group
        self.plane_group = plane_group
        self.shape = {"les": self.les, "x": self.x, "y": self.y}

    def plane_ranks(self):
        """The mesh ranks of this rank's slot, by ix * y + iy."""
        first = self.slot * self.x * self.y
        return list(range(first, first + self.x * self.y))

    def per_slot(self, n):
        """Instances a slot holds: GSPMD's block rule, ceil(n / L)."""
        return -(-n // self.les)

    def block(self, n):
        """slice of the fleet positions this rank's slot holds."""
        per = self.per_slot(n)
        return slice(min(self.slot * per, n), min((self.slot + 1) * per, n))

    def positions(self, n):
        b = self.block(n)
        return list(range(b.start, b.stop))


def make_mesh(n_les=None, n_x=1, n_y=1):
    """The mesh (les, x, y) over the world's ranks, in the JAX package's
    order (rank = slot * x * y + ix * y + iy); n_les * n_x * n_y must be
    the world's size (n_les None: the world over x * y). Builds the les
    groups and the plane groups: ``dist.new_group`` is a collective, so
    every rank builds every group, in the same order."""
    world = world_size()
    n_x, n_y = int(n_x), int(n_y)
    n_les = world // (n_x * n_y) if n_les is None else int(n_les)
    if n_les * n_x * n_y != world:
        raise ValueError("a mesh (les=%d, x=%d, y=%d) on %d ranks (one "
                         "rank a mesh point)" % (n_les, n_x, n_y, world))
    xy = n_x * n_y
    me = rank()
    group = plane_group = None
    if xy > 1 and n_les > 1:
        for j in range(xy):
            g = dist.new_group([s * xy + j for s in range(n_les)])
            if j == me % xy:
                group = g
        for s in range(n_les):
            g = dist.new_group([s * xy + j for j in range(xy)])
            if s == me // xy:
                plane_group = g
    return LesMesh(n_les, me, group, n_x, n_y, plane_group)


def local_les_positions(mesh, n_les):
    """Fleet positions this rank owns, the instances of its les slot,
    whose planes it shares with the other ranks of the slot (all of them
    without a mesh)."""
    return list(range(n_les)) if mesh is None else mesh.positions(n_les)


def shard_fleet(state, mesh, plane=None):
    """This rank's block of a whole fleet state (LESState or any tree of
    tensors with the fleet axis first): its slot's rows and, with a plane
    (``plane.Plane``), its block of their fields [n, nz(+1), ny, nx]."""
    from . import sharding
    from ..utils import tree as tree_util
    n = tree_util.flatten(state)[0][0].shape[0]
    state = sharding.local_rows(state, mesh, n)
    return state if plane is None else plane.block_fields(state)


def replicate(tree, mesh):
    """Check that every tensor of tree is the same on every rank of the
    mesh, bit for bit (the replicated GCM state); raises naming the first
    leaf that differs. Returns tree."""
    if mesh is None or mesh.les * mesh.x * mesh.y == 1:
        return tree
    from . import sharding
    from ..utils import tree as tree_util
    whole = LesMesh(mesh.les * mesh.x * mesh.y, mesh.rank)   # every rank
    what = "slot" if mesh.x * mesh.y == 1 else "rank"
    leaves, _ = tree_util.flatten(tree)
    for i, leaf in enumerate(leaves):
        if not torch.is_tensor(leaf):
            continue
        rows = sharding.all_rows(leaf.reshape(1, -1), whole)
        for r in range(1, whole.les):
            if not torch.equal(rows[r], rows[0]):
                raise RuntimeError(
                    "replicated leaf %d (shape %s) differs between %s 0 "
                    "and %s %d" % (i, tuple(leaf.shape), what, what, r))
    return tree
