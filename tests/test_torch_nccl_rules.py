"""The launch rules of the port's multi-rank runs over nccl, on the CPU.

- ``init_distributed``: one card a rank under nccl (``cuda:LOCAL_RANK``);
  with fewer cards than ranks, or no card, it raises under nccl and never
  falls back to gloo; gloo stays opt-in (``SPTPU_DIST_BACKEND=gloo``).
  The multi-rank entry points (the CLI, scalebench) raise without a card.
- ``chip_smoke.py``: ``rank_env`` / ``run_rank_set`` under nccl give each
  rank ``LOCAL_RANK`` and no ``SPTPU_DIST_BACKEND``; ``--cards N`` raises
  with fewer than N cards or none.
- The collectives (``Plane``, ``Bands``, ``sharding``) take a CUDA
  tensor through host memory under gloo only: under a stubbed nccl
  ``get_backend`` a tensor that reports cuda:0 (``OnCard``) is handed to
  the collective as it is, and a CPU tensor, or one on another card,
  raises (``mesh.staged``).
- ``sharding.rows_to_root`` (the checkpoint's collection of the fleet):
  a rank of slot s > 0 sends its block of each leaf to rank 0 alone, from
  its card under nccl and staged under gloo, one leaf at a time and each
  send done before the next; rank 0 receives one slot's block of one leaf
  at a time and yields each leaf whole in position order; a rank off
  (ix, iy) = (0, 0) sends nothing and is given nothing.
- Barriers name the rank's card under nccl (scalebench's included), the
  parity report names the process's current card, and ranks that build
  the same kernel at once each leave one complete library.

Nothing here needs a card: torch.cuda's queries and torch.distributed's
calls are stubbed.
"""

import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from sp_coupler_tpu_torch import spmaster
from sp_coupler_tpu_torch.ops import _build
from sp_coupler_tpu_torch.parallel import bands as pbands, mesh as pmesh
from sp_coupler_tpu_torch.parallel import plane as pplane, sharding
from sp_coupler_tpu_torch.runtime import scalebench
from sp_coupler_tpu_torch.verify import parity_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_VARS = ("SPTPU_DIST_COORD", "SPTPU_DIST_NPROCS", "SPTPU_DIST_PROC_ID",
             "SPTPU_DIST_BACKEND", "RANK", "WORLD_SIZE", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE", "MASTER_ADDR")


@pytest.fixture
def launch(monkeypatch, tmp_path):
    """init_distributed's world stubbed: returns set_up(rank, world,
    cards, **env) -> the calls it made (set_device, init_process_group)."""
    calls = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("set_device", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    for k in DIST_VARS:
        monkeypatch.delenv(k, raising=False)

    def set_up(rank, world, cards, **env):
        calls.clear()
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setenv("SPTPU_DIST_COORD",
                           "file://" + str(tmp_path / "store"))
        monkeypatch.setenv("SPTPU_DIST_NPROCS", str(world))
        monkeypatch.setenv("SPTPU_DIST_PROC_ID", str(rank))
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        return calls

    return set_up


@pytest.mark.parametrize("rank", range(4))
def test_nccl_gives_each_rank_its_card(launch, rank):
    calls = launch(rank, 4, 4, LOCAL_RANK=rank)
    assert pmesh.init_distributed(torch.device("cuda"))
    assert calls["backend"] == "nccl"
    assert calls["set_device"] == rank
    assert (calls["rank"], calls["world_size"]) == (rank, 4)


@pytest.mark.parametrize("cards, env", [
    (2, {}),                                    # 4 ranks, 2 cards
    (0, {}),                                    # no card
    (2, dict(SPTPU_DIST_BACKEND="nccl")),
    (2, dict(LOCAL_WORLD_SIZE=2)),              # LOCAL_RANK 3 of 2 cards
])
def test_nccl_with_fewer_cards_than_ranks_raises(launch, cards, env):
    calls = launch(3, 4, cards, LOCAL_RANK=3, **env)
    with pytest.raises(ValueError, match="card"):
        pmesh.init_distributed(torch.device("cuda"))
    assert "backend" not in calls and "set_device" not in calls


def test_gloo_on_the_card_is_opt_in(launch):
    calls = launch(2, 4, 1, LOCAL_RANK=2, SPTPU_DIST_BACKEND="gloo")
    assert pmesh.init_distributed(torch.device("cuda"))
    assert (calls["backend"], calls["set_device"]) == ("gloo", 0)
    assert pmesh.pick_backend("cuda", None, 4, 4) == "nccl"


@pytest.mark.parametrize("entry", ["spmaster", "scalebench"])
def test_multi_rank_entry_points_raise_without_a_card(launch, tmp_path,
                                                      entry):
    launch(1, 2, 0, LOCAL_RANK=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if entry == "spmaster":
            spmaster.build_runner(["--steps", "1", "--mesh_les", "2",
                                   "--odir", str(tmp_path / "out")])
        else:
            scalebench.main(["--sizes", "1,2"])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_rank_env(monkeypatch, backend):
    monkeypatch.setenv("SPTPU_DIST_BACKEND", "gloo")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for r in range(4):
        env = chip_smoke.rank_env(4, r, "/tmp/store", backend)
        assert (env["SPTPU_DIST_NPROCS"], env["SPTPU_DIST_PROC_ID"]) == (
            "4", str(r))
        if backend == "nccl":
            assert "SPTPU_DIST_BACKEND" not in env
            assert (env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) == (str(r),
                                                                    "4")
        else:
            assert env["SPTPU_DIST_BACKEND"] == "gloo"
            assert "LOCAL_RANK" not in env
    with pytest.raises(ValueError):
        chip_smoke.rank_env(4, 0, "/tmp/store", "mpi")


def test_run_rank_set_starts_nccl_ranks(monkeypatch, tmp_path):
    started = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, env, **kw):
            started.append((cmd, env))

        def wait(self, timeout=None):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", Proc)
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    monkeypatch.setenv("SPTPU_DIST_BACKEND", "gloo")
    chip_smoke.run_rank_set("t", 4, 10, ["--sizes", 1], "/tmp/store",
                            backend="nccl", module="some.module")
    assert [e["LOCAL_RANK"] for _, e in started] == ["0", "1", "2", "3"]
    assert not any("SPTPU_DIST_BACKEND" in e for _, e in started)
    assert started[0][0] == [sys.executable, "-m", "some.module",
                             "--sizes", "1"]


def test_cards_mode_needs_the_cards(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.cards_main(4)                # this machine: no card
    built = []
    monkeypatch.setattr(chip_smoke, "phase_env", lambda: "a card")
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: built.append(1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--cards 4 on a machine of 1"):
        chip_smoke.cards_main(4)
    with pytest.raises(ValueError):
        chip_smoke.cards_main(3)
    assert not built


def test_cards_mode_fails_without_a_card():
    """Without a card the script exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "chip_smoke.py", "--cards", "4"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


# ---- the collectives under nccl: nothing through the host --------------

class Staged(Exception):
    pass


class OnCard(torch.Tensor):
    """A CPU tensor that reports cuda:0, and raises Staged if a collective
    moves it to the host."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def cpu(self, *a, **kw):
        raise Staged("a CUDA tensor went through host memory")


def on_card(*shape):
    return torch.arange(float(torch.Size(shape).numel())).reshape(
        shape).as_subclass(OnCard)


@pytest.fixture
def world(monkeypatch):
    """Two ranks' collectives stubbed in one process (this rank's data
    stands in for the other's); returns set_backend(name)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(dist, "all_reduce", lambda t, op=None, group=None: t)

    def all_gather(parts, src, group=None):
        for p in parts:
            p.copy_(src)

    def batch(ops):
        for op in ops:
            if op.op is dist.irecv:
                op.tensor.zero_()
        return []

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "batch_isend_irecv", batch)
    monkeypatch.setattr(dist, "P2POp", lambda op, tensor, peer, group=None,
                        tag=0: SimpleNamespace(op=op, tensor=tensor))

    def set_backend(name):
        monkeypatch.setattr(dist, "get_backend", lambda group=None: name)

    return set_backend


COLLECTIVES = {
    "plane.sum_": lambda: pplane.Plane(8, 8, 1, 2, 0, 0).sum_(on_card(3)),
    "plane.max_": lambda: pplane.Plane(8, 8, 1, 2, 0, 0).max_(on_card(3)),
    "plane.gather": lambda: pplane.Plane(8, 8, 1, 2, 0, 0).gather(
        on_card(2, 8, 4)),
    "plane.halo": lambda: pplane.Plane(8, 8, 1, 2, 0, 0).halo(
        [on_card(2, 8, 4)], 1),
    "bands.sum_": lambda: pbands.Bands(8, 2, 0).sum_(on_card(5)),
    "bands.gather": lambda: pbands.Bands(8, 2, 0).gather(on_card(3, 4, 6)),
    "bands.columns": lambda: pbands.Bands(8, 2, 0).columns(
        [on_card(3, 4, 6)], torch.tensor([1, 30])),
    "sharding.all_rows": lambda: sharding.all_rows(on_card(4),
                                                   pmesh.LesMesh(2, 0)),
    "sharding.gather_rows": lambda: sharding.gather_rows(
        {"a": on_card(1, 4)}, pmesh.LesMesh(2, 0), 2),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_stage_under_gloo_only(world, name):
    world("nccl")
    before = pmesh.staged_tensors
    COLLECTIVES[name]()                 # no Staged: the tensors stay put
    assert pmesh.staged_tensors == before
    world("gloo")
    with pytest.raises(Staged):
        COLLECTIVES[name]()


@pytest.fixture
def p2p(monkeypatch):
    """dist.send / dist.recv stubbed: sends are recorded; a receive from
    rank r fills its buffer with 100 r + the row index and is recorded."""
    sent, received, synced = [], [], []
    monkeypatch.setattr(dist, "send", lambda t, dst, group=None:
                        sent.append((t, dst, group)))

    def recv(t, src, group=None):
        rows = torch.arange(t.shape[0], dtype=t.dtype).reshape(
            (-1,) + (1,) * (t.dim() - 1))
        t.copy_(100 * src + rows.expand(t.shape))
        received.append((tuple(t.shape), src, group))

    monkeypatch.setattr(dist, "recv", recv)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        SimpleNamespace(synchronize=lambda: synced.append(
                            len(sent))))
    return SimpleNamespace(sent=sent, received=received, synced=synced)


def test_rows_to_root_sends_from_the_card_under_nccl(world, p2p):
    """Rank 1 of slot 1 (les = 2): its block of each leaf goes to rank 0
    as it lies on the card, each send synchronised before the next; it is
    given nothing. Under gloo the same tensors go through host memory."""
    world("nccl")
    tree = {"a": on_card(2, 3), "b": on_card(2)}
    got = list(sharding.rows_to_root(tree, pmesh.LesMesh(2, 1), 4))
    assert got == [None, None]
    assert [(type(t), dst) for t, dst, _ in p2p.sent] == [(OnCard, 0)] * 2
    assert p2p.synced == [1, 2] and not p2p.received
    world("gloo")
    with pytest.raises(Staged):
        list(sharding.rows_to_root(tree, pmesh.LesMesh(2, 1), 4))


def test_rows_to_root_gives_rank0_each_leaf_whole(world, p2p):
    """Rank 0 of les = 3 slots of 2 rows (n = 5: slot 2 holds one): each
    leaf whole in position order, its own rows first, then one slot's
    block at a time from that slot's rank at (0, 0), on the host."""
    world("gloo")
    mesh = pmesh.LesMesh(3, 0, x=2, y=1)
    own = {"a": torch.full((2, 4), -1.0), "b": torch.full((2,), -2.0)}
    got = list(sharding.rows_to_root(own, mesh, 5))
    assert [g.shape for g in got] == [(5, 4), (5,)]
    assert got[0][:, 0].tolist() == [-1, -1, 200, 201, 400]
    assert got[1].tolist() == [-2, -2, 200, 201, 400]
    assert p2p.received == [((2, 4), 2, None), ((1, 4), 4, None),
                            ((2,), 2, None), ((1,), 4, None)]
    assert not p2p.sent


def test_rows_to_root_off_the_first_block_sends_nothing(world, p2p):
    """A rank at (ix, iy) != (0, 0) (its slot's planes reach rank 0 from
    (0, 0)) and a rank of a mesh without a les axis: None a leaf, nothing
    sent or received; without a mesh the leaves on the host."""
    world("nccl")
    tree = {"a": on_card(2, 3), "b": on_card(2)}
    assert list(sharding.rows_to_root(
        tree, pmesh.LesMesh(2, 3, x=2, y=1), 4)) == [None, None]
    assert not p2p.sent and not p2p.received
    plain = {"a": torch.ones(2, 3)}
    (whole,) = sharding.rows_to_root(plain, None, 2)
    assert whole.tolist() == [[1.0] * 3] * 2


def test_staged_refuses_what_nccl_cannot_move(world, monkeypatch):
    world("nccl")
    with pytest.raises(ValueError, match="on this rank's card"):
        pmesh.staged(torch.zeros(3))                  # a CPU tensor
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="cuda:0"):
        pmesh.staged(on_card(3))                      # another card
    with pytest.raises(ValueError):
        pplane.Plane(8, 8, 1, 2, 0, 0).sum_(torch.zeros(3))
    world("gloo")
    assert pmesh.staged(torch.zeros(3)) is False      # gloo moves CPU ones


# ---- barriers, the parity report's card, concurrent builds -------------

@pytest.mark.parametrize("backend, want", [("nccl", [2]), ("gloo", None)])
def test_barrier_names_the_card_under_nccl(monkeypatch, backend, want):
    seen = []
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(dist, "barrier", lambda group=None, device_ids=None:
                        seen.append((group, device_ids)))
    pmesh.barrier("g")
    assert seen == [("g", want)]


def test_scalebench_barriers_name_the_card(monkeypatch):
    """scalebench.measure on rank 0 of 2 under nccl (stubbed): every
    barrier of its group passes device_ids=[the current card]."""
    seen = []
    monkeypatch.setattr(pmesh, "world_size", lambda: 2)
    monkeypatch.setattr(pmesh, "rank", lambda: 0)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(dist, "barrier", lambda group=None, device_ids=None:
                        seen.append((group, device_ids)))
    monkeypatch.setattr(dist, "broadcast_object_list",
                        lambda box, src=0: None)
    monkeypatch.setattr(scalebench.shd, "all_rows",
                        lambda x, mesh: torch.stack([x, x]))
    r = scalebench.measure(sizes=[2], per_dev=1, nx=8, ny=8, nz=8,
                           substeps=1, reps=1, verbose=False, device="cpu")
    assert r["sizes"] == [2]
    assert seen and all(s == ((0, 1), [1]) for s in seen)


def test_parity_report_names_the_current_card(monkeypatch):
    lines = "".join("card %d, 700.00 W\n" % i for i in range(4))
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **kw: SimpleNamespace(stdout=lines))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert parity_report.card_name(None) == "card 2, 700.00 W"
    assert parity_report.card_name("given") == "given"


def test_ranks_building_one_kernel_at_once(monkeypatch, tmp_path):
    """Four ranks build csrc/lesstage.cu at once: each compiles into its own
    temporary file and renames it over the library, so every rank loads a
    whole library and no temporary file is left."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!%s\nimport sys, time\nout = sys.argv[sys.argv.index('-o') + 1]\n"
        "f = open(out, 'w')\nf.write('part')\nf.flush()\ntime.sleep(0.3)\n"
        "f.write(' whole')\nf.close()\n" % sys.executable)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    paths = [None] * 4

    def one(i):
        paths[i] = _build.build("lesstage")[0]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0] is not None
    assert open(paths[0]).read() == "part whole"
    assert os.listdir(build_dir) == [os.path.basename(paths[0])]
