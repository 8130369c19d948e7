"""The port's checkpoint file (io/restart.py), on the CPU.

- ``NpzWriter`` writes what ``np.savez`` writes for the same arrays (the
  keys in order, dtypes, shapes, values), one stored zip member an array,
  so ``np.load`` reads it in either package.
- ``save`` in one process writes each fleet leaf as it comes
  (``sharding.rows_to_root`` without a mesh); a save that fails part way
  leaves neither a restart.npz nor its temporary file, so a run never
  resumes from a short checkpoint.
"""

import json
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.io import restart

ARRAYS = {"gcm_0": np.arange(12, dtype=np.float32).reshape(3, 4),
          "les_0": np.arange(5, dtype=np.int32),
          "les_1": np.float64(2.5),
          "prof_0": np.linspace(0.0, 1.0, 7, dtype=np.float32)}


def test_npz_writer_matches_savez(tmp_path):
    out = restart.NpzWriter(str(tmp_path / "w.npz"))
    for k, v in ARRAYS.items():
        out.add(k, v)
    assert not (tmp_path / "w.npz").exists()         # whole only at close
    out.close()
    np.savez(tmp_path / "s.npz", **ARRAYS)
    with np.load(tmp_path / "w.npz") as a, np.load(tmp_path / "s.npz") as b:
        assert a.files == b.files == list(ARRAYS)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    with zipfile.ZipFile(tmp_path / "w.npz") as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["s.npz", "w.npz"]


def _runner(odir, profiles):
    fleet = {"0": torch.arange(6.0).reshape(2, 3), "1": torch.ones(2)}
    return SimpleNamespace(
        gcm=SimpleNamespace(state={"0": torch.zeros(4)},
                            get_model_time=lambda: 900.0, step_count=1),
        fleet=SimpleNamespace(state=fleet, time=900.0, n=2),
        prev_profiles=profiles, rain_last=np.zeros(2), sp_cols=[3, 7],
        cfg=SimpleNamespace(output_dir=str(odir)))


def test_save_in_one_process(tmp_path):
    restart.save(_runner(tmp_path, {"thl": np.ones((2, 5), np.float32)}))
    with np.load(tmp_path / restart.FNAME) as d:
        assert d.files == ["gcm_0", "les_0", "les_1", "prof_0"]
        assert d["les_0"].tolist() == [[0, 1, 2], [3, 4, 5]]
    with open(tmp_path / restart.META) as f:
        meta = json.load(f)
    assert meta["sp_cols"] == [3, 7] and meta["has_profiles"]


def test_failed_save_leaves_no_checkpoint(tmp_path):
    """A leaf np.save refuses (an object array) after the GCM and fleet
    leaves were written: save raises, and nothing is left behind."""
    bad = {"x": np.array([object()], dtype=object)}
    with pytest.raises(ValueError):
        restart.save(_runner(tmp_path, bad))
    assert list(tmp_path.iterdir()) == []


# ---- each rank reads its rows alone (config 4's resume) --------------------

N_FLEET = 6


def _fleet():
    rng = np.random.default_rng(3)
    return {"0": torch.as_tensor(rng.standard_normal((N_FLEET, 3, 4, 5))
                                 .astype(np.float32)),
            "1": torch.as_tensor(rng.integers(0, 99, (N_FLEET, 7))
                                 .astype(np.int32)),
            "2": torch.as_tensor(rng.standard_normal(N_FLEET))}


def _load_rank(rank, odir, store, out):
    """One gloo rank of two: a les mesh of 2 slots, restart.load of the
    checkpoint in odir into a fleet that holds the slot's rows."""
    import torch.distributed as dist
    from sp_coupler_tpu_torch.parallel import mesh as pmesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    try:
        mesh = pmesh.make_mesh(2)
        template = {k: v[mesh.block(N_FLEET)] for k, v in _fleet().items()}
        runner = SimpleNamespace(
            gcm=SimpleNamespace(), prev_profiles=None,
            fleet=SimpleNamespace(state=template, mesh=mesh, n=N_FLEET),
            cfg=SimpleNamespace(output_dir=odir))
        restart.load(runner)
        np.savez("%s.%d.npz" % (out, rank),
                 bytes_read=runner.restart_load["bytes_read"],
                 **{k: v.numpy() for k, v in runner.fleet.state.items()})
    finally:
        dist.destroy_process_group()


def test_two_ranks_read_their_rows_alone(tmp_path):
    """Two gloo ranks each load their block of the fleet from a stored
    checkpoint: equal to a whole-file load's rows, and no more than half
    of each leaf's bytes read (NpzReader's reads in place)."""
    import torch.multiprocessing as mp
    fleet = _fleet()
    runner = _runner(tmp_path, None)
    runner.fleet.state, runner.fleet.n = fleet, N_FLEET
    runner.gcm = SimpleNamespace(get_model_time=lambda: 900.0,
                                 step_count=1)
    restart.save(runner)
    out = str(tmp_path / "rank")
    mp.start_processes(_load_rank, args=(str(tmp_path),
                                         str(tmp_path / "store"), out),
                       nprocs=2, start_method="spawn")
    with np.load(tmp_path / restart.FNAME) as whole:
        total = 0
        for rank in range(2):
            got = np.load("%s.%d.npz" % (out, rank))
            rows = slice(3 * rank, 3 * rank + 3)
            for i, k in enumerate(sorted(fleet)):
                ref = whole["les_%d" % i][rows]
                assert got[k].dtype == ref.dtype
                assert got[k].tobytes() == ref.tobytes(), (rank, k)
            assert int(got["bytes_read"]) == sum(
                whole[key].nbytes // 2 for key in whole.files)
            total += int(got["bytes_read"])
    assert total == sum(v.numpy().nbytes for v in fleet.values())


def test_reader_rows_and_deflated_members(tmp_path):
    """NpzReader: rows of a stored member read in place, whole arrays
    and 0-d ones; a deflated member (np.savez_compressed, the JAX
    package's checkpoints) read through np.load."""
    arrays = dict(ARRAYS, big=np.arange(60, dtype=np.float64).reshape(
        10, 2, 3))
    out = restart.NpzWriter(str(tmp_path / "w.npz"))
    for k, v in arrays.items():
        out.add(k, v)
    out.close()
    np.savez_compressed(tmp_path / "c.npz", **arrays)
    for name in ("w.npz", "c.npz"):
        with restart.NpzReader(str(tmp_path / name)) as r:
            assert r.files == list(arrays)
            for k, v in arrays.items():
                got = r.get(k)
                assert got.dtype == v.dtype and got.shape == np.shape(v)
                assert got.tobytes() == np.asarray(v).tobytes()
            rows = r.get("big", slice(4, 7))
            np.testing.assert_array_equal(rows, arrays["big"][4:7])
            assert r.get("big", slice(9, 12)).shape == (1, 2, 3)
            read = r.bytes_read
        stored = name == "w.npz"
        assert (read == sum(np.asarray(v).nbytes for v in arrays.values())
                + (3 + 1) * 6 * 8) if stored else read > 0
