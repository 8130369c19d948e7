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
