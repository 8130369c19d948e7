"""Plane.halo over a transport that matches messages as nccl does.

nccl ignores the tags of point-to-point messages: between two ranks it
matches the k-th receive one rank posts from the other with the k-th
message the other posted to it. Gloo matches by tag, so the gloo tests
(test_torch_spatial.py) cannot see a halo exchange whose correctness
rests on tags. Here threads stand in for the ranks of a plane, and
``dist.batch_isend_irecv``, ``P2POp``, ``isend`` and ``irecv`` are
replaced by ``OrderedTransport``, which keeps nccl's rule and ignores
tags. Each split of a 16 x 16 plane, 2 x 1, 1 x 2, 2 x 2 and 4 x 1 (n_x
x n_y; with 2 blocks on an axis both neighbours are one rank), pads its
blocks with h points through ``Plane.halo``; every block must equal the
whole plane padded by periodic wrap, cut to the block, exactly. A
receive that finds no message within WAIT seconds fails the test.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sp_coupler_tpu_torch.parallel import plane as pplane

NY = NX = 16
WAIT = 5.0          # seconds a receive waits for its message


class OrderedTransport:
    """Point-to-point messages between threads standing in for ranks (a
    thread's rank in ``local.rank``): the k-th receive a rank posts from a
    peer takes the k-th message that peer posted to it, whatever the
    tags."""

    def __init__(self):
        self.cv = threading.Condition()
        self.sent = {}          # (src, dst) -> messages, in posting order
        self.posted = {}        # (src, dst) -> receives posted so far
        self.local = threading.local()

    def isend(self, tensor, dst, group=None, tag=0):
        with self.cv:
            self.sent.setdefault((self.local.rank, dst), []).append(
                tensor.clone())
            self.cv.notify_all()
        return SimpleNamespace(wait=lambda: True)

    def irecv(self, tensor, src, group=None, tag=0):
        key = (src, self.local.rank)
        with self.cv:
            k = self.posted.get(key, 0)
            self.posted[key] = k + 1

        def wait():
            with self.cv:
                if not self.cv.wait_for(
                        lambda: len(self.sent.get(key, ())) > k, WAIT):
                    raise TimeoutError("rank %d: no message %d from rank %d"
                                       % (key[1], k, src))
                tensor.copy_(self.sent[key][k])
            return True

        return SimpleNamespace(wait=wait)

    def batch_isend_irecv(self, ops):
        return [op.op(op.tensor, op.peer, op.group, op.tag) for op in ops]

    def run(self, fns):
        """fns[r]() on a thread of rank r each; their results, in rank
        order (re-raises the first rank's exception)."""
        out, errors = [None] * len(fns), [None] * len(fns)

        def body(r):
            self.local.rank = r
            try:
                out[r] = fns[r]()
            except Exception as e:      # reported below, with its rank
                errors[r] = e

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=4 * WAIT)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        for r, e in enumerate(errors):
            if e is not None:
                raise AssertionError("rank %d: %r" % (r, e)) from e
        return out


@pytest.fixture
def transport(monkeypatch):
    t = OrderedTransport()
    monkeypatch.setattr(dist, "isend", t.isend)
    monkeypatch.setattr(dist, "irecv", t.irecv)
    monkeypatch.setattr(dist, "batch_isend_irecv", t.batch_isend_irecv)
    monkeypatch.setattr(dist, "P2POp", lambda op, tensor, peer, group=None,
                        tag=0: SimpleNamespace(op=op, tensor=tensor,
                                               peer=peer, group=group,
                                               tag=tag))
    # the blocks are CPU tensors: nothing to stage through the host
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    return t


@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("n_x, n_y", [(2, 1), (1, 2), (2, 2), (4, 1)])
def test_halo_under_posting_order_matching(transport, n_x, n_y, h):
    rng = np.random.default_rng(7)
    whole = [rng.standard_normal((2, 3, NY, NX)).astype(np.float32),
             rng.standard_normal((5, NY, NX)).astype(np.float32)]
    padded = [np.pad(f, [(0, 0)] * (f.ndim - 2) + [(h, h), (h, h)],
                     mode="wrap") for f in whole]
    planes = [pplane.Plane(NY, NX, n_y, n_x, iy, ix)
              for ix in range(n_x) for iy in range(n_y)]

    def halo(p):
        blocks = [torch.from_numpy(
            f[..., p.y0:p.y0 + p.by, p.x0:p.x0 + p.bx].copy()) for f in whole]
        return p.halo(blocks, h)

    outs = transport.run([lambda p=p: halo(p) for p in planes])
    for p, got in zip(planes, outs):
        for g, ref in zip(got, padded):
            want = ref[..., p.y0:p.y0 + p.by + 2 * h,
                       p.x0:p.x0 + p.bx + 2 * h]
            assert g.shape == want.shape
            np.testing.assert_array_equal(
                g.numpy(), want, err_msg="block (ix %d, iy %d) of %d x %d"
                % (p.ix, p.iy, n_x, n_y))
