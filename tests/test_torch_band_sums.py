"""The banded analysis under the card's summation (spharm.float64_sums).

On the card spharm.card_sums sums the analysis in float64 and rounds to
float32 once. Under latitude bands each rank's Legendre sums are only a
part of the whole; for a field with a large mean (T: 250 K) the bands'
parts largely cancel, so rounding each to float32 before the all_reduce
adds them would lose most digits of the high-n coefficients. The bands'
float64 sums go through the all_reduce and are rounded once after it, so
the banded analysis lies as near float64 as the whole core's.

The four bands run in one process, as threads meeting in ThreadBands.sum_
(the all_reduce of parallel/bands.py, summed in rank order); the rule is
turned on for the CPU's float32 tensors by replacing
spharm.float64_sums. With the rule off (the CPU path, every CPU
comparison with the JAX package), the banded analysis is the float32
einsums' band sums added in float32, as it was.

Beside them, chip_smoke.py's banded_farther, the gate under which (h)
holds config 5's polar f_T level by level: it must pass the card's
float64 witness of the banded core and flag that of the banded core whose
band sums were rounded before the all_reduce.

  PYTHONPATH=. python tests/test_torch_band_sums.py [TRUNC ...]
      prints, under the card's rule, the top quarter of n's error (even /
      odd) of the float64 analysis rounded once, the whole core's and the
      4 bands' (default 63 159 639; TL639 ~1 min, ~3 GiB)."""

import copy
import threading

import numpy as np
import pytest
import torch

from sp_coupler_tpu_torch.models.gcm import spharm
from sp_coupler_tpu_torch.parallel.bands import Bands
from sp_coupler_tpu_torch.verify import tl639_rows

P = 4


class ThreadBands(Bands):
    """Bands of P threads of one process: sum_ adds the ranks' tensors in
    rank order and gives every rank the sum, as an all_reduce does; the
    dtype each rank handed it is kept in board["dtypes"]."""

    def __init__(self, nlat, r, board):
        super().__init__(nlat, P, r)
        self.board = board

    def sum_(self, t):
        b = self.board
        b["parts"][self.r] = t.clone()
        b["dtypes"].add(t.dtype)
        b["barrier"].wait()
        total = b["parts"][0].clone()
        for part in b["parts"][1:]:
            total += part
        b["barrier"].wait()
        t.copy_(total)
        return t


def banded_analysis(sht, fmw):
    """sht's Legendre analysis (_ana, through _ana_many) of the weighted
    zonal spectra fmw [..., nlat, M, 2] on P bands (threads), each band's
    rows by copy.copy(sht) cut to it: the coefficients every rank got
    (all equal) and the dtypes their all_reduce carried."""
    board = dict(parts=[None] * P, dtypes=set(),
                 barrier=threading.Barrier(P, timeout=60))
    out, errors = [None] * P, []

    def rank(r):
        try:
            bt = copy.copy(sht)
            bt._band(ThreadBands(sht.nlat, r, board))
            out[r] = bt._ana(fmw[..., bt.bands.r0:bt.bands.r1, :, :])
        except BaseException as e:          # noqa: BLE001 (re-raised below)
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for r in range(1, P):
        assert torch.equal(out[r], out[0]), r
    return out[0], board["dtypes"]


def t_like(sht, nlev=3, seed=0):
    """The weighted zonal spectra [nlev, nlat, M, 2] (float32, sht's
    _wq(_fft)) of a T-like grid: 250 K plus a red spectrum (amplitude (n
    + 1)^-1.5, ~10 K at n = 1), synthesized in float64 and rounded to
    float32."""
    rng = np.random.default_rng(seed)
    n = sht.n.numpy()[..., None]
    coef = rng.standard_normal((nlev, sht.M, sht.N, 2)) * 20.0 * (n + 1) ** -1.5
    s = torch.as_tensor(coef) * sht.mask.double()[..., None]
    grid = tl639_rows.as_double(sht).synthesize(s) + 250.0
    return sht._wq(sht._fft(grid.float()))


def top_quarter_error(got, ref, sht):
    """max |got - ref| over the coefficients with n >= 3 T / 4, over the
    largest |ref| among them, for the even and the odd n - m classes."""
    n, m = sht.n.numpy(), sht.m.numpy()
    top = (n >= 0.75 * sht.trunc) & (sht.mask.numpy() > 0)
    out = []
    for parity in (0, 1):
        sel = top & ((n - m) % 2 == parity)
        err = (got - ref).abs().numpy()[..., sel, :]
        out.append(float(err.max() / np.abs(ref.numpy()[..., sel, :]).max()))
    return out


@pytest.fixture
def card_rule(monkeypatch):
    """spharm.float64_sums as on the card, for the CPU's float32 tensors."""
    monkeypatch.setattr(spharm, "float64_sums",
                        lambda x: x.dtype == torch.float32)


@pytest.mark.parametrize("trunc", [63, 159])
def test_banded_analysis_as_near_float64_as_whole(trunc, card_rule):
    """Under the card's rule the banded Legendre analysis all_reduces
    float64 sums and lies, at the top quarter of n, within 2x the
    distance from the float64 analysis of the same zonal spectra of that
    analysis rounded once to float32 (the whole analysis summed in
    float64), and within 2x the whole core's, which folds the hemispheres
    in float32 first (rounded band by band before the all_reduce it lay
    39-43x farther at T63, 1.2e-6 and 1.7e-6)."""
    torch.set_num_threads(1)
    sht = spharm.SpectralTransform(trunc, device="cpu")
    fmw = t_like(sht)
    ref = tl639_rows.as_double(sht)._ana(fmw.double())
    whole = sht._ana(fmw)
    banded, dtypes = banded_analysis(sht, fmw)
    assert whole.dtype == banded.dtype == torch.float32
    assert dtypes == {torch.float64}
    e_once = top_quarter_error(ref.float().double(), ref, sht)
    e_whole = top_quarter_error(whole.double(), ref, sht)
    e_band = top_quarter_error(banded.double(), ref, sht)
    for once, w, b in zip(e_once, e_whole, e_band):
        assert 0.0 < once < 1e-7 and once <= w, (e_once, e_whole)
        assert b <= 2.0 * min(once, w), (e_once, e_whole, e_band)


def test_banded_analysis_off_the_card_is_float32_band_sums():
    """With the rule off (the CPU), the banded analysis is each band's
    float32 einsum sums added in float32 in rank order, bit for bit, and
    the all_reduce carries float32."""
    torch.set_num_threads(1)
    sht = spharm.SpectralTransform(21, device="cpu")
    fmw = t_like(sht)
    banded, dtypes = banded_analysis(sht, fmw)
    assert dtypes == {torch.float32}
    sums = None
    for r in range(P):
        bt = copy.copy(sht)
        bt._band(Bands(sht.nlat, P, r))
        part = fmw[..., bt.bands.r0:bt.bands.r1, :, :]
        parts = (torch.einsum("...jmc,jmk->...mkc", part, bt.Pe),
                 torch.einsum("...jmc,jmk->...mkc", part, bt.Po))
        sums = parts if sums is None else tuple(
            a + b for a, b in zip(sums, parts))
    want = sht._unpack_coeffs(*sums)
    assert torch.equal(banded, want)


# (h)'s float64 witness at f_T's levels 42-59 (the 4 polar columns of row
# 10, TL639/L60, four H100 80GB HBM3 at 700.00 W): each float32 core's
# largest distance in K from the whole core in float64, of card 0's whole
# core, of rank 0's banded core, and of the banded core with each band's
# sums rounded to float32 before the all_reduce
WITNESS_WHOLE = [9.37e-6, 8.33e-5, 7.41e-6, 5e-6, 2.67e-5, 1.05e-4, 2.3e-5,
                 1.16e-4, 1.03e-4, 1.17e-5, 3.17e-5, 1.48e-4, 3.27e-5,
                 1.4e-4, 1.88e-4, 5.33e-5, 1.06e-4, 3.85e-5]
WITNESS_BANDED = [3.34e-5, 2.23e-5, 9.9e-5, 5e-6, 5.72e-5, 5.88e-5, 3.82e-5,
                  2.45e-5, 1.34e-4, 1.19e-4, 1.38e-4, 7.15e-5, 7.85e-5,
                  1.8e-5, 2.04e-5, 2.93e-5, 1.37e-4, 6.23e-5]
WITNESS_ROUNDED = [8.57e-5, 6.99e-6, 2.06e-4, 8.13e-5, 5.44e-5, 5.99e-5,
                   2.73e-5, 1.31e-4, 2.67e-5, 9.44e-5, 2e-4, 1.94e-4, 9.37e-5,
                   1.8e-5, 3.69e-5, 1.41e-5, 7e-5, 8.43e-5]


@pytest.mark.parametrize("banded, flagged", [
    (WITNESS_BANDED, []), (WITNESS_ROUNDED, [44, 52])])
def test_banded_farther_holds_each_level_of_f_T(banded, flagged):
    """banded_farther compares the witness's distances level by level at
    f_T's levels only, with F_ULPS spacings of the level's T (250 K: 1.2e-4
    K): the banded core passes, the rounded band sums fail at levels 44
    and 52, though their largest distance lies below the whole core's
    (the levels above f_T's, where f_T is 0, here 3.3e-4 K off float64 for
    the whole core and 1e-3 K for the bands, do not count)."""
    import chip_smoke
    L, top = 60, 42
    witness = dict(whole=[3.3e-4] * top + WITNESS_WHOLE,
                   banded=[1e-3] * top + banded)
    f_T = np.zeros((4, L))
    f_T[:, top:] = 1e-4
    T = np.full((4, L), 250.0)
    far = chip_smoke.banded_farther(witness, f_T, T)
    assert [k for k, *_ in far] == flagged
    allow = chip_smoke.F_ULPS * float(np.spacing(np.float32(250.0)))
    for k, b, w, a in far:
        assert a == allow and b > w + a
    assert max(WITNESS_ROUNDED) < max(witness["whole"])


def _table(truncs):
    """The module's script: the top quarter of n's error under the card's
    rule of the float64 analysis rounded once, the whole core's and the
    bands', at each of truncs."""
    spharm.float64_sums = lambda x: x.dtype == torch.float32
    torch.set_num_threads(4)
    for trunc in truncs:
        sht = spharm.SpectralTransform(trunc, device="cpu")
        fmw = t_like(sht, nlev=1 if trunc > 300 else 3)
        ref = tl639_rows.as_double(sht)._ana(fmw.double())
        err = lambda x: ["%.2e" % e for e in top_quarter_error(
            x.double(), ref, sht)]
        print("T%d: once %s, whole %s, bands %s" % (
            trunc, err(ref.float()), err(sht._ana(fmw)),
            err(banded_analysis(sht, fmw)[0])), flush=True)


if __name__ == "__main__":
    import sys
    _table([int(a) for a in sys.argv[1:]] or [63, 159, 639])
