"""Launch geometry of the scalar (csrc/lesflat.cu) and momentum
(csrc/lesmom.cu) kernels, on the CPU: the blocks cover every point once,
the default z-chunks fill whole waves at the main path's shapes, shared
memory stays within what a block can use, and the Python constants mirror
the CUDA sources.
"""

import re

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from sp_coupler_tpu_torch.ops import lesflat, lesmom, tiling, _build


def _hits(geom, S, nz, ny, nx, smax):
    """How often each (instance, scalar, level, column) is written, as the
    kernels map their blocks: blockIdx.x = tile (x fastest), blockIdx.y =
    z-chunk, blockIdx.z = instance x groups + group of up to smax scalars
    (smax = S, one group, for the momentum kernel)."""
    n = geom.n
    hits = np.zeros((n, S, nz, ny, nx), np.int32)
    for bz in range(n * geom.groups):
        b, j0 = bz // geom.groups, (bz % geom.groups) * smax
        for by in range(geom.chunks):
            k0, k1 = by * geom.tz, min(nz, (by + 1) * geom.tz)
            assert k0 < k1   # no chunk is empty
            for bx in range(geom.tiles_x * geom.tiles_y):
                x0 = (bx % geom.tiles_x) * geom.tx
                y0 = (bx // geom.tiles_x) * geom.ty
                hits[b, j0:min(S, j0 + smax), k0:k1, y0:y0 + geom.ty,
                     x0:x0 + geom.tx] += 1
    return hits


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 3), S=st.integers(1, 9), nz=st.integers(2, 48),
       ny=st.integers(4, 40), nx=st.integers(4, 40),
       tz=st.one_of(st.none(), st.integers(1, 50)))
def test_scalar_geometry_covers_every_point_once(n, S, nz, ny, nx, tz):
    g = lesflat.scalar_geometry(n, S, nz, ny, nx, tz)
    assert g.smem <= tiling.SMEM_LIMIT
    assert g.groups == -(-S // lesflat.SMAX)
    assert g.chunks == -(-nz // g.tz) and (tz is None or g.tz == tz)
    assert (_hits(g, S, nz, ny, nx, lesflat.SMAX) == 1).all()


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 3), nz=st.integers(2, 48), ny=st.integers(4, 40),
       nx=st.integers(4, 40), tz=st.one_of(st.none(), st.integers(1, 50)))
def test_momentum_geometry_covers_every_point_once(n, nz, ny, nx, tz):
    g = lesmom.momentum_geometry(n, nz, ny, nx, tz)
    assert g.smem <= tiling.SMEM_LIMIT and g.groups == 1
    assert g.chunks == -(-nz // g.tz) and (tz is None or g.tz == tz)
    assert (_hits(g, 1, nz, ny, nx, 1) == 1).all()


GEOMETRY = {
    "lesflat": (lambda n, nz, tz=None: lesflat.scalar_geometry(
        n, 4, nz, 64, 64, tz), lesflat.RESIDENT),
    "lesmom": (lambda n, nz, tz=None: lesmom.momentum_geometry(
        n, nz, 64, 64, tz), lesmom.RESIDENT),
}


@pytest.mark.parametrize("kernel, n, tz", [("lesflat", 1, 7),
                                           ("lesflat", 2, 14),
                                           ("lesmom", 1, 5),
                                           ("lesmom", 2, 10)])
def test_default_chunks_of_the_main_path_fill_one_wave(kernel, n, tz):
    """64x64x160 (S = 4): the default tz is the shortest chunk whose blocks
    all fit in one wave of SMS x RESIDENT; one level less takes two."""
    geom, resident = GEOMETRY[kernel]
    wave = tiling.SMS * resident
    g = geom(n, 160)
    assert (g.tx, g.ty, g.tz) == (32, 8, tz)
    assert g.blocks <= wave < geom(n, 160, tz - 1).blocks
    # at nz = 157 the last chunk is short
    g157 = geom(2, 157)
    assert 157 % g157.tz != 0 and g157.blocks <= wave


@pytest.mark.parametrize("kernel", ["lesflat", "lesmom"])
def test_geometry_refuses(kernel, monkeypatch):
    geom = GEOMETRY[kernel][0]
    with pytest.raises(ValueError, match="tz must be"):
        geom(1, 32, tz=0)
    monkeypatch.setattr(tiling, "SMEM_LIMIT", 32 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        geom(1, 32)


def test_scalar_geometry_needs_a_stack():
    with pytest.raises(ValueError, match="stack"):
        lesflat.scalar_geometry(1, 0, 32, 16, 16)


def _constants(src):
    """name -> value of the `constexpr int` constants of a CUDA source, and
    the count of the entries of the enum that ends in NFLUX."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]*);", src):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+) = (\d+)\s*", part)
            if m:
                out[m.group(1)] = int(m.group(2))
    body = re.search(r"enum \{([^}]*NFLUX[^}]*)\}", src).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [x.strip() for x in body.split(",") if x.strip()]
    out["NFLUX"] = names.index("NFLUX")
    return out


@pytest.mark.parametrize("kernel, mod, names", [
    ("lesflat", lesflat, ("TX", "TY", "HALO", "SMAX", "NSLOT", "RESIDENT",
                          "NFLUX")),
    ("lesmom", lesmom, ("TX", "TY", "NF", "NSLOT", "RESIDENT", "NFLUX"))])
def test_constants_mirror_the_source(kernel, mod, names):
    """The launch geometry's constants are the CUDA source's: its tile, its
    ring, its flux planes and the blocks an SM its __launch_bounds__
    allows; so shared_bytes() is its Tile::BYTES."""
    src = open("%s/%s.cu" % (_build.CSRC_DIR, kernel)).read()
    c = _constants(src)
    assert {k: c[k] for k in names} == {k: getattr(mod, k) for k in names}
    assert "__launch_bounds__(NT, RESIDENT)" in src
