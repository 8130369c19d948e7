"""Launch geometry of the tiled LES kernels (csrc/lesstage.cu, lesflat.cu,
lesmom.cu).

Each of them launches one block per (tile of tx x ty columns, chunk of tz
levels, instance [x scalar group]), one thread per column of the tile,
marching upward through its chunk. ``tile_geometry`` gives the grid of
blocks, the levels per chunk and a block's shared memory; each kernel's
module fills in its own tile, shared-memory bytes, resident blocks per SM
and chunk start cost. The CPU tests check that the blocks cover every
point once.
"""

import functools
from typing import NamedTuple

SMEM_LIMIT = 232448   # bytes of shared memory one sm_90 block can use
SMS = 132             # streaming multiprocessors of an H100 SXM


class TileGeometry(NamedTuple):
    """A tiled kernel's launch: a block per (tile of tx x ty columns, chunk
    of tz levels, instance, group of the stack); smem is a block's dynamic
    shared memory in bytes."""
    tx: int
    ty: int
    tz: int
    tiles_x: int
    tiles_y: int
    chunks: int
    n: int
    smem: int
    groups: int = 1

    @property
    def blocks(self):
        return (self.tiles_x * self.tiles_y * self.chunks * self.n
                * self.groups)


@functools.lru_cache(maxsize=None)
def chunk_levels(columns, nz, resident, start):
    """Levels per z-chunk for `columns` tiles x instances (x groups): the
    tz that minimises waves x (tz + start), since blocks run in waves of
    SMS x resident and a block's time grows with its levels plus its
    start (the levels' worth of work a chunk does before its first level);
    the largest such tz on a tie."""
    waves = lambda t: -(-columns * -(-nz // t) // (SMS * resident))
    return min(range(1, nz + 1), key=lambda t: (waves(t) * (t + start), -t))


def tile_geometry(name, n, nz, ny, nx, tx, ty, smem, resident, start,
                  tz=None, groups=1):
    """The launch geometry of kernel `name` for an [n, nz, ny, nx] fleet
    (groups blocks per instance and column tile, for a stack taken in
    groups). tz: levels per z-chunk, by default ``chunk_levels``; the
    tests and chip_profile.py's sweeps pass their own. Raises ValueError
    for tz < 1 or shared memory above SMEM_LIMIT."""
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    if tz is None:
        tz = chunk_levels(tiles_x * tiles_y * n * groups, nz, resident, start)
    if tz < 1:
        raise ValueError("tz must be >= 1, got %r" % (tz,))
    if smem > SMEM_LIMIT:
        raise ValueError("the %s kernel needs %d bytes of shared memory a "
                         "block, above the %d it can use"
                         % (name, smem, SMEM_LIMIT))
    return TileGeometry(tx, ty, tz, tiles_x, tiles_y, -(-nz // tz), n, smem,
                        groups)
