"""LES grid definition (port of ``sp_coupler_tpu/models/les/grid.py``).

Staggered Arakawa C grid, periodic in x and y, rigid lid. Defaults follow
the reference RICO case: 64 x 64 x 160 cells, 12.8 km x 12.8 km x 4 km.
"""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LESGrid:
    """Static grid description."""

    nx: int = 64
    ny: int = 64
    nz: int = 160
    dx: float = 200.0
    dy: float = 200.0
    dz: float = 25.0

    @property
    def zsize(self):
        return self.nz * self.dz

    def zf(self, device=None):
        """Cell-center heights, ascending, [nz] float32."""
        return (torch.arange(self.nz, dtype=torch.float32, device=device)
                + 0.5) * self.dz

    def zh(self, device=None):
        """Face heights, ascending from 0, [nz+1] float32."""
        return torch.arange(self.nz + 1, dtype=torch.float32,
                            device=device) * self.dz
