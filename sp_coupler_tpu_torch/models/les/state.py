"""LES prognostic state, base state and initialization.

Port of ``sp_coupler_tpu/models/les/state.py``. The JAX package writes
every function for one instance and adds the fleet axis with vmap; here
the fleet axis is explicit and always present: fields are [n, nz(+1), ny,
nx], profiles [n, nz(+1)], per-instance scalars [n].
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c, default_device
from ...utils import thermo


class LESState(NamedTuple):
    """Prognostic + slowly-varying auxiliary state of an LES fleet."""

    u: torch.Tensor       # [n, nz, ny, nx] at x-faces
    v: torch.Tensor       # [n, nz, ny, nx] at y-faces
    w: torch.Tensor       # [n, nz+1, ny, nx] at z-faces; w[:, 0] = w[:, nz] = 0
    thl: torch.Tensor     # [n, nz, ny, nx] liquid-water potential temperature
    qt: torch.Tensor      # [n, nz, ny, nx] total water
    qr: torch.Tensor      # [n, nz, ny, nx] rain water
    e12: torch.Tensor     # [n, nz, ny, nx] sqrt(subgrid TKE)
    ps: torch.Tensor      # [n] surface pressure
    pbf: torch.Tensor     # [n, nz] base-state pressure at full levels
    pbh: torch.Tensor     # [n, nz+1] base-state pressure at half levels
    rhobf: torch.Tensor   # [n, nz] base-state density at full levels
    rhobh: torch.Tensor   # [n, nz+1] base-state density at half levels
    rain: torch.Tensor    # [n] accumulated surface rain, kg/m^2
    ustar: torch.Tensor   # [n] friction velocity diagnostic
    time: torch.Tensor    # [n] model time, s

    def index(self, i):
        """Sub-fleet of the instances selected by i (an index tensor or a
        slice); keeps the fleet axis."""
        return LESState(*[x[i] for x in self])


class LESForcing(NamedTuple):
    """Per-GCM-step forcings pushed onto each instance by the coupler."""

    f_u: torch.Tensor     # [n, nz]
    f_v: torch.Tensor     # [n, nz]
    f_thl: torch.Tensor   # [n, nz]
    f_qt: torch.Tensor    # [n, nz]
    f_ql: torch.Tensor    # [n, nz]
    f_ps: torch.Tensor    # [n]
    ql_ref: torch.Tensor  # [n, nz]
    wthl: torch.Tensor    # [n] surface kinematic heat flux, K m/s
    wqt: torch.Tensor     # [n] surface kinematic moisture flux, m/s
    z0m: torch.Tensor     # [n] roughness length momentum
    z0h: torch.Tensor     # [n] roughness length heat

    @classmethod
    def zeros(cls, n, nz, device=None, dtype=torch.float32):
        """Zero forcings (z0m 0.1 m, z0h 0.02 m), on the card unless device
        says otherwise (``default_device``)."""
        device = default_device(device)
        z = torch.zeros((n, nz), dtype=dtype, device=device)
        s = torch.zeros((n,), dtype=dtype, device=device)
        return cls(f_u=z, f_v=z, f_thl=z, f_qt=z, f_ql=z, f_ps=s,
                   ql_ref=z, wthl=s, wqt=s, z0m=s + 0.1, z0h=s + 0.02)

    def index(self, i):
        return LESForcing(*[x[i] for x in self])


def base_state(grid, thl0, qt0, ps):
    """Hydrostatic anelastic base state from [n, nz] profiles and ps [n].

    The Exner function is integrated upward level by level, in the same
    order as the JAX package's scan, so the float32 rounding matches.
    """
    dz = grid.dz
    thv0 = thl0 * (1.0 + c.eps_i * qt0)
    pi_s = thermo.exner(ps)
    thvh = torch.cat([thv0[:, :1], 0.5 * (thv0[:, 1:] + thv0[:, :-1]),
                      thv0[:, -1:]], dim=1)
    incr = c.grav * dz / (c.cp * thv0)
    pih = [pi_s]
    for k in range(grid.nz):
        pih.append(pih[-1] - incr[:, k])
    pih = torch.stack(pih, dim=1)                               # [n, nz+1]
    pif = pih[:, :-1] - 0.5 * c.grav * dz / (c.cp * thv0)
    pbf = c.pref0 * pif ** (c.cp / c.rd)
    pbh = c.pref0 * pih ** (c.cp / c.rd)
    Tf = thv0 * pif
    rhobf = pbf / (c.rd * Tf)
    rhobh = pbh / (c.rd * (thvh * pih))
    return pbf, pbh, rhobf, rhobh


def init_state(grid, u0, v0, thl0, qt0, ps, generator, vabsmax=0.5,
               thlabsmax=0.1, qabsmax=2.5e-5, e12_0=0.1):
    """Initial fleet state: [n, nz] profiles broadcast plus uniform noise.

    Noise amplitudes match the reference coupler's set_les_state; the
    draws come from ``generator`` on its own device (a CPU generator, as
    ``sp_coupler_tpu_torch.generator`` gives, draws the same on every
    device) and are moved to the profiles' device. They differ from the
    JAX package's threefry draws.
    """
    n = u0.shape[0]
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    dev = u0.device
    shp = (n, nz, ny, nx)

    def unif():
        r = torch.rand(shp, generator=generator, device=generator.device,
                       dtype=torch.float32).to(dev)
        return 2.0 * r - 1.0

    col = lambda p: p[:, :, None, None]
    u = col(u0) + vabsmax * unif()
    v = col(v0) + vabsmax * unif()
    thl = col(thl0) + thlabsmax * unif()
    qt = torch.clamp_min(col(qt0) + qabsmax * unif(), 0.0)
    ps = torch.as_tensor(ps, dtype=torch.float32, device=dev).expand(n)
    pbf, pbh, rhobf, rhobh = base_state(grid, thl0, qt0, ps)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    return LESState(
        u=u, v=v, w=torch.zeros((n, nz + 1, ny, nx), dtype=torch.float32,
                                device=dev),
        thl=thl, qt=qt, qr=torch.zeros(shp, dtype=torch.float32, device=dev),
        e12=torch.full(shp, e12_0, dtype=torch.float32, device=dev),
        ps=ps.clone(), pbf=pbf, pbh=pbh, rhobf=rhobf, rhobh=rhobh,
        rain=zero, ustar=zero + 0.1, time=zero.clone())
