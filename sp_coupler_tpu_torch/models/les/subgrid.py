"""Subgrid turbulence closures: Deardorff prognostic TKE and Smagorinsky.

Port of ``sp_coupler_tpu/models/les/subgrid.py``: strain and stability,
the Deardorff eddy viscosities and TKE sources (the reference case,
namoptions &NAMSUBGRID lsmagorinsky=.false.), the Smagorinsky-Lilly eddy
viscosity (lsmagorinsky=.true.), down-gradient diffusion and the neutral
surface drag law. Fields are [n, nz, ny, nx].
"""

import torch

from sp_coupler_tpu_torch import constants as c
from ...parallel.plane import reducer
from .advect import sp, sm, col, X, Y, Z

KAPPA = 0.4          # von Karman
CS = 0.15            # Smagorinsky constant
PRANDTL = 1.0 / 3.0  # turbulent Prandtl number (Kh = Km / Pr)
RI_C = 0.25          # critical Richardson number

# prognostic-TKE (Deardorff) constants, DALES values
CM = 0.12
CH1, CH2 = 1.0, 2.0
CE1, CE2 = 0.19, 0.51
CN = 0.76
E12_MIN = 1e-3  # floor on sqrt(TKE)


def _delta(grid):
    return (grid.dx * grid.dy * grid.dz) ** (1.0 / 3.0)


def _ddz(a, dz):
    """Centered z-derivative, one-sided at the two ends."""
    lo = (a[:, 1:2] - a[:, 0:1]) / dz
    mid = (a[:, 2:] - a[:, :-2]) / (2 * dz)
    hi = (a[:, -1:] - a[:, -2:-1]) / dz
    return torch.cat([lo, mid, hi], dim=Z)


def _center_gradients(grid, u, v, w):
    """Velocity gradients at cell centers."""
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    dudx = (sp(u, X) - u) / dx
    dvdy = (sp(v, Y) - v) / dy
    dwdz = (w[:, 1:] - w[:, :-1]) / dz
    uc = 0.5 * (u + sp(u, X))
    vc = 0.5 * (v + sp(v, Y))
    wc = 0.5 * (w[:, 1:] + w[:, :-1])
    ddy = lambda a: (sp(a, Y) - sm(a, Y)) / (2 * dy)
    ddx = lambda a: (sp(a, X) - sm(a, X)) / (2 * dx)
    return (dudx, dvdy, dwdz, ddy(uc), _ddz(uc, dz), ddx(vc), _ddz(vc, dz),
            ddx(wc), ddy(wc))


def strain_and_stability(grid, state, thv, thv_m=None):
    """(S2, N2) at cell centers: squared deformation and Brunt-Vaisala
    frequency from the slab-mean thv profile."""
    dudx, dvdy, dwdz, dudy, dudz, dvdx, dvdz, dwdx, dwdy = _center_gradients(
        grid, state.u, state.v, state.w)
    S2 = (2.0 * (dudx ** 2 + dvdy ** 2 + dwdz ** 2)
          + (dudy + dvdx) ** 2 + (dudz + dwdx) ** 2 + (dvdz + dwdy) ** 2)
    if thv_m is None:
        thv_m = torch.mean(thv, dim=(Y, X), keepdim=True)
    dthv = torch.cat([
        (thv_m[:, 1:2] - thv_m[:, 0:1]),
        (thv_m[:, 2:] - thv_m[:, :-2]) / 2.0,
        (thv_m[:, -1:] - thv_m[:, -2:-1]),
    ], dim=Z) / grid.dz
    N2 = c.grav / torch.clamp_min(thv_m, 1.0) * dthv
    return S2, N2.expand(S2.shape)


def eddy_viscosity(grid, state, thv, thv_m=None):
    """Smagorinsky-Lilly (Km, Kh) with the Richardson stability factor and
    the wall-limited mixing length; takes its own slab mean of thv where
    thv_m is None."""
    S2, N2 = strain_and_stability(grid, state, thv, thv_m)
    Ri = N2 / torch.clamp_min(S2, 1e-12)
    fstab = torch.sqrt(torch.clamp(1.0 - Ri / RI_C, 0.0, 1.0))
    delta = _delta(grid)
    zf = (torch.arange(grid.nz, dtype=torch.float32, device=S2.device)
          + 0.5) * grid.dz
    lam = 1.0 / torch.sqrt(1.0 / delta ** 2 + 1.0 / (KAPPA * zf) ** 2)
    Km = (CS * lam[None, :, None, None]) ** 2 * torch.sqrt(S2) * fstab
    return Km, Km / PRANDTL


def tke_viscosity(grid, state, thv, thv_m=None):
    """Deardorff closure: (Km, Kh, lam, S2, N2)."""
    S2, N2 = strain_and_stability(grid, state, thv, thv_m)
    e12 = torch.clamp_min(state.e12, E12_MIN)
    delta = _delta(grid)
    lam_stable = CN * e12 / torch.sqrt(torch.clamp_min(N2, 1e-10))
    lam = torch.where(N2 > 1e-10, torch.clamp_max(lam_stable, delta),
                      torch.full_like(N2, delta))
    Km = CM * lam * e12
    Kh = (CH1 + CH2 * lam / delta) * Km
    return Km, Kh, lam, S2, N2


def tke_sources(grid, Km, Kh, lam, S2, N2, e12, delta=None):
    """d(e12)/dt sources: (shear + buoyancy - dissipation) / (2 e12)."""
    if delta is None:
        delta = _delta(grid)
    e12s = torch.clamp_min(e12, E12_MIN)
    shear = Km * S2
    buoy = -Kh * N2
    diss = (CE1 + CE2 * lam / delta) * e12s ** 3 / lam
    return (shear + buoy - diss) / (2.0 * e12s)


def diffuse_scalar(grid, rhobf, rhobh, K, s, surf_flux=None):
    """Down-gradient diffusion tendency of a cell-centered scalar.

    ``surf_flux``: prescribed upward kinematic flux through the bottom face,
    [n] or [n, ny, nx]; the top face is zero flux.
    """
    dx, dy, dz = grid.dx, grid.dy, grid.dz
    Kx = 0.5 * (sm(K, X) + K)
    Fx = -Kx * (s - sm(s, X)) / dx
    tend = -(sp(Fx, X) - Fx) / dx
    Ky = 0.5 * (sm(K, Y) + K)
    Fy = -Ky * (s - sm(s, Y)) / dy
    tend = tend - (sp(Fy, Y) - Fy) / dy
    Kz = 0.5 * (K[:, 1:] + K[:, :-1])
    Fz_int = -col(rhobh[:, 1:-1]) * Kz * (s[:, 1:] - s[:, :-1]) / dz
    bottom = torch.zeros_like(Fz_int[:, :1])
    if surf_flux is not None:
        if surf_flux.dim() == 1:
            surf_flux = surf_flux[:, None, None]
        bottom = bottom + col(rhobh[:, :1]) * surf_flux.expand(
            s[:, 0].shape)[:, None]
    top = torch.zeros_like(Fz_int[:, :1])
    Fz = torch.cat([bottom, Fz_int, top], dim=Z)
    return tend - (Fz[:, 1:] - Fz[:, :-1]) / (col(rhobf) * dz)


def surface_drag(grid, state, z0m, red=None):
    """Neutral drag law: (ustar [n], flux_u, flux_v [n, ny, nx]); red: the
    plane's reductions for <u*^2> (None: the whole plane)."""
    z1 = 0.5 * grid.dz
    u1 = 0.5 * (state.u[:, 0] + sp(state.u[:, 0], X - 1))
    v1 = 0.5 * (state.v[:, 0] + sp(state.v[:, 0], Y - 1))
    U1 = torch.sqrt(u1 ** 2 + v1 ** 2 + 1e-4)
    cd = (KAPPA / torch.log(z1 / torch.clamp_min(z0m, 1e-6))) ** 2
    ustar2 = cd[:, None, None] * U1 ** 2
    flux_u = -ustar2 * u1 / U1
    flux_v = -ustar2 * v1 / U1
    return torch.sqrt(reducer(red).mean(ustar2)), flux_u, flux_v


def surface_momentum_fluxes(grid, state, z0m, red=None):
    """(ustar, fu, fv): drag-law stress interpolated to the u/v points."""
    ustar, flux_u_sfc, flux_v_sfc = surface_drag(grid, state, z0m, red)
    fu = 0.5 * (sm(flux_u_sfc, X - 1) + flux_u_sfc)
    fv = 0.5 * (sm(flux_v_sfc, Y - 1) + flux_v_sfc)
    return ustar, fu, fv


def diffuse_w(grid, rhobf, rhobh, Km, w):
    """Diffusion tendency of w [n, nz+1, ...], zero on the outer faces: the
    interior faces diffused as a scalar with face-interpolated Km."""
    Kw = 0.5 * (Km[:, 1:] + Km[:, :-1])
    # on the w grid the "cells" sit at zh[1..nz-1] with faces at zf
    tw_int = diffuse_scalar(grid, rhobh[:, 1:-1], rhobf, Kw, w[:, 1:-1])
    zero = torch.zeros_like(w[:, :1])
    return torch.cat([zero, tw_int, zero], dim=Z)


def diffuse_momentum(grid, rhobf, rhobh, Km, state, z0m, red=None):
    """Diffusion tendencies for (u, v, w) plus the surface drag stress."""
    ustar, fu, fv = surface_momentum_fluxes(grid, state, z0m, red)
    tu = diffuse_scalar(grid, rhobf, rhobh, Km, state.u, surf_flux=fu)
    tv = diffuse_scalar(grid, rhobf, rhobh, Km, state.v, surf_flux=fv)
    return tu, tv, diffuse_w(grid, rhobf, rhobh, Km, state.w), ustar
