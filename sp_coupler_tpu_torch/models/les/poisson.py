"""Anelastic pressure projection: all-matmul eigenbasis solve.

Port of the eigenbasis path of ``sp_coupler_tpu/models/les/poisson.py``.
The periodic horizontal directions are diagonalized with a real DFT
written as dense matmuls; the vertical operator is symmetrized and
eigen-factorized once per evolve call (``torch.linalg.eigh``); one
iterative-refinement pass polishes the float32 residual.

The JAX package needs float32-accurate products here (its TPU default,
bf16, leaves an unusable residual). The port keeps TF32 off for the same
reason (set in ``sp_coupler_tpu_torch/__init__.py``); the products stay
``torch.matmul`` as the JAX package left them to XLA.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from .advect import divergence, col, X, Y, Z


@functools.lru_cache(maxsize=None)
def _real_dft_basis_np(n, d):
    """Orthonormal real Fourier basis F [n, n] and modified wavenumbers
    lam [n] with F @ C @ F.T = diag(-lam) for the periodic second
    difference C/d^2. Rows: mean, (cos_k, sin_k) pairs, Nyquist."""
    x = np.arange(n)
    rows = [np.full(n, 1.0 / np.sqrt(n))]
    lam = [0.0]
    for k in range(1, (n + 1) // 2):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * k * x / n))
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * k * x / n))
        l = (2.0 - 2.0 * np.cos(2 * np.pi * k / n)) / d ** 2
        lam += [l, l]
    if n % 2 == 0:
        rows.append(((-1.0) ** x) / np.sqrt(n))
        lam.append(4.0 / d ** 2)
    return np.stack(rows).astype(np.float32), np.asarray(lam, np.float32)


class PoissonSolver(NamedTuple):
    """Factorized projection operator for a fleet; build once per evolve."""
    V: torch.Tensor      # [n, nz, nz] generalized eigenvectors (columns)
    inv: torch.Tensor    # [n, nz, ny, nx] 1/(mu - lam), mean mode zeroed
    Fy: torch.Tensor     # [ny, ny] real DFT basis
    Fx: torch.Tensor     # [nx, nx]

    def index(self, i):
        return PoissonSolver(self.V[i], self.inv[i], self.Fy, self.Fx)


def build_solver(grid, rhobf, rhobh) -> PoissonSolver:
    """Eigen-factorize the anelastic pressure operator for [n, nz(+1)]
    base-state profiles."""
    dz = grid.dz
    dev = rhobf.device
    off = rhobh[:, 1:-1] / dz ** 2
    dia = -(rhobh[:, :-1] + rhobh[:, 1:]) / dz ** 2
    dia = torch.cat([dia[:, :1] + rhobh[:, :1] / dz ** 2, dia[:, 1:-1],
                     dia[:, -1:] + rhobh[:, -1:] / dz ** 2], dim=1)
    isq = 1.0 / torch.sqrt(rhobf)
    offd = off * isq[:, :-1] * isq[:, 1:]
    S = (torch.diag_embed(dia * isq ** 2) + torch.diag_embed(offd, 1)
         + torch.diag_embed(offd, -1))
    mu, U = torch.linalg.eigh(S)
    # the mean-mode pin below relies on ascending eigenvalues (mu[-1] ~ 0)
    assert bool(torch.all(mu[:, 1:] >= mu[:, :-1])), "eigh not ascending"
    V = isq[:, :, None] * U
    Fx, lamx = (torch.as_tensor(a, device=dev)
                for a in _real_dft_basis_np(int(grid.nx), float(grid.dx)))
    Fy, lamy = (torch.as_tensor(a, device=dev)
                for a in _real_dft_basis_np(int(grid.ny), float(grid.dy)))
    lam = lamy[:, None] + lamx[None, :]
    den = mu[:, :, None, None] - lam[None, None]
    inv = torch.where(torch.abs(den) < 1e-12, torch.zeros_like(den),
                      1.0 / den)
    inv[:, -1, 0, 0] = 0.0                          # pin the mean mode
    return PoissonSolver(V=V, inv=inv, Fy=Fy, Fx=Fx)


def _apply_operator(grid, rhobf, rhobh, phi):
    """The discrete operator: div(rho_b grad phi), Neumann in z."""
    rf = col(rhobf)
    lap_x = rf * (torch.roll(phi, -1, X) - 2.0 * phi
                  + torch.roll(phi, 1, X)) / grid.dx ** 2
    lap_y = rf * (torch.roll(phi, -1, Y) - 2.0 * phi
                  + torch.roll(phi, 1, Y)) / grid.dy ** 2
    Fz = col(rhobh[:, 1:-1]) * (phi[:, 1:] - phi[:, :-1]) / grid.dz
    zero = torch.zeros_like(phi[:, :1])
    Fz_lo = torch.cat([zero, Fz], dim=Z)
    Fz_hi = torch.cat([Fz, zero], dim=Z)
    return lap_x + lap_y + (Fz_hi - Fz_lo) / grid.dz


def _solve_once(solver: PoissonSolver, rhs):
    """phi = F_y^T V (mu-lam)^{-1} V^T (F_y rhs F_x^T) F_x — 6 matmuls."""
    rhat = torch.einsum('ay,nzyx->nzax', solver.Fy, rhs)
    rhat = torch.einsum('bx,nzax->nzab', solver.Fx, rhat)
    y = torch.einsum('nzi,nzab->niab', solver.V, rhat)
    y = y * solver.inv
    phat = torch.einsum('nzi,niab->nzab', solver.V, y)
    phi = torch.einsum('ay,nzab->nzyb', solver.Fy, phat)
    return torch.einsum('bx,nzyb->nzyx', solver.Fx, phi)


def solve_pressure(grid, rhobf, rhobh, rhs, solver=None, refine=1):
    """Solve div(rho_b grad phi) = rhs; Neumann top/bottom, periodic x/y."""
    if solver is None:
        solver = build_solver(grid, rhobf, rhobh)
    phi = _solve_once(solver, rhs)
    for _ in range(refine):
        r = rhs - _apply_operator(grid, rhobf, rhobh, phi)
        phi = phi + _solve_once(solver, r)
    return phi


def project(grid, rhobf, rhobh, u, v, w, dt, solver=None, method="eigen"):
    """Project (u, v, w) onto the divergence-free subspace.

    ``dt``: the stage length, a python float or [n, 1, 1, 1] tensor.
    Returns corrected velocities and the pressure potential phi.
    """
    if method != "eigen":
        raise NotImplementedError(
            "projection method %r is not ported yet (ROADMAP.md, open "
            "items: solve_pressure_thomas)" % (method,))
    div = divergence(grid, rhobf, rhobh, u, v, w) / dt
    phi = solve_pressure(grid, rhobf, rhobh, div, solver=solver)
    u = u - dt * (phi - torch.roll(phi, 1, X)) / grid.dx
    v = v - dt * (phi - torch.roll(phi, 1, Y)) / grid.dy
    dphidz = (phi[:, 1:] - phi[:, :-1]) / grid.dz
    zero = torch.zeros_like(w[:, :1])
    w = w - dt * torch.cat([zero, dphidz, zero], dim=Z)
    return u, v, w, phi
