"""Hydrostatic primitive-equation spectral dycore (sigma, semi-implicit).

Port of the Eulerian sigma-coordinate path of
``sp_coupler_tpu/models/gcm/dycore.py``: vorticity-divergence form,
semi-implicit leapfrog with a Robert-Asselin filter and del^4
hyperdiffusion. Spectral state is packed real [L, M, N, 2].
"""

from typing import NamedTuple, Optional

import torch

from sp_coupler_tpu_torch import constants as c, default_device


class SpectralState(NamedTuple):
    """Prognostic spectral coefficients at one time level."""

    vort: torch.Tensor   # [L, M, N, 2]
    div: torch.Tensor
    T: torch.Tensor
    lnps: torch.Tensor   # [M, N, 2]
    q: torch.Tensor
    ql: torch.Tensor
    qi: torch.Tensor
    a: torch.Tensor

    @classmethod
    def zeros(cls, nlev, M, N, device=None):
        """Zero coefficients, on the card unless device says otherwise
        (``default_device``)."""
        device = default_device(device)
        z3 = torch.zeros((nlev, M, N, 2), dtype=torch.float32, device=device)
        z2 = torch.zeros((M, N, 2), dtype=torch.float32, device=device)
        return cls(vort=z3, div=z3, T=z3, lnps=z2, q=z3, ql=z3, qi=z3, a=z3)


class GridFields(NamedTuple):
    """Grid-space view of the state plus diagnostics ([L, nlat, nlon])."""

    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor
    q: torch.Tensor
    ql: torch.Tensor
    qi: torch.Tensor
    a: torch.Tensor
    lnps: torch.Tensor                 # [nlat, nlon]
    omega_p: Optional[torch.Tensor]    # omega / p
    vort: Optional[torch.Tensor]
    div: Optional[torch.Tensor]


def _lev(mat, x):
    """Level-mixing product sum_j mat[k, j] x[j, ...]."""
    return torch.einsum("kj,j...->k...", mat, x)


def to_grid(sht, vc, s: SpectralState) -> GridFields:
    """Grid view of a spectral state with the omega/p diagnostic."""
    u, v = sht.uv_from_vort_div(s.vort, s.div)
    T = sht.synthesize(s.T)
    q = sht.synthesize(s.q)
    ql = sht.synthesize(s.ql)
    qi = sht.synthesize(s.qi)
    a = sht.synthesize(s.a)
    lnps = sht.synthesize(s.lnps)
    vort = sht.synthesize(s.vort)
    div = sht.synthesize(s.div)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = u * dpx[None] + v * dpy[None]
    omega_p = vgrad - _lev(vc.Pmat, div + vgrad)
    return GridFields(u=u, v=v, T=T, q=q, ql=ql, qi=qi, a=a, lnps=lnps,
                      omega_p=omega_p, vort=vort, div=div)


def _vert_advect(vc, sdot_half, X):
    """(eta_dot dX/d-eta)_k with sdot_half [L+1, ...] zero at both ends."""
    dX_up = X - torch.cat([X[:1], X[:-1]], 0)
    dX_dn = torch.cat([X[1:], X[-1:]], 0) - X
    ds = vc.ds[:, None, None]
    return 0.5 / ds * (sdot_half[1:] * dX_dn + sdot_half[:-1] * dX_up)


def tendencies(sht, vc, s: SpectralState, f_coriolis_grid):
    """Explicit tendencies at time t: (N: SpectralState, g: GridFields)."""
    g = to_grid(sht, vc, s)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = g.u * dpx[None] + g.v * dpy[None]
    ds = vc.ds[:, None, None]
    Ct = (g.div + vgrad) * ds
    dpi_dt = -torch.sum(Ct, dim=0)
    csum = torch.cumsum(Ct, dim=0)
    total = csum[-1:]
    sdot_int = vc.sh[1:-1, None, None] * total - csum[:-1]
    zero = torch.zeros_like(sdot_int[:1])
    sdot = torch.cat([zero, sdot_int, zero], dim=0)

    Tp = g.T - vc.tref
    abs_vort = g.vort + f_coriolis_grid[None]
    Fu = (abs_vort * g.v - _vert_advect(vc, sdot, g.u)
          - c.rd * Tp * dpx[None])
    Fv = (-abs_vort * g.u - _vert_advect(vc, sdot, g.v)
          - c.rd * Tp * dpy[None])
    N_vort, divF = sht.vort_div_from_uv(Fu, Fv)

    E = 0.5 * (g.u ** 2 + g.v ** 2)
    lin = (sht.analyze(E) + _lev(vc.G, s.T)
           + c.rd * vc.tref * s.lnps[None])
    N_div = divF - sht.laplacian[..., None] * lin

    _, divTflux = sht.vort_div_from_uv(g.u * Tp, g.v * Tp)
    N_T_grid = (Tp * g.div - _vert_advect(vc, sdot, g.T)
                + c.kappa * g.T * g.omega_p)
    N_T = -divTflux + sht.analyze(N_T_grid)
    N_lnps = sht.analyze(dpi_dt)

    def scalar_adv(x_grid):
        _, divflux = sht.vort_div_from_uv(g.u * x_grid, g.v * x_grid)
        rest = x_grid * g.div - _vert_advect(vc, sdot, x_grid)
        return -divflux + sht.analyze(rest)

    N = SpectralState(vort=N_vort, div=N_div, T=N_T, lnps=N_lnps,
                      q=scalar_adv(g.q), ql=scalar_adv(g.ql),
                      qi=scalar_adv(g.qi), a=scalar_adv(g.a))
    return N, g


def semi_implicit_step(sht, vc, now: SpectralState, prev: SpectralState,
                       N: SpectralState, dt2):
    """Leapfrog step prev -> new over window dt2 (=2*dt; =dt on step one),
    delta-form semi-implicit for the linear gravity-wave terms."""
    h = dt2 / 2.0
    Minv = vc.implicit_inverse(h, sht.trunc)
    lam = (-sht.laplacian)[..., None]
    G, W, b, Tref = vc.G, vc.W, vc.b, vc.tref

    T_star = prev.T + dt2 * N.T
    pi_star = prev.lnps + dt2 * N.lnps
    dT_expl = 2.0 * (prev.T - now.T) + dt2 * N.T
    dPi_expl = 2.0 * (prev.lnps - now.lnps) + dt2 * N.lnps
    rhs = (prev.div + dt2 * N.div
           + h * lam[None] * (_lev(G, dT_expl)
                              + c.rd * Tref * dPi_expl[None]))
    ones = torch.ones(vc.nlev, dtype=torch.float32, device=G.device)
    GW = G @ W - c.rd * Tref * torch.outer(ones, b)
    corr = prev.div - 2.0 * now.div
    Acorr = (h * h) * lam[None] * _lev(GW, corr)
    x = rhs + Acorr
    div_new = torch.einsum("nlj,jmnc->lmnc", Minv, x)

    dDiv = div_new + prev.div - 2.0 * now.div
    T_new = T_star + h * _lev(W, dDiv)
    pi_new = pi_star - h * torch.einsum("j,j...->...", b, dDiv)
    return SpectralState(
        vort=prev.vort + dt2 * N.vort, div=div_new, T=T_new, lnps=pi_new,
        q=prev.q + dt2 * N.q, ql=prev.ql + dt2 * N.ql,
        qi=prev.qi + dt2 * N.qi, a=prev.a + dt2 * N.a)


def hyperdiffuse(sht, s: SpectralState, dt, tau=3600.0 * 4):
    """Implicit del^4 damping of every field but lnps (Eulerian path)."""
    lam_max = sht.trunc * (sht.trunc + 1) / sht.radius ** 2
    nu = 1.0 / (tau * lam_max ** 2)
    fac = (1.0 / (1.0 + dt * nu * sht.laplacian ** 2))[..., None]
    damp = lambda x: x * fac
    return SpectralState(vort=damp(s.vort), div=damp(s.div), T=damp(s.T),
                         lnps=s.lnps, q=damp(s.q), ql=damp(s.ql),
                         qi=damp(s.qi), a=damp(s.a))


def robert_filter(now, prev_f, new, eps=0.05):
    """Robert-Asselin filter: filtered 'now' for the next step."""
    f = lambda n, p, w: n + eps * (w - 2.0 * n + p)
    return SpectralState(*[f(n, p, w) for n, p, w in zip(now, prev_f, new)])
