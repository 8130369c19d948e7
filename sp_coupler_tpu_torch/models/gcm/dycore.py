"""Hydrostatic primitive-equation spectral dycore (semi-implicit).

Port of ``sp_coupler_tpu/models/gcm/dycore.py``: vorticity-divergence
form on sigma or hybrid levels, semi-implicit leapfrog with a
Robert-Asselin filter and del^4 hyperdiffusion (the Eulerian path; the
semi-Lagrangian step in ``semilag.py`` reuses its grid view, vertical
advection and filters). Spectral state is packed real [L, M, N, 2].
"""

from typing import NamedTuple, Optional

import torch

from sp_coupler_tpu_torch import constants as c, default_device
from . import spharm


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


def _hybrid_coeffs_grid(vc, lnps):
    """Per-gridpoint hybrid coefficients [L, nlat, nlon] (None on sigma
    levels): dpt, lnr, alpha and wp = Bbar ps / pf, the surface-following
    weight of grad(ln p) at full levels."""
    if not vc.hybrid:
        return None
    ps = c.pref0 * torch.exp(lnps)
    hc = vc.hybrid_coeffs(ps)
    Bbar = 0.5 * (vc.B[1:] + vc.B[:-1])
    wp = Bbar[:, None, None] * ps[None] / hc["pf"]
    return dict(dpt=hc["dpt"], lnr=hc["lnr"], alpha=hc["alpha"], wp=wp)


def to_grid(sht, vc, s: SpectralState, diag=True) -> GridFields:
    """Grid view of a spectral state with the omega/p diagnostic.
    diag=False skips the diagnostics (omega_p, grid vort and div), as the
    SL departure-time state needs only the prognostic fields."""
    u, v = sht.uv_from_vort_div(s.vort, s.div)
    T = sht.synthesize(s.T)
    q = sht.synthesize(s.q)
    ql = sht.synthesize(s.ql)
    qi = sht.synthesize(s.qi)
    a = sht.synthesize(s.a)
    lnps = sht.synthesize(s.lnps)
    if not diag:
        return GridFields(u=u, v=v, T=T, q=q, ql=ql, qi=qi, a=a, lnps=lnps,
                          omega_p=None, vort=None, div=None)
    vort = sht.synthesize(s.vort)
    div = sht.synthesize(s.div)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = u * dpx[None] + v * dpy[None]
    hc = _hybrid_coeffs_grid(vc, lnps)
    if hc is None:
        omega_p = vgrad - _lev(vc.Pmat, div + vgrad)
    else:
        # (omega/p)_k = wp_k v.grad(lnps)
        #   - (1/dpt_k)[lnr_k sum_{j<k} Ct_j + alpha_k Ct_k],
        # Ct_j = dpt_j D_j + dB_j v.grad(lnps) (per-unit-ps mass div)
        Ct = hc["dpt"] * div + vc.dB[:, None, None] * vgrad
        csum_ex = torch.cumsum(Ct, dim=0) - Ct
        omega_p = (hc["wp"] * vgrad
                   - (hc["lnr"] * csum_ex + hc["alpha"] * Ct) / hc["dpt"])
    return GridFields(u=u, v=v, T=T, q=q, ql=ql, qi=qi, a=a, lnps=lnps,
                      omega_p=omega_p, vort=vort, div=div)


def _vert_advect(vc, sdot_half, X, dpt=None):
    """(eta_dot dX/d-eta)_k with sdot_half [L+1, ...] zero at both ends,
    in per-unit-ps pressure units; dpt: the actual layer thickness per
    unit ps (default: the sigma constants)."""
    dX_up = X - torch.cat([X[:1], X[:-1]], 0)
    dX_dn = torch.cat([X[1:], X[-1:]], 0) - X
    ds = vc.ds[:, None, None] if dpt is None else dpt
    return 0.5 / ds * (sdot_half[1:] * dX_dn + sdot_half[:-1] * dX_up)


def tendencies(sht, vc, s: SpectralState, f_coriolis_grid):
    """Explicit tendencies at time t: (N: SpectralState, g: GridFields)."""
    g = to_grid(sht, vc, s)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = g.u * dpx[None] + g.v * dpy[None]
    hc = _hybrid_coeffs_grid(vc, g.lnps)
    if hc is None:
        Ct = (g.div + vgrad) * vc.ds[:, None, None]
        dpt, Bh, wp = None, vc.sh, 1.0
    else:
        dpt = hc["dpt"]
        Ct = g.div * dpt + vc.dB[:, None, None] * vgrad
        Bh, wp = vc.B, hc["wp"]
    dpi_dt = -torch.sum(Ct, dim=0)
    csum = torch.cumsum(Ct, dim=0)
    total = csum[-1:]
    sdot_int = Bh[1:-1, None, None] * total - csum[:-1]
    zero = torch.zeros_like(sdot_int[:1])
    sdot = torch.cat([zero, sdot_int, zero], dim=0)

    Tp = g.T - vc.tref
    abs_vort = g.vort + f_coriolis_grid[None]
    Fu = (abs_vort * g.v - _vert_advect(vc, sdot, g.u, dpt)
          - c.rd * Tp * wp * dpx[None])
    Fv = (-abs_vort * g.u - _vert_advect(vc, sdot, g.v, dpt)
          - c.rd * Tp * wp * dpy[None])
    N_vort, divF = sht.vort_div_from_uv(Fu, Fv)

    E = 0.5 * (g.u ** 2 + g.v ** 2)
    if hc is None:
        # sigma: the geopotential is linear in T, the G matrix is exact
        lin = (sht.analyze(E) + _lev(vc.G, s.T)
               + c.rd * vc.tref * s.lnps[None])
    else:
        # hybrid: Phi depends on ps through lnr/alpha, so it is computed
        # per grid point and analyzed (the semi-implicit correction keeps
        # the reference G)
        phi_grid = vc.geopotential_full(
            torch.movedim(g.T, 0, -1), lnr=torch.movedim(hc["lnr"], 0, -1),
            alpha=torch.movedim(hc["alpha"], 0, -1))
        lin = (sht.analyze(E + torch.movedim(phi_grid, -1, 0))
               + c.rd * vc.tref * s.lnps[None])
    N_div = divF - sht.laplacian[..., None] * lin

    _, divTflux = sht.vort_div_from_uv(g.u * Tp, g.v * Tp)
    N_T_grid = (Tp * g.div - _vert_advect(vc, sdot, g.T, dpt)
                + c.kappa * g.T * g.omega_p)
    N_T = -divTflux + sht.analyze(N_T_grid)
    N_lnps = sht.analyze(dpi_dt)

    def scalar_adv(x_grid):
        _, divflux = sht.vort_div_from_uv(g.u * x_grid, g.v * x_grid)
        rest = x_grid * g.div - _vert_advect(vc, sdot, x_grid, dpt)
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
    div_new = spharm.card_sums("nlj,jmnc->lmnc", Minv, x)

    dDiv = div_new + prev.div - 2.0 * now.div
    T_new = T_star + h * _lev(W, dDiv)
    pi_new = pi_star - h * torch.einsum("j,j...->...", b, dDiv)
    return SpectralState(
        vort=prev.vort + dt2 * N.vort, div=div_new, T=T_new, lnps=pi_new,
        q=prev.q + dt2 * N.q, ql=prev.ql + dt2 * N.ql,
        qi=prev.qi + dt2 * N.qi, a=prev.a + dt2 * N.a)


def hyperdiffuse(sht, s: SpectralState, dt, tau=3600.0 * 4,
                 damp_lnps=False):
    """Implicit del^4 damping, the smallest resolved scale at rate 1/tau.
    damp_lnps: damp lnps too. The Eulerian path leaves it undamped; the
    semi-Lagrangian path needs a sink for the grid-scale interpolation
    noise it puts into lnps every step."""
    lam_max = sht.trunc * (sht.trunc + 1) / sht.radius ** 2
    nu = 1.0 / (tau * lam_max ** 2)
    fac = (1.0 / (1.0 + dt * nu * sht.laplacian ** 2))[..., None]
    damp = lambda x: x * fac
    return SpectralState(vort=damp(s.vort), div=damp(s.div), T=damp(s.T),
                         lnps=damp(s.lnps) if damp_lnps else s.lnps,
                         q=damp(s.q), ql=damp(s.ql),
                         qi=damp(s.qi), a=damp(s.a))


def robert_filter(now, prev_f, new, eps=0.05):
    """Robert-Asselin filter: filtered 'now' for the next step."""
    f = lambda n, p, w: n + eps * (w - 2.0 * n + p)
    return SpectralState(*[f(n, p, w) for n, p, w in zip(now, prev_f, new)])
