"""Flux-form advection on the staggered C grid (anelastic, periodic x/y).

Port of ``sp_coupler_tpu/models/les/advect.py`` for the schemes the main
path runs: 5th-order upwind horizontal / 2nd-order vertical scalar
advection ("hybrid52") and 2nd-order momentum advection.

Axis convention: [n, z, y, x] = axes (0, 1, 2, 3); profiles are [n, nz].
"""

import torch

Z, Y, X = 1, 2, 3


def sp(a, ax, n=1):
    """a[i+n] at position i (periodic)."""
    return torch.roll(a, -n, ax)


def sm(a, ax, n=1):
    """a[i-n] at position i (periodic)."""
    return torch.roll(a, n, ax)


def col(p):
    """[n, k] profile -> [n, k, 1, 1] for broadcasting against fields."""
    return p[:, :, None, None]


def face_up5(s, vel, ax):
    """5th-order upwind-biased face value at face i, advecting velocity vel."""
    s0, sp1, sp2 = s, sp(s, ax), sp(s, ax, 2)
    sm1, sm2, sm3 = sm(s, ax), sm(s, ax, 2), sm(s, ax, 3)
    central = (37.0 * (sm1 + s0) - 8.0 * (sm2 + sp1) + (sm3 + sp2)) / 60.0
    upwind = (10.0 * (s0 - sm1) - 5.0 * (sp1 - sm2) + (sp2 - sm3)) / 60.0
    return central - torch.sign(vel) * upwind


def _hface(s, vel, ax, scheme):
    if scheme == "hybrid52":
        return face_up5(s, vel, ax)
    raise NotImplementedError(
        "advection scheme %r is not ported yet (ROADMAP.md, open items: "
        "cd2/hybrid62 advection)" % (scheme,))


def _zfaces(Fz_int):
    """Pad interior-face fluxes [n, nz-1, ...] with zero outer faces."""
    zero = torch.zeros_like(Fz_int[:, :1])
    return torch.cat([zero, Fz_int, zero], dim=Z)


def advect_scalar(grid, rhobf, rhobh, u, v, w, s, scheme="hybrid52"):
    """Advection tendency of a cell-centered scalar, flux form."""
    Fx = u * _hface(s, u, X, scheme)
    Fy = v * _hface(s, v, Y, scheme)
    tend = -(sp(Fx, X) - Fx) / grid.dx - (sp(Fy, Y) - Fy) / grid.dy
    s_f = 0.5 * (s[:, 1:] + s[:, :-1])
    Fz = _zfaces(col(rhobh[:, 1:-1]) * w[:, 1:-1] * s_f)
    return tend - (Fz[:, 1:] - Fz[:, :-1]) / (col(rhobf) * grid.dz)


def advect_u(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of u (x-face points)."""
    uc = 0.5 * (u + sp(u, X))
    Fx = uc * uc
    tx = -(Fx - sm(Fx, X)) / grid.dx
    vbar = 0.5 * (sm(v, X) + v)
    ubar = 0.5 * (sm(u, Y) + u)
    Fy = vbar * ubar
    ty = -(sp(Fy, Y) - Fy) / grid.dy
    wbar = 0.5 * (sm(w, X) + w)
    u_zf = 0.5 * (u[:, 1:] + u[:, :-1])
    Fz = _zfaces(col(rhobh[:, 1:-1]) * wbar[:, 1:-1] * u_zf)
    tz = -(Fz[:, 1:] - Fz[:, :-1]) / (col(rhobf) * grid.dz)
    return tx + ty + tz


def advect_v(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of v (y-face points)."""
    vc = 0.5 * (v + sp(v, Y))
    Fy = vc * vc
    ty = -(Fy - sm(Fy, Y)) / grid.dy
    ubar = 0.5 * (sm(u, Y) + u)
    vbar = 0.5 * (sm(v, X) + v)
    Fx = ubar * vbar
    tx = -(sp(Fx, X) - Fx) / grid.dx
    wbar = 0.5 * (sm(w, Y) + w)
    v_zf = 0.5 * (v[:, 1:] + v[:, :-1])
    Fz = _zfaces(col(rhobh[:, 1:-1]) * wbar[:, 1:-1] * v_zf)
    tz = -(Fz[:, 1:] - Fz[:, :-1]) / (col(rhobf) * grid.dz)
    return tx + ty + tz


def advect_w(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of w, [n, nz+1, ny, nx] with zero
    tendency on the boundary faces."""
    wi = w[:, 1:-1]
    u_zf = 0.5 * (u[:, 1:] + u[:, :-1])
    Fx = u_zf * 0.5 * (sm(wi, X) + wi)
    tx = -(sp(Fx, X) - Fx) / grid.dx
    v_zf = 0.5 * (v[:, 1:] + v[:, :-1])
    Fy = v_zf * 0.5 * (sm(wi, Y) + wi)
    ty = -(sp(Fy, Y) - Fy) / grid.dy
    wc = 0.5 * (w[:, 1:] + w[:, :-1])
    Fz = col(rhobf) * wc * wc
    tz = -(Fz[:, 1:] - Fz[:, :-1]) / (col(rhobh[:, 1:-1]) * grid.dz)
    return _zfaces(tx + ty + tz)


def divergence(grid, rhobf, rhobh, u, v, w):
    """div(rho u) at cell centers, [n, nz, ny, nx]."""
    du = (sp(u, X) - u) / grid.dx
    dv = (sp(v, Y) - v) / grid.dy
    Fw = col(rhobh) * w
    dw = (Fw[:, 1:] - Fw[:, :-1]) / grid.dz
    return col(rhobf) * (du + dv) + dw
