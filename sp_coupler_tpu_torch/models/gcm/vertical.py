"""Vertical discretization on sigma levels + semi-implicit matrices.

Port of the sigma branch of ``sp_coupler_tpu/models/gcm/vertical.py``:
the hydrostatic coefficients, the geopotential matrix G, the
semi-implicit couplings W and b, and the per-wavenumber implicit inverses
(host numpy, float64, then float32 on the device).
"""

import numpy as np
import torch

from sp_coupler_tpu_torch import constants as c, default_device


def sigma_levels(nlev, stretch=1.7):
    """Half-level sigma values [nlev+1]: 0 at top -> 1 at surface."""
    k = np.arange(nlev + 1) / nlev
    return k ** stretch


class VerticalCoords:
    """Precomputed sigma-coordinate operators."""

    hybrid = False

    def __init__(self, nlev, tref=300.0, device=None, hybrid=False):
        if hybrid:
            raise NotImplementedError(
                "hybrid sigma-pressure levels are not ported yet "
                "(ROADMAP.md, open items: hybrid vertical coordinates)")
        self.nlev = nlev
        self.tref = tref
        self.device = default_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=self.device)
        sh = sigma_levels(nlev)
        A_np = np.zeros(nlev + 1)
        B_np = sh.astype(np.float64)
        ds = sh[1:] - sh[:-1]
        sf = 0.5 * (sh[1:] + sh[:-1])
        lnr = np.zeros(nlev)
        lnr[1:] = np.log(sh[2:] / sh[1:-1])
        lnr[0] = 1.0 + np.log(2.0)
        alpha = np.zeros(nlev)
        alpha[1:] = 1.0 - sh[1:-1] / ds[1:] * lnr[1:]
        alpha[0] = np.log(2.0)
        G = np.zeros((nlev, nlev))
        for k in range(nlev):
            G[k, k] = c.rd * alpha[k]
            for j in range(k + 1, nlev):
                G[k, j] = c.rd * lnr[j]
        Pm = np.zeros((nlev, nlev))
        for k in range(nlev):
            Pm[k, k] = alpha[k]
            for j in range(k):
                Pm[k, j] = lnr[k] * ds[j] / ds[k]
        Pm[0, 0] = alpha[0]
        W = -c.kappa * tref * Pm
        b = ds.copy()

        self.A, self.B = f32(A_np), f32(B_np)
        self.sh, self.sf, self.ds = f32(sh), f32(sf), f32(ds)
        self.lnr, self.alpha = f32(lnr), f32(alpha)
        self.G, self.Pmat, self.W, self.b = f32(G), f32(Pm), f32(W), f32(b)
        self._G64, self._W64, self._b64 = G, W, b
        self._inv_cache = {}

    def implicit_inverse(self, dt, trunc, radius=c.a_earth):
        """[(trunc+2,), L, L] inverses (I - dt^2 lam_n (G W - R Tref 1 b^T))^-1
        indexed by total wavenumber n (host float64, cached)."""
        key = (float(dt), int(trunc), float(radius))
        if key not in self._inv_cache:
            L = self.nlev
            GW = self._G64 @ self._W64 - c.rd * self.tref * np.outer(
                np.ones(L), self._b64)
            ns = np.arange(trunc + 2)
            lam = ns * (ns + 1) / radius ** 2
            eye = np.eye(L)
            Ms = np.stack([np.linalg.inv(eye - dt * dt * l * GW)
                           for l in lam])
            self._inv_cache[key] = torch.as_tensor(
                Ms, dtype=torch.float32, device=self.device)
        return self._inv_cache[key]

    def pressures(self, ps):
        """ps [...] -> (ph [L+1, ...], pf [L, ...]); level axis leading."""
        shp = (self.nlev + 1,) + (1,) * ps.dim()
        ph = self.A.reshape(shp) + self.B.reshape(shp) * ps[None]
        pf = 0.5 * (ph[1:] + ph[:-1])
        return ph, pf

    def geopotential_half(self, T, phis=0.0):
        """Phi at half levels [..., L+1] from T [..., L] (top first)."""
        incr = c.rd * T * self.lnr
        csum = torch.flip(torch.cumsum(torch.flip(incr, (-1,)), dim=-1),
                          (-1,))
        phih = torch.cat([csum, torch.zeros_like(csum[..., :1])], dim=-1)
        return phis + phih

    def geopotential_full(self, T, phis=0.0):
        """Phi at full levels [..., L] (top first)."""
        return phis + torch.einsum("kj,...j->...k", self.G, T)
