"""Vertical discretization: sigma/hybrid levels + semi-implicit matrices.

Port of ``sp_coupler_tpu/models/gcm/vertical.py``: the hydrostatic
coefficients, the geopotential matrix G, the semi-implicit couplings W
and b, and the per-wavenumber implicit inverses (host numpy, float64,
then float32 on the device); on hybrid sigma-pressure levels also the
A/B half-level tables and the per-column nonlinear-term coefficients
(``hybrid_coeffs``) with the geopotential from them.
"""

import numpy as np
import torch

from sp_coupler_tpu_torch import constants as c, default_device


def sigma_levels(nlev, stretch=1.7):
    """Half-level sigma values [nlev+1]: 0 at top -> 1 at surface."""
    k = np.arange(nlev + 1) / nlev
    return k ** stretch


def hybrid_ab(nlev, pref=1.0e5, stretch=1.7):
    """Hybrid sigma-pressure A/B half-level coefficients [nlev+1] each.

    p_{k+1/2} = A_k + B_k * ps with B = sigma^2 (pure pressure at the
    top, terrain-following at the surface) and A = pref (sigma - sigma^2),
    so that at ps = pref the level pressures are the sigma set's and the
    semi-implicit linearization is the sigma model's."""
    s = sigma_levels(nlev, stretch)
    B = s * s
    A = pref * (s - B)
    return A, B


class VerticalCoords:
    """Precomputed vertical-coordinate operators.

    ``hybrid=True`` (or ``A_half``/``B_half`` given) switches the half-level
    pressure from p = sigma ps to p = A + B ps. The semi-implicit
    matrices are always the reference-state (ps = pref) linearization;
    the nonlinear terms use the per-column ``hybrid_coeffs``."""

    def __init__(self, nlev, tref=300.0, sigma_half=None, device=None,
                 hybrid=False, pref=1.0e5, A_half=None, B_half=None):
        self.nlev = nlev
        self.tref = tref
        self.hybrid = bool(hybrid) or A_half is not None
        self.pref = pref
        self.device = default_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=self.device)
        sh = sigma_levels(nlev) if sigma_half is None else np.asarray(
            sigma_half)
        assert sh.shape == (nlev + 1,)
        if self.hybrid:
            if A_half is None:
                A_np, B_np = hybrid_ab(nlev, pref)
            else:
                A_np = np.asarray(A_half, np.float64)
                B_np = np.asarray(B_half, np.float64)
                sh = A_np / pref + B_np     # reference-state sigma
        else:
            A_np = np.zeros(nlev + 1)
            B_np = sh.astype(np.float64)
        ds = sh[1:] - sh[:-1]
        sf = 0.5 * (sh[1:] + sh[:-1])
        # ln ratios; the top layer (sigma = 0 at its top) takes the IFS
        # convention
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
        self.dA, self.dB = f32(np.diff(A_np)), f32(np.diff(B_np))
        self.sh, self.sf, self.ds = f32(sh), f32(sf), f32(ds)
        self.lnr, self.alpha = f32(lnr), f32(alpha)
        self.G, self.Pmat, self.W, self.b = f32(G), f32(Pm), f32(W), f32(b)
        self._G64, self._W64, self._b64 = G, W, b
        # every dt of a run stays cached (the SL core asks for five)
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
        """ps [...] -> (ph [L+1, ...], pf [L, ...]); level axis leading.
        Sigma: ph = sh ps; hybrid: ph = A + B ps."""
        shp = (self.nlev + 1,) + (1,) * ps.dim()
        ph = self.A.reshape(shp) + self.B.reshape(shp) * ps[None]
        pf = 0.5 * (ph[1:] + ph[:-1])
        return ph, pf

    def hybrid_coeffs(self, ps):
        """Per-column nonlinear-term coefficients from actual pressures,
        level axis leading, broadcast against ps: dpt (Delta p / ps), w
        (ps dB / Delta p), lnr, alpha (top layer: the IFS convention), Bh
        (B at half levels), ph, pf. On sigma levels they are the
        precomputed constants."""
        ph, pf = self.pressures(ps)
        dp = ph[1:] - ph[:-1]
        shp = (self.nlev,) + (1,) * ps.dim()
        Bh = (self.B.reshape((self.nlev + 1,) + (1,) * ps.dim())
              * torch.ones_like(ph))
        if not self.hybrid:
            one = torch.ones_like(dp)
            return dict(dpt=self.ds.reshape(shp) * one, w=one,
                        lnr=self.lnr.reshape(shp) * one,
                        alpha=self.alpha.reshape(shp) * one,
                        Bh=Bh, ph=ph, pf=pf)
        dpt = dp / ps[None]
        w = self.dB.reshape(shp) * ps[None] / dp
        safe_top = torch.maximum(ph[:-1], 1e-3 * ph[1:])
        lnr = torch.log(ph[1:] / safe_top)
        alpha = 1.0 - ph[:-1] / dp * lnr
        # IFS top-layer convention (the model top is p = 0)
        ln2 = torch.log(torch.tensor(2.0, dtype=ps.dtype, device=ps.device))
        lnr = torch.cat([(1.0 + ln2 * torch.ones_like(lnr[0]))[None],
                         lnr[1:]])
        alpha = torch.cat([(ln2 * torch.ones_like(alpha[0]))[None],
                           alpha[1:]])
        return dict(dpt=dpt, w=w, lnr=lnr, alpha=alpha, Bh=Bh, ph=ph, pf=pf)

    def geopotential_half(self, T, phis=0.0, lnr=None):
        """Phi at half levels [..., L+1] from T [..., L] (top first); lnr:
        the per-column [..., L] of hybrid levels (default: the reference
        constants, exact on sigma)."""
        incr = c.rd * T * (self.lnr if lnr is None else lnr)
        csum = torch.flip(torch.cumsum(torch.flip(incr, (-1,)), dim=-1),
                          (-1,))
        phih = torch.cat([csum, torch.zeros_like(csum[..., :1])], dim=-1)
        return phis + phih

    def geopotential_full(self, T, phis=0.0, lnr=None, alpha=None):
        """Phi at full levels [..., L] (top first): the G-matrix form, or
        Phi_{k+1/2} + R alpha_k T_k with per-column lnr and alpha."""
        if lnr is None:
            return phis + torch.einsum("kj,...j->...k", self.G, T)
        phih = self.geopotential_half(T, phis, lnr)
        return phih[..., 1:] + c.rd * alpha * T
