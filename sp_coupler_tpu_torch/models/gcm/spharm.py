"""Spherical-harmonic transforms on the Gaussian grid (torch tensors).

Port of ``sp_coupler_tpu/models/gcm/spharm.py`` without a mesh: a real
DFT in longitude written as an einsum against cos/sin tables, and
Legendre transforms as einsums over the equator-folded associated-Legendre
tables (even/odd n-m classes, north half only). The tables are built with
the same host numpy code as the JAX package.

Conventions: packed-real spectral coefficients [..., M, N, 2] with M = T+1,
N = T+2 (the n = T+1 row is recurrence workspace); grid arrays
[..., nlat, nlon] with latitude running north -> south. Products run in
full float32 (TF32 off, as the JAX package's HIGHEST precision).
"""

import functools

import numpy as np
import torch

from sp_coupler_tpu_torch import default_device

GRID_FOR_TRUNC = {
    10: (32, 16),
    21: (64, 32),
    31: (96, 48),
    42: (128, 64),
    63: (192, 96),
    85: (256, 128),
    106: (320, 160),
    159: (480, 240),
    213: (640, 320),
    255: (768, 384),
    319: (960, 480),
    639: (1280, 640),
}


def gaussian_latitudes(nlat):
    """(mu, w): Gaussian nodes (sin latitude) and weights, north->south."""
    mu, w = np.polynomial.legendre.leggauss(nlat)
    order = np.argsort(-mu)
    return mu[order], w[order]


@functools.lru_cache(maxsize=8)
def legendre_tables(trunc, nlat):
    """(P, H) tables as numpy float64: [nlat, M, N] orthonormal associated
    Legendre functions and H = (1 - mu^2) dP/dmu."""
    M = trunc + 1
    N = trunc + 2
    mu, _ = gaussian_latitudes(nlat)
    sinl = np.sqrt(1.0 - mu ** 2)
    NP = trunc + 3
    P = np.zeros((nlat, M, NP))
    P[:, 0, 0] = 1.0 / np.sqrt(2.0)
    for m in range(1, M):
        P[:, m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * sinl * P[:, m - 1, m - 1]
    for m in range(M):
        if m + 1 < NP:
            P[:, m, m + 1] = mu * np.sqrt(2 * m + 3.0) * P[:, m, m]
        for n in range(m + 2, NP):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
            P[:, m, n] = a * (mu * P[:, m, n - 1] - b * P[:, m, n - 2])
    eps = np.zeros((M, NP + 1))
    for m in range(M):
        for n in range(m, NP + 1):
            if n > 0:
                eps[m, n] = np.sqrt(max(n * n - m * m, 0.0) /
                                    (4.0 * n * n - 1.0))
    H = np.zeros((nlat, M, N))
    for m in range(M):
        for n in range(m, N):
            t = (n + 1.0) * eps[m, n] * (P[:, m, n - 1] if n - 1 >= m else 0.0)
            t = t - n * eps[m, n + 1] * P[:, m, n + 1]
            H[:, m, n] = t
    return P[:, :, :N], H


def _shift(s, up):
    """Shift packed coefficients one row along n (zero fill)."""
    z = torch.zeros_like(s[..., :1, :])
    if up:
        return torch.cat([s[..., 1:, :], z], dim=-2)
    return torch.cat([z, s[..., :-1, :]], dim=-2)


class SpectralTransform:
    """Precomputed transform operator for one (truncation, grid) pair."""

    def __init__(self, trunc, nlat=None, nlon=None, radius=6.371e6,
                 device=None):
        if nlat is None or nlon is None:
            nlon, nlat = GRID_FOR_TRUNC[trunc]
        self.trunc, self.nlat, self.nlon = trunc, nlat, nlon
        self.radius = radius
        self.device = default_device(device)
        self.M = trunc + 1
        self.N = trunc + 2
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=self.device)
        i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                        device=self.device)
        mu, w = gaussian_latitudes(nlat)
        P, _ = legendre_tables(trunc, nlat)
        self.mu_np = mu
        self.mu = f32(mu)
        self.w = f32(w)
        self.cosl = f32(np.sqrt(1 - mu ** 2))
        # equator-folded tables: north half, even/odd (n - m) classes with
        # the n index packed (n = m + 2k)
        assert nlat % 2 == 0
        jn = nlat // 2
        self.jn = jn
        Ke = (self.N + 1) // 2
        self.Ke = Ke
        ms = np.arange(self.M)[:, None]
        ks = np.arange(Ke)[None, :]
        n_e = ms + 2 * ks
        n_o = n_e + 1
        ve = n_e < self.N
        vo = n_o < self.N
        idx_e = np.minimum(n_e, self.N - 1)
        idx_o = np.minimum(n_o, self.N - 1)
        self.Pe = f32((P[:jn, ms, idx_e] * ve).astype(np.float32))
        self.Po = f32((P[:jn, ms, idx_o] * vo).astype(np.float32))
        # derivative transform as a P-transform of shifted coefficients
        n_full = np.arange(self.N + 1)[None, :]
        m_full = np.arange(self.M)[:, None]
        eps = np.sqrt(np.maximum(n_full ** 2 - m_full ** 2, 0.0)
                      / np.maximum(4.0 * n_full ** 2 - 1.0, 1.0))
        nv = np.arange(self.N)[None, :]
        self._c_up = f32((nv + 2.0) * eps[:, 1:self.N + 1])
        self._c_dn = f32(-(nv - 1.0) * eps[:, :self.N])
        self._ca_up = f32(-nv * eps[:, 1:self.N + 1])
        self._ca_dn = f32((nv + 1.0) * eps[:, :self.N])
        self._idx_e = i32(idx_e)
        self._idx_o = i32(idx_o)
        self._ve = f32(ve)
        self._vo = f32(vo)
        dk = np.arange(self.N)[None, :] - np.arange(self.M)[:, None]
        self._k_of = i32(np.clip(np.maximum(dk, 0) // 2, 0, Ke - 1))
        self._class_even = torch.as_tensor((dk % 2 == 0) & (dk >= 0),
                                           device=self.device)
        n_idx = np.arange(self.N)[None, :] * np.ones((self.M, 1))
        m_idx = np.arange(self.M)[:, None] * np.ones((1, self.N))
        tri = (n_idx >= m_idx) & (n_idx <= trunc)
        self.mask = f32(tri)
        self.n = f32(n_idx)
        self.m = f32(m_idx)
        self.laplacian = f32(np.where(tri, -n_idx * (n_idx + 1), 0.0)
                             .astype(np.float32) / np.float32(radius ** 2))
        inv = np.zeros((self.M, self.N))
        nz = n_idx > 0
        inv[nz] = -(radius ** 2) / (n_idx * (n_idx + 1))[nz]
        self.inv_laplacian = f32(inv * tri)
        # zonal real DFT tables
        lam = 2.0 * np.pi * np.arange(nlon) / nlon
        ang = np.outer(lam, np.arange(self.M))
        fwd = np.stack([np.cos(ang), -np.sin(ang)], axis=-1) / nlon
        wm = np.where(np.arange(self.M) == 0, 1.0, 2.0)
        if nlon % 2 == 0 and self.M - 1 == nlon // 2:
            wm[-1] = 1.0
        inv_t = np.stack([np.cos(ang).T * wm[:, None],
                          -np.sin(ang).T * wm[:, None]], axis=1)
        self.Ffwd = f32(fwd)            # [nlon, M, 2]
        self.Finv = f32(inv_t)          # [M, 2, nlon]

    # ---- scalar transforms -------------------------------------------------

    def _fft(self, f):
        """[..., nlat, nlon] -> packed zonal spectra [..., nlat, M, 2]."""
        return torch.einsum("...i,imc->...mc", f, self.Ffwd)

    def _ifft(self, fm):
        """packed zonal spectra [..., nlat, M, 2] -> grid [..., nlat, nlon]."""
        return torch.einsum("...mc,mci->...i", fm, self.Finv)

    def _wq(self, fm):
        return fm * self.w[:, None, None]

    def _pack_coeffs(self, s):
        """[..., M, N, 2] -> (even, odd) packed [..., M, Ke, 2]."""
        def take(idx):
            i = idx.reshape((1,) * (s.dim() - 3) + idx.shape + (1,))
            i = i.expand(s.shape[:-2] + (self.Ke, s.shape[-1]))
            return torch.gather(s, -2, i)
        return (take(self._idx_e) * self._ve[..., None],
                take(self._idx_o) * self._vo[..., None])

    def _unpack_coeffs(self, se, so):
        """(even, odd) packed [..., M, Ke, 2] -> [..., M, N, 2]."""
        k = self._k_of.reshape((1,) * (se.dim() - 3) + self._k_of.shape
                               + (1,))
        k = k.expand(se.shape[:-2] + (self.N, se.shape[-1]))
        return torch.where(self._class_even[..., None],
                           torch.gather(se, -2, k), torch.gather(so, -2, k))

    def _fold(self, fm, sign):
        north = fm[..., :self.jn, :, :]
        south = torch.flip(fm[..., self.jn:, :, :], (-3,))
        return north + sign * south

    def _unfold(self, north, south_n):
        return torch.cat([north, torch.flip(south_n, (-3,))], dim=-3)

    def _h_shift(self, s):
        return (self._c_up[..., None] * _shift(s, True)
                + self._c_dn[..., None] * _shift(s, False))

    def _h_shift_adj(self, a):
        return (self._ca_up[..., None] * _shift(a, True)
                + self._ca_dn[..., None] * _shift(a, False))

    def _syn(self, s):
        se, so = self._pack_coeffs(s)
        fe = torch.einsum("...mkc,jmk->...jmc", se, self.Pe)
        fo = torch.einsum("...mkc,jmk->...jmc", so, self.Po)
        return self._unfold(fe + fo, fe - fo)

    def _ana(self, fmw):
        ge = self._fold(fmw, 1.0)
        go = self._fold(fmw, -1.0)
        se = torch.einsum("...jmc,jmk->...mkc", ge, self.Pe)
        so = torch.einsum("...jmc,jmk->...mkc", go, self.Po)
        return self._unpack_coeffs(se, so)

    def analyze(self, f):
        """Grid [..., nlat, nlon] -> packed spectral [..., M, N, 2]."""
        return self._ana(self._wq(self._fft(f))) * self.mask[..., None]

    def synthesize(self, s):
        """Packed spectral [..., M, N, 2] -> grid [..., nlat, nlon]."""
        return self._ifft(self._syn(s * self.mask[..., None]))

    # ---- derivatives -------------------------------------------------------

    def ddlon(self, s):
        """Spectral d/dlambda: multiply by i m."""
        re, im = s[..., 0], s[..., 1]
        return torch.stack([-self.m * im, self.m * re], dim=-1)

    @staticmethod
    def _mul_i(fm, mvec):
        re, im = fm[..., 0], fm[..., 1]
        return torch.stack([-mvec * im, mvec * re], dim=-1)

    def synthesize_ddmu(self, s):
        """Grid values of (1 - mu^2) df/dmu from packed spectral f."""
        return self._ifft(self._syn(self._h_shift(s * self.mask[..., None])))

    def uv_from_vort_div(self, vort, div):
        """Grid (u, v) from packed spectral vorticity & divergence."""
        psi = vort * self.inv_laplacian[..., None]
        chi = div * self.inv_laplacian[..., None]
        dchi_dl = self.synthesize(self.ddlon(chi))
        dpsi_dl = self.synthesize(self.ddlon(psi))
        dpsi_dm = self.synthesize_ddmu(psi)
        dchi_dm = self.synthesize_ddmu(chi)
        coslat = self.cosl[:, None]
        ucos = (dchi_dl - dpsi_dm) / self.radius
        vcos = (dpsi_dl + dchi_dm) / self.radius
        return ucos / coslat, vcos / coslat

    def vort_div_from_uv(self, u, v):
        """Packed spectral (vorticity, divergence) from grid (u, v)."""
        coslat = self.cosl[:, None]
        A = self._wq(self._fft(u / coslat))
        B = self._wq(self._fft(v / coslat))
        mvec = torch.arange(self.M, dtype=u.dtype, device=u.device)
        iA = self._mul_i(A, mvec)
        iB = self._mul_i(B, mvec)
        div = (self._ana(iA) - self._h_shift_adj(self._ana(B))) / self.radius
        vort = (self._ana(iB) + self._h_shift_adj(self._ana(A))) / self.radius
        return vort * self.mask[..., None], div * self.mask[..., None]

    def grad(self, s):
        """Grid (df/dx, df/dy) from spectral f."""
        dfdl = self.synthesize(self.ddlon(s))
        dfdm = self.synthesize_ddmu(s)
        coslat = self.cosl[:, None]
        return dfdl / (self.radius * coslat), dfdm / (self.radius * coslat)

    def latitudes_deg(self):
        """Gaussian latitudes (degrees, north -> south) from the float32
        mu, as the JAX package's (the same columns fall in a region)."""
        return np.degrees(np.arcsin(self.mu.cpu().numpy()))

    def longitudes_deg(self):
        return np.arange(self.nlon) * 360.0 / self.nlon
