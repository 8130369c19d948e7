"""Semi-Lagrangian advection for the spectral dycore (3-time-level SL-SI).

Port of ``sp_coupler_tpu/models/gcm/semilag.py``: the three-time-level
semi-Lagrangian semi-implicit scheme of the ECMWF lineage (Ritchie 1991;
Ritchie et al. 1995) on the dycore's semi-implicit matrices,

    X+(x_a) = [X- + h L X-](x_d)  +  tau N(t)(x_m)  +  h L X+(x_a)

with tau the time window (2 dt; dt on the Euler start), h = tau/2, L the
semi-implicit linear operators (L_D = +lam (G T + R Tref pi), L_T = +W D,
L_pi = -b.D), x_d/x_m the departure point and midpoint of the
great-circle trajectory, and N everything explicit minus L.

Trajectories and momentum advection use 3-D Cartesian unit vectors: no
pole problem, no metric terms, and the wind components are scalars under
interpolation, so one interpolation serves winds and tracers. Departure
values are cubic Lagrange interpolants (uniform longitude nodes,
Gaussian latitude nodes) on a grid extended by pole-mirrored ghost rows;
midpoint values are linear. ``SLGrid.method`` picks how the k x k taps
are evaluated: "gather" (advanced indexing, one gather per tap for all
fields at once) or "window" (a sum of shifted slices weighted by
elementwise masks, bounded by the trajectory's CFL). Both give the same
taps and weights.

The pipeline functions (``sl_mid_grid`` -> ``sl_mid_terms`` ->
``sl_trajectories`` -> ``sl_dep_stack`` -> ``sl_interp_dep`` ->
``sl_arrivals`` -> ``sl_solve``; ``sl_finish`` is the last two) are the
stages of ``sl_step``, which calls them one by one and drops each
intermediate as soon as the next stage has consumed it.

On latitude bands (--gcmprocs, the transform's ``bands``) the source
fields the trajectories and interpolations read (``sl_mid_grid``,
``sl_mid_terms``, ``sl_dep_stack``, the trajectory winds) are synthesized
over the whole grid on every rank from the replicated spectral state
(``sht.whole``): the taps reach beyond the band, and the polar ghost rows
span several bands. The arrival-point work (trajectories, interpolation,
``sl_arrivals``) runs on the band's rows only, and ``sl_solve``'s
analysis adds the ranks' sums.
"""

import numpy as np
import torch

from sp_coupler_tpu_torch import constants as c
from . import dycore, spharm


def _cross(a, b):
    """Cross product along axis 0 of [3, ...] tensors (broadcast)."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _einsum_lev(w, x):
    """sum_k w[k] x[k, ...] (a level reduction)."""
    return torch.einsum("k,k...->...", w, x)


class SLGrid:
    """Precomputed geometry for trajectories + departure interpolation.

    ``method``: "gather" evaluates the k*k interpolation taps by advanced
    indexing; "window" uses the bound on a trajectory's displacement: the
    taps become a sum of statically shifted field slices weighted by
    elementwise masks, and displacements beyond the window are clamped to
    its edge (trajectory truncation). None takes "gather" (the JAX
    package takes "window" only on a TPU, where a general gather is
    slow).

    ``dt`` sizes the window from the design displacement wind_max * 2 dt:
    latitude rows are grouped into <= 3 bands with a doubling ladder of
    widths that cover wind_max at every latitude up to ~80 deg. Without
    ``dt`` one band of width min(10, nlon/2 - 4). The band tables are
    built on the host in float64 numpy, as the JAX package builds them.

    With the transform's ``bands`` the arrival points are the band's rows
    (``arrival``); the grid tables ``r``, ``e``, ``n`` and the extended
    latitudes stay whole, for the source fields.
    """

    def __init__(self, sht, nghost=12, method=None, dt=None, wind_max=150.0):
        self.nlat, self.nlon = sht.nlat, sht.nlon
        self.bands = sht.bands
        self.row0 = 0 if sht.bands is None else sht.bands.r0
        self.nb = self.nlat if sht.bands is None else sht.bands.nb
        if method is None:
            method = "gather"
        if method not in ("window", "gather"):
            raise ValueError("SLGrid method must be 'window' or 'gather', "
                             "got %r" % (method,))
        self.method = method
        self.k_chunk = None
        # the float32 mu of the transform, as the JAX package's sht.mu
        mu = sht.whole.mu.cpu().numpy().astype(np.float64)  # north -> south
        cosphi = np.cos(np.arcsin(mu))
        dx_eq = 2.0 * np.pi * float(sht.radius) / self.nlon
        cap = max(self.nlon // 2 - 4, 2)
        if dt is not None:
            cells = wind_max * 2.0 * float(dt) / dx_eq   # equator cells
            cells_lat = wind_max * 2.0 * float(dt) / (
                np.pi * float(sht.radius) / self.nlat)
            lat_req = int(np.ceil(cells_lat)) + 1
        else:
            cells = None
            lat_req = 8
        self.ng = ng = int(min(max(nghost, lat_req + 4), self.nlat))
        self.S_lat = max(min(ng - 3, lat_req), 1)
        self.S_lon = min(10, cap)
        if cells is None:
            self.lon_bands = [([(0, self.nlat)], self.S_lon)]
        else:
            S0 = int(min(max(int(np.ceil(cells)) + 2, 3), cap))
            ladder = [S0]
            while ladder[-1] < cap and len(ladder) < 3:
                ladder.append(min(2 * ladder[-1], cap))
            req = np.ceil(cells / np.maximum(cosphi, 1e-9)) + 2
            # smallest ladder level covering each row (top level if none)
            lev = np.full(self.nlat, len(ladder) - 1, np.int64)
            for li in range(len(ladder) - 2, -1, -1):
                lev[req <= ladder[li]] = np.minimum(lev[req <= ladder[li]],
                                                    li)
            # each level is a central band or a mirrored pair of polar
            # segments: group the contiguous runs of rows per level
            bands = []
            for li in range(len(ladder)):
                rows = np.flatnonzero(lev == li)
                if rows.size == 0:
                    continue
                segs = []
                r0 = prev = rows[0]
                for r in rows[1:]:
                    if r != prev + 1:
                        segs.append((int(r0), int(prev) + 1))
                        r0 = r
                    prev = r
                segs.append((int(r0), int(prev) + 1))
                bands.append((segs, int(ladder[li])))
            self.lon_bands = bands
        # the row segments of lon_bands cut to the arrival rows, in their
        # numbering (the same list without bands)
        self.lon_bands_local = []
        for segs, Si in self.lon_bands:
            cut = [(max(r0, self.row0) - self.row0,
                    min(r1, self.row0 + self.nb) - self.row0)
                   for r0, r1 in segs]
            cut = [(a, b) for a, b in cut if b > a]
            if cut:
                self.lon_bands_local.append((cut, Si))
        phi = np.arcsin(mu)
        lam = 2.0 * np.pi * np.arange(self.nlon) / self.nlon
        # extended latitude nodes (descending): pole-mirrored ghost rows
        phi_ext = np.concatenate([
            (np.pi - phi[:ng])[::-1], phi, (-np.pi - phi[-ng:])[::-1]])
        f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        dtype=torch.float32,
                                        device=sht.device)
        self.phi_ext = f32(phi_ext)
        self.dlon = 2.0 * np.pi / self.nlon
        # local basis at the grid points [3, nlat, nlon]
        ph = phi[:, None] + 0.0 * lam[None, :]
        lm = lam[None, :] + 0.0 * phi[:, None]
        cph, sph = np.cos(ph), np.sin(ph)
        clm, slm = np.cos(lm), np.sin(lm)
        self.r = f32(np.stack([cph * clm, cph * slm, sph]))
        self.e = f32(np.stack([-slm, clm, np.zeros_like(clm)]))
        self.n = f32(np.stack([-sph * clm, -sph * slm, cph]))

    def arrival(self, x):
        """The arrival rows of whole-grid x [..., nlat, nlon]."""
        return x[..., self.row0:self.row0 + self.nb, :]

    # ---- extension + interpolation ------------------------------------

    def extend(self, f):
        """[..., nlat, nlon] -> [..., nlat+2 ng, nlon] with pole-mirrored
        ghost rows: the value at lon + 180 deg, exact for scalars (the
        Cartesian wind components are scalars, so no sign flips)."""
        ng, half = self.ng, self.nlon // 2
        north = torch.flip(torch.roll(f[..., :ng, :], half, dims=-1), (-2,))
        south = torch.flip(torch.roll(f[..., -ng:, :], half, dims=-1), (-2,))
        return torch.cat([north, f, south], dim=-2)

    def _lat_taps(self, phi_t, k):
        """Row j0 (in extended coordinates) of the topmost of the k
        latitude taps around phi_t."""
        neg = -self.phi_ext                              # ascending
        j = torch.searchsorted(neg, (-phi_t).contiguous(), right=True) - 1
        # j: phi_ext[j] >= phi_t > phi_ext[j+1]
        j0 = j - (k - 2) // 2                            # cubic j-1, linear j
        return torch.clamp(j0, 0, self.phi_ext.shape[0] - k)

    @staticmethod
    def _lagrange(x, nodes):
        """Lagrange weights of x on nodes (a list of k tensors shaped like
        x) -> list of k weight tensors."""
        k = len(nodes)
        w = []
        for l in range(k):
            num, den = 1.0, 1.0
            for m in range(k):
                if m == l:
                    continue
                num = num * (x - nodes[m])
                den = den * (nodes[l] - nodes[m])
            w.append(num / den)
        return w

    @staticmethod
    def _lon_weights(t, cubic):
        if not cubic:
            return [1.0 - t, t]
        return [-t * (t - 1.0) * (t - 2.0) / 6.0,
                (t * t - 1.0) * (t - 2.0) / 2.0,
                -t * (t + 1.0) * (t - 2.0) / 2.0,
                t * (t * t - 1.0) / 6.0]

    def interp(self, fields, lam_t, phi_t, cubic=True):
        """Interpolate a stack of fields at target points.

        fields: [F, K, nlat, nlon] (K: levels; the taps are computed once
        and shared over F). lam_t, phi_t: [K, rows, nlon] target angles
        (lam in [0, 2 pi)) at the arrival rows. Returns [F, K, rows,
        nlon]."""
        if self.method == "window":
            return self._interp_window(fields, lam_t, phi_t, cubic)
        return self._interp_gather(fields, lam_t, phi_t, cubic)

    def _interp_window(self, fields, lam_t, phi_t, cubic=True):
        """Windowed-stencil interpolation, whole or in level chunks of
        k_chunk levels (set by the core's split_phases mode: it bounds
        the per-level mask and weight working set; levels are
        independent, so the result is the same)."""
        kc = self.k_chunk
        K = lam_t.shape[0]
        if kc and K > kc and K % kc == 0:
            return torch.cat([
                self._interp_window_body(fields[:, i:i + kc],
                                         lam_t[i:i + kc], phi_t[i:i + kc],
                                         cubic)
                for i in range(0, K, kc)], dim=1)
        return self._interp_window_body(fields, lam_t, phi_t, cubic)

    def _window_lat(self, phi_t, k, Sj):
        """Latitude taps of the window path: (djb, the topmost tap's row
        offset from the arrival row, and its k node latitudes), from
        compares against statically shifted node rows."""
        j0, nb = self.ng + self.row0, self.nb
        phi_ext = self.phi_ext

        def prow(s, l=0):
            # phi_ext[ng + r + s + l] as a broadcastable [1, rows, 1]
            return phi_ext[j0 + s + l: j0 + s + l + nb][None, :, None]

        cnt = torch.zeros(phi_t.shape, dtype=torch.int64,
                          device=phi_t.device)
        for s in range(-Sj, Sj + 1):
            cnt = cnt + (prow(s) >= phi_t).to(torch.int64)
        djn = cnt - (Sj + 1)          # phi_ext[j_row+djn] >= phi > next
        raw = djn - (k - 2) // 2
        djb = torch.clamp(raw, -Sj, Sj)
        nodes = []
        for l in range(k):
            nl = torch.zeros_like(phi_t)
            for s in range(-Sj, Sj + 1):
                nl = nl + torch.where(djb == s, prow(s, l), 0.0)
            nodes.append(nl)
        return djb, nodes, raw

    def _window_dlon(self, lam_t):
        """(signed column offset of the tap base from the arrival column,
        fractional position t)."""
        nlon = self.nlon
        xi = lam_t / self.dlon
        i1f = torch.floor(xi)
        t = xi - i1f
        i_col = torch.arange(nlon, device=lam_t.device)[None, None, :]
        dlon = i1f.to(torch.int64) - i_col
        dlon = torch.remainder(dlon + nlon // 2, nlon) - (nlon // 2)
        return dlon, t

    def _interp_window_body(self, fields, lam_t, phi_t, cubic=True):
        """Windowed-stencil evaluation of the k*k Lagrange taps:

        value(r, c) = sum_dj sum_di wlat_dj wlon_di f[j0+dj, i1+di]
                    = sum_sj sum_si A_sj(r, c) B_si(r, c) f[r+sj, c+si]

        with A_sj = sum_dj wlat_dj [j0 - j_row + dj = sj] and
        B_si = sum_di wlon_di [d_lon + di0 + di = si]. The masks depend on
        the targets only, so they are built once per band and shared by
        every field."""
        k = 4 if cubic else 2
        nlon, nb = self.nlon, self.nb
        j0 = self.ng + self.row0
        Sj = min(self.S_lat, self.ng - k + 1)
        di0 = -1 if cubic else 0
        pad = max(min(Si, nlon // 2 - k) for _, Si in self.lon_bands) + k
        bands = [(segs, min(Si, nlon // 2 - k))
                 for segs, Si in self.lon_bands_local]

        dlon, t = self._window_dlon(lam_t)
        djb, nodes, _ = self._window_lat(phi_t, k, Sj)
        # weight point clamped to the stencil span (a no-op unless the
        # bracket saturated): edge truncation, not cubic extrapolation
        phi_w = torch.clamp(phi_t, nodes[-1], nodes[0])
        wlat = self._lagrange(phi_w, nodes)
        wlon = self._lon_weights(t, cubic)

        def seg_cat(x, segs):
            """A band's latitude segments of x [..., nlat, nlon]."""
            if len(segs) == 1:
                r0, r1 = segs[0]
                return x[..., r0:r1, :]
            return torch.cat([x[..., r0:r1, :] for r0, r1 in segs], dim=-2)

        ext = self.extend(fields)                 # [F, K, J_ext, nlon]
        padded = torch.cat([ext[..., -pad:], ext, ext[..., :pad]], dim=-1)
        out = torch.empty(fields.shape[:2] + lam_t.shape[1:],
                          dtype=fields.dtype, device=fields.device)
        for segs, Si in bands:
            dl_b = torch.clamp(seg_cat(dlon, segs), -Si, Si)
            wlat_b = [seg_cat(w, segs) for w in wlat]
            wlon_b = [seg_cat(w, segs) for w in wlon]
            djb_b = seg_cat(djb, segs)
            Bs = []
            for si in range(-Si + di0, Si + di0 + k):
                B = torch.zeros_like(wlat_b[0])
                for di in range(k):
                    B = B + torch.where(dl_b + di0 + di == si, wlon_b[di],
                                        0.0)
                Bs.append(B)
            acc = None
            for sj in range(-Sj, Sj + k):
                A = torch.zeros_like(wlat_b[0])
                for dj in range(k):
                    A = A + torch.where(djb_b + dj == sj, wlat_b[dj], 0.0)
                row = seg_cat(padded[..., j0 + sj: j0 + sj + nb, :], segs)
                P = None
                for B, si in zip(Bs, range(-Si + di0, Si + di0 + k)):
                    term = B * row[..., pad + si: pad + si + nlon]
                    P = term if P is None else P + term
                acc = A * P if acc is None else acc + A * P
            off = 0
            for r0, r1 in segs:
                out[..., r0:r1, :] = acc[..., off:off + (r1 - r0), :]
                off += r1 - r0
        return out

    def clamp_stats(self, lam_t, phi_t, cubic=True):
        """Fraction of target points whose displacement exceeds the
        window and is edge-truncated, in longitude and in latitude; under
        bands, of the whole grid's points (a collective)."""
        k = 4 if cubic else 2
        K, _, nlon = lam_t.shape
        Sj = min(self.S_lat, self.ng - k + 1)
        dlon, _ = self._window_dlon(lam_t)
        lon_exc = torch.zeros((), dtype=torch.float32, device=lam_t.device)
        for segs, Si in self.lon_bands_local:
            Si = min(Si, nlon // 2 - k)
            for r0, r1 in segs:
                lon_exc = lon_exc + torch.sum(
                    (torch.abs(dlon[:, r0:r1]) > Si).to(torch.float32))
        _, _, raw = self._window_lat(phi_t, k, Sj)
        lat_exc = torch.sum(((raw < -Sj) | (raw > Sj)).to(torch.float32))
        exc = torch.stack([lon_exc, lat_exc])
        if self.bands is not None:
            self.bands.sum_(exc)
        npts = float(K * self.nlat * nlon)
        return {"lon": exc[0] / npts, "lat": exc[1] / npts}

    def _interp_gather(self, fields, lam_t, phi_t, cubic=True):
        """Gather-tap evaluation: per tap one gather of every field at
        once; the taps are summed dj-major with the per-tap weight
        wlat_dj * wlon_di, in the JAX package's order."""
        k = 4 if cubic else 2
        F = fields.shape[0]
        K = lam_t.shape[0]
        lam_f = lam_t.reshape(K, -1)
        phi_f = phi_t.reshape(K, -1)
        P = lam_f.shape[1]
        nlon = self.nlon

        xi = lam_f / self.dlon
        i1f = torch.floor(xi)
        t = xi - i1f                                      # in [0, 1)
        i1 = i1f.to(torch.int64)
        di0 = -1 if cubic else 0
        j0 = self._lat_taps(phi_f, k)                     # [K, P]
        nodes = [self.phi_ext[j0 + l] for l in range(k)]
        # weight point clamped to the stencil span (a no-op unless j0
        # saturated at the extended grid's edge)
        phi_c = torch.clamp(phi_f, nodes[k - 1], nodes[0])
        wlat = self._lagrange(phi_c, nodes)
        wlon = self._lon_weights(t, cubic)
        cols = [torch.remainder(i1 + di0 + di, nlon) for di in range(k)]

        ext = self.extend(fields).reshape(F, K, -1)       # [F, K, Jext*nlon]
        acc = torch.zeros((F, K, P), dtype=fields.dtype,
                          device=fields.device)
        for dj in range(k):
            row = (j0 + dj) * nlon
            for di in range(k):
                idx = (row + cols[di])[None].expand(F, K, P)
                vals = torch.gather(ext, 2, idx)
                acc = acc + vals * (wlat[dj] * wlon[di])
        return acc.reshape((F,) + tuple(lam_t.shape))

    # ---- trajectories ---------------------------------------------------

    @staticmethod
    def _angles(rv):
        """Unit vectors [3, ...] -> (lam in [0, 2 pi), phi)."""
        phi = torch.arcsin(torch.clamp(rv[2], -1.0, 1.0))
        lam = torch.atan2(rv[1], rv[0])
        lam = torch.where(lam < 0.0, lam + 2.0 * np.pi, lam)
        return lam, phi

    def trajectories(self, u, v, half_tau, radius, iters=2):
        """Great-circle departure/midpoint angles from winds at time t.

        u, v: [K, nlat, nlon] (the whole grid). Returns (lam_d, phi_d),
        (lam_m, phi_m), each [K, rows, nlon] at the arrival rows. Midpoint
        iteration (McDonald 1986): r_m <- normalize(r_a - (tau/2)
        V(r_m)/a); the departure point is the arrival point reflected
        through the midpoint."""
        K = u.shape[0]
        e = self.e[:, None]
        n = self.n[:, None]
        r_a = self.arrival(self.r)[:, None].expand(3, K, self.nb, self.nlon)
        V3 = u[None] * e + v[None] * n                    # [3, K, ...]
        s = half_tau / radius
        r_m = r_a - s * self.arrival(V3)
        r_m = r_m / torch.linalg.norm(r_m, dim=0, keepdim=True)
        for _ in range(max(iters - 1, 0)):
            lam_m, phi_m = self._angles(r_m)
            Vm = self.interp(V3, lam_m, phi_m, cubic=False)
            # keep the interpolated wind tangent at the midpoint
            Vm = Vm - torch.sum(Vm * r_m, dim=0, keepdim=True) * r_m
            r_m = r_a - s * Vm
            r_m = r_m / torch.linalg.norm(r_m, dim=0, keepdim=True)
        lam_m, phi_m = self._angles(r_m)
        dot = torch.sum(r_a * r_m, dim=0, keepdim=True)
        r_d = 2.0 * dot * r_m - r_a
        lam_d, phi_d = self._angles(r_d)
        return (lam_d, phi_d), (lam_m, phi_m)


def _coriolis_inverse(W, r3, a):
    """Solve V + a (r x V) = W for tangent V (W tangent): the implicit
    arrival half of the trapezoidal Coriolis treatment."""
    return (W - a * _cross(r3, W)) / (1.0 + a * a)


def sl_trajectories(sht, vc, slg: SLGrid, now, tau):
    """Trajectory angles from the arrival-time winds: the 3-D great-circle
    departure/midpoint pairs and the 2-D pair of the mass-weighted mean
    wind (continuity: d(lnps)/dt following ubar = -sum_k dpt_k D_k)."""
    h = tau / 2.0
    a = sht.radius
    u, v = sht.uv_from_vort_div(now.vort, now.div)
    wbar = vc.dB if vc.hybrid else vc.ds
    (lam_d, phi_d), (lam_m, phi_m) = slg.trajectories(u, v, h, a)
    ubar = torch.einsum("k,kij->ij", wbar, u)[None]
    vbar = torch.einsum("k,kij->ij", wbar, v)[None]
    (lam_d2, phi_d2), (lam_m2, phi_m2) = slg.trajectories(ubar, vbar, h, a)
    return {"angd": (lam_d, phi_d, lam_d2, phi_d2),
            "angm": (lam_m, phi_m, lam_m2, phi_m2)}


def sl_dep_stack(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
                 coriolis="midpoint"):
    """The departure-time combined-field stack X- + h (L X)- (no
    trajectories, no interpolation, no midpoint terms)."""
    L = vc.nlev
    h = tau / 2.0
    hd = (1.0 - decenter) * h          # explicit / departure half
    gp = dycore.to_grid(sht, vc, prev, diag=False)
    # gamma = G T + R Tref pi (the implicitly treated geopotential head)
    gamma_p = dycore._lev(vc.G, prev.T) + c.rd * vc.tref * prev.lnps[None]
    dgx_p, dgy_p = sht.grad(gamma_p)
    WD_p = sht.synthesize(dycore._lev(vc.W, prev.div))
    bD_p = sht.synthesize(_einsum_lev(vc.b, prev.div))
    e3, n3 = slg.e[:, None], slg.n[:, None]
    r3 = slg.r[:, None]
    # Coriolis parameter as a grid field (traditional approximation)
    fcor = 2.0 * c.omega * slg.r[2][None]                # [1, nlat, nlon]
    V3_p = gp.u[None] * e3 + gp.v[None] * n3             # [3, L, ...]
    grad_gamma_p3 = dgx_p[None] * e3 + dgy_p[None] * n3
    if coriolis == "trapezoid":
        # half the rotation at the departure point, half implicitly at
        # arrival (_coriolis_inverse)
        V3_comb = (V3_p - h * fcor[None] * _cross(r3, V3_p)
                   - hd * grad_gamma_p3)
    else:
        # "midpoint": Coriolis joins the explicit terms at the midpoint
        V3_comb = V3_p - hd * grad_gamma_p3
    T_comb = gp.T + hd * WD_p
    pi_comb = gp.lnps[None] - hd * bD_p[None]            # [1, nlat, nlon]
    dep_fields = torch.cat([
        V3_comb,
        torch.stack([T_comb, gp.q, gp.ql, gp.qi, gp.a]).reshape(
            5, L, slg.nlat, slg.nlon)], dim=0)           # [8, L, nlat, nlon]
    return {"dep": dep_fields, "pi_comb": pi_comb}


def sl_mid_grid(sht, vc, slg: SLGrid, now):
    """Grid half of the midpoint prep: arrival-time grid fields, surface
    pressure gradients, vertical velocity and the geopotential spectrum."""
    g = dycore.to_grid(sht, vc, now)
    dpx, dpy = sht.grad(now.lnps)
    hc = dycore._hybrid_coeffs_grid(vc, g.lnps)
    vgrad = g.u * dpx[None] + g.v * dpy[None]
    if hc is None:
        ds = vc.ds[:, None, None]
        Ct = (g.div + vgrad) * ds
        dpt, dpt_full, Bh, wp = None, ds, vc.sh, 1.0
    else:
        dpt = dpt_full = hc["dpt"]
        Ct = g.div * dpt + vc.dB[:, None, None] * vgrad
        Bh, wp = vc.B, hc["wp"]
    csum = torch.cumsum(Ct, dim=0)
    total = csum[-1:]
    sdot_int = Bh[1:-1, None, None] * total - csum[:-1]
    zero = torch.zeros_like(sdot_int[:1])
    sdot = torch.cat([zero, sdot_int, zero], dim=0)
    if hc is None:
        phi_spec = dycore._lev(vc.G, now.T)
    else:
        phi_grid = vc.geopotential_full(
            torch.movedim(g.T, 0, -1), lnr=torch.movedim(hc["lnr"], 0, -1),
            alpha=torch.movedim(hc["alpha"], 0, -1))
        phi_spec = sht.analyze(torch.movedim(phi_grid, -1, 0))
    return {"u": g.u, "v": g.v, "T": g.T, "q": g.q, "ql": g.ql,
            "qi": g.qi, "a": g.a, "div": g.div, "omega_p": g.omega_p,
            "sdot": sdot, "dpt": dpt, "dpt_full": dpt_full, "wp": wp,
            "dpx": dpx, "dpy": dpy, "phi_spec": phi_spec}


def sl_mid_terms(sht, vc, slg: SLGrid, now, m, coriolis="midpoint"):
    """N-term half of the midpoint prep: the explicit nonlinear terms
    N(t) from the grid bundle m (sl_mid_grid)."""
    L = vc.nlev
    e3, n3 = slg.e[:, None], slg.n[:, None]
    r3 = slg.r[:, None]
    fcor = 2.0 * c.omega * slg.r[2][None]                # [1, nlat, nlon]
    sdot, dpt, dpt_full, wp = m["sdot"], m["dpt"], m["dpt_full"], m["wp"]
    dpx, dpy = m["dpx"], m["dpy"]

    # momentum: N_V = -vertadv(V) - Rd T wp grad(pi) - grad(Phi)
    #                 + grad(gamma)
    dphx, dphy = sht.grad(m["phi_spec"])
    gamma_n = dycore._lev(vc.G, now.T) + c.rd * vc.tref * now.lnps[None]
    dgx_n, dgy_n = sht.grad(gamma_n)
    Fx = -c.rd * m["T"] * wp * dpx[None] - dphx + dgx_n
    Fy = -c.rd * m["T"] * wp * dpy[None] - dphy + dgy_n
    adv_u = dycore._vert_advect(vc, sdot, m["u"], dpt)
    adv_v = dycore._vert_advect(vc, sdot, m["v"], dpt)
    N_V3 = (-(adv_u[None] * e3 + adv_v[None] * n3)
            + Fx[None] * e3 + Fy[None] * n3)
    if coriolis != "trapezoid":
        # centered-midpoint Coriolis -f r x V(t), interpolated with N
        V3_n = m["u"][None] * e3 + m["v"][None] * n3
        N_V3 = N_V3 - fcor[None] * _cross(r3, V3_n)

    # T: N_T = kappa T omega/p - vertadv(T) - W D
    WD_n = sht.synthesize(dycore._lev(vc.W, now.div))
    N_T = (c.kappa * m["T"] * m["omega_p"]
           - dycore._vert_advect(vc, sdot, m["T"], dpt) - WD_n)
    # lnps: N_pi = -sum_k dpt_k D_k + b.D
    bD_n = sht.synthesize(_einsum_lev(vc.b, now.div))
    N_pi = (-torch.sum(dpt_full * m["div"], dim=0) + bD_n)[None]
    # tracers: only vertical advection is explicit (horizontal transport
    # is the trajectory)
    N_q = -dycore._vert_advect(vc, sdot, m["q"], dpt)
    N_ql = -dycore._vert_advect(vc, sdot, m["ql"], dpt)
    N_qi = -dycore._vert_advect(vc, sdot, m["qi"], dpt)
    N_a = -dycore._vert_advect(vc, sdot, m["a"], dpt)
    mid_fields = torch.cat([
        N_V3,
        torch.stack([N_T, N_q, N_ql, N_qi, N_a]).reshape(
            5, L, slg.nlat, slg.nlon)], dim=0)
    return {"mid": mid_fields, "N_pi": N_pi}


def sl_interp_dep(slg: SLGrid, dep_fields, pi_comb, lam_d, phi_d,
                  lam_d2, phi_d2):
    """Departure-point (cubic) interpolation of the combined fields."""
    dep_vals = slg.interp(dep_fields, lam_d, phi_d, cubic=True)
    # pi is 2-D: fields [F=1, K=1, nlat, nlon], targets [K=1, nlat, nlon]
    pi_dep = slg.interp(pi_comb[None], lam_d2, phi_d2, cubic=True)
    return dep_vals, pi_dep


def sl_arrivals(slg: SLGrid, mid_fields, N_pi, lam_m, phi_m,
                lam_m2, phi_m2, dep_vals, pi_dep, tau,
                coriolis="midpoint"):
    """Midpoint (linear) interpolation + arrival-point combination and
    the Coriolis inverse: the grid half of the finish."""
    h = tau / 2.0
    r = slg.arrival(slg.r)
    e3, n3 = slg.arrival(slg.e)[:, None], slg.arrival(slg.n)[:, None]
    r3 = r[:, None]
    fcor = 2.0 * c.omega * r[2][None]

    def combine(mid_b, dep_b, lam_b, phi_b):
        """Midpoint interpolation + arrival combination of one level
        block (levels are independent)."""
        mid_vals = slg.interp(mid_b, lam_b, phi_b, cubic=False)
        W3 = dep_b[:3] + tau * mid_vals[:3]
        # tangent projection at the arrival point
        W3 = W3 - torch.sum(W3 * r3, dim=0, keepdim=True) * r3
        if coriolis == "trapezoid":
            V3_t = _coriolis_inverse(W3, r3, h * fcor[None])
        else:
            V3_t = W3
        u_t = torch.sum(V3_t * e3, dim=0)
        v_t = torch.sum(V3_t * n3, dim=0)
        arrived = dep_b[3:] + tau * mid_vals[3:]
        return torch.cat([u_t[None], v_t[None], arrived], dim=0)

    kc = slg.k_chunk
    K = lam_m.shape[0]
    if kc and K > kc and K % kc == 0:
        # level-chunked interpolation + combination (split_phases): the
        # full-size midpoint values never exist at once
        out = torch.cat([
            combine(mid_fields[:, i:i + kc], dep_vals[:, i:i + kc],
                    lam_m[i:i + kc], phi_m[i:i + kc])
            for i in range(0, K, kc)], dim=1)
    else:
        out = combine(mid_fields, dep_vals, lam_m, phi_m)
    u_t, v_t, T_t, q_t, ql_t, qi_t, a_t = [out[i] for i in range(7)]
    pi_mid = slg.interp(N_pi[None], lam_m2, phi_m2, cubic=False)
    pi_t = (pi_dep + tau * pi_mid)[0, 0]
    return u_t, v_t, T_t, q_t, ql_t, qi_t, a_t, pi_t


def sl_solve(sht, vc, u_t, v_t, T_t, q_t, ql_t, qi_t, a_t, pi_t, tau,
             decenter=0.1):
    """Spectral analysis of the arrival fields + the off-centered
    semi-implicit solve: the spectral half of the finish."""
    h = tau / 2.0
    ha = (1.0 + decenter) * h          # implicit / arrival half
    vort_new, D_tilde = sht.vort_div_from_uv(u_t, v_t)
    T_tilde = sht.analyze(T_t)
    pi_tilde = sht.analyze(pi_t)
    Minv = vc.implicit_inverse(ha, sht.trunc)
    lam_op = (-sht.laplacian)[..., None]                 # +n(n+1)/a^2
    rhs = D_tilde + ha * lam_op[None] * (
        dycore._lev(vc.G, T_tilde) + c.rd * vc.tref * pi_tilde[None])
    div_new = spharm.card_sums("nlj,jmnc->lmnc", Minv, rhs)
    T_new = T_tilde + ha * dycore._lev(vc.W, div_new)
    pi_new = pi_tilde - ha * _einsum_lev(vc.b, div_new)
    mask = sht.mask[..., None]
    return dycore.SpectralState(
        vort=vort_new * mask, div=div_new * mask, T=T_new * mask,
        lnps=pi_new * mask, q=sht.analyze(q_t), ql=sht.analyze(ql_t),
        qi=sht.analyze(qi_t), a=sht.analyze(a_t))


def sl_finish(sht, vc, slg: SLGrid, mid_fields, N_pi, lam_m, phi_m,
              lam_m2, phi_m2, dep_vals, pi_dep, tau, decenter=0.1,
              coriolis="midpoint"):
    """Midpoint interpolation + arrival combination + semi-implicit
    solve (sl_arrivals then sl_solve)."""
    arr = sl_arrivals(slg, mid_fields, N_pi, lam_m, phi_m, lam_m2, phi_m2,
                      dep_vals, pi_dep, tau, coriolis)
    return sl_solve(sht, vc, *arr, tau, decenter=decenter)


def sl_step(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
            coriolis="midpoint", keep=None, given=None):
    """One 3TL semi-Lagrangian semi-implicit step: prev -> new over tau.

    Replaces dycore.tendencies + semi_implicit_step when
    GCMConfig.advection == "sl": same prognostics, same semi-implicit
    matrices, same hyperdiffusion and Robert filter downstream.

    ``decenter``: first-order off-centering of the semi-implicit gravity
    terms (implicit weight (1+eps) h, explicit (1-eps) h); it damps the
    spurious resonance of a centered 3TL SL-SI scheme.
    ``coriolis``: "midpoint" evaluates -f r x V with the explicit terms,
    centered in time (stable for f tau < 2); "trapezoid" splits the
    rotation into an explicit departure half and an implicit arrival half
    (stable for any f dt, but it damps synoptic eddies).

    The stages (SL_STAGES) run in the JAX package's split order, each
    intermediate dropped as soon as the next stage has consumed it: the
    caching allocator then reuses its memory, in stream order, so no
    stage's working set outlives it. ``keep``: a mapping that receives
    each stage's output under its name. ``given``: another run's stages
    by name; each stage then takes its inputs from given, so that its
    output shows its own difference from that run's."""
    whole = sht.whole
    st = {}

    def put(name, value):
        st[name] = value
        if keep is not None:
            keep[name] = value

    src = st if given is None else given
    put("mg", sl_mid_grid(whole, vc, slg, now))
    put("mid", sl_mid_terms(whole, vc, slg, now, src["mg"], coriolis))
    put("traj", sl_trajectories(whole, vc, slg, now, tau))
    put("stack", sl_dep_stack(whole, vc, slg, now, prev, tau, decenter,
                              coriolis))
    st.pop("mg")
    put("dep", sl_interp_dep(slg, src["stack"]["dep"],
                             src["stack"]["pi_comb"], *src["traj"]["angd"]))
    st.pop("stack")
    put("arr", sl_arrivals(slg, src["mid"]["mid"], src["mid"]["N_pi"],
                           *src["traj"]["angm"], *src["dep"], tau,
                           coriolis))
    st.pop("mid"), st.pop("traj"), st.pop("dep")
    put("new", sl_solve(sht, vc, *src["arr"], tau, decenter=decenter))
    st.pop("arr")
    return st.pop("new")


# the stages of sl_step, in order
SL_STAGES = ("mg", "mid", "traj", "stack", "dep", "arr", "new")
