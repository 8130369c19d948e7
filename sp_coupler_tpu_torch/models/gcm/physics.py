"""GCM physics: radiation, surface fluxes + vertical diffusion, cloud scheme.

Port of ``sp_coupler_tpu/models/gcm/physics.py``. All functions operate on
grid fields [L, nlat, nlon], top level first.
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c
from ...utils import thermo


class PhysicsParams(NamedTuple):
    tau_rad: float = 20.0 * 86400.0
    tau_rad_sfc: float = 4.0 * 86400.0
    t_strat: float = 200.0
    t_eq_sfc: float = 300.0
    dT_eq_pole: float = 60.0
    dtheta_z: float = 25.0
    sst: float = 300.0
    dsst_pole: float = 27.0
    z0m: float = 1.6e-4
    z0h: float = 3.2e-5
    cd_max: float = 2.5e-3
    k_vdiff: float = 15.0
    pbl_top_sigma: float = 0.75
    rh_crit: float = 0.85
    tau_cond: float = 900.0
    tau_cld: float = 3.0 * 3600.0
    rayleigh_tau: float = 0.0


def equilibrium_temperature(p, lat_rad, prm: PhysicsParams):
    """Held-Suarez-style radiative-equilibrium temperature."""
    sin2 = torch.sin(lat_rad) ** 2
    cos2 = 1.0 - sin2
    pr = p / c.pref0
    Teq = (prm.t_eq_sfc - prm.dT_eq_pole * sin2
           - prm.dtheta_z * torch.log(torch.clamp_min(pr, 1e-6)) * cos2) \
        * pr ** c.kappa
    return torch.clamp_min(Teq, prm.t_strat)


def radiation(T, p, lat_rad, sigma_full, prm: PhysicsParams):
    """Newtonian cooling tendency dT/dt [L, nlat, nlon]."""
    Teq = equilibrium_temperature(p, lat_rad, prm)
    sig = sigma_full[:, None, None]
    kt = (1.0 / prm.tau_rad
          + (1.0 / prm.tau_rad_sfc - 1.0 / prm.tau_rad)
          * torch.clamp_min((sig - 0.7) / 0.3, 0.0)
          * torch.cos(lat_rad) ** 4)
    return -kt * (T - Teq)


def sst_field(lat_rad, prm: PhysicsParams):
    return prm.sst - prm.dsst_pole * torch.sin(lat_rad) ** 2


def surface_fluxes(u1, v1, T1, q1, p_sfc, z1, lat_rad, prm: PhysicsParams):
    """Bulk ocean surface fluxes (OpenIFS sign convention: positive down)
    plus the raw upward kinematic fluxes used by vertical diffusion."""
    sst = sst_field(lat_rad, prm)
    rho = p_sfc / (c.rd * T1)
    U1 = torch.sqrt(u1 ** 2 + v1 ** 2 + 0.25)
    cd = torch.clamp_max((0.4 / torch.log(z1 / prm.z0m)) ** 2, prm.cd_max)
    ch = torch.clamp_max((0.4 / torch.log(z1 / prm.z0h)) ** 2, prm.cd_max)
    th1 = T1 * thermo.iexner(p_sfc)
    wth = ch * U1 * (sst * thermo.iexner(p_sfc) - th1)
    qs_sst = thermo.qsat_liq(sst, p_sfc)
    wq = torch.clamp_min(ch * U1 * (qs_sst - q1), 0.0)
    tau_u = -cd * U1 * u1
    tau_v = -cd * U1 * v1
    return {
        "wth": wth, "wq": wq, "tau_u": tau_u, "tau_v": tau_v, "rho": rho,
        "TSflux": -rho * c.cp * wth * thermo.exner(p_sfc),
        "TLflux": -rho * c.rlv * wq,
        "SHflux": -rho * wq,
        "QLflux": torch.zeros_like(wq),
        "QIflux": torch.zeros_like(wq),
        "Z0M": torch.full_like(wq, prm.z0m),
        "Z0H": torch.full_like(wq, prm.z0h),
    }


def vertical_diffusion(vc, u, v, T, q, sfc, dz_levels, prm: PhysicsParams,
                       vdiff_mask):
    """K-diffusion in the boundary layer + surface flux injection; zero in
    columns where ``vdiff_mask`` [nlat, nlon] is 0 (SP columns with vdiff
    switched off). Returns tendencies (du, dv, dT, dq)."""
    sig = vc.sf[:, None, None]
    K = prm.k_vdiff * torch.clamp((sig - prm.pbl_top_sigma)
                                  / (1.0 - prm.pbl_top_sigma), 0.0, 1.0)
    dz = dz_levels

    def diff(X, sflux):
        Kh = 0.5 * (K[1:] + K[:-1])
        dzh = 0.5 * (dz[1:] + dz[:-1])
        F_int = -Kh * (X[:-1] - X[1:]) / dzh
        zero = torch.zeros_like(F_int[:1])
        F = torch.cat([zero, F_int, sflux[None]], dim=0)
        return (F[1:] - F[:-1]) / dz

    du = diff(u, sfc["tau_u"]) * vdiff_mask
    dv = diff(v, sfc["tau_v"]) * vdiff_mask
    dT = diff(T, sfc["wth"]) * vdiff_mask
    dq = diff(q, sfc["wq"]) * vdiff_mask
    return du, dv, dT, dq


def cloud_scheme(T, q, ql, qi, a, p, dt, prm: PhysicsParams):
    """Large-scale condensation + Sundqvist cloud fraction."""
    qs = thermo.qsat_liq(T, p)
    dqsdT = qs * c.rlv / (c.rv * T ** 2)
    excess = (q - qs) / (1.0 + (c.rlv / c.cp) * dqsdT)
    zero = torch.zeros_like(excess)
    cond = torch.where(excess > 0,
                       excess * min(1.0, dt / prm.tau_cond), zero)
    evap = torch.where(excess < 0,
                       torch.minimum(ql + qi, -excess * min(
                           1.0, dt / prm.tau_cond)), zero)
    dcond = cond - evap
    fi = thermo.ice_fraction(T)
    ql_new = torch.clamp_min(ql + dcond * (1.0 - fi), 0.0)
    qi_new = torch.clamp_min(qi + dcond * fi, 0.0)
    q_new = torch.clamp_min(q - dcond, 0.0)
    T_new = T + (c.rlv / c.cp) * dcond
    rh = torch.clamp(q_new / thermo.qsat_liq(T_new, p), 0.0, 1.0)
    a_diag = 1.0 - torch.sqrt(torch.clamp((1.0 - rh) / (1.0 - prm.rh_crit),
                                          0.0, 1.0))
    has_cond = (ql_new + qi_new) > 1e-7
    a_diag = torch.where(has_cond, torch.clamp_min(a_diag, 0.1), a_diag)
    w = min(1.0, dt / prm.tau_cld)
    a_new = torch.clamp(a + w * (a_diag - a), 0.0, 1.0)
    sink = min(1.0, dt / (4.0 * prm.tau_cond)) * torch.clamp_min(
        ql_new + qi_new - 1e-3, 0.0)
    frac = sink / torch.clamp_min(ql_new + qi_new, 1e-12)
    ql_new = ql_new * (1.0 - frac)
    qi_new = qi_new * (1.0 - frac)
    return T_new, q_new, ql_new, qi_new, a_new
