"""Single-moment bulk "simpleice" microphysics (mixed-phase precipitation).

Port of ``sp_coupler_tpu/models/les/micro.py``: KK2000 warm rain for the
liquid part, a threshold/timescale snow source for the ice part, and
phase-blended power-law fall speeds. Fields are [n, nz, ny, nx].
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c
from ...parallel.plane import reducer
from ...utils import thermo


class MicroParams(NamedTuple):
    nc0: float = 200.0e6     # cloud droplet number (1/m^3)
    auto_k: float = 1350.0   # KK2000 autoconversion prefactor
    accr_k: float = 67.0     # KK2000 accretion prefactor
    evap_tau: float = 60.0   # rain evaporation timescale (s)
    sed_a: float = 14.34     # rain fall speed prefactor
    sed_b: float = 0.1346    # rain fall speed exponent
    ice_tau: float = 600.0   # ice -> snow autoconversion timescale (s)
    ice_qi0: float = 1.0e-5  # ice autoconversion threshold (kg/kg)
    sed_ai: float = 3.29     # snow fall speed prefactor
    sed_bi: float = 0.16     # snow fall speed exponent


def rain_tendencies(grid, params, rhobf, T, p, qv, ql, qr, dt, red=None):
    """(dqt/dt, dqr/dt, dthl/dt, surface_rain_flux [n]).

    ``dt`` is the substep length, [n, 1, 1, 1] or a scalar; ``p`` and
    ``rhobf`` broadcast against the fields. ``red``: the plane's
    reductions (``parallel.plane``) for the surface mean; None: the whole
    plane in these tensors.
    """
    nc_cm3 = params.nc0 * 1e-6
    fi = thermo.ice_fraction(T)
    ql_w = torch.clamp_min(ql, 0.0) * (1.0 - fi)
    ql_i = torch.clamp_min(ql, 0.0) * fi
    auto = (params.auto_k * ql_w ** 2.47 * nc_cm3 ** (-1.79)
            + torch.clamp_min(ql_i - params.ice_qi0, 0.0) / params.ice_tau)
    accr = params.accr_k * (torch.clamp_min(ql, 0.0)
                            * torch.clamp_min(qr, 0.0)) ** 1.15
    to_rain = torch.minimum(auto + accr, torch.clamp_min(ql, 0.0) / dt)
    qs = thermo.qsat_liq(T, p)
    subsat = torch.clamp((qs - qv) / torch.clamp_min(qs, 1e-8), 0.0, 1.0)
    evap = torch.minimum(subsat * qr / params.evap_tau,
                         torch.clamp_min(qr, 0.0) / dt)
    lheat = (1.0 - fi) * c.rlv + fi * c.rls
    dqr = to_rain - evap
    dqt = -to_rain + evap
    dthl = -lheat / c.cp * thermo.iexner(p) * evap
    rho = rhobf[:, :, None, None]
    rq = torch.clamp_min(rho * qr, 0.0)
    vt = ((1.0 - fi) * params.sed_a * rq ** params.sed_b
          + fi * params.sed_ai * rq ** params.sed_bi)
    flux = rho * vt * torch.clamp_min(qr, 0.0)
    flux_above = torch.cat([flux[:, 1:], torch.zeros_like(flux[:, :1])],
                           dim=1)
    dqr_sed = (flux_above - flux) / (rho * grid.dz)
    dqr_total = torch.maximum(dqr + dqr_sed, -torch.clamp_min(qr, 0.0) / dt)
    surf_flux = reducer(red).mean(flux[:, 0])
    return dqt, dqr_total, dthl, surf_flux


def ice_split(T, ql):
    """Diagnostic (ql_water, ql_ice) partition by temperature."""
    fi = thermo.ice_fraction(T)
    return ql * (1.0 - fi), ql * fi
