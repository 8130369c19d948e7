"""Moist-thermodynamic helper functions on torch tensors.

Port of ``sp_coupler_tpu/utils/thermo.py``: Exner functions, virtual
temperature, liquid-water potential temperature and the saturation
quantities used by the LES saturation adjustment.
"""

import torch

from sp_coupler_tpu_torch import constants as c


def rms(a):
    """Root mean square."""
    return torch.sqrt(torch.mean(torch.square(a)))


def exner(p):
    """Exner function (p/p0)^(Rd/cp)."""
    return (p / c.pref0) ** (c.rd / c.cp)


def iexner(p):
    """Inverse Exner function."""
    return (p / c.pref0) ** (-c.rd / c.cp)


def virtual_temperature(T, qv, qcond):
    """Tv = T (1 + 0.61 qv - qcond); qcond = ql + qi."""
    return T * (1.0 + c.eps_i * qv - qcond)


def thl_from_T(T, p, qcond):
    """Liquid-water potential temperature (T - Lv qcond/cp) / exner(p)."""
    return (T - c.rlv * qcond / c.cp) * iexner(p)


def T_from_thl(thl, p, ql):
    """Real temperature from thl on known pressure."""
    return thl * exner(p) + c.rlv * ql / c.cp


def esat_liq(T):
    """Saturation vapor pressure over liquid water (Tetens)."""
    return c.es0 * torch.exp(c.at_liq * (T - c.tmelt) / (T - c.bt_liq))


def esat_ice(T):
    """Saturation vapor pressure over ice (Tetens/Murray)."""
    return c.es0 * torch.exp(c.at_ice * (T - c.tmelt) / (T - c.bt_ice))


def _qsat(es, p):
    es = torch.minimum(es, 0.9 * p)  # guard very low pressure columns
    return (c.rd / c.rv) * es / (p - (1.0 - c.rd / c.rv) * es)


def qsat_liq(T, p):
    """Saturation specific humidity over liquid water."""
    return _qsat(esat_liq(T), p)


def qsat_ice(T, p):
    return _qsat(esat_ice(T), p)


def ice_fraction(T):
    """1 below 250 K, 0 above the triple point, linear ramp between."""
    t_all_ice = 250.0
    return torch.clamp((c.tmelt - T) / (c.tmelt - t_all_ice), 0.0, 1.0)


def sat_adjust(thl, qt, p, n_iter=3):
    """All-or-nothing saturation adjustment: (thl, qt, p) -> (T, ql, qsat).

    Fixed-point iteration with the dqsat/dT correction, as in the JAX
    package (``step.thermodynamics`` calls it with ``n_iter=2``).
    """
    ex = exner(p)
    T = thl * ex
    ql = torch.zeros_like(qt)
    for _ in range(n_iter):
        qs = qsat_liq(T, p)
        dqsdt = qs * c.rlv / (c.rv * T * T)
        ql = torch.clamp_min((qt - qs + dqsdt * (T - thl * ex))
                             / (1.0 + c.rlv / c.cp * dqsdt), 0.0)
        T = thl * ex + c.rlv * ql / c.cp
    qs = qsat_liq(T, p)
    return T, ql, qs
