"""Coupling conversions: GCM columns <-> LES forcings/tendencies.

Port of ``convert_profiles``, ``convert_surface_fluxes``, ``les_forcings``
and ``gcm_tendencies`` from ``sp_coupler_tpu/coupling/convert.py``. Every
function takes the SP columns as a leading batch axis ([n, L] profiles,
top level first; [n] surface values).
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c
from ..utils import thermo, interp


class ConvertedProfiles(NamedTuple):
    """GCM column state converted to the LES grid + diagnostics."""

    u: torch.Tensor       # [n, nz_les]
    v: torch.Tensor
    thl: torch.Tensor
    qt: torch.Tensor
    ql: torch.Tensor
    ps: torch.Tensor      # [n]
    Zf: torch.Tensor      # [n, L] GCM full-level heights (m), descending
    Zh: torch.Tensor      # [n, L+1] GCM half-level heights, descending to 0
    Tv: torch.Tensor      # [n, L]
    THL: torch.Tensor     # [n, L] thl on GCM levels
    QT: torch.Tensor      # [n, L] qt on GCM levels


def convert_profiles(prof, zf_les, heights=None):
    """GCM profile dict ([n, L] arrays) -> ConvertedProfiles. heights:
    (Zf, Zh) above the surface where the GCM gives them itself (a
    replayed one, ``ReplayGCM.get_heights``), else from the geopotential
    (Zgfull, Zghalf)."""
    U, V, T = prof["U"], prof["V"], prof["T"]
    SH, QL, QI = prof["SH"], prof["QL"], prof["QI"]
    Pf, Ph = prof["Pfull"], prof["Phalf"]

    Tv = thermo.virtual_temperature(T, SH, QL + QI)
    if heights is None:
        Zgf, Zgh = prof["Zgfull"], prof["Zghalf"]
        Zh = (Zgh - Zgh[..., -1:]) / c.grav
        Zf = (Zgf - Zgh[..., -1:]) / c.grav
    else:
        Zf, Zh = heights
    thl_ = thermo.thl_from_T(T, Pf, QL + QI)
    qt_ = SH + QL + QI

    itp = lambda fp: interp.interp_desc(zf_les, Zf, fp)
    return ConvertedProfiles(
        u=itp(U), v=itp(V), thl=itp(thl_), qt=itp(qt_), ql=itp(QL),
        ps=Ph[..., -1], Zf=Zf, Zh=Zh, Tv=Tv, THL=thl_, QT=qt_)


def convert_surface_fluxes(surf, Ph_sfc, T_sfc):
    """OpenIFS surface fields -> (z0m, z0h, wthl, wqt) for the LES.

    surf keys: Z0M, Z0H, QLflux, QIflux, SHflux, TLflux, TSflux ([n]).
    Signs flip: OpenIFS positive down, DALES positive up (spcpl.py
    :153-167). wthl uses the sensible heat flux only (TSflux).
    """
    rho = Ph_sfc / (c.rd * T_sfc)
    wqt = -(surf["QLflux"] + surf["QIflux"] + surf["SHflux"]) / rho
    wthl = -surf["TSflux"] * thermo.iexner(Ph_sfc) / (c.cp * rho)
    return surf["Z0M"], surf["Z0H"], wthl, wqt


def les_forcings(conv: ConvertedProfiles, les_prof, dt_gcm, factor=1.0):
    """Relaxation forcings toward the GCM state (spcpl.py:328-333)."""
    f = lambda target, mean: factor * (target - mean) / dt_gcm
    return {
        "f_u": f(conv.u, les_prof["U"]),
        "f_v": f(conv.v, les_prof["V"]),
        "f_thl": f(conv.thl, les_prof["THL"]),
        "f_qt": f(conv.qt, les_prof["QT"]),
        "f_ql": f(conv.ql, les_prof["QL"]),
        "f_ps": f(conv.ps, les_prof["PS"]),
    }


def gcm_tendencies(prof, conv: ConvertedProfiles, les_prof, A_d,
                   zf_les, zh_les, dt_gcm, factor=1.0, conservative=False):
    """LES slab means -> GCM profile tendencies (spcpl.py:388-542).

    Returns (tend dict for U, V, T, SH, QL, QI, A, diagnostics dict).
    """
    Zf, Zh = conv.Zf, conv.Zh
    h = zf_les
    pf = interp.interp_desc(h, Zf, prof["Pfull"])
    t_from_thl = les_prof["THL"] * thermo.exner(pf) + \
        c.rlv * les_prof["QL"] / c.cp
    t_d = les_prof["T"]
    ql_d = les_prof["QL"]
    ql_ice_d = les_prof["QL_ice"]
    ql_water_d = ql_d - ql_ice_d

    if not conservative:
        remap = lambda x: interp.interp(Zf, h, x)
    else:
        W = interp.conservative_matrix(Zh, zh_les, les_prof["Rhobf"])
        remap = lambda x: torch.matmul(W, x[..., None])[..., 0]

    t_r = remap(t_d)
    qt_r = remap(les_prof["QT"])
    ql_r = remap(ql_d)
    ql_w_r = remap(ql_water_d)
    ql_i_r = remap(ql_ice_d)
    u_r = remap(les_prof["U"])
    v_r = remap(les_prof["V"])

    ft = dt_gcm
    f_T = factor * (t_r - prof["T"]) / ft
    f_SH = factor * ((qt_r - ql_r) - prof["SH"]) / ft
    f_QL = factor * (ql_w_r - prof["QL"]) / ft
    f_QI = factor * (ql_i_r - prof["QI"]) / ft
    f_U = factor * (u_r - prof["U"]) / ft
    f_V = factor * (v_r - prof["V"]) / ft
    f_A = factor * (A_d - prof["A"]) / ft

    inside = (Zf <= h[-1]).to(f_T.dtype)
    tend = {
        "T": f_T * inside, "SH": f_SH * inside, "QL": f_QL * inside,
        "QI": f_QI * inside, "U": f_U * inside, "V": f_V * inside,
        "A": f_A * inside,
    }
    diag = {
        "t": t_from_thl, "t_": t_d, "pf": pf,
        "ql_water": ql_water_d, "ql_ice": ql_ice_d,
    }
    return tend, diag
