"""Variability nudge: align LES condensate with the GCM's cloud profile.

Port of ``sp_coupler_tpu/coupling/nudge.py`` (the reference's
variability_nudge, spcpl.py:613-744, enabled by --qt_forcing variance) for
a whole fleet at once: per instance and level, a factor beta scales the qt
fluctuations so that the implied mean condensate matches the GCM's ql_ref;
where the fluctuations are too weak (beta would pass BETA_MAX) zero-mean
Gaussian noise is added instead; optionally THL compensates to keep T.
Both root-finds are fixed-iteration bisections over every level of every
instance, as in the JAX package.

The noise R is one standard-normal horizontal field per instance, shared
by its levels. The caller draws it (from a torch.Generator: the JAX
package draws from jax.random keys, so the draws differ) or passes the
JAX package's draw.

On spatial blocks (``plane``, a ``parallel.plane.Plane``) the fields and
R are this rank's block of the planes: every plane mean, each step of the
root searches among them, is the plane's (an all_reduce over its ranks),
the most saturated cell is the whole plane's, and the standard deviation
is taken in two passes over the plane mean.
"""

from typing import NamedTuple

import torch

from sp_coupler_tpu_torch import constants as c
from ..parallel.plane import reducer
from ..utils import thermo

BETA_MAX = 5.0
N_BISECT = 40  # |interval| / 2^40 -> float32-exact roots


class NudgeResult(NamedTuple):
    qt: torch.Tensor        # [n, nz, ny, nx] adjusted total water
    thl: torch.Tensor       # [n, nz, ny, nx] adjusted (only if constant_T)
    beta: torch.Tensor      # [n, nz]
    alpha: torch.Tensor     # [n, nz] log(beta)/dt
    qt_std: torch.Tensor    # [n, nz]


def _bisect(f, lo, hi, n=N_BISECT):
    """Bisection for f monotone increasing, elementwise over lo/hi; where
    f has no sign change in [lo, hi] the result clamps to an endpoint."""
    a, b = lo, hi
    for _ in range(n):
        m = 0.5 * (a + b)
        neg = f(m) < 0
        a, b = torch.where(neg, m, a), torch.where(neg, b, m)
    return 0.5 * (a + b)


def variability_nudge(qt, thl, qsat, ql_ref, p, dt, R=None, generator=None,
                      constant_T=False, ql_significant=1e-9, plane=None):
    """qt/thl/qsat: [n, nz, ny, nx]; ql_ref/p: [n, nz]. R: the noise
    [n, ny, nx], or None to draw it from ``generator`` (on the
    generator's device, then moved to qt's). plane: the fields and R are
    this rank's block of the planes, or None.

    Level cases (spcpl.py:658-729):
    1. ql_ref significant -> bisect beta in [0, BETA_MAX] so that
       mean(max(beta (qt - qt_mean) + qt_mean - qsat, 0)) = ql_ref;
    2. GCM clear but LES cloudy -> scale to barely unsaturated at the most
       saturated cell; beta < 0 -> 1;
    3. neither -> beta = 1.
    Where case 1 hits BETA_MAX, add a R instead (a from a second
    bisection) and set beta = 1.
    """
    n, nz, ny, nx = qt.shape
    if R is None:
        R = torch.randn((n, ny, nx), generator=generator,
                        device=generator.device, dtype=qt.dtype).to(qt.device)
    red = reducer(plane)
    R = (R - red.mean(R, keepdim=True))[:, None]
    lev = lambda x: x[..., None, None]
    mean = red.mean
    qt_mean = mean(qt)                                          # [n, nz]
    ql_mean = mean(torch.clamp_min(qt - qsat, 0.0))
    dqt = qt - lev(qt_mean)

    def ql_of_beta(beta):
        return mean(torch.clamp_min(lev(beta) * dqt + lev(qt_mean) - qsat,
                                    0.0))

    def ql_of_a(a):
        return mean(torch.clamp_min(qt + lev(a) * R - qsat, 0.0))

    zeros = torch.zeros_like(qt_mean)
    f_mult = lambda b: ql_of_beta(b) - ql_ref
    bracketed = (f_mult(zeros) <= 0.0) & (f_mult(zeros + BETA_MAX) >= 0.0)
    beta_root = _bisect(f_mult, zeros, zeros + BETA_MAX)
    beta1 = torch.where(bracketed, beta_root, BETA_MAX)

    qt_max, qs_at_max = red.argmax_take(qt - qsat, qt, qsat)
    denom = qt_max - qt_mean
    beta2 = (qs_at_max - qt_mean) / torch.where(torch.abs(denom) > 1e-12,
                                                denom, 1e-12)
    beta2 = torch.where(beta2 < 0, 1.0, beta2)

    significant = ql_ref > ql_significant
    les_cloudier = ql_mean > ql_ref
    beta = torch.where(significant, beta1,
                       torch.where(les_cloudier, beta2, 1.0))

    need_additive = significant & (beta >= BETA_MAX)
    f_add = lambda a: ql_of_a(a) - ql_ref
    a_root = _bisect(f_add, zeros, zeros + BETA_MAX)
    a_amp = torch.where(need_additive & (ql_ref > ql_mean), a_root, 0.0)
    beta = torch.where(need_additive, 1.0, beta)

    qt_new = qt + (lev(beta - 1.0) * dqt + lev(a_amp) * R)
    if constant_T:
        dQL = (torch.clamp_min(qt_new - qsat, 0.0)
               - torch.clamp_min(qt - qsat, 0.0))
        thl_new = thl - c.rlv / lev(c.cp * thermo.exner(p)) * dQL
    else:
        thl_new = thl
    alpha = torch.log(torch.clamp_min(beta, 1e-6)) / dt
    qt_std = red.std(qt_new)
    return NudgeResult(qt=qt_new, thl=thl_new, beta=beta, alpha=alpha,
                       qt_std=qt_std)
