"""Schwarzschild metric (inverse components) and Christoffel symbols.

Port of adiabatic_raytracer_tpu/models/metric.py (RayTracer.jl:455-527):
signature (-,+,+,+), contravariant diagonal components in spherical
coordinates, interior continuation for r <= r_NS.  Points are (..., 3)
tensors; every function broadcasts over the leading axes and is safe under
torch.func transforms.

The reference evaluates sin/cos through utils/precise.py, a Cody-Waite f32
workaround for the TPU's low-precision transcendentals.  The port uses
torch's libm (correctly rounded to an ulp or two in f32 and f64 alike), so
f64 values differ from the JAX package only by libm rounding.
"""

from __future__ import annotations

import torch

from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW


def schwarzschild_radius(mass_ns):
    """r_s = 2 G M / c^2 [km] (RayTracer.jl:194)."""
    return 2.0 * G_NEW * mass_ns / C_KM**2


def metric_inverse(x_sph, mass_ns, r_ns=10.0):
    """(g^tt, g^rr, g^thth, g^pp) at spherical points (g_schwartz,
    RayTracer.jl:455-501), including the reference's interior quirk: r_s is
    scaled by (r/r_NS)^3 before the interior lapse formula uses it."""
    r = x_sph[..., 0]
    sin_theta = torch.sin(x_sph[..., 1])
    rs0 = schwarzschild_radius(mass_ns)
    inside = r <= r_ns
    rs = torch.where(inside, rs0 * (r / r_ns) ** 3, rs0 + 0.0 * r)

    one_m = 1.0 - rs / r
    g_tt = -1.0 / one_m
    g_rr = one_m
    g_thth = 1.0 / r**2
    g_pp = 1.0 / (r * sin_theta) ** 2

    # guard the untaken interior branch (its sqrt args go negative far
    # outside the star and would poison gradients through the where)
    arg1 = torch.where(inside, 1.0 - rs / r_ns, torch.ones_like(r))
    arg2 = torch.where(inside, 1.0 - r**2 * rs / r_ns**3, torch.ones_like(r))
    g_tt_in = -4.0 / (3.0 * torch.sqrt(arg1) - torch.sqrt(arg2)) ** 2

    g_tt = torch.where(inside, g_tt_in, g_tt)
    g_rr = torch.where(inside, arg2, g_rr)
    return g_tt, g_rr, g_thth, g_pp


def lapse_A(r, mass_ns):
    """A = 1 - r_s/r (RayTracer.jl:209)."""
    return 1.0 - schwarzschild_radius(mass_ns) / r


def christoffel(x_sph, mass_ns):
    """The ten Christoffel combinations used by conversion_prob
    (Cristoffel, RayTracer.jl:503-527); GM from the full mass as given."""
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    gm = G_NEW * mass_ns / C_KM**2
    s, c = torch.sin(theta), torch.cos(theta)
    g_rrr = -gm / (r * (r - 2.0 * gm))
    g_rtt = -(r - 2.0 * gm)
    g_rpp = -(r - 2.0 * gm) * s**2
    g_trt = 1.0 / r
    g_tpp = -s * c
    g_prp = 1.0 / r
    g_ptp = c / s
    g_ttr = 1.0 / r
    g_ppr = 1.0 / r
    g_ppt = c / s
    return g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr, g_ppt
