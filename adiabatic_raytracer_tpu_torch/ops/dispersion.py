"""Dispersion relations: photon/axion Hamiltonians, local frequency, on-shell
normalization and k-parallel projection.

Port of adiabatic_raytracer_tpu/ops/dispersion.py (RayTracer.jl:530-685,
1044-1058).  Momenta are covariant spherical components carrying the energy
scale in eV; `erg` is the conserved energy at infinity.
"""

from __future__ import annotations

import math

import torch

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.models.magnetosphere import b_sph_lower, omega_p_sph
from adiabatic_raytracer_tpu_torch.models.metric import metric_inverse
from adiabatic_raytracer_tpu_torch.ops.geometry import cart_to_sph, celerity_from_cart


def _clamp_r(x_sph, r_ns):
    """r clamped to the stellar surface before the photon dispersion
    (RayTracer.jl:531, 560)."""
    return torch.cat([torch.clamp(x_sph[..., :1], min=r_ns), x_sph[..., 1:]], dim=-1)


def k_par(x_sph, k, t, sc: Scene, mass_ns, b_mass_ns=None):
    """Momentum component parallel to B (K_par, RayTracer.jl:1044-1058)."""
    if b_mass_ns is None:
        b_mass_ns = mass_ns
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass_ns)
    _, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    bmag = torch.sqrt(g_rr * b_low[..., 0] ** 2 + g_thth * b_low[..., 1] ** 2
                      + g_pp * b_low[..., 2] ** 2)
    return (g_rr * k[..., 0] * b_low[..., 0] + g_thth * k[..., 1] * b_low[..., 1]
            + g_pp * k[..., 2] * b_low[..., 2]) / bmag


def ctheta_b_sphere(x_sph, k, t, sc: Scene, mass_ns):
    """cos(angle(k, B)) in the covariant 3-metric (RayTracer.jl:957-971)."""
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, mass_ns)
    _, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    bnorm = torch.sqrt(g_rr * b_low[..., 0] ** 2 + g_thth * b_low[..., 1] ** 2
                       + g_pp * b_low[..., 2] ** 2)
    knorm = torch.sqrt(g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2
                       + g_pp * k[..., 2] ** 2)
    return (g_rr * k[..., 0] * b_low[..., 0] + g_thth * k[..., 1] * b_low[..., 1]
            + g_pp * k[..., 2] * b_low[..., 2]) / (knorm * bnorm)


def hamiltonian_photon(x_sph, k, t, erg, sc: Scene, mass_ns, *, zero_in=False,
                       bndry_lyr=-1.0):
    """Photon Hamiltonian, three dispersion modes (RayTracer.jl:530-556);
    production is the anisotropic Melrose form."""
    x0 = _clamp_r(x_sph, sc.r_ns)
    wp = omega_p_sph(x0, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x0, mass_ns)
    ksqr = (g_tt * erg**2 + g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2
            + g_pp * k[..., 2] ** 2)
    if sc.isotropic:
        return 0.5 * (ksqr + wp**2)
    if not sc.melrose:
        ct = ctheta_b_sphere(x0, k, t, sc, mass_ns)
        e2 = erg**2 / g_rr
        return 0.5 * (ksqr - wp**2 * (1.0 - ct**2) / (wp**2 * ct**2 - e2) * e2)
    kp = k_par(x0, k, t, sc, mass_ns)
    e2 = erg**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2)


def hamiltonian_axion(x_sph, k, erg, mass_ns):
    """Axion Hamiltonian H = 1/2 k.k (RayTracer.jl:632-640)."""
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    return 0.5 * (g_tt * erg**2 + g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2
                  + g_pp * k[..., 2] ** 2)


def omega_function(x_sph, k, t, sc: Scene, mass_ns, *, iso=None, kmag=None,
                   zero_in=False, bndry_lyr=-1.0):
    """Local photon frequency (omega_function, RayTracer.jl:558-589),
    including the reference's /sqrt(2) quirk (RayTracer.jl:584)."""
    if iso is None:
        iso = sc.isotropic
    x0 = _clamp_r(x_sph, sc.r_ns)
    wp = omega_p_sph(x0, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)
    _, g_rr, g_thth, g_pp = metric_inverse(x0, mass_ns)
    if kmag is None:
        ksqr = g_rr * k[..., 0] ** 2 + g_thth * k[..., 1] ** 2 + g_pp * k[..., 2] ** 2
    else:
        ksqr = kmag**2
    if iso:
        return torch.sqrt(ksqr + wp**2)
    kp = k_par(x0, k, t, sc, mass_ns)
    disc = ksqr**2 + 2.0 * ksqr * wp**2 - 4.0 * kp**2 * wp**2 + wp**4
    return torch.sqrt((ksqr + wp**2 + torch.sqrt(disc)) / math.sqrt(2.0))


def k_norm_cart(x_cart, khat_cart, t, erg, sc: Scene, mass_ns, *, is_photon=True,
                ax_fix=False, flat=False):
    """Scale a Cartesian direction onto the dispersion shell
    (k_norm_Cart, RayTracer.jl:643-685); ax_fix=True normalizes a photon
    onto the axion shell."""
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, khat_cart, mass_ns)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    wsq = g_rr * w[..., 0] ** 2 + g_thth * w[..., 1] ** 2 + g_pp * w[..., 2] ** 2
    if (not is_photon) or ax_fix:
        nrm_sq = (-(erg**2) * g_tt - sc.mass_a**2) / wsq
    else:
        wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                         mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr, zero_in=True)
        if sc.isotropic:
            kp = 0.0
        else:
            kp = k_par(x_sph, w, t, sc, mass_ns, b_mass_ns=0.0 if flat else mass_ns)
        nrm_sq = (-(erg**2) * g_tt - wp**2) / (wsq - wp**2 / (-(erg**2) * g_tt) * kp**2)
    return torch.sqrt(nrm_sq)[..., None] * khat_cart


def k_sphere(x_cart, k_cart, mass_ns, flat=False):
    """Cartesian momentum -> covariant celerity (k_sphere,
    RayTracer.jl:983-1008); no 1/erg normalization."""
    return celerity_from_cart(x_cart, k_cart, 0.0 if flat else mass_ns)
