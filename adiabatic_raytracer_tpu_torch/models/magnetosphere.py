"""Goldreich-Julian magnetosphere: rotating misaligned dipole B and plasma
frequency.  Port of adiabatic_raytracer_tpu/models/magnetosphere.py
(RayTracer.jl:854-1309); torch libm in place of the reference's Cody-Waite
f32 sin/cos (see models/metric.py).  Points are (..., 3) tensors.
"""

from __future__ import annotations

import math

import torch

from adiabatic_raytracer_tpu_torch.constants import (
    GAUSS_TO_EV2,
    HBAR,
    INV_ALPHA,
    M_E_EV,
    SQRT_4PI_ALPHA,
)
from adiabatic_raytracer_tpu_torch.models.metric import metric_inverse
from adiabatic_raytracer_tpu_torch.ops.geometry import cart_to_sph


def _omega_p_of_bz(bz, omega_pul):
    """Plasma frequency [eV] from n_GJ ~ Omega.B (RayTracer.jl:877-878)."""
    nelec = torch.abs(2.0 * omega_pul * bz) / SQRT_4PI_ALPHA * GAUSS_TO_EV2 * HBAR
    return torch.sqrt(4.0 * math.pi * nelec / INV_ALPHA / M_E_EV)


def dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns):
    """Orthonormal (B_r, B_theta, B_phi) [Gauss] (Dipole_SPH,
    RayTracer.jl:1105-1118)."""
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    phi = x_sph[..., 2]
    psi = phi - omega_pul * t
    bnorm = b0 * (r_ns / r) ** 3 / 2.0
    ct, st = torch.cos(theta), torch.sin(theta)
    cm, sm = math.cos(theta_m), math.sin(theta_m)
    cp, sp = torch.cos(psi), torch.sin(psi)
    br = 2.0 * bnorm * (cm * ct + sm * st * cp)
    btheta = bnorm * (cm * st - sm * ct * cp)
    bphi = bnorm * sm * sp
    return br, btheta, bphi


def bndry_lyr_scalars(mass_a, omega_pul, b0, r_ns):
    """(pole_val, rmax) of the boundary layer: omega_p [eV] at the pole and
    the aligned dipole's conversion radius [km] (RayTracer.jl:1155-1162)."""
    pole_val = float(_omega_p_of_bz(torch.tensor(float(b0), dtype=torch.float64),
                                    omega_pul))
    return pole_val, r_ns * (pole_val / mass_a) ** (2.0 / 3.0)


def _bndry_lyr_term(r, mass_a, bndry_lyr, omega_pul, b0, r_ns):
    """Boundary-layer addition to omega_p for r >= r_NS
    (RayTracer.jl:1155-1162); 0 where disabled or inside the star."""
    pole_val, rmax = bndry_lyr_scalars(mass_a, omega_pul, b0, r_ns)
    term = pole_val * (r_ns / r) ** 1.5 * torch.exp(
        -(r - rmax * bndry_lyr) / (0.1 * rmax))
    on = (bndry_lyr > 0.0) & (r >= r_ns)
    return torch.where(on, term, torch.zeros_like(r))


def omega_p_sph(x_sph, t, theta_m, omega_pul, b0, r_ns, *, mass_a=1e-5,
                bndry_lyr=-1.0, zero_in=True):
    """omega_p [eV] at spherical points (GJ_Model_ωp_vecSPH,
    RayTracer.jl:1120-1170)."""
    r = x_sph[..., 0]
    theta = x_sph[..., 1]
    br, btheta, _ = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    bz = br * torch.cos(theta) - btheta * torch.sin(theta)
    wp = _omega_p_of_bz(bz, omega_pul)
    if float(bndry_lyr) > 0.0:
        wp = wp + _bndry_lyr_term(r, mass_a, bndry_lyr, omega_pul, b0, r_ns)
    if zero_in:
        wp = torch.where(r <= r_ns, torch.zeros_like(wp), wp)
    return wp


def omega_p_cart(x_cart, t, theta_m, omega_pul, b0, r_ns, *, mass_a=1e-5,
                 bndry_lyr=-1.0, zero_in=False):
    """omega_p [eV] at Cartesian points (GJ_Model_ωp_vec,
    RayTracer.jl:1066-1103); the Cartesian evaluator never zeroes the
    interior."""
    return omega_p_sph(cart_to_sph(x_cart), t, theta_m, omega_pul, b0,
                       r_ns, mass_a=mass_a, bndry_lyr=bndry_lyr, zero_in=zero_in)


def b_cart(x_cart, t, theta_m, omega_pul, b0, r_ns):
    """Cartesian B-vector [Gauss] (GJ_Model_vec, RayTracer.jl:854-891)."""
    x_sph = cart_to_sph(x_cart)
    theta = x_sph[..., 1]
    phi = x_sph[..., 2]
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    bx = br * st * cp + btheta * ct * cp - bphi * sp
    by = br * st * sp + btheta * ct * sp + bphi * cp
    bz = br * ct - btheta * st
    return torch.stack([bx, by, bz], dim=-1)


def b_sph_lower(x_sph, t, theta_m, omega_pul, b0, r_ns, mass_ns):
    """Covariant B_i = B_(i) / sqrt(g^ii) [Gauss] (GJ_Model_Sphereical,
    RayTracer.jl:1296-1298)."""
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    _, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns, r_ns=10.0)
    return torch.stack(
        [br / torch.sqrt(g_rr), btheta / torch.sqrt(g_thth),
         bphi / torch.sqrt(g_pp)], dim=-1)


def b_sph_component(x_sph, t, theta_m, omega_pul, b0, r_ns, mass_ns, comp):
    """0 -> |B| * 1.95e-2 [eV^2]; 1..3 -> contravariant B^i * 1.95e-2
    (GJ_Model_Sphereical return_comp, RayTracer.jl:1299-1307)."""
    br, btheta, bphi = dipole_sph(x_sph, t, theta_m, omega_pul, b0, r_ns)
    if comp == 0:
        return torch.sqrt(br**2 + btheta**2 + bphi**2) * GAUSS_TO_EV2
    _, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns, r_ns=10.0)
    if comp == 1:
        return br / torch.sqrt(g_rr) * g_rr * GAUSS_TO_EV2
    if comp == 2:
        return btheta / torch.sqrt(g_thth) * g_thth * GAUSS_TO_EV2
    if comp == 3:
        return bphi / torch.sqrt(g_pp) * g_pp * GAUSS_TO_EV2
    raise ValueError(f"comp must be in 0..3, got {comp}")


def conversion_surface_radius(mass_a, theta_m, omega_pul, b0, r_ns, t_in=0.0):
    """Maximum conversion-surface radius estimate, sizing the sampling disk
    (Find_Conversion_Surface, RayTracer.jl:1250-1263).  Python float."""
    theta_ev = theta_m / 2.0 if theta_m < math.pi / 2.0 else (theta_m + math.pi) / 2.0
    x_eval = r_ns * torch.tensor(
        [math.sin(theta_ev), 0.0, math.cos(theta_ev)], dtype=torch.float64)
    om_test = float(omega_p_cart(x_eval, t_in, theta_m, omega_pul, b0, r_ns))
    return r_ns * (om_test / mass_a) ** (2.0 / 3.0) * 1.01


def cyclotron_freq_cart(x_cart, t, theta_m, omega_pul, b0, r_ns):
    """Electron cyclotron frequency [eV] (cyclotronF_vec, RayTracer.jl:798-802)."""
    b = b_cart(x_cart, t, theta_m, omega_pul, b0, r_ns)
    bmag = torch.sqrt(torch.sum(b * b, dim=-1))
    return bmag * 0.3 / 5.11e5 * (1.95e-20 * 1e18)
