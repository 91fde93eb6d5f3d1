"""Coordinate and momentum transforms: Cartesian <-> spherical, celerity.

Port of adiabatic_raytracer_tpu/ops/geometry.py (RayTracer.jl:196-216,
404-416, 983-1008).  x_sph = [r, theta, phi]; covariant celerity
w = (v_r / sqrt(A), v_th r, v_ph r sin(theta)) / A with A = 1 - r_s/r.
The reference's conversion-surface-angle diagnostics (surf_norm and friends,
RayTracer.jl:895-1063) are dead in its production path; they are here for
analysis, single-point functions whose derivatives come from torch.func
(vmap them over a batch).
"""

from __future__ import annotations

import torch
from torch.func import grad

from adiabatic_raytracer_tpu_torch.models.metric import lapse_A, metric_inverse


# sin^2(theta) below which an f32 point counts as near the rotation axis
# (within ~0.57 degrees): there z / r keeps few digits, and rounds to 1 or
# past it within ~3e-4 rad of the axis.
POLE_ZONE = 1e-4


def _pole_zone(x, r):
    """(z / r, the f32 points near the rotation axis, the cylindrical
    radius) of Cartesian points x (..., 3) of radius r."""
    cz = x[..., 2] / r
    return cz, 1.0 - cz * cz < POLE_ZONE, torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)


def polar_angle(x, r):
    """theta of Cartesian points x (..., 3) of radius r, arccos(z / r) as the
    reference computes it.  In f32 near the rotation axis (1 - (z/r)^2 <
    POLE_ZONE) it is atan2(rho, z) from the cylindrical radius rho, as K1's
    <float> takes sin(theta) there (art::line_sin_theta): the reference's
    f32 form gives 0 or NaN within ~3e-4 rad of the axis (a sampled event
    1.6e-3 km off it at r 11.5 km made a NaN row).  Elsewhere, and in f64,
    bit for bit the reference's form; the arccos branch is fed a safe value
    in the zone, so that derivatives stay finite."""
    if x.dtype != torch.float32:
        return torch.arccos(x[..., 2] / r)
    cz, pole, rho = _pole_zone(x, r)
    return torch.where(pole, torch.atan2(rho, x[..., 2]),
                       torch.arccos(torch.where(pole, torch.zeros_like(cz), cz)))


def sin_polar(x, r):
    """sin(theta) of Cartesian points x (..., 3) of radius r,
    sqrt(1 - (z/r)^2) floored at 1e-15 (as the reference); in f32 in the
    pole zone (polar_angle) rho / r, floored alike."""
    st = torch.sqrt(torch.clamp(1.0 - (x[..., 2] / r) ** 2, min=1e-30))
    if x.dtype != torch.float32:
        return st
    _, pole, rho = _pole_zone(x, r)
    return torch.where(pole, torch.clamp(rho / r, min=1e-15), st)


def cart_to_sph(x):
    """(..., 3) Cartesian -> [r, theta, phi] (theta: polar_angle)."""
    r = torch.sqrt(torch.sum(x * x, dim=-1))
    theta = polar_angle(x, r)
    phi = torch.atan2(x[..., 1], x[..., 0])
    return torch.stack([r, theta, phi], dim=-1)


def sph_to_cart(x_sph):
    r, theta, phi = x_sph[..., 0], x_sph[..., 1], x_sph[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([r * st * torch.cos(phi), r * st * torch.sin(phi), r * ct],
                       dim=-1)


def cart_vel_to_sph(x_cart, v_cart):
    """Cartesian velocity -> (dr/dt, r dth/dt, r sth dph/dt)
    (RayTracer.jl:205-206)."""
    r = torch.sqrt(torch.sum(x_cart * x_cart, dim=-1))
    sin_theta = sin_polar(x_cart, r)
    dr_dt = torch.sum(x_cart * v_cart, dim=-1) / r
    v_th = (x_cart[..., 2] * dr_dt - r * v_cart[..., 2]) / (r * sin_theta)
    v_ph = (-x_cart[..., 1] * v_cart[..., 0] + x_cart[..., 0] * v_cart[..., 1]) / (
        r * sin_theta)
    return torch.stack([dr_dt, v_th, v_ph], dim=-1)


def celerity_from_cart(x_cart, v_cart, mass_ns):
    """Cartesian direction -> covariant celerity w (RayTracer.jl:209-211)."""
    x_sph = cart_to_sph(x_cart)
    r = x_sph[..., 0]
    sin_theta = torch.sin(x_sph[..., 1])
    v_pl = cart_vel_to_sph(x_cart, v_cart)
    a = lapse_A(r, mass_ns)
    w = torch.stack([
        v_pl[..., 0] / torch.sqrt(a),
        v_pl[..., 1] * r,
        v_pl[..., 2] * (r * sin_theta),
    ], dim=-1) / a[..., None]
    return w


def celerity_to_cart_vel(x_sph, w, mass_ns, a=None):
    """Covariant celerity w -> Cartesian proper velocity
    (RayTracer.jl:406-416); `a` overrides the lapse."""
    r, theta, phi = x_sph[..., 0], x_sph[..., 1], x_sph[..., 2]
    if a is None:
        a = lapse_A(r, mass_ns)
    v_r = w[..., 0] * torch.sqrt(a) * a
    v_th = w[..., 1] / r * a
    v_ph = w[..., 2] / (r * torch.sin(theta)) * a
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    v_tmp = st * v_r + ct * v_th
    vx = cp * v_tmp - sp * v_ph
    vy = sp * v_tmp + cp * v_ph
    vz = ct * v_r - st * v_th
    return torch.stack([vx, vy, vz], dim=-1)


def spatial_dot(x_sph, a, b, mass_ns):
    """sum_i g^{ii} a_i b_i (spatial_dot, RayTracer.jl:973-981)."""
    _, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    return (g_rr * a[..., 0] * b[..., 0] + g_thth * a[..., 1] * b[..., 1]
            + g_pp * a[..., 2] * b[..., 2])


def spatial_norm(x_sph, a, mass_ns):
    return torch.sqrt(spatial_dot(x_sph, a, a, mass_ns))


# ---------------------------------------------------------------------------
# Conversion-surface-angle diagnostics (JAX ops/geometry.py:108-187).  Single
# points x_cart, k_cart of shape [3]; torch.func.vmap for batches.
# ---------------------------------------------------------------------------


def _surface_normal_sph(x_sph, t, sc, mass_ns):
    """Covariant, metric-normalized gradient of omega_p: the conversion-surface
    normal (surfNorm inner block, RayTracer.jl:914-916)."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import omega_p_sph

    grd = grad(lambda xp: omega_p_sph(xp, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                                      mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr))(x_sph)
    return grd / spatial_norm(x_sph, grd, mass_ns)


def surf_norm(x_cart, k_cart, t, sc, mass_ns, *, return_vec=False):
    """cos(angle) between the ray momentum and the conversion-surface normal
    grad(omega_p), in the covariant 3-metric (surfNorm, RayTracer.jl:895-933)."""
    x_sph = cart_to_sph(x_cart)
    w = celerity_from_cart(x_cart, k_cart, mass_ns)
    snorm = _surface_normal_sph(x_sph, t, sc, mass_ns)
    ctheta = spatial_dot(x_sph, w, snorm, mass_ns) / spatial_norm(x_sph, w, mass_ns)
    if return_vec:
        return ctheta, snorm
    return ctheta


def angle_vg_snorm(x_cart, vg_cart, t, sc, mass_ns, *, return_vec=False):
    """cos(angle) between the group velocity and the conversion-surface normal
    (angle_vg_sNorm, RayTracer.jl:1011-1042): the same covariant projection
    as surf_norm."""
    return surf_norm(x_cart, vg_cart, t, sc, mass_ns, return_vec=return_vec)


def theta_b_cart(x_cart, k_cart, t, sc):
    """Angle between k and B in flat Cartesian components (theta_B,
    RayTracer.jl:951-955)."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import b_cart

    b = b_cart(x_cart, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    cos_t = torch.sum(k_cart * b, dim=-1) / torch.sqrt(
        torch.sum(k_cart * k_cart, dim=-1) * torch.sum(b * b, dim=-1))
    return torch.arccos(cos_t)


def _proj(k_cart, grd):
    return torch.abs(torch.sum(k_cart * grd)) / torch.sqrt(torch.sum(k_cart * k_cart))


def dtheta_dr_proj(x_cart, k_cart, t, sc):
    """|k_hat . grad(theta_B)| (dθdr_proj, RayTracer.jl:1060-1063)."""
    return _proj(k_cart, grad(lambda x: theta_b_cart(x, k_cart, t, sc))(x_cart))


def dwdr_abs_proj(x_cart, k_cart, t, sc):
    """|k_hat . grad(omega_p)| in Cartesian coordinates: the projection that
    the reference's d2wdr2_abs_vec calls as `dwdr_abs_vec`, which the
    reference never defines (RayTracer.jl:939-942)."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import omega_p_cart

    return _proj(k_cart, grad(
        lambda x: omega_p_cart(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                               mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr))(x_cart))


def d2wdr2_abs_vec(x_cart, k_cart, t, sc):
    """(2/tan(theta_B) * dθdr_proj * dwdr - d2wdr2_proj) / sin(theta_B)^2
    (d2wdr2_abs_vec, RayTracer.jl:936-949), with dwdr_abs_proj in the role
    of the reference's undefined inner function."""
    d2_proj = _proj(k_cart, grad(lambda x: dwdr_abs_proj(x, k_cart, t, sc))(x_cart))
    dwdr = dwdr_abs_proj(x_cart, k_cart, t, sc)
    theta = theta_b_cart(x_cart, k_cart, t, sc)
    d0dr = dtheta_dr_proj(x_cart, k_cart, t, sc)
    return (2.0 / torch.tan(theta) * d0dr * dwdr - d2_proj) / torch.sin(theta) ** 2
