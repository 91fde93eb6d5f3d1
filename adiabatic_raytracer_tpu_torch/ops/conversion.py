"""Conversion physics: Landau-Zener probability, gradient bundles, jacobians.

Port of adiabatic_raytracer_tpu/ops/conversion.py (RayTracer.jl:734-790,
1311-1473; MainRunner.jl:67-124).  Functions are scalar per point (x of
shape [3]); batch them with ``torch.func.vmap`` at the call site.  The
reference's forward-mode ``jax.jacfwd`` becomes ``torch.func.jacfwd``.
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW, GAUSS_TO_EV2, HBAR
from adiabatic_raytracer_tpu_torch.models.magnetosphere import (
    b_sph_component,
    b_sph_lower,
    omega_p_sph,
)
from adiabatic_raytracer_tpu_torch.models.metric import christoffel, metric_inverse
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_sphere, omega_function
from adiabatic_raytracer_tpu_torch.ops.geometry import cart_to_sph, polar_angle


def _sdot(g, a, b):
    _, g_rr, g_thth, g_pp = g
    return g_rr * a[0] * b[0] + g_thth * a[1] * b[1] + g_pp * a[2] * b[2]


def k_gamma(x_sph, ksphere, t, erg_inf, sc: Scene, mass_ns, *, bndry_lyr=-1.0,
            flat=False):
    """Photon momentum on the anisotropic shell (k_gamma,
    RayTracer.jl:1311-1325); erg_loc = erg_inf / g_rr verbatim."""
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, _, _ = g
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                        0.0 if flat else mass_ns)
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    kmag = torch.sqrt(_sdot(g, ksphere, ksphere))
    bmag = torch.sqrt(_sdot(g, b_low, b_low))
    ct = _sdot(g, b_low, ksphere) / (kmag * bmag)
    if sc.isotropic:
        ct = ct * 0.0
    erg_loc = erg_inf / g_rr
    return erg_loc * torch.sqrt(erg_loc**2 - wp**2) / torch.sqrt(
        erg_loc**2 - wp**2 * ct**2)


def dwp_ds(x_cart, ksphere, t, w_erg, sc: Scene, mass_ns, *, flat=False,
           bndry_lyr=-1.0):
    """Gradient bundle along the ray (dwp_ds, RayTracer.jl:1327-1403).
    Returns (|w'|, |k'|, |E'|, cos_w, |v_g|, dk_vg, dE_vg, k_vg)."""
    x_sph = cart_to_sph(x_cart)
    rr = x_sph[0]
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    erg_inf = torch.sqrt(1.0 - 2.0 * G_NEW * mass_ns / rr / C_KM**2) * w_erg
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, g_thth, g_pp = g
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                        0.0 if flat else mass_ns)
    kmag = torch.sqrt(_sdot(g, ksphere, ksphere))
    khat = ksphere / kmag
    kb_norm = _sdot(g, b_low, khat)
    v_ortho = -(b_low - kb_norm * khat)
    v_ortho = v_ortho / torch.sqrt(_sdot(g, v_ortho, v_ortho))
    bmag = torch.sqrt(_sdot(g, b_low, b_low))
    ct = _sdot(g, b_low, ksphere) / (kmag * bmag)
    st = torch.sin(torch.arccos(ct))
    if sc.isotropic:
        ct = ct * 0.0
        st = st / st
    xi = st**2 / (1.0 - ct**2 * wp**2 / w_erg**2)
    aniso_mix = wp**2 / w_erg**2 * xi / (st / ct)

    def wp_of(x):
        return omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                           mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=True)

    grad_wp = jacfwd(wp_of)(x_sph)
    w_prime = _sdot(g, khat, grad_wp) + aniso_mix * _sdot(g, v_ortho, grad_wp)

    grad_kg = jacfwd(lambda x: k_gamma(x, ksphere, t, erg_inf, sc, mass_ns,
                                       bndry_lyr=bndry_lyr, flat=flat))(x_sph)
    grad_kg_norm = grad_kg / torch.sqrt(_sdot(g, grad_kg, grad_kg))
    k_prime = _sdot(g, khat, grad_kg) + aniso_mix * _sdot(g, v_ortho, grad_kg)

    grad_om = jacfwd(lambda x: omega_function(x, ksphere, t, sc, mass_ns,
                                              iso=sc.isotropic))(x_sph)
    grad_om_norm = grad_om / torch.sqrt(_sdot(g, grad_om, grad_om))
    cos_w = torch.abs(_sdot(g, khat, grad_om_norm))

    v_group = jacfwd(lambda k: omega_function(x_sph, k, t, sc, mass_ns,
                                              iso=sc.isotropic))(ksphere)
    v_group = v_group / torch.stack([g_rr, g_thth, g_pp])
    vg_norm = torch.sqrt(_sdot(g, v_group, v_group))
    vg_hat = v_group / vg_norm

    slength = torch.sqrt(1.0 + (wp**2 / w_erg**2 * st**2 / (
        1.0 - wp**2 / w_erg**2 * ct**2) * (ct / st)) ** 2)
    if sc.isotropic:
        slength = slength / slength
    new_guess = (slength / vg_norm) * _sdot(g, khat, grad_om)

    dk_vg = torch.abs(_sdot(g, vg_hat, grad_kg_norm))
    k_vg = torch.abs(_sdot(g, vg_hat, khat))
    de_vg = torch.abs(_sdot(g, vg_hat, grad_om_norm))
    return (torch.abs(w_prime), torch.abs(k_prime), torch.abs(new_guess), cos_w,
            vg_norm, dk_vg, de_vg, k_vg)


def conversion_prob(x_sph, ksphere, t, w_erg, sc: Scene, mass_ns, *, flat=False,
                    bndry_lyr=-1.0, one_d=False, wp_mass_a_default=False):
    """Landau-Zener P_nonAD (conversion_prob, RayTracer.jl:1405-1473).
    Returns (Prob, |vhat.gradE|, cos_w, |gradE|, cos_w_2, |gradE_2|)."""
    g = metric_inverse(x_sph, mass_ns)
    _, g_rr, g_thth, g_pp = g
    b_mass = 0.0 if flat else mass_ns
    b_low = b_sph_lower(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass)
    wp_mass_a = 1e-5 if wp_mass_a_default else sc.mass_a
    wp = omega_p_sph(x_sph, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=wp_mass_a, bndry_lyr=bndry_lyr, zero_in=True)
    kmag = torch.sqrt(_sdot(g, ksphere, ksphere))
    khat = ksphere / kmag
    bmag = torch.sqrt(_sdot(g, b_low, b_low)) * GAUSS_TO_EV2
    ct = _sdot(g, b_low, ksphere) * GAUSS_TO_EV2 / (kmag * bmag)
    st = torch.sin(torch.arccos(ct))
    if sc.isotropic:
        ct = ct * 0.0
        st = st / st
    vloc = torch.sqrt(w_erg**2 - sc.mass_a**2) / w_erg

    if sc.isotropic:
        dmu_e = jacfwd(lambda x: omega_function(x, ksphere, t, sc, mass_ns,
                                                iso=True, kmag=kmag))(x_sph)
        dmu_e2 = dmu_e
    else:
        (g_rrr, g_rtt, g_rpp, g_trt, g_tpp, g_prp, g_ptp, g_ttr, g_ppr,
         g_ppt) = christoffel(x_sph, mass_ns)
        dmu_wp = jacfwd(lambda x: omega_p_sph(
            x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, mass_a=sc.mass_a,
            bndry_lyr=bndry_lyr, zero_in=True))(x_sph)
        dmu_babs = jacfwd(lambda x: b_sph_component(
            x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass, 0))(x_sph)
        grads_bi = [
            jacfwd(lambda x, c=c: b_sph_component(
                x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, b_mass, c))(x_sph)
            for c in (1, 2, 3)
        ]
        k1, k2, k3 = ksphere[0], ksphere[1], ksphere[2]
        term1 = k1 * grads_bi[0] + k2 * grads_bi[1] + k3 * grads_bi[2]
        b1, b2, b3 = b_low[0], b_low[1], b_low[2]
        ev = GAUSS_TO_EV2
        term2_r = (k1 * (g_rr * b1 * ev) * g_rrr + k2 * g_trt * (b2 * g_thth * ev)
                   + k3 * g_prp * (b3 * g_pp * ev))
        term2_t = (k1 * (g_thth * b2 * ev) * g_rtt + k3 * g_ptp * (b3 * g_pp * ev)
                   + k2 * (g_rr * b1 * ev) * g_ttr)
        term2_p = (k1 * (g_pp * b3 * ev) * g_rpp + k2 * g_tpp * (b3 * g_pp * ev)
                   + k3 * g_ppr * (b1 * g_rr * ev) + k3 * g_ppt * (b2 * g_thth * ev))
        dmu_ct = (term1 + torch.stack([term2_r, term2_t, term2_p])) / (kmag * bmag) \
            - ct * dmu_babs / bmag

        v_group = jacfwd(lambda k: omega_function(x_sph, k, t, sc, mass_ns,
                                                  iso=sc.isotropic))(ksphere)
        vg1, vg2, vg3 = v_group[0], v_group[1], v_group[2]
        t2r = g_rrr * k1 * (g_rr * vg1) + g_trt * k2 * (g_thth * vg2) + g_prp * k3 * (g_pp * vg3)
        t2t = g_rtt * k1 * (g_thth * vg2) + g_ptp * k3 * (g_pp * vg3) + g_ttr * k2 * (g_rr * vg1)
        t2p = (g_rpp * k1 * (g_pp * vg3) + g_tpp * k2 * (g_pp * vg3)
               + g_ppr * k3 * (g_rr * vg1) + g_ppt * k3 * (g_thth * vg2))
        term2 = torch.stack([t2r, t2t, t2p])

        pre_f = wp / torch.abs(w_erg**5 + ct**2 * w_erg * (wp**4 - 2.0 * wp**2 * w_erg**2))
        dmu_e = pre_f * (w_erg**4 * st**2 * dmu_wp
                         - w_erg**2 * ct * wp * (w_erg**2 - wp**2) * dmu_ct)
        dmu_e2 = dmu_e + term2

    grad_e_norm = dmu_e / torch.sqrt(_sdot(g, dmu_e, dmu_e))
    grad_e2_norm = dmu_e2 / torch.sqrt(_sdot(g, dmu_e2, dmu_e2))
    cos_w = torch.abs(_sdot(g, khat, grad_e_norm))
    cos_w_2 = torch.abs(_sdot(g, khat, grad_e2_norm))
    vhat_grad_e = _sdot(g, khat, dmu_e)
    grad_emag = _sdot(g, dmu_e, dmu_e)
    grad_emag_2 = _sdot(g, dmu_e2, dmu_e2)

    # literal constants pre-folded into one python float, same grouping as
    # the reference (conversion.py:262-272: the grouping keeps f32 finite)
    ax_coupling = sc.ax_g * bmag
    lit = math.pi / 2.0 * 1e-18 / (C_KM * HBAR)
    if one_d:
        prob = lit * ax_coupling * (ax_coupling / (vloc * torch.abs(vhat_grad_e)))
    else:
        prefactor = w_erg**4 * st**2 / (ct**2 * wp**2 * (wp**2 - 2.0 * w_erg**2)
                                        + w_erg**4)
        prob = lit * prefactor * ax_coupling * (
            ax_coupling / (torch.abs(vhat_grad_e) * vloc))
    return (prob, torch.abs(vhat_grad_e), cos_w, torch.sqrt(grad_emag), cos_w_2,
            torch.sqrt(grad_emag_2))


def get_prob_nonad(pos_cart, k_cart, erg_inf_ini, sc: Scene, *, flat=None):
    """Driver-side conversion probability at a point (get_Prob_nonAD,
    MainRunner.jl:67-124): full NS mass in the metric, `flat` only lowers
    the B components."""
    if flat is None:
        flat = sc.flat
    mass_ns = sc.mass_ns
    x_sph = cart_to_sph(pos_cart)
    rmag = x_sph[0]
    ksph = k_sphere(pos_cart, k_cart, mass_ns, flat=flat)
    erg_ax = erg_inf_ini / torch.sqrt(1.0 - 2.0 * G_NEW * mass_ns / rmag / C_KM**2)
    prob, *_ = conversion_prob(x_sph, ksph, 0.0, erg_ax, sc, mass_ns, flat=flat,
                               bndry_lyr=sc.bndry_lyr, one_d=False,
                               wp_mass_a_default=True)
    return prob


def g_det(x_sph, t, sc: Scene, mass_ns, *, flat=False, bndry_lyr=-1.0):
    """sqrt(-g) area-jacobian ratio of the sampling measure (g_det,
    RayTracer.jl:734-754)."""
    if flat:
        return torch.ones(x_sph.shape[:-1], dtype=x_sph.dtype, device=x_sph.device)
    _, g_rr, _, _ = metric_inverse(x_sph, mass_ns, r_ns=sc.r_ns)
    r = x_sph[..., 0]

    def wp_of(x):
        return omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                           mass_a=sc.mass_a, bndry_lyr=bndry_lyr, zero_in=False)

    dwp = jacfwd(wp_of)(x_sph)
    dr_th = dwp[0] ** -1 * dwp[1]
    dr_p = dwp[0] ** -1 * dwp[2]
    s2 = torch.sin(x_sph[..., 1]) ** 2
    sqrt_det = r * torch.sqrt(s2 * (g_rr * r**2 + dr_th**2) + dr_p**2)
    sqrt_det_nogr = r * torch.sqrt(s2 * (r**2 + dr_th**2) + dr_p**2)
    return sqrt_det / sqrt_det_nogr


def v_infinity(theta, phi, r, vel_loc, *, v_comp=0, mass_ns=1.0):
    """Asymptotic velocity component (v_infinity, RayTracer.jl:771-790)."""
    vmag = torch.sqrt(torch.sum(vel_loc**2))
    gmr = G_NEW * mass_ns / r / C_KM**2
    v_inf = torch.sqrt(vmag**2 - 2.0 * gmr)
    rhat = torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi), torch.cos(theta)])
    rv = torch.sum(vel_loc * rhat)
    denom = v_inf**2 + gmr - v_inf * rv
    return (v_inf**2 * vel_loc[v_comp] + v_inf * gmr * rhat[v_comp]
            - v_inf * vel_loc[v_comp] * rv) / denom


def jacobian_fv(x_cart, vel_loc, mass_ns=1.0):
    """|det d v_inf / d v_loc|^-1, the Liouville weight (jacobian_fv,
    RayTracer.jl:756-769)."""
    rmag = torch.sqrt(torch.sum(x_cart**2))
    phi = torch.atan2(x_cart[1], x_cart[0])
    theta = polar_angle(x_cart, rmag)

    def vinf(v):
        return torch.stack([v_infinity(theta, phi, rmag, v, v_comp=c, mass_ns=mass_ns)
                            for c in (0, 1, 2)])

    jj = torch.linalg.det(jacfwd(vinf)(vel_loc))
    return torch.abs(jj) ** -1
