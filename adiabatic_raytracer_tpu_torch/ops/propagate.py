"""Ray propagation: physics RHS, crossing condition, launch/result transforms.

Port of adiabatic_raytracer_tpu/ops/propagate.py (RayTracer.jl:71-123,
171-452).  State per ray: u = [r, theta, phi, w_r, w_th, w_ph, e7] with the
covariant celerity normalized by erg_inf and e7 = erg_inf * Delta_omega.

The RHS differentiates the Hamiltonians with torch autograd: the rays are
independent, so the gradient of the batch sum is the per-ray gradient (one
forward and one backward pass per evaluation, as the reference's jax.grad).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW
from adiabatic_raytracer_tpu_torch.models.magnetosphere import omega_p_sph
from adiabatic_raytracer_tpu_torch.models.metric import metric_inverse
from adiabatic_raytracer_tpu_torch.ops.dispersion import (
    hamiltonian_axion,
    hamiltonian_photon,
    k_norm_cart,
    k_par,
)
from adiabatic_raytracer_tpu_torch.ops.geometry import (
    cart_to_sph,
    celerity_from_cart,
    celerity_to_cart_vel,
    sph_to_cart,
)
from adiabatic_raytracer_tpu_torch.ops.integrator import PoolResult, integrate_pool


class PropagateResult(NamedTuple):
    traj: Any        # [B, NS, 3] Cartesian positions on the save grid
    mom: Any         # [B, NS, 3] Cartesian proper velocities (x erg scale)
    erg: Any         # [B, NS] e7 along the trajectory
    fail: Any        # [B] 1.0 survived, 0.0 ended below 1.01 r_NS
    cut_short: Any   # [B] bool
    xc: Any          # [B, MAXC, 3]
    kc: Any          # [B, MAXC, 3]
    tc: Any          # [B, MAXC] proper time at crossing
    dwc: Any         # [B, MAXC] Delta_omega at crossing
    n_cross: Any     # [B]
    times: Any       # [B, NS] save grid (log-time)
    final_lnt: Any   # [B]
    ns_hit: Any      # [B] bool
    maxed: Any       # [B] bool
    steps: Any       # [B]
    pcx: Any = None  # [B, MAXC] in-kernel conversion probabilities (mega only)


def crossing_condition(u, lnt, sc: Scene, mass_eff):
    """Thick-surface level-crossing condition (RayTracer.jl:254-297): the
    momenta renormalized onto the axion shell, then the Melrose photon
    Hamiltonian over erg_inf^2.  u [..., 7], lnt [...]."""
    x = u[..., 0:3]
    w = u[..., 3:6]
    erg_inf = u[..., 6]
    t = torch.exp(lnt)
    g_tt, g_rr, g_thth, g_pp = metric_inverse(x, mass_eff)
    wsq = g_rr * w[..., 0] ** 2 + g_thth * w[..., 1] ** 2 + g_pp * w[..., 2] ** 2
    nrm_sq = (-(erg_inf**2) * g_tt - sc.mass_a**2) / wsq
    w_ax = w * torch.sqrt(nrm_sq)[..., None]
    wp = omega_p_sph(x, t, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                     mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr, zero_in=True)
    kp = 0.0 if sc.isotropic else k_par(x, w_ax, t, sc, mass_eff)
    ksqr = (g_tt * erg_inf**2 + g_rr * w_ax[..., 0] ** 2 + g_thth * w_ax[..., 1] ** 2
            + g_pp * w_ax[..., 2] ** 2)
    e2 = erg_inf**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2) / erg_inf**2


def make_rhs(sc: Scene, mass_eff, time0, species: str):
    """Hamilton's equations in log-time (func!/func_axion!,
    RayTracer.jl:71-123).  species 'photon' | 'axion' | 'mixed'.  Quirk kept
    from the reference: the photon's spatial gradients exclude the
    boundary-layer plasma term, its time derivative includes it
    (RayTracer.jl:84-88)."""
    bndry = float(sc.bndry_lyr) > 0.0

    def rhs(u, lnt, ray_args):
        erg = ray_args["erg"]
        is_photon = ray_args["is_photon"]
        t = torch.exp(lnt)
        x = u[:, 0:3]
        e7 = u[:, 6]
        g_rr = metric_inverse(x, mass_eff)[1]
        with torch.enable_grad():
            z = torch.cat([x, u[:, 3:6] * erg[:, None]], dim=1).detach().requires_grad_(True)
            tt = (time0 + t).detach().requires_grad_(species != "axion" and not bndry)
            xx, kk = z[:, 0:3], z[:, 3:6]
            if species == "axion":
                h = hamiltonian_axion(xx, kk, erg, mass_eff)
            else:
                hp = hamiltonian_photon(xx, kk, tt, -e7, sc, mass_eff, bndry_lyr=-1.0)
                if species == "photon":
                    h = hp
                else:
                    ha = hamiltonian_axion(xx, kk, erg, mass_eff)
                    h = torch.where(is_photon, hp, ha)
            leaves = [z, tt] if tt.requires_grad else [z]
            grads = torch.autograd.grad(h.sum(), leaves, allow_unused=True)
            if species != "axion" and bndry:
                ttb = (time0 + t).detach().requires_grad_(True)
                hb = hamiltonian_photon(x, u[:, 3:6] * erg[:, None], ttb, -e7, sc,
                                        mass_eff, bndry_lyr=sc.bndry_lyr)
                dh_dt = torch.autograd.grad(hb.sum(), ttb)[0]
            elif species != "axion":
                dh_dt = grads[1] if grads[1] is not None else torch.zeros_like(t)
        gz = grads[0]
        dh_dx, dh_dk = gz[:, 0:3], gz[:, 3:6]
        fac_t = t[:, None]
        grr = g_rr[:, None]
        ergc = erg[:, None]
        du_x_ax = dh_dk * C_KM * fac_t * grr / ergc
        du_w_ax = -dh_dx * C_KM * fac_t * grr / ergc / ergc
        if species == "axion":
            return torch.cat([du_x_ax, du_w_ax, torch.zeros_like(u[:, 6:7])], dim=1)
        m_e7 = -e7[:, None]
        du_x_ph = dh_dk * C_KM * fac_t * grr / m_e7
        du_w_ph = -dh_dx * C_KM * fac_t * grr / m_e7 / ergc
        du_e7_ph = dh_dt * t * g_rr / (-e7)
        frozen = (u[:, 0] <= sc.r_ns * 1.01)[:, None]
        du_ph = torch.cat([du_x_ph, du_w_ph, du_e7_ph[:, None]], dim=1)
        du_ph = torch.where(frozen, torch.zeros_like(du_ph), du_ph)
        if species == "photon":
            return du_ph
        du_ax = torch.cat([du_x_ax, du_w_ax, torch.zeros_like(u[:, 6:7])], dim=1)
        return torch.where(is_photon[:, None], du_ph, du_ax)

    return rhs


def lapse_interior(r, mass_ns, r_ns):
    """1 - r_s(r)/r with the (r/r_NS)^3 interior mass (RayTracer.jl:398-406)."""
    m = torch.where(r < r_ns, mass_ns * r**3 / r_ns**3, mass_ns + 0.0 * r)
    return 1.0 - 2.0 * G_NEW * m / C_KM**2 / r


def launch_state(x0_cart, k0_cart, sc: Scene, erg, delta_w, time0=0.0):
    """On-shell launch state u0 [B, 7] (RayTracer.jl:179-216): both species
    are normalized onto the axion shell (photons with ax_fix)."""
    k0n = k_norm_cart(x0_cart, k0_cart, time0, erg, sc, sc.mass_ns,
                      is_photon=True, ax_fix=True)
    w0 = celerity_from_cart(x0_cart, k0n, sc.mass_ns_eff) / erg[:, None]
    return torch.cat([cart_to_sph(x0_cart), w0, (erg * delta_w)[:, None]], dim=1)


def propagate(x0_cart, k0_cart, sc: Scene, cfg: NumericsConfig, *, erg, delta_w,
              lnt0, lnt1, is_photon, max_crossings, species: str = "mixed",
              time0=0.0, detect_events: bool = True) -> PropagateResult:
    """Propagate rays with the pool engine; inputs [B, ...] f64 tensors."""
    mass_eff = sc.mass_ns_eff
    u0 = launch_state(x0_cart, k0_cart, sc, erg, delta_w, time0)
    frac = torch.linspace(0.0, 1.0, cfg.n_save, dtype=u0.dtype, device=u0.device)
    save_lnt = lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]
    rhs = make_rhs(sc, mass_eff, time0, species)
    res = integrate_pool(
        rhs, lambda u, l: crossing_condition(u, l, sc, mass_eff), u0, lnt0, lnt1,
        {"erg": erg, "is_photon": is_photon}, cfg, save_lnt=save_lnt,
        kill_at_surface=is_photon, r_ns=sc.r_ns, x0_cart=x0_cart,
        max_crossings=max_crossings, detect_events=detect_events)
    return finalize_propagate(res, erg, sc, mass_eff, save_lnt)


def finalize_propagate(res: PoolResult, erg, sc: Scene, mass_eff, save_lnt) -> PropagateResult:
    """PoolResult -> Cartesian outputs (RayTracer.jl:393-444)."""
    save_x = res.save_u[..., 0:3]
    save_w = res.save_u[..., 3:6] * erg[:, None, None]
    a_save = lapse_interior(save_x[..., 0], mass_eff, sc.r_ns)
    cross_x = res.cross_u[..., 0:3]
    return PropagateResult(
        traj=sph_to_cart(save_x),
        mom=celerity_to_cart_vel(save_x, save_w, mass_eff, a=a_save),
        erg=res.save_u[..., 6],
        fail=torch.where(res.u[:, 0] <= sc.r_ns * 1.01, 0.0, 1.0).to(res.u.dtype),
        cut_short=res.cut_short,
        xc=sph_to_cart(cross_x),
        kc=celerity_to_cart_vel(cross_x, res.cross_u[..., 3:6] * erg[:, None, None],
                                mass_eff),
        tc=torch.exp(res.cross_lnt),
        dwc=res.cross_u[..., 6] / erg[:, None],
        n_cross=res.n_cross, times=save_lnt, final_lnt=res.lnt,
        ns_hit=res.ns_hit, maxed=res.maxed, steps=res.steps)
