"""K2: the whole adaptive DP5 integrator in one CUDA kernel (csrc/megakernel.cu).

Replaces the Pallas megakernel (adiabatic_raytracer_tpu/ops/megakernel.py:
_mega_kernel via integrate_mega).  One warp per ray runs the full adaptive
loop with its state in registers: the hand-adjoint RHS, the gated event
scan, bisection, the start-point and r < 1.01 r_NS rejections, NS kill,
stall cut, up to `max_crossings` crossing records, the ntimes=3 midpoint and
the in-kernel conversion probability per crossing.  The step is the one K3
and K4 run (csrc/tree_warp.cuh): the serial chain replicated in the 32
lanes, the event scan and the bisection spread over them.  min(B, resident
warps) warps pull rays from a queue in device memory, so a ray's result
does not depend on which warp ran it.  The dispersion (anisotropic Melrose
or isotropic, each with or without the boundary-layer plasma term) is a
template parameter of the device code: the launch picks the scene's
instantiation from MegaParams (art::disp_of).  The in-kernel MC chain (the
reference's with_chain; integrate_mega's chain_cap and uniforms) is one more
instantiation on the Melrose scene, mega_chain_kernel: a chain lane is born
again in the kernel at each clean crossing, by the birth block K3 and K4
run (child_birth), and integrates on; _chain_plain is its plain version.

Precision: f64 state and physics.  The TPU kernel's float-float state,
Cody-Waite sin/cos/exp and f32 bisection cap were workarounds for a chip
without f64; Hopper has it in hardware, so none of them is carried over.
The boundary follows the caller's state dtype, as the TPU kernel's does
(megakernel.py:1591-1604 and :1527 there): an f32 state (--precision f32)
goes up to f64 at the launch and the outputs come back in f32.

Event semantics follow the pool engine (ops/integrator.py), which is this
kernel's plain version: each accepted step scans the Hermite interpolant at
`interp_points` samples and refines up to `max_roots_per_step` roots in
line order.  The gate is decided per ray: the dense pass runs when the
ray's own `interp_coarse`-point pass flipped sign or dipped below
`scan_gate_theta`; interp_coarse=0 always runs the dense pass, which is
then the pool's algorithm exactly.

This module also holds the torch twins of the device functions K2, K3 and
K4 share (_metric, _dipole_unit, _omega_p, _bndry_t, _condition,
_grad_h_hand, _rhs, _prob_nd, _hermite; csrc/physics.cuh,
csrc/mega_device.cuh), written on tuples of [B] tensors against the same
MegaParams struct the kernels receive; the card checks each one through
`probe`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene
from adiabatic_raytracer_tpu_torch.constants import (
    C_KM,
    G_NEW,
    GAUSS_TO_EV2,
    HBAR,
    INV_ALPHA,
    M_E_EV,
    SQRT_4PI_ALPHA,
)
from adiabatic_raytracer_tpu_torch.ops import cuda_lib
from adiabatic_raytracer_tpu_torch.ops.geometry import celerity_to_cart_vel, sph_to_cart
from adiabatic_raytracer_tpu_torch.ops.integrator import integrate_pool
from adiabatic_raytracer_tpu_torch.ops.propagate import (
    PropagateResult,
    crossing_condition,
    lapse_interior,
    launch_state,
    make_rhs,
)

SPECIES = {"photon": 0, "axion": 1, "mixed": 2}
MAX_SLOTS = 16
# The pool engine (and every host-side physics function of the reference)
# evaluates the metric's interior branch below r = 10 km whatever the scene's
# r_ns (models/metric.py: metric_inverse's r_ns default); the kernels follow
# the pool, so their metric takes this radius while fields and cuts use r_ns.
# At r_ns < 10 km the photon side meets that branch between r_ns and 10 km
# (the reference's TPU kernel takes r_ns there instead, megakernel.py:273).
METRIC_R_NS = 10.0


class MegaParams(ctypes.Structure):
    """Scene and numerics scalars, passed by value at launch (csrc/physics.cuh
    declares the same struct), so a new scene needs no rebuild.  bndry_lyr
    and isotropic also pick the kernel's dispersion variant (art::disp_of)."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "cm", "sm", "omega", "b0_sign", "r_ns", "r_metric", "rs0", "mass_a", "wp2_scale",
        "rs0_full", "gm_full", "prob_scale", "rtol", "atol", "dt_min",
        "safety", "min_fac", "max_fac", "pi_beta", "expo1", "gate_theta",
        "stall_min")] + [(n, ctypes.c_int) for n in (
        "max_steps", "interp", "interp_coarse", "bisect", "stall_window",
        "max_roots", "max_crossings", "species", "with_prob")] + [
        (n, ctypes.c_double) for n in ("bndry_lyr", "bndry_pole_t", "bndry_rmax")] + [
        ("isotropic", ctypes.c_int)]


def can_prob(sc: Scene) -> bool:
    """The in-kernel probability covers anisotropic Melrose dispersion, no
    boundary layer, curved space (megakernel.py:172 of the reference)."""
    return (bool(sc.melrose) and not bool(sc.isotropic)
            and not bool(sc.flat) and float(sc.bndry_lyr) <= 0)


def check_supported(sc: Scene, cfg: NumericsConfig, max_crossings: int):
    """Raise on what the kernel does not cover, naming the ROADMAP item."""
    if not sc.isotropic and not sc.melrose:
        raise NotImplementedError("megakernel: the non-Melrose anisotropic dispersion "
                                  "has no kernel branch, in the reference either "
                                  "(ROADMAP Queue 1, \"Left unported on purpose\")")
    if cfg.rhs_mode != "hand" or cfg.cond_mode != "fast":
        raise NotImplementedError("megakernel: rhs_mode='vjp' / cond_mode="
                                  "'canonical' are not ported yet (ROADMAP Queue 2a, "
                                  "K2's branches still to port)")
    if not 1 <= max_crossings <= MAX_SLOTS:
        raise ValueError(f"max_crossings must be in 1..{MAX_SLOTS}")


def _wp2_scale(sc: Scene) -> float:
    """(omega_p / mass_a)^2 per unit |B_z / b0|."""
    return (4.0 * math.pi / (INV_ALPHA * M_E_EV)
            * (2.0 * abs(float(sc.omega_pul) * float(sc.b0)) / SQRT_4PI_ALPHA * GAUSS_TO_EV2
               * HBAR) / float(sc.mass_a) ** 2)


def bndry_scalars(sc: Scene):
    """(bndry_lyr, pole_t, rmax) of the boundary-layer plasma term
    (models/magnetosphere._bndry_lyr_term; SceneConsts of the reference):
    pole_t = omega_p at the pole / mass_a, rmax = r_ns pole_t^(2/3), the
    aligned dipole's conversion radius."""
    pole_t = math.sqrt(_wp2_scale(sc))
    return float(sc.bndry_lyr), pole_t, float(sc.r_ns) * pole_t ** (2.0 / 3.0)


def mega_params(sc: Scene, cfg: NumericsConfig, *, max_crossings: int = 1,
                species: str = "photon", with_prob: bool = False) -> MegaParams:
    mass_eff = float(sc.mass_ns_eff)
    b0 = float(sc.b0)
    omega = float(sc.omega_pul)
    mass_a = float(sc.mass_a)
    mass_full = float(sc.mass_ns)
    wp2_scale = _wp2_scale(sc)
    lyr, pole_t, rmax = bndry_scalars(sc)
    b_s = abs(b0) * GAUSS_TO_EV2
    prob_scale = ((math.pi / 2.0) * (float(sc.ax_g) * 1e-9 * b_s) ** 2
                  / (mass_a * C_KM * HBAR))
    kc = int(cfg.interp_coarse)
    beta = float(cfg.pi_beta)
    return MegaParams(
        cm=math.cos(float(sc.theta_m)), sm=math.sin(float(sc.theta_m)),
        omega=omega, b0_sign=1.0 if b0 >= 0 else -1.0, r_ns=float(sc.r_ns),
        r_metric=METRIC_R_NS,
        rs0=2.0 * G_NEW * mass_eff / C_KM**2, mass_a=mass_a, wp2_scale=wp2_scale,
        rs0_full=2.0 * G_NEW * mass_full / C_KM**2, gm_full=G_NEW * mass_full / C_KM**2,
        prob_scale=prob_scale, rtol=float(cfg.rtol), atol=float(cfg.atol),
        dt_min=float(cfg.dt_min), safety=float(cfg.safety),
        min_fac=float(cfg.min_dt_factor), max_fac=float(cfg.max_dt_factor),
        pi_beta=beta, expo1=0.2 - 0.75 * beta,
        gate_theta=float(cfg.scan_gate_theta), stall_min=float(cfg.stall_min_progress),
        max_steps=int(cfg.max_steps), interp=int(cfg.interp_points),
        interp_coarse=kc if 0 < kc < int(cfg.interp_points) else 0,
        bisect=int(cfg.bisect_iters), stall_window=int(cfg.stall_window),
        max_roots=int(cfg.max_roots_per_step), max_crossings=int(max_crossings),
        species=SPECIES[species], with_prob=int(bool(with_prob) and can_prob(sc)),
        bndry_lyr=lyr, bndry_pole_t=pole_t, bndry_rmax=rmax,
        isotropic=int(bool(sc.isotropic)))


# ---------------------------------------------------------------------------
# torch twins of the device functions (csrc/physics.cuh, csrc/megakernel.cu)
# ---------------------------------------------------------------------------


def _metric(P, r, sin_th, rs0=None):
    rs0 = P.rs0 if rs0 is None else rs0
    rn = P.r_metric
    inside = r <= rn
    rs = torch.where(inside, rs0 * (r / rn) ** 3, torch.full_like(r, rs0))
    one_m = 1.0 - rs / r
    a1 = torch.clamp(1.0 - rs / rn, min=1e-30)
    a2 = 1.0 - r**2 * rs / rn**3
    g_tt = torch.where(inside, -4.0 / (3.0 * torch.sqrt(a1)
                                       - torch.sqrt(torch.clamp(a2, min=1e-30))) ** 2,
                       -1.0 / one_m)
    g_rr = torch.where(inside, a2, one_m)
    return g_tt, g_rr, 1.0 / r**2, 1.0 / (r * sin_th) ** 2


def _dmetric_dr(P, r, sin_th, rs0=None):
    """d(g^tt, g^rr, g^thth, g^pp)/dr, both branches of _metric."""
    rs0 = P.rs0 if rs0 is None else rs0
    rn = P.r_metric
    inside = r <= rn
    one_m = 1.0 - rs0 / r
    ext_tt = (rs0 / r**2) / one_m**2
    a1 = 1.0 - rs0 * r**3 / rn**4
    a2 = 1.0 - rs0 * r**5 / rn**6
    s1 = torch.sqrt(torch.clamp(a1, min=1e-30))
    s2 = torch.sqrt(torch.clamp(a2, min=1e-30))
    da1 = torch.where(a1 > 1e-30, -3.0 * rs0 * r**2 / rn**4, torch.zeros_like(r))
    da2 = -5.0 * rs0 * r**4 / rn**6
    dd = 3.0 * da1 / (2.0 * s1) - torch.where(a2 > 1e-30, da2, torch.zeros_like(r)) / (2.0 * s2)
    int_tt = 8.0 / (3.0 * s1 - s2) ** 3 * dd
    d_tt = torch.where(inside, int_tt, ext_tt)
    d_rr = torch.where(inside, da2, rs0 / r**2)
    return d_tt, d_rr, -2.0 / r**3, -2.0 / (r**3 * sin_th**2)


def _dipole_unit(P, r, cz, sin_th, cphi, sphi, time):
    """GJ dipole in units of |b0|, rotated by omega*time."""
    swt, cwt = torch.sin(P.omega * time), torch.cos(P.omega * time)
    cp = cphi * cwt + sphi * swt
    sp = sphi * cwt - cphi * swt
    bnorm = P.b0_sign * (P.r_ns / r) ** 3 * 0.5
    br = 2.0 * bnorm * (P.cm * cz + P.sm * sin_th * cp)
    btheta = bnorm * (P.cm * sin_th - P.sm * cz * cp)
    bphi = bnorm * P.sm * sp
    return br, btheta, bphi


def _omega_p(P, br, btheta, cz, sin_th, r, b0_abs):
    """omega_p [eV] from the unit dipole scaled by |b0|; 0 inside the star."""
    bz = (br * cz - btheta * sin_th) * b0_abs
    nelec = torch.abs(2.0 * P.omega * bz) / SQRT_4PI_ALPHA * GAUSS_TO_EV2 * HBAR
    wp = torch.sqrt(4.0 * math.pi * nelec / INV_ALPHA / M_E_EV)
    return torch.where(r <= P.r_ns, torch.zeros_like(wp), wp)


def _bndry_t(P, r):
    """Boundary-layer omega_p addition in mass_a units where r > r_NS
    (megakernel.py:312 of the reference; models/magnetosphere._bndry_lyr_term,
    whose support r >= r_NS is cut to r > r_NS by the zeroed interior)."""
    q = P.r_ns / r
    term = P.bndry_pole_t * (q * torch.sqrt(q)) * torch.exp(
        -(r - P.bndry_rmax * P.bndry_lyr) / (0.1 * P.bndry_rmax))
    return torch.where(r > P.r_ns, term, torch.zeros_like(term))


def _condition(P, u, lnt):
    """Strength-reduced crossing condition (the reference's cond_mode
    "fast", megakernel.py:433): after the axion-shell renormalization the
    condition is 0.5 ma^2 (wp2t mel - 1) / e7^2, mel = 1 - kp^2/e2 (Melrose)
    or 1 (isotropic); the boundary layer adds bt to sqrt(wp2t)."""
    x1, x2, x3, w1, w2, w3, e7 = u
    t = torch.exp(lnt)
    r = x1
    s_th, c_th = torch.sin(x2), torch.cos(x2)
    s_ph, c_ph = torch.sin(x3), torch.cos(x3)
    g_tt, g_rr, g_thth, g_pp = _metric(P, r, s_th)
    br, bth, bph = _dipole_unit(P, r, c_th, s_th, c_ph, s_ph, t)
    bz = br * c_th - bth * s_th
    wp2t = torch.where(r <= P.r_ns, torch.zeros_like(bz), P.wp2_scale * torch.abs(bz))
    if P.bndry_lyr > 0:
        wp2t = (torch.sqrt(wp2t) + _bndry_t(P, r)) ** 2
    e72 = e7 * e7
    inv_e72 = 1.0 / e72
    if P.isotropic:
        return (0.5 * P.mass_a**2) * (wp2t - 1.0) * inv_e72
    wsq = g_rr * w1**2 + g_thth * w2**2 + g_pp * w3**2
    nrm2 = (-e72 * g_tt - P.mass_a**2) / wsq
    inv_r = 1.0 / r
    n_w = (torch.sqrt(g_rr) * w1 * br + inv_r * w2 * bth
           + inv_r / torch.abs(s_th) * w3 * bph)
    bm2 = br * br + bth * bth + bph * bph
    mel = 1.0 - nrm2 * n_w * n_w * g_rr * inv_e72 / bm2
    return (0.5 * P.mass_a**2) * (wp2t * mel - 1.0) * inv_e72


def _grad_h_hand(P, x1, x2, x3, kt1, kt2, kt3, time, ergt_ph, ergt_ax, photon):
    """Hand adjoint of the nondimensionalized Hamiltonians (megakernel.py:602
    of the reference): (dH~/dx (3), dH~/dk~ (3), dH~/dt), Melrose or
    isotropic photon branch and axion branch (metric only).  The boundary
    layer enters the photon's time derivative only, not its spatial
    gradients (RayTracer.jl:84-88).

    The photon branch, at r = max(x1, r_NS), for the diagonal metric with
    g^rr = G(r) and g^tt = T(r):
        H~ = 0.5 (T e~^2 + G k1^2 + k2^2 / r^2 + k3^2 / (r s)^2 + wp2 F),
        n = sqrt(G) k1 B_r + k2 B_th / r + k3 B_ph / (r s),  kp2 = n^2 / |B|^2,
        F = 1 - kp2 G E  (Melrose; isotropic: F = 1),  E = 1 / e~^2,
    e~ = ergt_ph, s = sin(theta), B the unit dipole.  G enters F through
    e2 = e~^2 / g^rr of the pool's Hamiltonian.  Then
        dH~/dk1 = G k1 - lam sqrt(G) B_r,  lam = wp2 G E n / |B|^2,
        d(ksqr)/dr = T' e~^2 + G' k1^2 - 2 (k2^2 + k3^2 / s^2) / r^3,
        dn/dr = (G' / (2 sqrt(G))) k1 B_r - 3 n / r - (k2 B_th / r + k3 B_ph / (r s)) / r,
        dF/dr = -E (G dkp2/dr + kp2 G'),
    and the theta, phi and t chains through B only.  Outside r_metric G is
    A = 1 - rs0 / r = -1 / T, so T' = A' / A^2: that arithmetic is kept
    there as it was.  Below r_metric, which the clamp reaches when r_NS <
    r_metric, G, G' and T' are the interior branch of _metric and
    _dmetric_dr, as the pool's metric_inverse takes them (r_metric = 10 km
    whatever r_NS)."""
    z = torch.zeros_like(x1)
    s_th, c_th = torch.sin(x2), torch.cos(x2)
    if P.species != SPECIES["photon"]:
        _, grr_a, gthth_a, gpp_a = _metric(P, x1, s_th)
        dgtt, dgrr, dgthth, dgpp = _dmetric_dr(P, x1, s_th)
        ax_k = (grr_a * kt1, gthth_a * kt2, gpp_a * kt3)
        ax_r = 0.5 * (dgtt * ergt_ax**2 + dgrr * kt1**2 + dgthth * kt2**2 + dgpp * kt3**2)
        ax_th = -gpp_a * (c_th / s_th) * kt3**2
        ax = (ax_r, ax_th, z), ax_k, z
        if P.species == SPECIES["axion"]:
            return ax
    else:
        ax = None

    s_ph, c_ph = torch.sin(x3), torch.cos(x3)
    r = torch.clamp(x1, min=P.r_ns)
    inv_r = 1.0 / r
    A = 1.0 - P.rs0 * inv_r
    inv_A = 1.0 / A
    inv_s = 1.0 / s_th
    inv_r2 = inv_r * inv_r
    g_pp = inv_r2 * inv_s * inv_s
    dA_dr = P.rs0 * inv_r2
    E = 1.0 / (ergt_ph * ergt_ph)

    swt, cwt = torch.sin(P.omega * time), torch.cos(P.omega * time)
    cp = c_ph * cwt + s_ph * swt
    sp = s_ph * cwt - c_ph * swt
    bnorm = P.b0_sign * 0.5 * (P.r_ns * inv_r) ** 3
    m_r = P.cm * c_th + P.sm * s_th * cp
    m_t = P.cm * s_th - P.sm * c_th * cp
    br = 2.0 * bnorm * m_r
    bth = bnorm * m_t
    bph = bnorm * P.sm * sp
    bz = br * c_th - bth * s_th
    wp2 = P.wp2_scale * torch.abs(bz)
    w_fac = P.wp2_scale * torch.sign(bz)

    # g^rr, its r-derivative and d(ksqr)/dr's metric part: exterior, then
    # the interior branch where the clamped r lies below r_metric
    G, dG = A, dA_dr
    dk_r = (ergt_ph**2 * inv_A * inv_A + kt1**2) * dA_dr
    if P.r_ns < P.r_metric:
        inside = r < P.r_metric
        g_rr = _metric(P, r, s_th)[1]
        d_tt, d_rr = _dmetric_dr(P, r, s_th)[:2]
        G = torch.where(inside, g_rr, A)
        dG = torch.where(inside, d_rr, dA_dr)
        dk_r = torch.where(inside, ergt_ph**2 * d_tt + kt1**2 * d_rr, dk_r)
    dksqr_r = dk_r - 2.0 * inv_r2 * inv_r * (kt2**2 + inv_s * inv_s * kt3**2)
    dinv_s = -inv_s * inv_s * c_th
    dksqr_th = 2.0 * inv_r2 * inv_s * dinv_s * kt3**2
    bndry = P.bndry_lyr > 0

    if P.isotropic:   # H = 0.5 (ksqr + wp2): no anisotropy chain
        dbz_r = -3.0 * bz * inv_r
        dbz_th = -3.0 * bth * c_th - 1.5 * br * s_th
        dbz_ph = -3.0 * s_th * c_th * bph
        dbz_t = 3.0 * bnorm * P.sm * s_th * c_th * P.omega * sp
        ph_r = 0.5 * (dksqr_r + w_fac * dbz_r)
        ph_th = 0.5 * (dksqr_th + w_fac * dbz_th)
        ph_ph = 0.5 * w_fac * dbz_ph
        ph_k = (G * kt1, inv_r2 * kt2, g_pp * kt3)
        ph_t = 0.5 * w_fac * dbz_t
        if bndry:
            wpt = torch.sqrt(torch.clamp(wp2, min=1e-30))
            ph_t = ph_t + 0.5 * (_bndry_t(P, r) / wpt) * w_fac * dbz_t
        return _photon_or_axion(P, x1, photon, (ph_r, ph_th, ph_ph), ph_k, ph_t, ax)

    sqG = torch.sqrt(G)
    q1 = sqG * kt1
    q2 = inv_r * kt2
    q3 = inv_r * inv_s * kt3
    n = q1 * br + q2 * bth + q3 * bph
    bm2 = br * br + bth * bth + bph * bph
    inv_bm2 = 1.0 / bm2
    kp2 = n * n * inv_bm2
    F = 1.0 - kp2 * G * E
    lam = wp2 * G * E * n * inv_bm2
    ph_k = (G * kt1 - lam * sqG * br, inv_r2 * kt2 - lam * inv_r * bth,
            g_pp * kt3 - lam * inv_r * inv_s * bph)
    aE = G * E

    dn_r = (0.5 * dG / sqG) * kt1 * br - 3.0 * inv_r * n - inv_r * (q2 * bth + q3 * bph)
    dkp2_r = inv_bm2 * 2.0 * n * dn_r + 6.0 * kp2 * inv_r
    dwp2_r = -3.0 * wp2 * inv_r
    dF_r = -E * (dkp2_r * G + kp2 * dG)
    ph_r = 0.5 * (dksqr_r + dwp2_r * F + wp2 * dF_r)

    dbr_th = -2.0 * bth
    dbth_th = 0.5 * br
    dbz_th = -3.0 * bth * c_th - 1.5 * br * s_th
    dq3_th = inv_r * kt3 * dinv_s
    dn_th = q1 * dbr_th + q2 * dbth_th + dq3_th * bph
    dbm2_th = -3.0 * br * bth
    dkp2_th = inv_bm2 * (2.0 * n * dn_th - kp2 * dbm2_th)
    ph_th = 0.5 * (dksqr_th + w_fac * dbz_th * F - wp2 * aE * dkp2_th)

    dbr_ph = -2.0 * s_th * bph
    dbth_ph = c_th * bph
    dbph_ph = bnorm * P.sm * cp
    dbz_ph = -3.0 * s_th * c_th * bph
    dn_ph = q1 * dbr_ph + q2 * dbth_ph + q3 * dbph_ph
    dbm2_ph = 2.0 * (br * dbr_ph + bth * dbth_ph + bph * dbph_ph)
    dkp2_ph = inv_bm2 * (2.0 * n * dn_ph - kp2 * dbm2_ph)
    ph_ph = 0.5 * (w_fac * dbz_ph * F - wp2 * aE * dkp2_ph)

    bs = bnorm * P.sm
    wsp = P.omega * sp
    dbr_t = 2.0 * bs * s_th * wsp
    dbth_t = -bs * c_th * wsp
    dbph_t = -bs * P.omega * cp
    dbz_t = 3.0 * bs * s_th * c_th * wsp
    dn_t = q1 * dbr_t + q2 * dbth_t + q3 * dbph_t
    dbm2_t = 2.0 * (br * dbr_t + bth * dbth_t + bph * dbph_t)
    dkp2_t = inv_bm2 * (2.0 * n * dn_t - kp2 * dbm2_t)
    ph_t = 0.5 * (w_fac * dbz_t * F - wp2 * aE * dkp2_t)
    if bndry:
        # the excess 0.5 (2 wpt bt + bt^2) F; bt does not depend on time
        wpt = torch.sqrt(torch.clamp(wp2, min=1e-30))
        bt = _bndry_t(P, r)
        dwp2_t = w_fac * dbz_t
        ph_t = ph_t + 0.5 * ((bt / wpt) * dwp2_t * F + (2.0 * wpt * bt + bt * bt)
                             * (-aE * dkp2_t))
    return _photon_or_axion(P, x1, photon, (ph_r, ph_th, ph_ph), ph_k, ph_t, ax)


def _photon_or_axion(P, x1, photon, ph_x, ph_k, ph_t, ax):
    """_grad_h_hand's output: the photon branch, its r-gradient zeroed at the
    r-clamp, selected per ray against the axion branch `ax`."""
    ph_r, ph_th, ph_ph = ph_x
    z = torch.zeros_like(x1)
    ph_r = torch.where(x1 > P.r_ns, ph_r, z)
    if P.species == SPECIES["photon"]:
        return (ph_r, ph_th, ph_ph), ph_k, ph_t
    (ax_r, ax_th, _), ax_k, _ = ax
    w = torch.where
    return ((w(photon, ph_r, ax_r), w(photon, ph_th, ax_th), w(photon, ph_ph, z)),
            tuple(w(photon, p, a) for p, a in zip(ph_k, ax_k)), w(photon, ph_t, z))


def _rhs(P, u, lnt, erg, is_ph):
    """Hamilton's equations from the hand adjoint (megakernel.py:771 of the
    reference).  The lapse factor g^rr is taken at the ray's own r, as the
    pool engine (and the Julia reference) does; the TPU kernel took it at
    max(r, r_NS), which differs for axions inside the star (ROADMAP Queue 3)."""
    x1, x2, x3, w1, w2, w3, e7 = u
    t = torch.exp(lnt)
    inv_ma = 1.0 / P.mass_a
    kt1, kt2, kt3 = w1 * (erg * inv_ma), w2 * (erg * inv_ma), w3 * (erg * inv_ma)
    g_rr = _metric(P, x1, torch.sin(x2))[1]
    photon = is_ph > 0.5
    gx, gk, gt = _grad_h_hand(P, x1, x2, x3, kt1, kt2, kt3, t, -e7 * inv_ma,
                              erg * inv_ma, photon)
    ma2 = P.mass_a * P.mass_a
    denom = torch.where(photon, -e7, erg)
    fac = C_KM * t * g_rr / denom
    du_x = tuple(gi * P.mass_a * fac for gi in gk)
    du_w = tuple(-(gi * ma2) * fac / erg for gi in gx)
    du_e7 = torch.where(photon, gt * ma2 * t * g_rr / (-e7), torch.zeros_like(e7))
    frozen = (x1 <= P.r_ns * 1.01) & photon
    return tuple(torch.where(frozen, torch.zeros_like(d), d) for d in du_x + du_w + (du_e7,))


def _prob_nd(P, u, erg):
    """Conversion probability p = 1 - exp(-P_nonAD) at a crossing state
    (megakernel.py:494 of the reference; get_Prob_nonAD -> conversion_prob),
    nondimensionalized, with the three gradient pulls (grad wp, grad |B|,
    grad k.B^i) differentiated by hand.  As in the host function, the metric
    takes its interior branch below r_metric (g^rr, and so the r-derivative
    of sqrt(g^rr) in grad k.B^r), while the local energy's lapse and the
    Christoffel symbols keep the exterior form at every r.  Crossings are
    recorded at r >= 1.01 r_NS, which lies below r_metric when r_NS < 9.9 km."""
    x1, x2, x3, w1, w2, w3, e7 = u
    r = x1
    s_th, c_th = torch.sin(x2), torch.cos(x2)
    s_ph, c_ph = torch.sin(x3), torch.cos(x3)
    g_tt, g_rr, g_thth, g_pp = _metric(P, r, s_th, rs0=P.rs0_full)
    inv_ma = 1.0 / P.mass_a
    kt1, kt2, kt3 = w1 * (erg * inv_ma), w2 * (erg * inv_ma), w3 * (erg * inv_ma)
    wt = torch.abs(e7) * inv_ma / torch.sqrt(torch.clamp(1.0 - P.rs0_full / r, min=1e-10))

    bnorm = P.b0_sign * (P.r_ns / r) ** 3 * 0.5
    br = 2.0 * bnorm * (P.cm * c_th + P.sm * s_th * c_ph)
    bth = bnorm * (P.cm * s_th - P.sm * c_th * c_ph)
    bph = bnorm * P.sm * s_ph
    inv_r = 1.0 / r
    abs_s = torch.abs(s_th)

    # grad wp (wp = sqrt(wp2_scale |bz|), zero inside the star)
    bz = br * c_th - bth * s_th
    wp = torch.sqrt(torch.where(r <= P.r_ns, torch.zeros_like(bz), P.wp2_scale * torch.abs(bz)))
    dwp_fac = torch.where(wp > 0, P.wp2_scale * torch.sign(bz) / (2.0 * wp), torch.zeros_like(wp))
    dmu_wp = (dwp_fac * (-3.0 * bz * inv_r),
              dwp_fac * (-3.0 * bth * c_th - 1.5 * br * s_th),
              dwp_fac * (-3.0 * s_th * c_th * bph))

    # grad |B| (unit dipole)
    bmag = torch.sqrt(br * br + bth * bth + bph * bph)
    dbph_ph = bnorm * P.sm * c_ph
    dmu_b = (-3.0 * bmag * inv_r,
             -1.5 * br * bth / bmag,
             (br * (-2.0 * s_th * bph) + bth * (c_th * bph) + bph * dbph_ph) / bmag)

    # grad of kb = kt1 br sqrt(g_rr) + kt2 bth / r + kt3 bph / (r |sin|)
    sqA = torch.sqrt(g_rr)
    dsqA = 0.5 * (P.rs0_full * inv_r * inv_r) / sqA
    if P.r_ns < P.r_metric:   # d sqrt(g^rr)/dr on the metric's interior branch
        d_rr = _dmetric_dr(P, r, s_th, rs0=P.rs0_full)[1]
        dsqA = torch.where(r < P.r_metric, 0.5 * d_rr / sqA, dsqA)
    inv_rs = inv_r / abs_s
    term1 = (kt1 * (-3.0 * br * inv_r * sqA + br * dsqA)
             + kt2 * (-3.0 * bth * inv_r * inv_r - bth * inv_r * inv_r)
             + kt3 * (-3.0 * bph * inv_r * inv_rs - bph * inv_r * inv_rs),
             kt1 * (-2.0 * bth) * sqA + kt2 * (0.5 * br) * inv_r
             + kt3 * bph * (-c_th * inv_r / (s_th * abs_s)),
             kt1 * (-2.0 * s_th * bph) * sqA + kt2 * (c_th * bph) * inv_r
             + kt3 * dbph_ph * inv_rs)
    kb = kt1 * br * sqA + kt2 * bth * inv_r + kt3 * bph * inv_rs

    bup1 = br * sqA
    bup2 = bth * torch.sqrt(g_thth)
    bup3 = bph * torch.sqrt(g_pp)
    gm = P.gm_full
    cot = c_th / s_th
    g_rrr = -gm / (r * (r - 2.0 * gm))
    g_rtt = -(r - 2.0 * gm)
    g_rpp = -(r - 2.0 * gm) * s_th * s_th
    kmag = torch.sqrt(g_rr * kt1**2 + g_thth * kt2**2 + g_pp * kt3**2)
    ct = kb / (kmag * bmag)
    st2 = torch.clamp(1.0 - ct * ct, min=0.0)
    t2b = (kt1 * bup1 * g_rrr + kt2 * inv_r * bup2 + kt3 * inv_r * bup3,
           kt1 * bup2 * g_rtt + kt3 * cot * bup3 + kt2 * bup1 * inv_r,
           kt1 * bup3 * g_rpp + kt2 * (-s_th * c_th) * bup3 + kt3 * inv_r * bup1
           + kt3 * cot * bup2)
    dmu_ct = tuple((t1 + t2) / (kmag * bmag) - ct * db / bmag
                   for t1, t2, db in zip(term1, t2b, dmu_b))

    wp2 = wp * wp
    wt2 = wt * wt
    pre_f = wp / torch.abs(wt2 * wt2 * wt + ct * ct * wt * (wp2 * wp2 - 2.0 * wp2 * wt2))
    dmu_e = tuple(pre_f * (wt2 * wt2 * st2 * dw - wt2 * ct * wp * (wt2 - wp2) * dc)
                  for dw, dc in zip(dmu_wp, dmu_ct))
    vhat_grad_e = (g_rr * kt1 * dmu_e[0] + g_thth * kt2 * dmu_e[1]
                   + g_pp * kt3 * dmu_e[2]) / kmag
    vloc = torch.sqrt(torch.clamp(wt2 - 1.0, min=1e-12)) / wt
    prefactor = wt2 * wt2 * st2 / (ct * ct * wp2 * (wp2 - 2.0 * wt2) + wt2 * wt2)
    p_nonad = P.prob_scale * prefactor * bmag * bmag / (torch.abs(vhat_grad_e) * vloc)
    return torch.clamp(1.0 - torch.exp(-p_nonad), 0.0, 1.0)


def _hermite(u0, u1, f0, f1, h, tau):
    t2 = tau * tau
    t3 = t2 * tau
    return tuple((2 * t3 - 3 * t2 + 1) * a + (t3 - 2 * t2 + tau) * h * fa
                 + (-2 * t3 + 3 * t2) * b + (t3 - t2) * h * fb
                 for a, b, fa, fb in zip(u0, u1, f0, f1))


def child_birth(P, us, erg, u_draw, p):
    """Torch twin of art::child_birth (csrc/tree_warp.cuh), a child's birth
    at the recorded crossings us [n, 7] (MainRunner.jl:278-305): (the MC
    draw u_draw < p, the birth state [n, 7], the child's Delta_omega).  The
    birth state is the crossing's momenta renormalized onto the axion shell
    at the event energy with the full-NS-mass metric, in place."""
    r_s = torch.clamp(us[:, 0], min=P.r_ns)
    g_tt, g_rr, g_thth, g_pp = _metric(P, r_s, torch.sin(us[:, 1]), rs0=P.rs0_full)
    wsq = g_rr * us[:, 3] ** 2 + g_thth * us[:, 4] ** 2 + g_pp * us[:, 5] ** 2
    et = erg / P.mass_a
    nrm = torch.sqrt(torch.clamp((-g_tt * et * et - 1.0) / (et * et * wsq), min=0.0))
    uc = torch.cat([us[:, 0:3], us[:, 3:6] * nrm[:, None], us[:, 6:7]], dim=1)
    return u_draw < p, uc, us[:, 6] / erg


def rare_crossing(us, erg, mass_eff):
    """The rare-fail guard (MainRunner.jl:213-224) at crossing states us
    [n, 7]: a Cartesian proper-velocity component above 1 (the twin of
    art::rare_velocity)."""
    v = celerity_to_cart_vel(us[:, 0:3], us[:, 3:6] * erg[:, None], mass_eff)
    return (torch.abs(v) > 1.0).any(dim=1)


def sph_point(u):
    """The Cartesian point of states u [n, 7], as the kernels compute a
    segment's start point for the start-point rejection."""
    st, ct = torch.sin(u[:, 1]), torch.cos(u[:, 1])
    return torch.stack([u[:, 0] * st * torch.cos(u[:, 2]), u[:, 0] * st * torch.sin(u[:, 2]),
                        u[:, 0] * ct], dim=1)


# ---------------------------------------------------------------------------
# probe: the device functions one at a time, for the card-side checks
# ---------------------------------------------------------------------------

PROBE_FUNCS = ("metric", "dipole", "omega_p", "condition", "rhs", "prob", "hermite")
PROBE_OUT = {"metric": 4, "dipole": 3, "omega_p": 1, "condition": 1, "rhs": 7,
             "prob": 1, "hermite": 7}


def probe_plain(P, which: str, u, lnt, erg, is_ph, b0_abs):
    """Torch twin outputs for `probe`: u [B, 7] (for hermite [B, 30]:
    u0, u1, f0, f1, h, tau), lnt/erg/is_ph [B].  Returns [B, PROBE_OUT]."""
    c = tuple(u[:, i] for i in range(u.shape[1]))
    if which == "metric":
        out = _metric(P, c[0], torch.sin(c[1]))
    elif which == "dipole":
        out = _dipole_unit(P, c[0], torch.cos(c[1]), torch.sin(c[1]),
                           torch.cos(c[2]), torch.sin(c[2]), torch.exp(lnt))
    elif which == "omega_p":
        br, bth, _ = _dipole_unit(P, c[0], torch.cos(c[1]), torch.sin(c[1]),
                                  torch.cos(c[2]), torch.sin(c[2]), torch.exp(lnt))
        out = (_omega_p(P, br, bth, torch.cos(c[1]), torch.sin(c[1]), c[0], b0_abs),)
    elif which == "condition":
        out = (_condition(P, c[:7], lnt),)
    elif which == "rhs":
        out = _rhs(P, c[:7], lnt, erg, is_ph)
    elif which == "prob":
        out = (_prob_nd(P, c[:7], erg),)
    elif which == "hermite":
        out = _hermite(c[0:7], c[7:14], c[14:21], c[21:28], c[28], c[29])
    else:
        raise ValueError(which)
    return torch.stack(out, dim=1)


def probe(P, which: str, u, lnt, erg, is_ph, b0_abs):
    """Evaluate one device function on the card (csrc/megakernel.cu
    art_probe) at [B] states; CPU tensors run the torch twin."""
    if u.device.type == "cpu":
        return probe_plain(P, which, u, lnt, erg, is_ph, b0_abs)
    lib = cuda_lib.lib()
    B = u.shape[0]
    width = 30 if which == "hermite" else 7
    f64 = torch.float64
    for t, name, shape in ((u, "u", (B, width)), (lnt, "lnt", (B,)), (erg, "erg", (B,)),
                           (is_ph, "is_ph", (B,))):
        cuda_lib.require(t, name, f64, shape)
    out = torch.empty((B, PROBE_OUT[which]), dtype=f64, device=u.device)
    code = lib.art_probe(PROBE_FUNCS.index(which), u.data_ptr(), lnt.data_ptr(),
                         erg.data_ptr(), is_ph.data_ptr(), out.data_ptr(), B,
                         float(b0_abs), P, cuda_lib.stream_ptr(u))
    cuda_lib.check(code, f"probe {which} launch")
    cuda_lib.LAUNCHES["probe"] += 1
    return out


def bind(lib):
    p = ctypes.c_void_p
    lib.art_probe.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int,
                              ctypes.c_double, MegaParams, p]
    lib.art_probe.restype = ctypes.c_int
    lib.art_megakernel.argtypes = [p, p, ctypes.c_int, MegaParams,
                                   p, p, p, p, p, p, p, p, p]
    lib.art_megakernel.restype = ctypes.c_int
    lib.art_megakernel_chain.argtypes = [p, p, p, ctypes.c_int, MegaParams,
                                         p, p, p, p, p, p, p, p, p, p]
    lib.art_megakernel_chain.restype = ctypes.c_int
    lib.art_megakernel_resident_warps.argtypes = [MegaParams, ctypes.POINTER(ctypes.c_int)]
    lib.art_megakernel_resident_warps.restype = ctypes.c_int


def resident_warps(P: MegaParams, device: torch.device) -> int:
    """The warps K2's instantiation for P's scene keeps resident at once on
    the card: blocks per SM at its registers (CUDA occupancy) x SMs x 4.  A
    launch of B rays runs min(B, this) warps."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        cuda_lib.check(cuda_lib.lib().art_megakernel_resident_warps(P, ctypes.byref(out)),
                       "megakernel occupancy")
    return out.value


# ---------------------------------------------------------------------------
# integrate_mega: kernel wrapper and plain version
# ---------------------------------------------------------------------------


def _codes(res, lnt1):
    """K2's end codes of a pool run (1 end, 2 NS, 3 crossing cap, 4 step
    cap, 5 stalled; 0 a launch with nothing to integrate)."""
    code = torch.zeros(res.u.shape[0], dtype=torch.float64, device=res.u.device)
    reached = (~res.cut_short & ~res.ns_hit & (res.lnt >= lnt1 - 1e-14)
               & (res.steps > 0))
    for flag, val in ((res.stalled, 5.0), (res.maxed, 4.0), (reached, 1.0),
                      (res.ns_hit, 2.0), (res.cut_short, 3.0)):
        code = torch.where(flag, torch.full_like(code, val), code)
    return code


def _outputs_from_pool(res, lnt0, lnt1, erg, P, S, with_prob):
    """integrate_mega's output tuple from a pool run."""
    B = res.u.shape[0]
    code = _codes(res, lnt1)
    lnt_mid = 0.5 * (lnt0 + lnt1)
    save_mid = torch.where((lnt_mid <= res.lnt)[:, None], res.save_u[:, 1],
                           torch.zeros_like(res.save_u[:, 1]))
    cru = res.cross_u[:, :S]
    crlnt = res.cross_lnt[:, :S]
    pcx = torch.zeros((B, S), dtype=torch.float64, device=res.u.device)
    if with_prob:
        used = torch.arange(S, device=res.u.device)[None, :] < res.n_cross[:, None]
        if bool(used.any()):
            bi, si = used.nonzero(as_tuple=True)
            st = tuple(cru[bi, si, i] for i in range(7))
            pcx[bi, si] = _prob_nd(P, st, erg[bi])
    f = lambda a: a.to(torch.float64)
    return (res.u, res.lnt, f(res.steps), code, f(res.n_cross), cru, crlnt, save_mid,
            pcx, torch.zeros_like(code), None, f(res.steps))


def save_grid(lnt0, lnt1):
    """K2's ntimes=3 save grid [B, 3]: start, midpoint, end."""
    frac = torch.tensor([0.0, 0.5, 1.0], dtype=lnt0.dtype, device=lnt0.device)
    return lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]


def pool_run(u0, lnt0, lnt1, erg, x0_cart, sc: Scene, cfg: NumericsConfig, *,
             max_crossings: int, is_photon, species: str, save_lnt=None):
    """The pool engine on K2's inputs (save grid: start, midpoint, end, or
    `save_lnt`); returns its PoolResult, which also counts each ray's
    bisected roots."""
    B = u0.shape[0]
    if save_lnt is None:
        save_lnt = save_grid(lnt0, lnt1)
    mass_eff = sc.mass_ns_eff
    pool_cfg = dataclasses.replace(cfg, max_crossings=max_crossings, n_save=3)
    return integrate_pool(
        make_rhs(sc, mass_eff, 0.0, species),
        lambda u, l: crossing_condition(u, l, sc, mass_eff), u0, lnt0, lnt1,
        {"erg": erg, "is_photon": is_photon}, pool_cfg, save_lnt=save_lnt,
        kill_at_surface=is_photon, r_ns=sc.r_ns, x0_cart=x0_cart,
        max_crossings=torch.full((B,), max_crossings, dtype=torch.int64, device=u0.device))


def _in_dtype(out, dtype):
    """integrate_mega's output tuple in the caller's dtype."""
    return tuple(None if t is None else t.to(dtype) for t in out)


def integrate_mega_plain(u0, lnt0, lnt1, erg, x0_cart, sc: Scene, cfg: NumericsConfig,
                         *, max_crossings: int = 1, is_photon=None,
                         species: str = "photon", with_prob: bool = False,
                         chain_cap=None, uniforms=None):
    """K2's plain version: the pool engine (same DP5 tableau, controller and
    event semantics; dense scan on every step) followed by the torch twin of
    _prob_nd at the recorded crossings.  Same output tuple as
    integrate_mega, at the same boundary: f64 inside, whatever the caller's
    dtype (compute_dtype does not apply: the kernel has one precision), the
    outputs in u0's dtype.  n_fine counts every step, since the pool always
    scans densely.  With chain_cap, the chain instantiation's plain version
    (_chain_plain)."""
    B = u0.shape[0]
    S = int(max_crossings)
    if is_photon is None:
        is_photon = torch.ones(B, dtype=torch.bool, device=u0.device)
    f64 = torch.float64
    u0_, lnt0, lnt1, erg, x0_cart = (a.to(f64) for a in (u0, lnt0, lnt1, erg, x0_cart))
    if chain_cap is not None:
        check_chain(sc, species)
        P = mega_params(sc, cfg, max_crossings=S, species=species, with_prob=True)
        out = _chain_plain(P, u0_, lnt0, lnt1, erg, x0_cart, sc, cfg, S, is_photon, species,
                           chain_cap.to(f64), uniforms.to(f64))
        return _in_dtype(out, u0.dtype)
    P = mega_params(sc, cfg, max_crossings=S, species=species, with_prob=with_prob)
    res = pool_run(u0_, lnt0, lnt1, erg, x0_cart, sc, cfg, max_crossings=S,
                   is_photon=is_photon, species=species)
    out = _outputs_from_pool(res, lnt0, lnt1, erg, P, S, bool(P.with_prob))
    return _in_dtype(out[:10] + (is_photon.to(f64),) + out[11:], u0.dtype)


def check_chain(sc: Scene, species: str):
    """Raise on a chain launch K2's chain instantiation does not run: it
    draws against the in-kernel probability (can_prob's scenes) and flips a
    ray's species, so it needs species "mixed"."""
    if not can_prob(sc):
        raise ValueError("the in-kernel MC chain needs the in-kernel probability: the "
                         "anisotropic Melrose, curved-space scene without boundary layer")
    if species != "mixed":
        raise ValueError(f"the in-kernel MC chain flips species: species 'mixed', got {species!r}")


def _chain_plain(P, u0, lnt0, lnt1, erg, x0_cart, sc, cfg, S, is_photon, species, cap, uni):
    """The chain instantiation's plain version, f64: rays with cap 0 run the
    pool at S crossings; the chain rays run segment by segment, each a pool
    run at one crossing on the launch's save grid.  After a segment that
    recorded a crossing, a ray whose crossing is not rare (rare_crossing)
    and that has fewer than its cap recorded is born again at the crossing
    (child_birth, drawing uni[ray, slot] against the crossing's _prob_nd)
    and runs its next segment from there, its start point the crossing's.
    Returns integrate_mega's output tuple."""
    B = u0.shape[0]
    dev, f64 = u0.device, torch.float64
    uf, lntf = u0.clone(), lnt0.clone()
    steps, code, n_cross = (torch.zeros(B, dtype=f64, device=dev) for _ in range(3))
    cru = torch.zeros((B, S, 7), dtype=f64, device=dev)
    crlnt = torch.zeros((B, S), dtype=f64, device=dev)
    pcx = torch.zeros((B, S), dtype=f64, device=dev)
    save_mid = torch.zeros((B, 7), dtype=f64, device=dev)
    nodes = torch.zeros(B, dtype=f64, device=dev)
    is_ph = is_photon.to(f64).clone()
    grid = save_grid(lnt0, lnt1)

    multi = (cap < 0.5).nonzero().squeeze(1)
    if multi.numel():
        res = pool_run(u0[multi], lnt0[multi], lnt1[multi], erg[multi], x0_cart[multi], sc,
                       cfg, max_crossings=S, is_photon=is_photon[multi], species=species)
        out = _outputs_from_pool(res, lnt0[multi], lnt1[multi], erg[multi], P, S, True)
        for dst, src in zip((uf, lntf, steps, code, n_cross, cru, crlnt, save_mid, pcx),
                            out[:9]):
            dst[multi] = src

    lanes = (cap >= 0.5).nonzero().squeeze(1)
    cap_r = torch.clamp(torch.round(cap), max=S)
    u, lnt, x0, ph = u0[lanes], lnt0[lanes], x0_cart[lanes], is_photon[lanes].clone()
    while lanes.numel():
        res = pool_run(u, lnt, lnt1[lanes], erg[lanes], x0, sc, cfg, max_crossings=1,
                       is_photon=ph, species=species, save_lnt=grid[lanes])
        spanned = (grid[lanes, 1] > lnt) & (grid[lanes, 1] <= res.lnt)
        save_mid[lanes[spanned]] = res.save_u[spanned, 1]
        steps[lanes] += res.steps.to(f64)
        crossed = res.n_cross >= 1
        ci = crossed.nonzero().squeeze(1)
        lc, slot = lanes[ci], n_cross[lanes[ci]].long()
        us = res.cross_u[ci, 0]
        p = _prob_nd(P, us.unbind(1), erg[lc])
        cru[lc, slot] = us
        crlnt[lc, slot] = res.cross_lnt[ci, 0]
        pcx[lc, slot] = p
        n_cross[lc] += 1.0
        go = torch.zeros_like(crossed)
        go[ci] = (n_cross[lc] < cap_r[lc]) & ~rare_crossing(us, erg[lc], sc.mass_ns_eff)
        end = (~go).nonzero().squeeze(1)
        le = lanes[end]
        uf[le], lntf[le], code[le] = res.u[end], res.lnt[end], _codes(res, lnt1[lanes])[end]
        is_ph[le] = ph[end].to(f64)
        gi = go.nonzero().squeeze(1)
        lg = lanes[gi]
        draw = uni[lg, n_cross[lg].long() - 1]
        conv, uc, _ = child_birth(P, res.u[gi], erg[lg], draw, pcx[lg, n_cross[lg].long() - 1])
        nodes[lg] += 1.0
        u, lnt, x0 = uc, res.lnt[gi], sph_point(uc)
        ph = torch.where(conv, ~ph[gi], ph[gi])
        lanes = lg
    save_mid = torch.where((0.5 * (lnt0 + lnt1) <= lntf)[:, None], save_mid,
                           torch.zeros_like(save_mid))
    return (uf, lntf, steps, code, n_cross, cru, crlnt, save_mid, pcx, nodes, is_ph, steps)


def integrate_mega(u0, lnt0, lnt1, erg, x0_cart, sc: Scene, cfg: NumericsConfig, *,
                   max_crossings: int = 1, is_photon=None, species: str = "photon",
                   with_prob: bool = False, chain_cap=None, uniforms=None):
    """Run K2 over a [B, 7] state batch, min(B, resident warps) warps
    pulling rays from a queue.  Returns (u_final [B,7],
    lnt_final [B], steps [B], code [B] (1 end, 2 NS, 3 crossing cap,
    4 step cap, 5 stalled), n_cross [B], cross_u [B,S,7], cross_lnt [B,S],
    save_mid [B,7] (0 where the midpoint was never spanned), pcx [B,S],
    chain_nodes [B], is_ph [B], n_fine [B]), in u0's dtype: the
    inputs go up to f64 and the kernel runs in f64 whatever the caller's
    dtype (--precision f32 gives f32 in and out).

    chain_cap [B] (0 = off) with uniforms [B, S] runs K2's chain
    instantiation (the reference's with_chain; csrc/megakernel.cu run_ray):
    a ray with cap c > 0 continues its pure-MC chain through up to c
    recorded crossings, drawing uniforms[ray, slot] at crossing `slot`;
    chain_nodes counts its in-kernel restarts and is_ph is its final
    species.  It implies with_prob, needs species "mixed" and a scene
    can_prob covers.  Without it chain_nodes is 0 and is_ph the input
    species.  CPU tensors run integrate_mega_plain."""
    if u0.device.type == "cpu":
        return integrate_mega_plain(u0, lnt0, lnt1, erg, x0_cart, sc, cfg,
                                    max_crossings=max_crossings, is_photon=is_photon,
                                    species=species, with_prob=with_prob,
                                    chain_cap=chain_cap, uniforms=uniforms)
    S = int(max_crossings)
    check_supported(sc, cfg, S)
    chain = chain_cap is not None
    if chain:
        check_chain(sc, species)
        with_prob = True
    lib = cuda_lib.lib()
    B = u0.shape[0]
    dev = u0.device
    f64 = torch.float64
    if is_photon is None:
        is_photon = torch.ones(B, dtype=torch.bool, device=dev)
    col7 = chain_cap if chain else torch.zeros_like(erg)
    aux = torch.stack([a.to(f64) for a in (lnt0, lnt1, erg, x0_cart[:, 0], x0_cart[:, 1],
                                           x0_cart[:, 2], is_photon, col7)],
                      dim=1).contiguous()
    u_in = u0.to(f64).contiguous()
    cuda_lib.require(u_in, "u0", f64, (B, 7))
    cuda_lib.require(aux, "aux", f64, (B, 8))
    P = mega_params(sc, cfg, max_crossings=S, species=species, with_prob=with_prob)
    uf = torch.empty((B, 7), dtype=f64, device=dev)
    lntf = torch.empty(B, dtype=f64, device=dev)
    diag = torch.empty((B, 4), dtype=f64, device=dev)
    cru = torch.empty((B, S, 7), dtype=f64, device=dev)
    crlnt = torch.empty((B, S), dtype=f64, device=dev)
    save_mid = torch.empty((B, 7), dtype=f64, device=dev)
    pcx = torch.empty((B, S), dtype=f64, device=dev)
    head = torch.zeros(1, dtype=torch.int32, device=dev)   # the ray queue's head
    if chain:
        uni = uniforms.to(f64).contiguous()
        cuda_lib.require(uni, "uniforms", f64, (B, S))
        chain_out = torch.empty((B, 2), dtype=f64, device=dev)
        code = lib.art_megakernel_chain(
            u_in.data_ptr(), aux.data_ptr(), uni.data_ptr(), B, P, uf.data_ptr(),
            lntf.data_ptr(), diag.data_ptr(), cru.data_ptr(), crlnt.data_ptr(),
            save_mid.data_ptr(), pcx.data_ptr(), chain_out.data_ptr(), head.data_ptr(),
            cuda_lib.stream_ptr(u_in))
        cuda_lib.check(code, "megakernel chain launch")
        cuda_lib.LAUNCHES["megakernel_chain"] += 1
        nodes, is_ph_out = chain_out[:, 0], chain_out[:, 1]
    else:
        code = lib.art_megakernel(
            u_in.data_ptr(), aux.data_ptr(), B, P, uf.data_ptr(), lntf.data_ptr(),
            diag.data_ptr(), cru.data_ptr(), crlnt.data_ptr(), save_mid.data_ptr(),
            pcx.data_ptr(), head.data_ptr(), cuda_lib.stream_ptr(u_in))
        cuda_lib.check(code, "megakernel launch")
        cuda_lib.LAUNCHES["megakernel"] += 1
        nodes, is_ph_out = torch.zeros_like(lntf), is_photon.to(f64)
    return _in_dtype((uf, lntf, diag[:, 0], diag[:, 1], diag[:, 2], cru, crlnt, save_mid, pcx,
                      nodes, is_ph_out, diag[:, 3]), u0.dtype)


def propagate_mega(x0_cart, k0_cart, sc: Scene, cfg: NumericsConfig, *, erg, delta_w,
                   lnt0, lnt1, is_photon, max_crossings: int = 1,
                   species: str = "mixed", with_prob: bool = False, chain_cap=None,
                   uniforms=None) -> PropagateResult:
    """PropagateResult around integrate_mega (the reference's propagate_mega);
    the ntimes=3 trajectory is (launch point, midpoint, endpoint).
    chain_cap and uniforms run the in-kernel MC chain where can_prob covers
    the scene (elsewhere they are ignored, as in the reference); the result
    then carries chain_nodes and final_is_ph."""
    mass_eff = sc.mass_ns_eff
    u0 = launch_state(x0_cart, k0_cart, sc, erg, delta_w)
    chain = chain_cap is not None and can_prob(sc)
    with_prob = (bool(with_prob) and can_prob(sc)) or chain
    (uf, lntf, steps, code, n_cross, cru, crlnt, save_mid, pcx, nodes, is_ph_out,
     _nfine) = integrate_mega(u0, lnt0, lnt1, erg, x0_cart, sc, cfg,
                              max_crossings=max_crossings, is_photon=is_photon,
                              species=species, with_prob=with_prob,
                              chain_cap=chain_cap if chain else None,
                              uniforms=uniforms if chain else None)

    def state_to_cart(uu):
        x_sph = uu[:, 0:3]
        a = lapse_interior(x_sph[:, 0], mass_eff, sc.r_ns)
        return sph_to_cart(x_sph), celerity_to_cart_vel(x_sph, uu[:, 3:6] * erg[:, None],
                                                        mass_eff, a=a)

    x_end, v_end = state_to_cart(uf)
    save_mid = torch.where((torch.abs(save_mid[:, 0]) > 0)[:, None], save_mid, uf)
    x_mid, v_mid = state_to_cart(save_mid)
    _, v_start = state_to_cart(u0)
    cross_sph = cru[..., 0:3]
    frac = torch.tensor([0.0, 0.5, 1.0], dtype=u0.dtype, device=u0.device)
    return PropagateResult(
        traj=torch.stack([x0_cart, x_mid, x_end], dim=1),
        mom=torch.stack([v_start, v_mid, v_end], dim=1),
        erg=torch.stack([erg * delta_w, save_mid[:, 6], uf[:, 6]], dim=1),
        fail=torch.where(uf[:, 0] <= sc.r_ns * 1.01, 0.0, 1.0).to(uf.dtype),
        cut_short=code == 3.0,
        xc=sph_to_cart(cross_sph),
        kc=celerity_to_cart_vel(cross_sph, cru[..., 3:6] * erg[:, None, None], mass_eff),
        tc=torch.exp(crlnt), dwc=cru[..., 6] / erg[:, None],
        n_cross=n_cross.to(torch.int64),
        times=lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :],
        final_lnt=lntf, ns_hit=code == 2.0, maxed=(code == 4.0) | (code == 5.0),
        steps=steps.to(torch.int64), pcx=pcx if with_prob else None,
        chain_nodes=nodes.to(torch.int64) if chain else None,
        final_is_ph=is_ph_out > 0.5 if chain else None)
