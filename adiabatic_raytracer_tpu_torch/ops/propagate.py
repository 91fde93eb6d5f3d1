"""Ray propagation: physics RHS, crossing condition, launch/result transforms.

Port of adiabatic_raytracer_tpu/ops/propagate.py (RayTracer.jl:71-123,
171-452).  State per ray: u = [r, theta, phi, w_r, w_th, w_ph, e7] with the
covariant celerity normalized by erg_inf and e7 = erg_inf * Delta_omega.

The RHS differentiates the Hamiltonians with torch autograd: in f64 in
reverse mode (the rays are independent, so the gradient of the batch sum is
the per-ray gradient: one forward and one backward pass per evaluation, as
the reference's jax.grad); in f32 in forward mode, one tangent per input
component, as the reference's compute_dtype="f32" path does
(propagate.py:136-141 there).  The reference differentiates an f32 state at
compute_dtype "state" (its --precision f32) in reverse mode, which on XLA's
CPU loses up to 5.4% of dH/dx; the port takes forward mode for every f32
evaluation.

compute_dtype="f32" (NumericsConfig.compute_dtype) evaluates the RHS and the
crossing condition in f32 on an f32 copy of the scene (`cast_scene`) while
the caller's integration state keeps its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

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


def cast_scene(sc: Scene, dtype) -> Scene:
    """The scene with its numbers rounded to `dtype` (f32: the reference's
    _cast_tree(sc, float32); f64: unchanged).  They stay python floats, which
    torch applies to f32 tensors as those f32 values."""
    if dtype != torch.float32:
        return sc
    r = lambda v: float(np.float32(v))
    return dataclasses.replace(sc, **{
        f.name: tuple(r(x) for x in v) if isinstance(v, tuple) else r(v)
        for f in dataclasses.fields(sc)
        if isinstance(v := getattr(sc, f.name), (tuple, float, int)) and not isinstance(v, bool)})


def physics_dtype(compute_dtype: str, state_dtype):
    """The dtype the physics is evaluated in: f32 at compute_dtype "f32",
    else the state's (the reference's NumericsConfig.compute_dtype)."""
    return torch.float32 if compute_dtype == "f32" else state_dtype


def to_physics(compute_dtype: str, sc: Scene, *tensors):
    """(scene, *tensors) as the physics takes them: at compute_dtype "f32"
    the f32 scene and f32 tensors, else unchanged."""
    if compute_dtype != "f32":
        return (sc, *tensors)
    return (cast_scene(sc, torch.float32), *(t.float() for t in tensors))


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


def condition_fn(sc: Scene, mass_eff, compute_dtype: str = "state"):
    """cond(u, lnt) -> the crossing condition in the caller's dtype,
    evaluated at compute_dtype="f32" in f32 on the f32 scene (the pool's
    cond_fn, propagate.py:213-222 of the reference)."""
    if compute_dtype != "f32":
        return lambda u, lnt: crossing_condition(u, lnt, sc, mass_eff)
    sc_c, m_c = cast_scene(sc, torch.float32), float(np.float32(mass_eff))
    return lambda u, lnt: crossing_condition(u.float(), lnt.float(), sc_c, m_c).to(u.dtype)


class _ZeroTangentNumbers(torch.overrides.TorchFunctionMode):
    """Inside a forward-AD pass, the python numbers of tensor arithmetic as
    0-dim duals with a zero tangent (one per value and dtype).  torch gives a
    number an undefined tangent, and its forward formulas then run the op
    through a zero-tensor path ~20x slower on the CPU; the values are the
    same, the number taking the tensor's dtype either way.  It exists for
    the CPU (the tests' time): the card's main path runs no f32 RHS, so it
    can go once torch's forward AD takes numbers at full speed."""

    _OPS = frozenset(("mul", "__mul__", "__rmul__", "add", "__add__", "__radd__", "sub",
                      "__sub__", "__rsub__", "div", "__truediv__", "__rtruediv__", "__rdiv__"))

    def __init__(self):
        super().__init__()
        self._consts = {}

    def _const(self, v, ref):
        key = (v, ref.dtype, ref.device)
        if key not in self._consts:
            zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
            self._consts[key] = fwAD.make_dual(torch.full((), v, dtype=ref.dtype,
                                                          device=ref.device), zero)
        return self._consts[key]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if len(args) == 2 and getattr(func, "__name__", None) in self._OPS:
            a, b = args
            if type(b) in (float, int):
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    args = (a, self._const(b, a))
            elif type(a) in (float, int):
                if isinstance(b, torch.Tensor) and b.is_floating_point():
                    args = (self._const(a, b), b)
        return func(*args, **(kwargs or {}))


def _jvp_rows(f, args, tangents, fixed=()):
    """Forward-mode derivatives of a per-row function f(*args, *fixed) -> [B]
    along T tangents at once (jax.jacfwd): every argument [B, ...] is
    repeated T times along the rows, so one forward-AD pass over T*B rows
    gives all T directional derivatives, [T, B].  tangents[i] is the
    [T, B, ...] tangent of args[i]; `fixed` are held constant (zero
    tangents).  In f32, forward tangents stay O(1) where reverse-mode
    cotangents through the ~1e13 B-field intermediates lose the gradient."""
    T = tangents[0].shape[0]
    rep = lambda a: a.repeat(T, *([1] * (a.dim() - 1)))
    primals = tuple(rep(a) for a in args)
    tans = tuple(t.reshape(p.shape) for p, t in zip(primals, tangents))
    with fwAD.dual_level(), _ZeroTangentNumbers():
        held = tuple(fwAD.make_dual(a, torch.zeros_like(a)) if a.is_floating_point() else a
                     for a in map(rep, fixed))
        out = f(*(fwAD.make_dual(p, t) for p, t in zip(primals, tans)), *held)
        return fwAD.unpack_dual(out).tangent.reshape(T, -1)


def make_rhs(sc: Scene, mass_eff, time0, species: str, compute_dtype: str = "state"):
    """Hamilton's equations in log-time (func!/func_axion!,
    RayTracer.jl:71-123).  species 'photon' | 'axion' | 'mixed'.  Quirk kept
    from the reference: the photon's spatial gradients exclude the
    boundary-layer plasma term, its time derivative includes it
    (RayTracer.jl:84-88).  compute_dtype="f32": the physics in f32 on the
    f32 scene, the result in the state's dtype (make_rhs of the reference).
    Evaluated in f32, the derivatives are forward-mode (_jvp_rows)."""
    f32 = compute_dtype == "f32"
    if f32:
        sc = cast_scene(sc, torch.float32)
        mass_eff, time0 = float(np.float32(mass_eff)), float(np.float32(time0))
    bndry = float(sc.bndry_lyr) > 0.0

    def h_spatial(z, tt, e7, erg, is_photon):
        xx, kk = z[:, 0:3], z[:, 3:6]
        if species == "axion":
            return hamiltonian_axion(xx, kk, erg, mass_eff)
        hp = hamiltonian_photon(xx, kk, tt, -e7, sc, mass_eff, bndry_lyr=-1.0)
        if species == "photon":
            return hp
        return torch.where(is_photon, hp, hamiltonian_axion(xx, kk, erg, mass_eff))

    def grads_forward(x, ks, tt, e7, erg, is_photon):
        """(dH/dz [B, 6], dH/dt [B] or None), forward mode: tangents 0-5 the
        components of z = (x, k), tangent 6 the time, which the spatial
        Hamiltonian shares with dH/dt unless a boundary layer adds its term
        to dH/dt alone (then a pass of its own)."""
        z = torch.cat([x, ks], dim=1)
        with_t = species != "axion" and not bndry
        n = 7 if with_t else 6
        eye = torch.eye(n, dtype=z.dtype, device=z.device)[:, None, :].expand(n, z.shape[0], n)
        if with_t:
            d = _jvp_rows(h_spatial, (z, tt), (eye[..., :6], eye[..., 6]), (e7, erg, is_photon))
        else:
            d = _jvp_rows(h_spatial, (z,), (eye,), (tt, e7, erg, is_photon))
        dh_dt = d[6] if with_t else None
        if species != "axion" and bndry:
            dh_dt = _jvp_rows(lambda t_: hamiltonian_photon(x, ks, t_, -e7, sc, mass_eff,
                                                            bndry_lyr=sc.bndry_lyr),
                              (tt,), (torch.ones_like(tt)[None],))[0]
        return d[:6].T, dh_dt

    def grads_reverse(x, ks, tt, e7, erg, is_photon):
        dh_dt = None
        with torch.enable_grad():
            z = torch.cat([x, ks], dim=1).detach().requires_grad_(True)
            tt = tt.detach().requires_grad_(species != "axion" and not bndry)
            h = h_spatial(z, tt, e7, erg, is_photon)
            leaves = [z, tt] if tt.requires_grad else [z]
            grads = torch.autograd.grad(h.sum(), leaves, allow_unused=True)
            if species != "axion" and bndry:
                ttb = tt.detach().requires_grad_(True)
                hb = hamiltonian_photon(x, ks, ttb, -e7, sc, mass_eff, bndry_lyr=sc.bndry_lyr)
                dh_dt = torch.autograd.grad(hb.sum(), ttb)[0]
            elif species != "axion":
                dh_dt = grads[1] if grads[1] is not None else torch.zeros_like(tt)
        return grads[0], dh_dt

    def rhs(u, lnt, ray_args):
        out_dtype = u.dtype
        erg = ray_args["erg"]
        is_photon = ray_args["is_photon"]
        if f32:    # the scene was cast once above (to_physics per call would recast it)
            u, lnt, erg = u.float(), lnt.float(), erg.float()
        t = torch.exp(lnt)
        x = u[:, 0:3]
        e7 = u[:, 6]
        g_rr = metric_inverse(x, mass_eff)[1]
        grads = grads_forward if u.dtype == torch.float32 else grads_reverse
        gz, dh_dt = grads(x, u[:, 3:6] * erg[:, None], time0 + t, e7, erg, is_photon)
        dh_dx, dh_dk = gz[:, 0:3], gz[:, 3:6]
        fac_t = t[:, None]
        grr = g_rr[:, None]
        ergc = erg[:, None]
        du_x_ax = dh_dk * C_KM * fac_t * grr / ergc
        du_w_ax = -dh_dx * C_KM * fac_t * grr / ergc / ergc
        if species == "axion":
            return torch.cat([du_x_ax, du_w_ax, torch.zeros_like(u[:, 6:7])],
                             dim=1).to(out_dtype)
        m_e7 = -e7[:, None]
        du_x_ph = dh_dk * C_KM * fac_t * grr / m_e7
        du_w_ph = -dh_dx * C_KM * fac_t * grr / m_e7 / ergc
        du_e7_ph = dh_dt * t * g_rr / (-e7)
        frozen = (u[:, 0] <= sc.r_ns * 1.01)[:, None]
        du_ph = torch.cat([du_x_ph, du_w_ph, du_e7_ph[:, None]], dim=1)
        du_ph = torch.where(frozen, torch.zeros_like(du_ph), du_ph)
        if species == "photon":
            return du_ph.to(out_dtype)
        du_ax = torch.cat([du_x_ax, du_w_ax, torch.zeros_like(u[:, 6:7])], dim=1)
        return torch.where(is_photon[:, None], du_ph, du_ax).to(out_dtype)

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
    """Propagate rays with the pool engine; inputs [B, ...] tensors in the
    state dtype (f64, or f32 under --precision f32)."""
    mass_eff = sc.mass_ns_eff
    u0 = launch_state(x0_cart, k0_cart, sc, erg, delta_w, time0)
    frac = torch.linspace(0.0, 1.0, cfg.n_save, dtype=u0.dtype, device=u0.device)
    save_lnt = lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]
    rhs = make_rhs(sc, mass_eff, time0, species, cfg.compute_dtype)
    res = integrate_pool(
        rhs, condition_fn(sc, mass_eff, cfg.compute_dtype), u0, lnt0, lnt1,
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
