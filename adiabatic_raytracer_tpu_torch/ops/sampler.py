"""Conversion-surface Monte-Carlo sampler.

Port of adiabatic_raytracer_tpu/ops/sampler.py (find_samples_new,
RayTracer.jl:1480-1653): draw a disk point and direction, evaluate the
thick-surface level-crossing condition on a dense grid along the straight
line, bisect the sign changes, and draw a crossing index.  The draws use the
threefry stream of utils/rng.py, so a key gives the same events as the JAX
sampler.  Batched: every function works on [B, ...] tensors directly.

The dense line scan is the sampler's hot loop.  line_engine="kernel" routes
it through ops/line_scan.line_scan (the K1 CUDA kernel on a CUDA tensor, its
plain f32 version on a CPU tensor); line_engine="plain" evaluates
_line_condition on the grid in the compute dtype.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW
from adiabatic_raytracer_tpu_torch.models.magnetosphere import omega_p_cart
from adiabatic_raytracer_tpu_torch.models.metric import metric_inverse, schwarzschild_radius
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_par
from adiabatic_raytracer_tpu_torch.utils import rng

MAX_LINE_CROSSINGS = 16


class SampleResult(NamedTuple):
    success: Any    # [B] bool
    xpos: Any       # [B, 3] selected crossing position (Cartesian)
    r_disk: Any     # [B] disk radius drawn
    weight: Any     # [B] number of accepted crossings along the line
    v_loc: Any      # [B, 3] local velocity [c]
    v_ifty: Any     # [B, 3] asymptotic velocity [c]
    erg_inf: Any    # [B] energy at infinity [eV]


def _sph_of(p):
    rr = torch.sqrt(torch.sum(p * p, dim=-1))
    x_sph = torch.stack([rr, torch.arccos(p[..., 2] / rr),
                         torch.atan2(p[..., 1], p[..., 0])], dim=-1)
    return rr, x_sph


def _line_condition(p, vvec_loc, erg_inf, sc: Scene, mass_ns, thick: bool = True):
    """Crossing condition at Cartesian points p [..., 3] (RayTracer.jl:
    1547-1583); vvec_loc [..., 3] and erg_inf [...] broadcast against p.
    The momentum renormalized onto the axion shell points along the
    *velocity* direction vvec_loc."""
    if not thick:
        wp = omega_p_cart(p, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                          mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
        return torch.log(wp) - math.log(sc.mass_a)

    rr, x_sph = _sph_of(p)
    sin_theta = torch.sqrt(torch.clamp(1.0 - (p[..., 2] / rr) ** 2, min=1e-30))
    r_s0 = schwarzschild_radius(mass_ns)
    aa = torch.where(rr < sc.r_ns, torch.ones_like(rr), 1.0 - r_s0 / rr)

    dr_dt = torch.sum(p * vvec_loc, dim=-1) / rr
    v_th = (p[..., 2] * dr_dt - rr * vvec_loc[..., 2]) / (rr * sin_theta)
    v_ph = (-p[..., 1] * vvec_loc[..., 0] + p[..., 0] * vvec_loc[..., 1]) / (rr * sin_theta)
    w = torch.stack([dr_dt / torch.sqrt(aa), v_th * rr, v_ph * (rr * sin_theta)],
                    dim=-1) / aa[..., None]

    g_tt, g_rr, g_thth, g_pp = metric_inverse(x_sph, mass_ns)
    wsq = g_rr * w[..., 0] ** 2 + g_thth * w[..., 1] ** 2 + g_pp * w[..., 2] ** 2
    nrm_sq = (-(erg_inf**2) * g_tt - sc.mass_a**2) / wsq
    w = w * torch.sqrt(nrm_sq)[..., None]

    wp = omega_p_cart(p, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                      mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    kp = 0.0 if sc.isotropic else k_par(x_sph, w, 0.0, sc, mass_ns)
    ksqr = (g_tt * erg_inf**2 + g_rr * w[..., 0] ** 2 + g_thth * w[..., 1] ** 2
            + g_pp * w[..., 2] ** 2)
    e2 = erg_inf**2 / g_rr
    return 0.5 * (ksqr + wp**2 * (e2 - kp**2) / e2) / erg_inf**2


def _accept_crossing(p, erg_inf, sc: Scene, mass_ns):
    """Recording filter (affect!, RayTracer.jl:1585-1597): outside the star
    and locally propagating."""
    rr, x_sph = _sph_of(p)
    _, g_rr, _, _ = metric_inverse(x_sph, mass_ns)
    erg_l = erg_inf / torch.sqrt(g_rr)
    wp = omega_p_cart(p, 0.0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns,
                      mass_a=sc.mass_a, bndry_lyr=sc.bndry_lyr)
    return (rr > sc.r_ns) & (erg_l > wp)


class _Geometry(NamedTuple):
    x0: Any
    vvec: Any
    vvec_loc: Any
    erg_inf: Any
    r_rnd: Any
    v_ifty: Any     # [km/s]
    key_pick: Any


def _unit(theta, phi):
    return torch.stack([torch.sin(theta) * torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi), torch.cos(theta)], dim=-1)


def _draw(keys, maxR, sc: Scene, vmean, flat_sampling: bool, dtype) -> _Geometry:
    """Sampling geometry of a batch of events (RayTracer.jl:1483-1542), one
    key per event: the same eight subkeys and draws as the reference."""
    ks = rng.split(keys, 8)                                   # [B, 8, 2]
    u = [rng.uniform(ks[:, i], dtype=dtype) for i in range(6)]
    theta_i = torch.arccos(1.0 - 2.0 * u[0])
    phi_i = 2.0 * math.pi * u[1]
    theta_loc = torch.arccos(1.0 - 2.0 * u[2])
    phi_loc = 2.0 * math.pi * u[3]
    phi_rnd = 2.0 * math.pi * u[4]
    r_rnd = torch.sqrt(u[5]) * maxR if flat_sampling else u[5] * maxR

    vvec = _unit(theta_i, phi_i)
    vvec_loc = _unit(theta_loc, phi_loc)
    x1 = r_rnd * torch.cos(phi_rnd)
    x2 = r_rnd * torch.sin(phi_rnd)
    # inverse Euler rotation of (x1, x2, 0) into the disk plane (RayTracer.jl:1529)
    x0 = torch.stack([
        x1 * torch.cos(-phi_i) * torch.cos(-theta_i) + x2 * torch.sin(-phi_i),
        x2 * torch.cos(-phi_i) - x1 * torch.sin(-phi_i) * torch.cos(-theta_i),
        x1 * torch.sin(-theta_i),
    ], dim=-1)
    x0 = x0 + vvec * (-maxR * 1.1)

    v_ifty = (vmean + rng.uniform(ks[:, 6], (3,), dtype=dtype) * 1.0e-5) / math.sqrt(3.0)
    v_ifty_mag = torch.sqrt(torch.sum(v_ifty**2, dim=-1))
    gamma_a = 1.0 / torch.sqrt(1.0 - (v_ifty_mag / C_KM) ** 2)
    erg_inf = sc.mass_a * torch.sqrt(1.0 + (v_ifty_mag / C_KM * gamma_a) ** 2)
    return _Geometry(x0, vvec, vvec_loc, erg_inf, r_rnd, v_ifty, ks[:, 7])


def _select(geo: _Geometry, g, s_grid, sc: Scene, mass_ns, *, thick: bool,
            n_max: int, bisect_iters: int) -> SampleResult:
    """Root-refine the scanned condition and draw a crossing
    (RayTracer.jl:1585-1647).  g: [B, N] condition on the s grid."""
    B, n_grid = g.shape
    x0, vvec, vloc, erg = geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf

    def cond_at(s):                                           # s [B, M]
        p = x0[:, None, :] + s[..., None] * vvec[:, None, :]
        return _line_condition(p, vloc[:, None, :], erg[:, None], sc, mass_ns, thick)

    sign = torch.sign(g)
    flips = sign[:, 1:] * sign[:, :-1] < 0                   # [B, N-1]
    idx = torch.arange(n_grid - 1, device=g.device).expand(B, -1)
    keyed = torch.where(flips, idx, torch.full_like(idx, n_grid - 2))
    # first MAXC flip intervals in line order (the reference's top_k trick)
    slot_idx = torch.topk(keyed, MAX_LINE_CROSSINGS, dim=1, largest=False,
                          sorted=True).values
    has_root = (torch.arange(MAX_LINE_CROSSINGS, device=g.device)[None, :]
                < flips.sum(dim=1, keepdim=True))

    s_lo = s_grid[slot_idx]
    s_hi = s_grid[slot_idx + 1]
    g_lo = torch.gather(g, 1, slot_idx)
    for _ in range(bisect_iters):
        s_mid = 0.5 * (s_lo + s_hi)
        g_mid = cond_at(s_mid)
        left = torch.sign(g_mid) == torch.sign(g_lo)
        s_lo, s_hi, g_lo = (torch.where(left, s_mid, s_lo),
                            torch.where(left, s_hi, s_mid),
                            torch.where(left, g_mid, g_lo))
    s_star = 0.5 * (s_lo + s_hi)
    p_star = x0[:, None, :] + s_star[..., None] * vvec[:, None, :]   # [B, MAXC, 3]

    ok = has_root & _accept_crossing(p_star, erg[:, None], sc, mass_ns)
    n_accepted = ok.sum(dim=1)
    rand_inx = rng.randint(geo.key_pick, (), 1, n_max + 1)
    success = n_accepted >= rand_inx
    acc_order = torch.cumsum(ok.to(torch.int64), dim=1)
    pick = torch.argmax(((acc_order == rand_inx[:, None]) & ok).to(torch.int8), dim=1)
    xpos = p_star[torch.arange(B, device=g.device), pick]

    v_ifty_mag = torch.sqrt(torch.sum(geo.v_ifty**2, dim=-1))
    rmag = torch.sqrt(torch.sum(xpos**2, dim=-1))
    vmag_loc = torch.sqrt(v_ifty_mag**2 + 2.0 * G_NEW * mass_ns / rmag) / C_KM
    return SampleResult(success=success, xpos=xpos, r_disk=geo.r_rnd,
                        weight=n_accepted.to(g.dtype), v_loc=vloc * vmag_loc[:, None],
                        v_ifty=geo.v_ifty / C_KM, erg_inf=erg)


def sample_batch(key, batch: int, maxR, sc: Scene, mass_ns, *, n_grid: int,
                 n_max: int = 6, thick: bool = True, flat_sampling: bool = True,
                 compute_dtype: str = "state", line_engine: str = "plain"):
    """`batch` conversion-surface samples from one key (the reference's
    sample_batch: per-event keys from split(key, batch)).  The device is the
    key's.  flat_sampling=False selects the legacy 1/r disk measure of
    find_samples (RayTracer.jl:1656-1799)."""
    dtype = torch.float32 if compute_dtype == "f32" else torch.float64
    keys = rng.split(key, batch)
    geo = _draw(keys, maxR, sc, 220.0, flat_sampling, dtype)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=key.device).to(dtype)
    if line_engine == "kernel" and thick:
        from adiabatic_raytracer_tpu_torch.ops.line_scan import line_scan

        g = line_scan(geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid,
                      sc, mass_ns).to(dtype)
    elif line_engine in ("plain", "kernel"):
        p = geo.x0[:, None, :] + s_grid[None, :, None] * geo.vvec[:, None, :]
        g = _line_condition(p, geo.vvec_loc[:, None, :], geo.erg_inf[:, None],
                            sc, mass_ns, thick)
    else:
        raise ValueError(f"line_engine must be 'plain' or 'kernel', got {line_engine!r}")
    return _select(geo, g, s_grid, sc, mass_ns, thick=thick, n_max=n_max,
                   bisect_iters=50)


def default_n_grid(maxR: float, march_dt: float = 0.5, scan_per_step: int = 20) -> int:
    """Grid matching the reference's Euler dt=0.5 with interp_points=20
    (RayTracer.jl:1599-1613)."""
    return int(math.ceil(2.2 * float(maxR) / march_dt)) * scan_per_step + 1
