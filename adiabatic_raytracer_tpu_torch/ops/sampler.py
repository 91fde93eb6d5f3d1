"""Conversion-surface Monte-Carlo sampler.

Port of adiabatic_raytracer_tpu/ops/sampler.py (find_samples_new,
RayTracer.jl:1480-1653): draw a disk point and direction, evaluate the
thick-surface level-crossing condition on a dense grid along the straight
line, bisect the sign changes, and draw a crossing index.  The draws use the
threefry stream of utils/rng.py, so a key gives the same events as the JAX
sampler.  Batched: every function works on [B, ...] tensors directly.

The dense line scan and the refinement of its sign changes are the
sampler's hot loop.  line_engine="kernel" routes them through
ops/line_scan.line_roots: on a CUDA tensor the fused K1 kernel, which scans,
bisects and filters each line in one launch; on a CPU tensor its plain
version, the f32 grid (line_scan_plain) followed by _roots.
line_engine="plain" evaluates _line_condition on the grid in the compute
dtype and calls _roots.
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
from adiabatic_raytracer_tpu_torch.ops.propagate import physics_dtype
from adiabatic_raytracer_tpu_torch.utils import rng

MAX_LINE_CROSSINGS = 16
BISECT_ITERS = 50


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


def _flip_slots(g):
    """The first MAX_LINE_CROSSINGS sign-change intervals of each line of the
    condition g [B, N], in line order (the reference's top_k trick: slots past
    the line's count hold the fill interval N - 2): (slot_idx [B, MAXC], the
    interval's left grid index; g_lo [B, MAXC], g there; n_flips [B] int32,
    the line's count).  A flip is sign(g[n]) * sign(g[n+1]) < 0; zeros and
    NaNs (torch.sign 0) are none."""
    B, n_grid = g.shape
    sign = torch.sign(g)
    flips = sign[:, 1:] * sign[:, :-1] < 0                   # [B, N-1]
    idx = torch.arange(n_grid - 1, device=g.device).expand(B, -1)
    keyed = torch.where(flips, idx, torch.full_like(idx, n_grid - 2))
    slot_idx = torch.topk(keyed, MAX_LINE_CROSSINGS, dim=1, largest=False,
                          sorted=True).values
    return slot_idx, torch.gather(g, 1, slot_idx), flips.sum(dim=1).to(torch.int32)


def _bisect(cond_at, s_grid, slot_idx, g_lo, iters: int):
    """`iters` halvings of each interval [s_grid[i], s_grid[i + 1]], i in
    slot_idx, keeping the half whose left end has g_lo's sign; the midpoint
    of the last one."""
    s_lo = s_grid[slot_idx]
    s_hi = s_grid[slot_idx + 1]
    for _ in range(iters):
        s_mid = 0.5 * (s_lo + s_hi)
        g_mid = cond_at(s_mid)
        left = torch.sign(g_mid) == torch.sign(g_lo)
        s_lo, s_hi, g_lo = (torch.where(left, s_mid, s_lo),
                            torch.where(left, s_hi, s_mid),
                            torch.where(left, g_mid, g_lo))
    return 0.5 * (s_lo + s_hi)


def _cond_along(x0, vvec, vloc, erg, sc: Scene, mass_ns, thick: bool):
    """The condition at s [B, M] along the lines x0 + s vvec."""
    def cond_at(s):
        p = x0[:, None, :] + s[..., None] * vvec[:, None, :]
        return _line_condition(p, vloc[:, None, :], erg[:, None], sc, mass_ns, thick)
    return cond_at


def _accept_at(x0, vvec, erg, s_star, sc: Scene, mass_ns):
    """The recording filter at the points x0 + s_star vvec, s_star [B, M]."""
    p_star = x0[:, None, :] + s_star[..., None] * vvec[:, None, :]
    return _accept_crossing(p_star, erg[:, None], sc, mass_ns)


def _roots(x0, vvec, vloc, erg, g, s_grid, sc: Scene, mass_ns, *, thick: bool = True):
    """Root-refine the scanned condition g [B, N] on the grid s_grid
    (RayTracer.jl:1585-1597): the first MAX_LINE_CROSSINGS sign changes of
    each line, bisected in the compute dtype of x0, and the recording filter
    at each root.  Returns (s_star [B, MAXC], ok [B, MAXC] = has a root and
    passes the filter, n_flips [B] int32)."""
    slot_idx, g_lo, n_flips = _flip_slots(g)
    has_root = (torch.arange(MAX_LINE_CROSSINGS, device=g.device)[None, :]
                < n_flips[:, None])
    s_star = _bisect(_cond_along(x0, vvec, vloc, erg, sc, mass_ns, thick), s_grid, slot_idx,
                     g_lo, BISECT_ITERS)
    ok = has_root & _accept_at(x0, vvec, erg, s_star, sc, mass_ns)
    return s_star, ok, n_flips


def _pick(geo: _Geometry, s_star, ok, sc: Scene, mass_ns, n_max: int,
          int_dtype=torch.int64) -> SampleResult:
    """Draw one of each line's accepted crossings (RayTracer.jl:1615-1647);
    the index draw is jax.random.randint's at int_dtype."""
    B = ok.shape[0]
    n_accepted = ok.sum(dim=1)
    rand_inx = rng.randint(geo.key_pick, (), 1, n_max + 1, dtype=int_dtype)
    success = n_accepted >= rand_inx
    acc_order = torch.cumsum(ok.to(torch.int64), dim=1)
    pick = torch.argmax(((acc_order == rand_inx[:, None]) & ok).to(torch.int8), dim=1)
    s_pick = s_star[torch.arange(B, device=ok.device), pick]
    xpos = geo.x0 + s_pick[:, None] * geo.vvec

    v_ifty_mag = torch.sqrt(torch.sum(geo.v_ifty**2, dim=-1))
    rmag = torch.sqrt(torch.sum(xpos**2, dim=-1))
    vmag_loc = torch.sqrt(v_ifty_mag**2 + 2.0 * G_NEW * mass_ns / rmag) / C_KM
    return SampleResult(success=success, xpos=xpos, r_disk=geo.r_rnd,
                        weight=n_accepted.to(s_star.dtype),
                        v_loc=geo.vvec_loc * vmag_loc[:, None],
                        v_ifty=geo.v_ifty / C_KM, erg_inf=geo.erg_inf)


def sample_batch(key, batch: int, maxR, sc: Scene, mass_ns, *, n_grid: int,
                 n_max: int = 6, thick: bool = True, flat_sampling: bool = True,
                 compute_dtype: str = "state", line_engine: str = "plain",
                 state_dtype=torch.float64):
    """`batch` conversion-surface samples from one key (the reference's
    sample_batch: per-event keys from split(key, batch)).  The device is the
    key's.  flat_sampling=False selects the legacy 1/r disk measure of
    find_samples (RayTracer.jl:1656-1799).  The draws and the physics run
    in the compute dtype: f32, or at "state" the run's state dtype
    (sampler.py:96-100 of the reference).  state_dtype f32 is the JAX run
    with x64 off, whose crossing-index draw is an int32 randint."""
    dtype = physics_dtype(compute_dtype, state_dtype)
    keys = rng.split(key, batch)
    geo = _draw(keys, maxR, sc, 220.0, flat_sampling, dtype)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=key.device).to(dtype)
    if line_engine == "kernel" and thick:
        from adiabatic_raytracer_tpu_torch.ops.line_scan import line_roots

        s_star, ok, _ = line_roots(geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid,
                                   sc, mass_ns)
    elif line_engine in ("plain", "kernel"):
        p = geo.x0[:, None, :] + s_grid[None, :, None] * geo.vvec[:, None, :]
        g = _line_condition(p, geo.vvec_loc[:, None, :], geo.erg_inf[:, None],
                            sc, mass_ns, thick)
        s_star, ok, _ = _roots(geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, g, s_grid, sc,
                               mass_ns, thick=thick)
    else:
        raise ValueError(f"line_engine must be 'plain' or 'kernel', got {line_engine!r}")
    int_dtype = torch.int32 if state_dtype == torch.float32 else torch.int64
    return _pick(geo, s_star, ok, sc, mass_ns, n_max, int_dtype)


def default_n_grid(maxR: float, march_dt: float = 0.5, scan_per_step: int = 20) -> int:
    """Grid matching the reference's Euler dt=0.5 with interp_points=20
    (RayTracer.jl:1599-1613)."""
    return int(math.ceil(2.2 * float(maxR) / march_dt)) * scan_per_step + 1
