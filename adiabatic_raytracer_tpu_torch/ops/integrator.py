"""Batched adaptive Dormand-Prince 5(4) pool integrator with event detection.

Port of adiabatic_raytracer_tpu/ops/integrator.py (RayTracer.jl:171-452):
a pool of rays advances in lockstep, each with its own step size, masks and
crossing buffers; crossings are found by a sign-change scan of the event
condition on cubic-Hermite dense output at `interp_points` samples per
accepted step, refined by bisection.  This is the CPU engine and the plain
version the K2 megakernel is held against (ops/megakernel.py).

Eager torch pays per operation, so the scan runs as one [B, K] chain of
tensor ops and the bisection as one [B] chain, never a Python loop over
samples or rays.  The Python `while` over steps syncs with the device once
per step.  `init_state` / `iter_budget` / `return_state` run the loop in
chunks from a carried PoolState (ops/streaming.py compacts between chunks).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig
from adiabatic_raytracer_tpu_torch.ops.geometry import sph_to_cart

# Dormand-Prince 5(4) tableau (exact rationals), FSAL
DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
DP_E = tuple(b5 - b4 for b5, b4 in zip(DP_B5, DP_B4))


def hermite(u0, u1, f0, f1, h, tau):
    """Cubic Hermite dense output on [0, 1]; h and tau broadcast against u."""
    t2 = tau * tau
    t3 = t2 * tau
    return ((2 * t3 - 3 * t2 + 1) * u0 + (t3 - 2 * t2 + tau) * h * f0
            + (-2 * t3 + 3 * t2) * u1 + (t3 - t2) * h * f1)


class PoolState(NamedTuple):
    """The loop's carried state, per ray (JAX integrator.PoolState, plus the
    port's n_bisect)."""
    u: Any
    lnt: Any
    dt: Any
    f0: Any          # FSAL derivative at (lnt, u)
    g0: Any          # event condition at (lnt, u)
    done: Any
    ns_hit: Any
    cut_short: Any
    maxed: Any
    stalled: Any
    n_cross: Any
    n_bisect: Any
    cross_u: Any
    cross_lnt: Any
    save_u: Any      # [B, NS, 7] before the past-the-end fill
    steps: Any
    lnt_ck: Any      # log-time at the last stall check
    errold: Any      # PI controller memory


class PoolResult(NamedTuple):
    u: Any           # [B, 7] final state
    lnt: Any         # [B] final log-time
    save_u: Any      # [B, NS, 7] states on the save grid
    cross_u: Any     # [B, MAXC, 7] states at recorded crossings
    cross_lnt: Any   # [B, MAXC]
    n_cross: Any     # [B] int64
    cut_short: Any   # [B] bool: terminated by max_crossings
    ns_hit: Any      # [B] bool: killed at the stellar surface
    maxed: Any       # [B] bool: step limit
    steps: Any       # [B] int64 attempted steps
    stalled: Any     # [B] bool: cut by the stall detector
    n_bisect: Any    # [B] int64 roots bisected (recorded or not)


def _lin(coefs, ks):
    """sum(c * k) over nonzero coefficients, in the reference's order."""
    acc = 0
    for c, k in zip(coefs, ks):
        if c != 0.0:
            acc = acc + c * k
    return acc


def _error_norm(err, u0, u1, rtol, atol):
    scale = atol + rtol * torch.maximum(torch.abs(u0), torch.abs(u1))
    return torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))


def _initial_dt(u0, f0, span, rtol, atol):
    scale = atol + rtol * torch.abs(u0)
    d0 = torch.sqrt(torch.mean((u0 / scale) ** 2, dim=-1))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2, dim=-1))
    dt0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                      0.01 * d0 / d1)
    return torch.minimum(dt0, 0.1 * span)


def integrate_pool(rhs: Callable, cond_fn: Callable, u0, lnt0, lnt1, ray_args,
                   cfg: NumericsConfig, *, save_lnt, kill_at_surface, r_ns,
                   x0_cart, max_crossings, detect_events: bool = True,
                   init_state: PoolState = None, iter_budget: int = None,
                   return_state: bool = False):
    """Advance rays from lnt0 to lnt1 with per-ray adaptive steps.

    rhs(u [B,7], lnt [B], ray_args) -> [B,7]; cond_fn(u [...,7], lnt [...])
    -> [...].  Crossings below 1.01 r_NS, and a first crossing that has not
    moved from the start point (factor 1.0001 per |component|,
    RayTracer.jl:303-322), are rejected without recording.

    init_state resumes from a carried state (u0 and lnt0 are then unused),
    iter_budget stops after that many loop iterations (0 builds the initial
    state), return_state returns (PoolResult, PoolState)."""
    ref = u0 if init_state is None else init_state.u
    B = ref.shape[0]
    dev, dtype = ref.device, ref.dtype
    MAXC = cfg.max_crossings
    NS = save_lnt.shape[1]
    K = cfg.interp_points
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    beta = float(cfg.pi_beta)

    if init_state is None:
        u = u0.clone()
        lnt = lnt0.clone()
        f0 = rhs(u, lnt, ray_args)
        g0 = cond_fn(u, lnt)
        span = lnt1 - lnt0
        dt = _initial_dt(u, f0, span, rtol, atol)
        done = span <= 0
        ns_hit = torch.zeros(B, dtype=torch.bool, device=dev)
        cut_short = torch.zeros_like(ns_hit)
        maxed = torch.zeros_like(ns_hit)
        stalled = torch.zeros_like(ns_hit)
        n_cross = torch.zeros(B, dtype=torch.int64, device=dev)
        n_bisect = torch.zeros(B, dtype=torch.int64, device=dev)
        cross_u = torch.zeros((B, MAXC, u0.shape[1]), dtype=dtype, device=dev)
        cross_lnt = torch.zeros((B, MAXC), dtype=dtype, device=dev)
        save_u = torch.zeros((B, NS, u0.shape[1]), dtype=dtype, device=dev)
        save_u[:, 0] = u0
        steps = torch.zeros(B, dtype=torch.int64, device=dev)
        lnt_ck = lnt0.clone()
        errold = torch.full((B,), 1e-4, dtype=dtype, device=dev)
    else:
        (u, lnt, dt, f0, g0, done, ns_hit, cut_short, maxed, stalled, n_cross, n_bisect,
         cross_u, cross_lnt, save_u, steps, lnt_ck, errold) = init_state
    rows = torch.arange(B, device=dev)
    taus = torch.linspace(0.0, 1.0, K + 1, dtype=torch.float64, device=dev)[1:-1].to(dtype)
    kidx = torch.arange(K, device=dev)[None, :]

    it = 0
    while bool((~done).any()) and (iter_budget is None or it < iter_budget):
        it += 1
        active = ~done
        h = torch.clamp(torch.minimum(dt, lnt1 - lnt), min=0.0)
        hc = h[:, None]
        ks = [f0]
        for i in range(1, 7):
            ks.append(rhs(u + hc * _lin(DP_A[i], ks), lnt + DP_C[i] * h, ray_args))
        u_new = u + hc * _lin(DP_B5, ks)
        f_new = ks[6]
        err = hc * _lin(DP_E, ks)

        enorm = _error_norm(err, u, u_new, rtol, atol)
        forced = dt <= cfg.dt_min * 1.0000001
        accept = ((enorm <= 1.0) | forced) & active & (h > 0)
        en_safe = torch.where(enorm > 0, enorm, torch.full_like(enorm, 1e-10))
        if beta:
            fac = cfg.safety * en_safe ** -(0.2 - 0.75 * beta) * errold ** beta
            fac = torch.clamp(fac, cfg.min_dt_factor, cfg.max_dt_factor)
            fac = torch.where(accept, fac, torch.clamp(fac, max=1.0))
        else:
            fac = torch.clamp(cfg.safety * en_safe ** -0.2, cfg.min_dt_factor,
                              cfg.max_dt_factor)
        dt_next = torch.clamp(dt * fac, min=cfg.dt_min)
        t1 = lnt + h

        # dense output on the save grid
        in_step = (save_lnt > lnt[:, None]) & (save_lnt <= t1[:, None]) & accept[:, None]
        if bool(in_step.any()):
            tau_s = torch.where(hc > 0, (save_lnt - lnt[:, None]) / hc,
                                torch.zeros_like(save_lnt))
            u_s = hermite(u[:, None], u_new[:, None], f0[:, None], f_new[:, None],
                          hc[:, None], tau_s[:, :, None])
            save_u = torch.where(in_step[:, :, None], u_s, save_u)

        g_new = cond_fn(u_new, t1)
        u_prev, lnt_prev, f_prev, g_prev = u, lnt, f0, g0
        acc1 = accept[:, None]
        u = torch.where(acc1, u_new, u)
        lnt = torch.where(accept, t1, lnt)
        dt = torch.where(active, dt_next, dt)
        f0 = torch.where(acc1, f_new, f0)
        g0 = torch.where(accept, g_new, g0)
        steps = steps + active.to(torch.int64)
        errold = torch.where(accept, torch.clamp(enorm, min=1e-4), errold)

        if detect_events and bool(accept.any()):
            u_t = hermite(u_prev[:, None], u_new[:, None], f_prev[:, None],
                          f_new[:, None], hc[:, None], taus[None, :, None])
            g_int = cond_fn(u_t, lnt_prev[:, None] + taus[None, :] * hc)
            gs = torch.cat([g_prev[:, None], g_int, g_new[:, None]], dim=1)
            sg = torch.sign(gs)
            flips = (sg[:, 1:] * sg[:, :-1] < 0) & acc1            # [B, K]
            if bool(flips.any()):
                cursor = torch.zeros(B, dtype=torch.int64, device=dev)
                for _ in range(cfg.max_roots_per_step):
                    elig = flips & (kidx >= cursor[:, None])
                    has = elig.any(dim=1)
                    if not bool(has.any()):
                        break
                    idx = torch.argmax(elig.to(torch.int8), dim=1)
                    n_bisect = n_bisect + (has & ~done).to(torch.int64)
                    tau_lo = idx.to(dtype) / K
                    tau_hi = (idx + 1).to(dtype) / K
                    g_lo = gs[rows, idx]
                    for _ in range(cfg.bisect_iters):
                        tau_mid = 0.5 * (tau_lo + tau_hi)
                        g_mid = cond_fn(hermite(u_prev, u_new, f_prev, f_new, hc,
                                                tau_mid[:, None]),
                                        lnt_prev + tau_mid * h)
                        left = torch.sign(g_mid) == torch.sign(g_lo)
                        tau_lo, tau_hi, g_lo = (torch.where(left, tau_mid, tau_lo),
                                                torch.where(left, tau_hi, tau_mid),
                                                torch.where(left, g_mid, g_lo))
                    tau_star = 0.5 * (tau_lo + tau_hi)
                    u_star = hermite(u_prev, u_new, f_prev, f_new, hc, tau_star[:, None])
                    lnt_star = lnt_prev + tau_star * h

                    pos = sph_to_cart(u_star[:, 0:3])
                    s = 1.0001
                    within = ((torch.abs(pos) < torch.abs(x0_cart) * s)
                              & (torch.abs(pos) > torch.abs(x0_cart) / s)).all(dim=1)
                    start_dup = within & (n_cross == 0)
                    below = u_star[:, 0] < r_ns * 1.01
                    record = has & ~done & ~start_dup & ~below & (n_cross < MAXC)
                    slot = torch.clamp(n_cross, 0, MAXC - 1)
                    rec = record.nonzero().squeeze(1)
                    cross_u[rec, slot[rec]] = u_star[rec]
                    cross_lnt[rec, slot[rec]] = lnt_star[rec]
                    n_cross = n_cross + record.to(torch.int64)
                    term = record & (n_cross >= max_crossings)
                    u = torch.where(term[:, None], u_star, u)
                    lnt = torch.where(term, lnt_star, lnt)
                    cut_short = cut_short | term
                    done = done | term
                    cursor = torch.where(has, idx + 1, torch.full_like(idx, K))

        # terminal conditions
        ns_now = accept & kill_at_surface & (u[:, 0] < r_ns * 1.01) & ~done
        reached = accept & (t1 >= lnt1 - 1e-14) & ~done
        maxed_now = (steps >= cfg.max_steps) & ~done
        if cfg.stall_window:
            at_win = (steps % cfg.stall_window == 0) & (steps > 0)
            stall_now = at_win & ~done & (lnt - lnt_ck < cfg.stall_min_progress)
            lnt_ck = torch.where(at_win, lnt, lnt_ck)
            stalled = stalled | stall_now
            done = done | stall_now
        ns_hit = ns_hit | ns_now
        maxed = maxed | maxed_now
        done = done | ns_now | reached | maxed_now

    past_end = save_lnt > lnt[:, None]
    res = PoolResult(u=u, lnt=lnt,
                     save_u=torch.where(past_end[:, :, None], u[:, None, :], save_u),
                     cross_u=cross_u, cross_lnt=cross_lnt, n_cross=n_cross,
                     cut_short=cut_short, ns_hit=ns_hit, maxed=maxed, steps=steps,
                     stalled=stalled, n_bisect=n_bisect)
    if not return_state:
        return res
    return res, PoolState(u=u, lnt=lnt, dt=dt, f0=f0, g0=g0, done=done, ns_hit=ns_hit,
                          cut_short=cut_short, maxed=maxed, stalled=stalled,
                          n_cross=n_cross, n_bisect=n_bisect, cross_u=cross_u,
                          cross_lnt=cross_lnt, save_u=save_u, steps=steps, lnt_ck=lnt_ck,
                          errold=errold)
