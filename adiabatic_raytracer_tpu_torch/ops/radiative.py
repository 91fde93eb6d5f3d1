"""Auxiliary radiative-transfer pieces: cyclotron-resonance optical depth and
the energy drift along a trajectory.

Port of adiabatic_raytracer_tpu/ops/radiative.py, the partly wired
components of the reference:
  * Crossings / get_crossings / apply   RayTracer.jl:29-66
  * tau_cyc                             RayTracer.jl:804-851
  * dwdt_vec                            RayTracer.jl:690-704
  * dist_diff                           RayTracer.jl:1805-1810

They work on saved trajectory arrays [B, NS, 3] / [B, NS]; derivatives come
from torch.func.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.func import grad, vmap

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, HBAR
from adiabatic_raytracer_tpu_torch.models.magnetosphere import cyclotron_freq_cart, omega_p_cart


class Crossings(NamedTuple):
    """Sign-change brackets of a sampled series (RayTracer.jl:29-66): i1 and
    i2 the indices either side, weight the linear-interpolation weight of
    i1, mask which of the max_crossings slots hold a crossing."""
    i1: Any
    i2: Any
    weight: Any
    mask: Any


def get_crossings(a, *, max_crossings: int = 8, keep_all: bool = True) -> Crossings:
    """The first max_crossings sign changes of a [..., N] series along its
    last axis, with linear-interpolation weights; empty slots point at
    N - 2, as in the JAX function's fill value."""
    sign = torch.sign(a)
    diff = sign[..., 1:] - sign[..., :-1]
    hit = (diff != 0) if keep_all else (diff > 0)
    n = a.shape[-1] - 1
    # hit positions first, in increasing order, then the misses
    pos = torch.arange(n, device=a.device)
    order = torch.sort(torch.where(hit, pos, pos + n), dim=-1).values[..., :max_crossings]
    if order.shape[-1] < max_crossings:
        order = torch.cat([order, order.new_full(order.shape[:-1] + (max_crossings - n,),
                                                 2 * n)], dim=-1)
    i1 = torch.where(order < n, order, torch.full_like(order, a.shape[-1] - 2))
    mask = torch.arange(max_crossings, device=a.device) < hit.sum(dim=-1, keepdim=True)
    i2 = i1 + 1
    a1 = torch.gather(a, -1, i1)
    a2 = torch.gather(a, -1, i2)
    return Crossings(i1=i1, i2=i2, weight=a2 / (a2 - a1), mask=mask)


def apply_crossings(c: Crossings, arr):
    """`arr` [..., N] interpolated at the crossings (apply,
    RayTracer.jl:38-40)."""
    return (torch.gather(arr, -1, c.i1) * c.weight
            + torch.gather(arr, -1, c.i2) * (1.0 - c.weight))


def tau_cyc(x_traj, k_traj, tarr, t_start, sc: Scene):
    """Cyclotron-resonance optical depth along saved trajectories (tau_cyc,
    RayTracer.jl:804-851): at the first crossing of log(omega_c) -
    log(mass_a), tau = pi omega_p^2 / |khat . grad omega_c| / (c hbar); 0
    where the trajectory meets no resonance.  x_traj, k_traj [B, NS, 3],
    tarr [NS], t_start [B]; returns [B]."""
    B, NS, _ = x_traj.shape
    t0 = tarr[None, :] + t_start[:, None]                               # [B, NS]
    cyc = cyclotron_freq_cart(x_traj, t0, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    cx = get_crossings(torch.log(cyc) - math.log(sc.mass_a), max_crossings=1)
    found = cx.mask[:, 0]
    w = cx.weight[:, 0]
    i1, i2 = cx.i1[:, 0], cx.i2[:, 0]
    rows = torch.arange(B, device=x_traj.device)
    tp = torch.where(found, t0[rows, i1] * w + (1 - w) * t0[rows, i2], t0[:, 0])
    wv = w[:, None]
    xp = torch.where(found[:, None], x_traj[rows, i1] * wv + (1 - wv) * x_traj[rows, i2],
                     x_traj[:, 0])
    kp = torch.where(found[:, None], k_traj[rows, i1] * wv + (1 - wv) * k_traj[rows, i2],
                     torch.zeros_like(x_traj[:, 0]))
    wp = omega_p_cart(xp, tp, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns, mass_a=sc.mass_a,
                      bndry_lyr=sc.bndry_lyr)
    grad_oc = vmap(grad(lambda x, t: cyclotron_freq_cart(x, t, sc.theta_m, sc.omega_pul,
                                                         sc.b0, sc.r_ns)))(xp, tp)
    kmag = torch.linalg.norm(kp, dim=-1)
    doc_dl = torch.abs(torch.sum(kp * grad_oc, dim=-1)) / torch.where(
        kmag > 0, kmag, torch.ones_like(kmag))
    tau = math.pi * wp**2 / doc_dl / (C_KM * HBAR)
    return torch.where(kmag > 0, tau, torch.zeros_like(tau))


def dwdt_vec(x_traj, k_traj, tarr, t_start, sc: Scene, omega_fn):
    """Energy drift accumulated along trajectories (dwdt_vec,
    RayTracer.jl:690-704): the sum over segments of d omega/dt at the
    segment's end times its length over c.  omega_fn(x [3], k [3], t, sc)
    is a scalar; returns [B]."""
    t0 = tarr[None, :] + t_start[:, None]
    dwdt = vmap(vmap(grad(lambda t, x, k: omega_fn(x, k, t, sc))))(
        t0[:, 1:], x_traj[:, 1:], k_traj[:, 1:])                          # [B, NS-1]
    dl = torch.linalg.norm(x_traj[:, 1:] - x_traj[:, :-1], dim=-1)
    return torch.sum(dwdt * dl / C_KM, dim=1)


def dist_diff(x_traj):
    """Successive radial distance differences in 1/eV (dist_diff,
    RayTracer.jl:1805-1810); the last slot repeats the third-last."""
    r = torch.linalg.norm(x_traj, dim=-1)
    b = torch.zeros_like(r)
    b[:, :-1] = torch.abs(r[:, 1:] - r[:, :-1]) / C_KM / HBAR
    b[:, -1] = b[:, -3]
    return b
