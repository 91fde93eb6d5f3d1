"""K3 and K4: whole forward branching trees in CUDA kernels
(csrc/treekernel.cu, csrc/treerefill.cu, both on csrc/tree_device.cuh).

K3 replaces the Pallas tree kernel (adiabatic_raytracer_tpu/ops/treekernel.py:
_tree_kernel via tree_kernel_launch).  Every CUDA warp is one event and runs
the event's complete tree: it integrates each node's segment with the warp's
DP5 step (csrc/tree_warp.cuh: the serial chain replicated in its 32 lanes,
the event scan and the bisection spread over them), records finals, pushes
children onto a per-event pending queue, applies the per-node cutoffs
(MainRunner.jl:324-339), pops the max-weight pending node and restarts.
This is the reference's exact per-node semantics, i.e. the host work-queue
engine at tree_k=1 (ops/tree.forward_tree), which is K3's reference.

K4 replaces the Pallas refill kernel (_tree_kernel_refill via
tree_refill_launch): the same tree body, but each partition's warps pull
events from a queue, a warp taking the next unstarted event when its tree
ends.  Per event it writes what K3 writes, into the same rows.

Where the TPU kernels and the host engine differ, the port follows the host
engine and K2 (ROADMAP Queue 3): every sign change of a step is scanned (up
to max_roots_per_step), not only the first; "reached" is lnt >= lnt1 - 1e-14;
the MC uniforms are the host engine's (the state dtype's draws, held in
f64); the prob cutoff is tot_prob >= 1 - prob_cutoff.
The child birth state is renormalized onto the axion shell in place, phi as
integrated, as the TPU kernel does; the host engine's Cartesian round trip
wraps phi into (-pi, pi], and the integrator's error scale atol + rtol |u|
then takes other steps, which near-tangent crossings amplify: 17 of 2048
production events differ between the two engines by more than 1e-6
(ROADMAP Queue 3, tests/test_torch_tree_engines.py).

`tree_kernel_launch` and `tree_refill_launch` launch the kernels on CUDA
tensors and run `tree_kernel_launch_plain` and `tree_refill_launch_plain`
(the same blocks, PyTorch, one DP5 step of all lanes per loop iteration,
K2's torch twins) on CPU tensors.  `forward_tree_kernel` is the tree engine
around them (treekernel.py:1066 of the reference): root state, pre-drawn
uniforms, then K4 (tree_refill > 0), or K3 in one launch or in bounded
relaunches with staged straggler compaction; the exact host replay of
overflow events, and finals-only pools.  `_scan_roots_warp`, `_bisect_warp`
and `_pop_best_warp` are plain models of the warp's scan, bisection and pop,
for the CPU tests, which hold them bit for bit against the serial versions
the plain versions run.

Blocks are row-major per event (csrc/tree_device.cuh documents the layout);
the row indices below are the kernels'.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.ops import cuda_lib
from adiabatic_raytracer_tpu_torch.ops.geometry import celerity_to_cart_vel, sph_to_cart
from adiabatic_raytracer_tpu_torch.ops.integrator import DP_A, DP_C, DP_E
from adiabatic_raytracer_tpu_torch.ops.megakernel import (
    MegaParams,
    _condition,
    _hermite,
    _prob_nd,
    _rhs,
    can_prob,
    check_supported,
    child_birth,
    mega_params,
    rare_crossing,
    variant_of,
)
from adiabatic_raytracer_tpu_torch.ops.megakernel import (
    sph_point as _cart,   # a segment's start point, as the kernels compute it
)
from adiabatic_raytracer_tpu_torch.ops.propagate import lapse_interior, launch_state
from adiabatic_raytracer_tpu_torch.utils import rng

# aux [B, 32] rows
A_LNT, A_ERROLD, A_DT, A_STEPS, A_LNTCK, A_ISPH, A_DONE, A_INFO = range(8)
A_COUNT, A_CMAIN, A_TOTP, A_ANOM, A_NALLOC = range(8, 13)
A_WCUR, A_PROB, A_PCONV, A_PCONV0, A_TB, A_DW, A_ORD = range(13, 20)
A_X0X, A_X0Y, A_X0Z, A_ITERS, A_ERG, A_LNT1, A_STEPTOT = range(20, 27)
# work done: dense scan passes, bisected roots, photon steps, recorded
# crossings (one prob_nd each), accepted steps
A_NFINE, A_NBISECT, A_STEPS_PH, A_NCROSS, A_NACC = 27, 28, 29, 30, 31
AUX_ROWS = 32
U_ROWS = 16   # uin [B, 16]: u in rows 0..6, then the counts below
# photon steps begun and crossings recorded below r_metric (the metric's
# interior branch), summed over the event's launches
U_PH_IN, U_CROSS_IN = 7, 8
# queue slot rows (16 per slot): u(7), lnt, is_ph, weight, prob, pconv,
# pconv0, dw, pool slot, status
Q_U0, Q_LNT, Q_ISPH, Q_W, Q_PROB, Q_PCONV, Q_PCONV0, Q_DW, Q_SLOT, Q_ST = (
    0, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# final slot rows (16 per slot): written, is_final, is_ph, order, weight,
# prob, pconv, pconv0, t_birth, u_end(7)
F_VALID, F_ISFIN, F_ISPH, F_ORD, F_W, F_PROB, F_PCONV, F_PCONV0, F_TB = range(9)
F_U0 = 9
ROWS = 16

INFO_OVERFLOW = 9.0   # the event needs the host replay


class TreeParams(ctypes.Structure):
    """Tree scalars passed by value at launch (csrc/tree_device.cuh)."""

    _fields_ = [("prob_cutoff", ctypes.c_double)] + [(n, ctypes.c_int) for n in (
        "mc_nodes", "num_cutoff", "max_nodes", "nf", "qd", "uu", "it_cap")]


def tree_params(tcfg: TreeConfig, *, nf: int, qd: int, uu: int, it_cap: int) -> TreeParams:
    return TreeParams(prob_cutoff=float(tcfg.prob_cutoff), mc_nodes=int(tcfg.mc_nodes),
                      num_cutoff=int(tcfg.num_cutoff), max_nodes=int(tcfg.max_nodes),
                      nf=int(nf), qd=int(qd), uu=int(uu), it_cap=int(it_cap))


def kernel_params(sc: Scene, cfg: NumericsConfig) -> MegaParams:
    """K2's scene/numerics struct for a tree segment: species mixed, one
    crossing slot, in-kernel probability."""
    return mega_params(sc, cfg, max_crossings=1, species="mixed", with_prob=True)


def check_tree_scene(sc: Scene, cfg: NumericsConfig):
    """Raise on a scene K3 and K4 do not run: they need the in-kernel
    probability, and are built for the anisotropic Melrose dispersion
    without a boundary layer only."""
    check_supported(sc, cfg, 1)
    if not can_prob(sc):
        raise NotImplementedError(
            "K3/K4 need the in-kernel probability, which covers the anisotropic Melrose, "
            "curved-space scene without boundary layer; elsewhere the tree runs the host "
            "queue (ROADMAP Queue 1, \"Left unported on purpose\": K3/K4 at scenes "
            "without the in-kernel probability)")


def bind(lib):
    p = ctypes.c_void_p
    lib.art_treekernel.argtypes = [p, p, p, p, p, ctypes.c_int, MegaParams, TreeParams, p]
    lib.art_treekernel.restype = ctypes.c_int
    i = ctypes.c_int
    lib.art_treerefill.argtypes = [p, p, p, p, p, p, i, i, i, i, i, MegaParams, TreeParams, p]
    lib.art_treerefill.restype = ctypes.c_int
    lib.art_treerefill_resident_warps.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.art_treerefill_resident_warps.restype = ctypes.c_int


# ---------------------------------------------------------------------------
# the plain version: one DP5 step of all lanes per loop iteration
# ---------------------------------------------------------------------------


def _lin(coefs, ks, c):
    """sum_j coefs[j] * ks[j][c] over the nonzero coefficients, in order."""
    acc = None
    for a, k in zip(coefs, ks):
        if a != 0.0:
            acc = a * k[c] if acc is None else acc + a * k[c]
    return acc


def _initial_dt(P, u, f0, span):
    """integrator._initial_dt on [n, 7] rows (art::initial_dt)."""
    sc = P.atol + P.rtol * torch.abs(u)
    d0 = torch.sqrt(((u / sc) ** 2).sum(dim=1) / 7.0)
    d1 = torch.sqrt(((f0 / sc) ** 2).sum(dim=1) / 7.0)
    dt = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    return torch.minimum(dt, 0.1 * span)


def _f(P, u, lnt, erg, is_ph):
    return torch.stack(_rhs(P, u.unbind(1), lnt, erg, is_ph), dim=1)


def _g(P, u, lnt):
    return _condition(P, u.unbind(1), lnt)


def _flipped(a, b):
    return torch.sign(a) * torch.sign(b) < 0


def _g_interp(P, u0, u1, f0, f1, h, lnt0, gate=False):
    """g_tau(rows, tau): the condition on the Hermite interpolant of the
    steps `rows` (of u0 .. lnt0, [m, 7] and [m]) at tau, rows and tau
    broadcast against each other; gate: the coarse gate's samples
    (_condition's gate)."""
    def g_tau(rows, tau):
        c = lambda t: tuple(t[rows, i] for i in range(7))
        hr = h[rows]
        return _condition(P, _hermite(c(u0), c(u1), c(f0), c(f1), hr, tau), lnt0[rows] + tau * hr,
                          gate=gate)
    return g_tau


def _bisect(g_fn, tlo, thi, glo, iters):
    """The serial bisection of art::dp5_step on [n] roots: `iters` halvings
    of [tlo, thi], keeping the half whose left end has glo's sign; g_fn(tm)
    is the condition at [n] taus.  Returns (tlo, thi)."""
    for _ in range(iters):
        tm = 0.5 * (tlo + thi)
        gm = g_fn(tm)
        left = torch.sign(gm) == torch.sign(glo)
        tlo, thi, glo = (torch.where(left, tm, tlo), torch.where(left, thi, tm),
                         torch.where(left, gm, glo))
    return tlo, thi


def _root_filter(P, x0, us, first=True):
    """The roots [n, 7] that may be recorded: not below 1.01 r_NS, and,
    where `first` (no crossing recorded yet), not the start point (within
    1e-4 of x0 [n, 3] in every Cartesian component)."""
    pc = _cart(us)
    ax0 = torch.abs(x0)
    within = ((torch.abs(pc) < ax0 * 1.0001) & (torch.abs(pc) > ax0 / 1.0001)).all(dim=1)
    return ~(within & first) & ~(us[:, 0] < P.r_ns * 1.01)


def _scan_roots(P, x0, u0, u1, f0, f1, h, lnt0, g0, g1, g_tau=None, free=None):
    """The accepted steps' gated event scan (art::dp5_step_warp, serial
    order) on [m] lanes.  `free` [m]: the crossing slots left (K2: 16 -
    n_cross; K3 and K4: one, the default); the start-point filter applies
    while no crossing is recorded (free == P.max_crossings).  Every root
    of a step that passes the filters is recorded, in order, up to
    max_roots bisected roots, and the root that fills the last slot ends
    the step.  Returns (recorded [m] int64, u_root [m, R, 7], lnt_root
    [m, R], dense passes [m], bisected roots [m]), R = max_roots, record k
    of a lane at [:, k].  g_tau(rows, tau) evaluates the condition
    (_g_interp by default)."""
    m = u0.shape[0]
    dev, dt = u0.device, u0.dtype
    g_gate = g_tau or _g_interp(P, u0, u1, f0, f1, h, lnt0, gate=True)
    g_tau = g_tau or _g_interp(P, u0, u1, f0, f1, h, lnt0)
    rows = torch.arange(m, device=dev)[:, None]
    free = torch.ones(m, dtype=torch.int64, device=dev) if free is None else free

    def g_at(taus, g=g_tau):   # [m, T] condition values at the interpolant's taus [T]
        return g(rows, taus[None, :])

    n_rec = torch.zeros(m, dtype=torch.int64, device=dev)
    u_s = torch.zeros((m, P.max_roots, 7), dtype=dt, device=dev)
    lnt_s = torch.zeros((m, P.max_roots), dtype=dt, device=dev)
    K, Kc = P.interp, P.interp_coarse
    dense = torch.ones(m, dtype=torch.bool, device=dev)
    if Kc > 0:
        taus_c = torch.arange(1, Kc, dtype=dt, device=dev) / Kc
        seq = torch.cat([g0[:, None], g_at(taus_c, g_gate), g1[:, None]], dim=1)
        flip_c = _flipped(seq[:, :-1], seq[:, 1:]).any(dim=1)
        dense = flip_c | (torch.abs(seq).amin(dim=1) < P.gate_theta)
    n_root = torch.zeros(m, dtype=dt, device=dev)
    if not bool(dense.any()):
        return n_rec, u_s, lnt_s, dense.to(dt), n_root
    taus = torch.arange(1, K, dtype=dt, device=dev) / K
    seq = torch.cat([g0[:, None], g_at(taus), g1[:, None]], dim=1)
    flips = _flipped(seq[:, :-1], seq[:, 1:]) & dense[:, None]          # [m, K]
    kidx = torch.arange(K, device=dev)[None, :]
    cursor = torch.zeros(m, dtype=torch.int64, device=dev)
    stop = torch.zeros(m, dtype=torch.bool, device=dev)
    for _ in range(P.max_roots):
        elig = flips & (kidx >= cursor[:, None]) & ~stop[:, None]
        has = elig.any(dim=1)
        if not bool(has.any()):
            break
        idx = torch.argmax(elig.to(torch.int8), dim=1)
        li = has.nonzero().squeeze(1)
        j = idx[li]
        hs, ls = h[li], lnt0[li]
        tlo, thi = _bisect(lambda t: g_tau(li, t), j.to(dt) / K, (j + 1).to(dt) / K,
                           seq[li, j], P.bisect)
        ts = 0.5 * (tlo + thi)
        sub = lambda t: tuple(t[li, c] for c in range(7))
        us = torch.stack(_hermite(sub(u0), sub(u1), sub(f0), sub(f1), hs, ts), dim=1)
        first = free[li] - n_rec[li] == P.max_crossings
        ok = _root_filter(P, x0[li], us, first) & (n_rec[li] < free[li])
        n_root[li] += 1.0
        ri = li[ok]
        u_s[ri, n_rec[ri]] = us[ok]
        lnt_s[ri, n_rec[ri]] = (ls + ts * hs)[ok]
        n_rec[ri] += 1
        stop = stop | ((n_rec >= free) & (n_rec > 0))
        cursor = torch.where(has, idx + 1, torch.full_like(idx, K))
    return n_rec, u_s, lnt_s, dense.to(dt), n_root


# ---------------------------------------------------------------------------
# plain models of the warp algorithms (csrc/tree_warp.cuh, tree_device.cuh),
# for the CPU tests: lanes are a last dimension of 32, a shuffle is a gather
# along it, a ballot a boolean row
# ---------------------------------------------------------------------------

_LANES = 32
_NODE = torch.arange(1, _LANES + 1)                  # lane l holds bisection node l + 1
_DEPTH = torch.tensor([n.bit_length() - 1 for n in range(1, _LANES + 1)])


def _bisect_warp(g_fn, tlo, thi, glo, iters):
    """art::bisect_warp on [n] roots: rounds of up to 5 levels; lane l
    rebuilds node l + 1 of the round's tree (children 2n left, 2n + 1 right)
    by replaying tm = 0.5 * (lo + hi) along its path bits, g_fn evaluates
    every lane's node ([n, 32] taus), and the walk reads each level's node by
    shuffle and applies the serial rule.  Returns (tlo, thi): _bisect's."""
    dev = tlo.device
    node_n, depth = _NODE.to(dev), _DEPTH.to(dev)
    rows = torch.arange(tlo.shape[0], device=dev)
    left = iters
    while left > 0:
        levels = min(left, 5)
        lo = tlo[:, None].expand(-1, _LANES)
        hi = thi[:, None].expand(-1, _LANES)
        for d in range(4, -1, -1):        # path bits below the leading one, top first
            on = depth > d
            mid = 0.5 * (lo + hi)
            right = ((node_n >> d) & 1) == 1
            lo, hi = torch.where(on & right, mid, lo), torch.where(on & ~right, mid, hi)
        tm = 0.5 * (lo + hi)
        gm = torch.where(depth < levels, g_fn(tm), torch.zeros_like(tm))
        node = torch.ones_like(rows)
        for _ in range(levels):
            tn, gn = tm[rows, node - 1], gm[rows, node - 1]
            keep = torch.sign(gn) == torch.sign(glo)
            tlo, thi = torch.where(keep, tn, tlo), torch.where(keep, thi, tn)
            glo = torch.where(keep, gn, glo)
            node = torch.where(keep, 2 * node + 1, 2 * node)
        left -= levels
    return tlo, thi


def _scan_roots_warp(P, x0, u0, u1, f0, f1, h, lnt0, g0, g1, g_tau=None, free=None):
    """The warp's event scan (art::dp5_step_warp) on [m] accepted steps,
    with _scan_roots' arguments and outputs.  A pass of K points runs in
    rounds of 32 lanes: lane l holds j = 32 r + l + 1 <= K (g1 at j = K), at
    tau = j / K; its left neighbour comes by shfl_up (lane 0: the previous
    round's last value), the sign changes as a ballot.  The coarse gate is
    one pass of Kc points; the dense pass bisects its flips (_bisect_warp)
    in increasing j, at most max_roots of them, recording each that passes
    the filters, until the last free slot is filled."""
    m = u0.shape[0]
    dev, dt = u0.device, u0.dtype
    g_tau = g_tau or _g_interp(P, u0, u1, f0, f1, h, lnt0)
    rows = torch.arange(m, device=dev)[:, None]
    lane = torch.arange(_LANES, device=dev)
    free = torch.ones(m, dtype=torch.int64, device=dev) if free is None else free

    def rounds(n_pts):
        """(j [32], g [m, 32], g(j - 1) [m, 32], ballot [m, 32]) per round."""
        carry = g0
        for base in range(0, n_pts, _LANES):
            j = base + lane + 1
            g = torch.where(j < n_pts, g_tau(rows, (j.to(dt) / n_pts)[None, :]), g1[:, None])
            gp = torch.cat([carry[:, None], g[:, :-1]], dim=1)
            carry = g[:, -1]
            yield j, g, gp, (j <= n_pts) & _flipped(gp, g)

    n_rec = torch.zeros(m, dtype=torch.int64, device=dev)
    u_s = torch.zeros((m, P.max_roots, 7), dtype=dt, device=dev)
    lnt_s = torch.zeros((m, P.max_roots), dtype=dt, device=dev)
    n_root = torch.zeros(m, dtype=dt, device=dev)
    K, Kc = P.interp, P.interp_coarse
    dense = torch.ones(m, dtype=torch.bool, device=dev)
    if Kc > 0:
        flip_c = torch.zeros(m, dtype=torch.bool, device=dev)
        low = torch.abs(g0) < P.gate_theta
        for j, g, _, ballot in rounds(Kc):
            flip_c = flip_c | ballot.any(dim=1)
            low = low | ((j <= Kc) & (torch.abs(g) < P.gate_theta)).any(dim=1)
        dense = flip_c | low
    if not bool(dense.any()):
        return n_rec, u_s, lnt_s, dense.to(dt), n_root
    stop = ~dense
    for j, g, gp, ballot in rounds(K):
        for lo in range(_LANES):            # __ffs order: increasing lane
            li = (ballot[:, lo] & ~stop).nonzero().squeeze(1)
            if li.numel() == 0:
                continue
            jr = int(j[lo])
            n_root[li] += 1.0
            tlo, thi = _bisect_warp(lambda t: g_tau(li[:, None], t),
                                    torch.full((li.shape[0],), float(jr - 1), dtype=dt, device=dev) / K,
                                    torch.full((li.shape[0],), float(jr), dtype=dt, device=dev) / K,
                                    gp[li, lo], P.bisect)
            ts = 0.5 * (tlo + thi)
            sub = lambda t: tuple(t[li, c] for c in range(7))
            us = torch.stack(_hermite(sub(u0), sub(u1), sub(f0), sub(f1), h[li], ts), dim=1)
            first = free[li] - n_rec[li] == P.max_crossings
            ok = _root_filter(P, x0[li], us, first) & (n_rec[li] < free[li])
            ri = li[ok]
            u_s[ri, n_rec[ri]] = us[ok]
            lnt_s[ri, n_rec[ri]] = (lnt0[li] + ts * h[li])[ok]
            n_rec[ri] += 1
            stop = stop | ((n_rec >= free) & (n_rec > 0)) | (n_root >= P.max_roots)
    return n_rec, u_s, lnt_s, dense.to(dt), n_root


def _pop_best(q):
    """The serial pop rule on [n, QD, 16] queues: (found [n], best [n]), the
    pending slot of the largest weight, ties to the lower pool slot, then to
    the lower slot index."""
    pend = q[:, :, Q_ST] > 0.5
    wv = torch.where(pend, q[:, :, Q_W], torch.full_like(q[:, :, Q_W], -math.inf))
    cand = pend & (wv == wv.amax(dim=1, keepdim=True))
    slot = torch.where(cand, q[:, :, Q_SLOT], torch.full_like(wv, math.inf))
    return pend.any(dim=1), torch.argmin(slot, dim=1)


def _pop_best_warp(q):
    """The warp's pop (art::tree_run) on [n, QD, 16] queues, with _pop_best's
    outputs: lane l takes the best of its slots l, l + 32, ... by the serial
    rule, then a butterfly of xor shuffles keeps, of two candidates, the
    larger weight, then the lower pool slot, then the lower slot index;
    lane 0's pick is the warp's."""
    n, qd = q.shape[:2]
    dev, dt = q.device, q.dtype
    lane = torch.arange(_LANES, device=dev)
    best = torch.full((n, _LANES), -1, dtype=torch.int64, device=dev)
    bw = torch.zeros((n, _LANES), dtype=dt, device=dev)
    bsl = torch.zeros_like(bw)
    for base in range(0, qd, _LANES):
        s = base + lane
        sc = s.clamp(max=qd - 1)
        st, ws, sl = (q[:, sc, r] for r in (Q_ST, Q_W, Q_SLOT))
        take = (s < qd) & ~(st < 0.5) & ((best < 0) | (ws > bw) | ((ws == bw) & (sl < bsl)))
        best = torch.where(take, s.expand(n, -1), best)
        bw, bsl = torch.where(take, ws, bw), torch.where(take, sl, bsl)
    for off in (16, 8, 4, 2, 1):
        ob, ow, osl = best[:, lane ^ off], bw[:, lane ^ off], bsl[:, lane ^ off]
        take = (ob >= 0) & ((best < 0) | (ow > bw) | (
            (ow == bw) & ((osl < bsl) | ((osl == bsl) & (ob < best)))))
        best = torch.where(take, ob, best)
        bw, bsl = torch.where(take, ow, bw), torch.where(take, osl, bsl)
    pick = best[:, 0]
    return pick >= 0, pick.clamp(min=0)


def _step(P, S, run, lnt1, erg, x0):
    """One attempted DP5 step of the lanes `run` (art::dp5_step with one
    crossing slot).  Updates S in place; returns (seg_end, crossed, u_root,
    lnt_root), [n] masks and the root of the crossed lanes."""
    n = run.shape[0]
    dev = run.device
    u, f0 = S["u"], S["f0"]
    ph = S["is_ph"]
    h = torch.clamp(torch.minimum(S["dt"], lnt1 - S["lnt"]), min=0.0)
    uc = u.unbind(1)
    ks = [f0.unbind(1)]
    for s in range(1, 7):
        ui = tuple(uc[c] + h * _lin(DP_A[s], ks, c) for c in range(7))
        ks.append(_rhs(P, ui, S["lnt"] + DP_C[s] * h, erg, ph))
    u_new = torch.stack([uc[c] + h * _lin(DP_A[6], ks, c) for c in range(7)], dim=1)
    f_new = torch.stack(ks[6], dim=1)
    e = torch.stack([h * _lin(DP_E, ks, c) for c in range(7)], dim=1)
    sc = P.atol + P.rtol * torch.maximum(torch.abs(u), torch.abs(u_new))
    enorm = torch.sqrt(((e / sc) ** 2).sum(dim=1) / 7.0)
    forced = S["dt"] <= P.dt_min * 1.0000001
    accept = ((enorm <= 1.0) | forced) & (h > 0.0) & run
    en_safe = torch.where(enorm > 0.0, enorm, torch.full_like(enorm, 1e-10))
    if P.pi_beta != 0.0:
        fac = P.safety * en_safe ** (-P.expo1) * S["errold"] ** P.pi_beta
        fac = torch.clamp(fac, P.min_fac, P.max_fac)
        fac = torch.where(accept, fac, torch.clamp(fac, max=1.0))
    else:
        fac = torch.clamp(P.safety * en_safe ** -0.2, P.min_fac, P.max_fac)
    dt_next = torch.clamp(S["dt"] * fac, min=P.dt_min)
    t1 = S["lnt"] + h
    g_new = _g(P, u_new, t1)

    u_prev, lnt_prev, g_prev = u, S["lnt"], S["g0"]
    a1 = accept[:, None]
    S["u"] = torch.where(a1, u_new, u)
    S["lnt"] = torch.where(accept, t1, lnt_prev)
    S["g0"] = torch.where(accept, g_new, g_prev)
    S["errold"] = torch.where(accept, torch.clamp(enorm, min=1e-4), S["errold"])
    S["dt"] = torch.where(run, dt_next, S["dt"])
    S["steps"] = S["steps"] + run.to(S["steps"].dtype)

    crossed = torch.zeros(n, dtype=torch.bool, device=dev)
    u_root = torch.zeros_like(u)
    lnt_root = torch.zeros_like(lnt_prev)
    ai = accept.nonzero().squeeze(1)
    if ai.numel():
        n_rec, us, ls, nf, nb = _scan_roots(P, x0[ai], u_prev[ai], u_new[ai], f0[ai],
                                            f_new[ai], h[ai], lnt_prev[ai], g_prev[ai],
                                            g_new[ai])
        S["nfine"][ai] += nf
        S["nbisect"][ai] += nb
        rec = n_rec > 0               # one slot: at most one record, the step's end
        ri = ai[rec]
        crossed[ri] = True
        u_root[ri] = us[rec, 0]
        lnt_root[ri] = ls[rec, 0]
        S["u"][ri] = us[rec, 0]       # the crossing cap stops at the root
        S["lnt"][ri] = ls[rec, 0]
    S["f0"] = torch.where(a1, f_new, f0)

    live = run & ~crossed
    ns = accept & (ph > 0.5) & (S["u"][:, 0] < P.r_ns * 1.01)
    reached = accept & (t1 >= lnt1 - 1e-14)
    maxed = S["steps"] >= P.max_steps
    stalled = torch.zeros_like(run)
    if P.stall_window > 0:
        at_win = live & (torch.remainder(S["steps"], P.stall_window) == 0)
        stalled = at_win & (S["lnt"] - S["lnt_ck"] < P.stall_min)
        S["lnt_ck"] = torch.where(at_win, S["lnt"], S["lnt_ck"])
    seg_end = crossed | (live & (ns | reached | maxed | stalled))
    return seg_end, crossed, u_root, lnt_root


def _segment_end(P, T: TreeParams, S, ends, crossed, u_root, lnt_root, p_root, lnt1, erg,
                 x0, uni, q, fin, mass_eff):
    """Segment ends of the lanes `ends` (the kernel's segment-end block):
    final record or children, cutoffs, pop and restart.  Updates S, x0, q
    and fin in place; returns the lanes whose tree stopped."""
    dev, dt = S["u"].device, S["u"].dtype
    rare = torch.zeros_like(ends)
    ci = crossed.nonzero().squeeze(1)
    if ci.numel():   # rare-fail guard (MainRunner.jl:213-224)
        rare[ci] = rare_crossing(u_root[ci], erg[ci], mass_eff)
    exit_ = ends & ~crossed
    w = S["w"]
    S["totp"] = S["totp"] + torch.where(exit_ | rare, w, torch.zeros_like(w))
    overflow = exit_ & ~(S["cmain"] < T.nf - 0.5)

    fi = (exit_ & ~overflow).nonzero().squeeze(1)
    if fi.numel():   # final records (MainRunner.jl:200-207)
        rec = torch.stack([torch.ones_like(w[fi]), (S["u"][fi, 0] > P.r_ns * 1.1).to(dt),
                           S["is_ph"][fi], S["ord"][fi], w[fi], S["prob"][fi], S["pconv"][fi],
                           S["pconv0"][fi], S["tb"][fi]], dim=1)
        fin[fi, S["cmain"][fi].long()] = torch.cat([rec, S["u"][fi]], dim=1)
    S["cmain"] = S["cmain"] + exit_.to(dt)

    spawn = crossed & ~rare
    si = spawn.nonzero().squeeze(1)
    if si.numel():   # children (MainRunner.jl:278-305)
        ord_ = S["ord"][si]
        mc = ord_ > T.mc_nodes + 0.5
        ix = ord_.long() - 1          # node index n draws fold_in(event_key, n)
        in_rng = (ix >= 0) & (ix < T.uu)
        u_draw = torch.where(in_rng, uni[si, ix.clamp(0, T.uu - 1)], torch.zeros_like(ord_))
        p = p_root[si]
        conv, uc, dw_child = child_birth(P, u_root[si], erg[si], u_draw, p)
        is_ph = S["is_ph"][si]
        flip = 1.0 - is_ph
        w_s, pconv = w[si], S["pconv"][si]
        nall = S["nall"][si]
        row_a = torch.stack([lnt_root[si], torch.where(mc, torch.where(conv, flip, is_ph), flip),
                             torch.where(mc, w_s, p * w_s),
                             torch.where(mc, torch.where(conv, p, 1.0 - p), p), p,
                             torch.where(mc, torch.where(conv, p, pconv), p), dw_child, nall,
                             torch.ones_like(p)], dim=1)
        row_b = torch.stack([lnt_root[si], is_ph, (1.0 - p) * w_s, 1.0 - p, p, pconv, dw_child,
                             nall + 1.0, torch.ones_like(p)], dim=1)
        free = q[si, :, Q_ST] < 0.5                                    # [m, QD]
        rank = torch.cumsum(free.to(torch.int64), dim=1)
        pos_a = free & (rank == 1)
        pos_b = free & (rank == 2) & ~mc[:, None]
        for pos, row in ((pos_a, row_a), (pos_b, row_b)):
            li, sl = pos.nonzero(as_tuple=True)
            q[si[li], sl] = torch.cat([uc[li], row[li]], dim=1)
        # QD = mc_nodes + 2 bounds the pending count: a failed push means a
        # shrunk queue, and the host replays the event
        fail = ~pos_a.any(dim=1) | (~mc & ~pos_b.any(dim=1))
        overflow[si] = overflow[si] | fail
        S["nall"][si] = nall + torch.where(mc, 1.0, 2.0).to(dt)

    # per-node cutoffs (MainRunner.jl:324-339), overflow first
    info = S["info"]
    hit2 = S["totp"] >= 1.0 - T.prob_cutoff
    hit3 = S["cmain"] >= T.num_cutoff - 0.5
    hit4 = S["count"] > T.max_nodes + 0.5
    code = torch.where(overflow, INFO_OVERFLOW, torch.where(
        hit2, 2.0, torch.where(hit3, 3.0, torch.where(hit4, 4.0, 0.0))))
    stop = ends & (code > 0.0)
    S["info"] = torch.where(stop, code.to(dt), info)

    # pop the max-weight pending node, ties to the lower pool slot
    want = ends & ~stop
    pend = q[:, :, Q_ST] > 0.5
    found = pend.any(dim=1)
    stop = stop | (want & ~found)      # worklist exhausted: info stays 1
    pi = (want & found).nonzero().squeeze(1)
    if pi.numel():
        qp = q[pi]
        best = _pop_best(qp)[1]
        row = qp[torch.arange(pi.shape[0], device=dev), best]
        q[pi, best, Q_ST] = 0.0
        S["count"][pi] = S["count"][pi] + 1.0
        S["ord"][pi] = S["count"][pi]
        dw = row[:, Q_DW]
        S["dw"][pi] = dw
        S["anom"][pi] = S["anom"][pi] + ((dw > -0.5) | (dw < -2.0)).to(dt)
        u = row[:, Q_U0:Q_U0 + 7]
        lnt = row[:, Q_LNT]
        is_ph = row[:, Q_ISPH]
        for name, r in (("w", Q_W), ("prob", Q_PROB), ("pconv", Q_PCONV), ("pconv0", Q_PCONV0)):
            S[name][pi] = row[:, r]
        S["tb"][pi] = torch.exp(lnt)
        f0 = _f(P, u, lnt, erg[pi], is_ph)
        S["u"][pi] = u
        S["lnt"][pi] = lnt
        S["is_ph"][pi] = is_ph
        S["f0"][pi] = f0
        S["g0"][pi] = _g(P, u, lnt)
        S["dt"][pi] = _initial_dt(P, u, f0, lnt1[pi] - lnt)
        S["steps"][pi] = 0.0
        S["lnt_ck"][pi] = lnt
        S["errold"][pi] = 1e-4
        x0[pi] = _cart(u)
    return stop


# aux rows carried as per-lane state by the plain versions
_REGS = {"lnt": A_LNT, "errold": A_ERROLD, "dt": A_DT, "steps": A_STEPS, "lnt_ck": A_LNTCK,
         "is_ph": A_ISPH, "info": A_INFO, "count": A_COUNT, "cmain": A_CMAIN, "totp": A_TOTP,
         "anom": A_ANOM, "nall": A_NALLOC, "w": A_WCUR, "prob": A_PROB, "pconv": A_PCONV,
         "pconv0": A_PCONV0, "tb": A_TB, "dw": A_DW, "ord": A_ORD, "steptot": A_STEPTOT,
         "nfine": A_NFINE, "nbisect": A_NBISECT, "steps_ph": A_STEPS_PH, "ncross": A_NCROSS,
         "nacc": A_NACC}


def _load(P, uin, aux, uni, qin, ev, nf: int, qd: int):
    """Per-lane state of the plain versions for the events `ev` [n] (a
    warp reading its event's rows): the registers, the integrator state
    with f0, g0 and, where aux holds none, the initial step, the event's
    energy, end time, uniforms and queue, and empty finals."""
    a = aux[ev]
    L = {k: a[:, r].clone() for k, r in _REGS.items()}
    L["u"] = uin[ev, 0:7].clone()
    L["ph_in"], L["cross_in"] = uin[ev, U_PH_IN].clone(), uin[ev, U_CROSS_IN].clone()
    L["erg"], L["lnt1"] = a[:, A_ERG], a[:, A_LNT1]
    L["x0"] = a[:, A_X0X:A_X0Z + 1].clone()
    L["un"] = uni[ev]
    L["q"] = qin[ev].reshape(-1, qd, ROWS).clone()
    L["fl"] = torch.zeros((ev.shape[0], nf, ROWS), dtype=torch.float64, device=uin.device)
    L["f0"] = _f(P, L["u"], L["lnt"], L["erg"], L["is_ph"])
    L["g0"] = _g(P, L["u"], L["lnt"])
    L["dt"] = torch.where(L["dt"] > 0.0, L["dt"],
                          _initial_dt(P, L["u"], L["f0"], L["lnt1"] - L["lnt"]))
    return L


def _store(L, lanes, ev, uout, auxout, qout, fin, done, iters):
    """Write the state of `lanes` back into the rows of their events `ev`
    (a warp writing its event out), with A_DONE = done and A_ITERS =
    iters."""
    n = ev.shape[0]
    a = auxout[ev]
    for k, r in _REGS.items():
        a[:, r] = L[k][lanes]
    a[:, A_X0X:A_X0Z + 1] = L["x0"][lanes]
    a[:, A_DONE] = done.to(a.dtype)
    a[:, A_ITERS] = iters
    auxout[ev] = a
    uout[ev, 0:7] = L["u"][lanes]
    uout[ev, U_PH_IN], uout[ev, U_CROSS_IN] = L["ph_in"][lanes], L["cross_in"][lanes]
    qout[ev] = L["q"][lanes].reshape(n, -1)
    fin[ev] = L["fl"][lanes].reshape(n, -1)


def _advance(P, T: TreeParams, L, active, mass_eff):
    """One lockstep iteration of the lanes `active`: a DP5 step of each whose
    node starts before lnt1, then the segment ends (a node born at or after
    lnt1 ends at once).  Updates L in place; returns the lanes whose tree
    stopped."""
    f64 = L["u"].dtype
    nostep = active & (L["lnt"] >= L["lnt1"])
    run = active & ~nostep
    L["steptot"] = L["steptot"] + run.to(f64)
    L["steps_ph"] = L["steps_ph"] + (run & (L["is_ph"] > 0.5)).to(f64)
    lnt_prev = L["lnt"]   # an accepted step always advances lnt
    L["ph_in"] = L["ph_in"] + (run & (L["is_ph"] > 0.5) & (L["u"][:, 0] < P.r_metric)).to(f64)
    seg_end, crossed, u_root, lnt_root = _step(P, L, run, L["lnt1"], L["erg"], L["x0"])
    L["cross_in"] = L["cross_in"] + (crossed & (u_root[:, 0] < P.r_metric)).to(f64)
    L["nacc"] = L["nacc"] + (run & (L["lnt"] != lnt_prev)).to(f64)
    L["ncross"] = L["ncross"] + crossed.to(f64)
    ends = (seg_end & run) | nostep
    if not bool(ends.any()):
        return torch.zeros_like(active)
    p_root = torch.zeros_like(lnt_root)
    ci = crossed.nonzero().squeeze(1)
    if ci.numel():
        p_root[ci] = _prob_nd(P, u_root[ci].unbind(1), L["erg"][ci])
    return _segment_end(P, T, L, ends, crossed, u_root, lnt_root, p_root, L["lnt1"], L["erg"],
                        L["x0"], L["un"], L["q"], L["fl"], mass_eff)


def tree_kernel_launch_plain(uin, aux, uni, qin, sc: Scene, cfg: NumericsConfig,
                             tcfg: TreeConfig, *, nf: int, qd: int, it_cap: int):
    """K3's plain version on the same blocks: the lanes whose aux[A_DONE] is
    clear advance in lockstep, one DP5 step (or segment end) per loop
    iteration, for at most it_cap iterations.  Same contract as
    tree_kernel_launch."""
    P = kernel_params(sc, cfg)
    B = uin.shape[0]
    T = tree_params(tcfg, nf=nf, qd=qd, uu=uni.shape[1], it_cap=it_cap)
    uout, auxout, qout = uin.clone(), aux.clone(), qin.clone()
    fin = torch.zeros((B, nf * ROWS), dtype=torch.float64, device=uin.device)
    li = (aux[:, A_DONE] < 0.5).nonzero().squeeze(1)
    if li.numel() == 0 or it_cap <= 0:
        return uout, auxout, qout, fin
    L = _load(P, uin, aux, uni, qin, li, nf, qd)
    done = torch.zeros(li.shape[0], dtype=torch.bool, device=uin.device)
    it = 0
    while it < it_cap and not bool(done.all()):
        it += 1
        done = done | _advance(P, T, L, ~done, sc.mass_ns_eff)
    _store(L, slice(None), li, uout, auxout, qout, fin, done, aux[li, A_ITERS] + 1.0)
    return uout, auxout, qout, fin


def tree_kernel_launch(uin, aux, uni, qin, sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig,
                       *, nf: int, qd: int, it_cap: int):
    """One K3 launch over [B] events.  uin [B, 16], aux [B, 32], uni [B, UU],
    qin [B, QD*16], all f64 (row layouts at the module top).  Returns
    (uout, auxout, qout, fin [B, NF*16]): the state after at most it_cap
    steps per event, and this launch's final records (F_VALID set on the
    slots written).  Events with aux[A_DONE] set are left as they are.
    CPU tensors run tree_kernel_launch_plain; a scene the kernel refuses
    (check_tree_scene) raises on either device."""
    check_tree_scene(sc, cfg)
    if uin.device.type == "cpu":
        return tree_kernel_launch_plain(uin, aux, uni, qin, sc, cfg, tcfg, nf=nf, qd=qd,
                                        it_cap=it_cap)
    P = kernel_params(sc, cfg)
    variant = tree_variant(P)
    lib = cuda_lib.lib(variant)
    B = uin.shape[0]
    uu = uni.shape[1]
    _require_blocks(uin, aux, uni, qin, qd)
    uout, auxout, qout = uin.clone(), aux.clone(), qin.clone()
    fin = torch.zeros((B, nf * ROWS), dtype=torch.float64, device=uin.device)
    code = lib.art_treekernel(uout.data_ptr(), auxout.data_ptr(), uni.data_ptr(),
                              qout.data_ptr(), fin.data_ptr(), B, P,
                              tree_params(tcfg, nf=nf, qd=qd, uu=uu, it_cap=it_cap),
                              cuda_lib.stream_ptr(uin))
    cuda_lib.check(code, "treekernel launch")
    cuda_lib.count_launch("treekernel", variant)
    return uout, auxout, qout, fin


def tree_variant(P) -> cuda_lib.Variant:
    """The library of a K3 or K4 launch: the condition, gate and RHS modes
    of P (a variant library at a non-default one); K3 and K4 have no step
    profile and no resumable instantiation."""
    return variant_of(P)._replace(profile="full", resume=False)


def _require_blocks(uin, aux, uni, qin, qd):
    B, uu = uin.shape[0], uni.shape[1]
    for t, name, shape in ((uin, "uin", (B, U_ROWS)), (aux, "aux", (B, AUX_ROWS)),
                           (uni, "uni", (B, uu)), (qin, "qin", (B, qd * ROWS))):
        cuda_lib.require(t, name, torch.float64, shape)


def _check_refill(epart, refill_k, it_cap, lanes):
    if not (epart >= 1 and refill_k >= 1 and 0 <= it_cap < 2**31 and lanes >= 1):
        raise ValueError(f"K4 takes epart >= 1, refill_k >= 1, 0 <= it_cap < 2**31 and "
                         f"at least one lane or warp; got {epart}, {refill_k}, {it_cap}, "
                         f"{lanes}")


@functools.lru_cache(maxsize=None)
def resident_warps(device_index: int, variant: cuda_lib.Variant = None) -> int:
    """The warps K4 (of `variant`'s library) keeps resident at once on a
    card: blocks per SM at its registers (CUDA occupancy) x SMs x 4."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        cuda_lib.check(cuda_lib.lib(variant).art_treerefill_resident_warps(ctypes.byref(out)),
                       "treerefill occupancy")
    return out.value


def refill_warps(E: int, epart: int, device: torch.device, variant=None) -> int:
    """K4's default warps per partition: the card's resident warps shared
    by the ceil(E / epart) partitions, at least 1."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, resident_warps(index, variant) // max(-(-E // epart), 1))


def tree_refill_launch_plain(uin, aux, uni, qin, sc: Scene, cfg: NumericsConfig,
                             tcfg: TreeConfig, *, nf: int, qd: int, epart: int, refill_k: int,
                             it_cap: int, lanes: int = 128):
    """K4's plain version on the same blocks: each partition's `lanes` in
    lockstep, one DP5 step (or segment end) of every busy lane per
    loop iteration.  At iteration 0, and whenever the iteration count is a
    multiple of refill_k, the idle lanes of a partition take its next live
    events in lane order; a lane whose tree stops writes its event's rows at
    once, with A_ITERS = the iteration count.  A partition with nv live
    events runs min(lanes, nv) lanes (the others would never get one).
    Same contract as tree_refill_launch."""
    _check_refill(epart, refill_k, it_cap, lanes)
    P = kernel_params(sc, cfg)
    E = uin.shape[0]
    dev = uin.device
    T = tree_params(tcfg, nf=nf, qd=qd, uu=uni.shape[1], it_cap=it_cap)
    uout, auxout, qout = uin.clone(), aux.clone(), qin.clone()
    fin = torch.zeros((E, nf * ROWS), dtype=torch.float64, device=dev)
    live = aux[:, A_DONE] < 0.5
    queues = [live[p0:p0 + epart].nonzero().squeeze(1) + p0 for p0 in range(0, E, epart)]
    n_lanes = [min(lanes, int(qq.numel())) for qq in queues]
    first = [0]
    for n in n_lanes:
        first.append(first[-1] + n)
    if first[-1] == 0 or it_cap <= 0:
        return uout, auxout, qout, fin
    heads = list(n_lanes)
    lane_ev = torch.cat([qq[:n] for qq, n in zip(queues, n_lanes)])
    L = _load(P, uin, aux, uni, qin, lane_ev, nf, qd)
    busy = torch.ones(first[-1], dtype=torch.bool, device=dev)
    it = 0
    while it < it_cap:
        if it % refill_k == 0:
            new_l, new_e = [], []
            for p, qq in enumerate(queues):
                k = qq.numel() - heads[p]
                if k <= 0:
                    continue
                idle = (~busy[first[p]:first[p + 1]]).nonzero().squeeze(1) + first[p]
                k = min(k, idle.numel())
                if k:
                    new_l.append(idle[:k])
                    new_e.append(qq[heads[p]:heads[p] + k])
                    heads[p] += k
            if new_l:
                ln, ev = torch.cat(new_l), torch.cat(new_e)
                for key, val in _load(P, uin, aux, uni, qin, ev, nf, qd).items():
                    L[key][ln] = val
                lane_ev[ln] = ev
                busy[ln] = True
        if not bool(busy.any()):
            if all(h >= qq.numel() for h, qq in zip(heads, queues)):
                break
            it = (it // refill_k + 1) * refill_k   # every lane waits for the next refill
            continue
        stop = _advance(P, T, L, busy, sc.mass_ns_eff)
        it += 1
        si = stop.nonzero().squeeze(1)
        if si.numel():
            _store(L, si, lane_ev[si], uout, auxout, qout, fin,
                   torch.ones(si.shape[0], dtype=torch.bool, device=dev), float(it))
            busy[si] = False
    bi = busy.nonzero().squeeze(1)   # budget spent: these events stay live
    if bi.numel():
        _store(L, bi, lane_ev[bi], uout, auxout, qout, fin,
               torch.zeros(bi.shape[0], dtype=torch.bool, device=dev), float(it))
    return uout, auxout, qout, fin


def tree_refill_launch(uin, aux, uni, qin, sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig,
                       *, nf: int, qd: int, epart: int, refill_k: int, it_cap: int,
                       warps: int | None = None):
    """One K4 launch over [E] events in partitions of `epart` (the last may
    be short), each served by `warps` warps (default: the card's resident
    warps over the partitions, at least 1) pulling its events from a queue,
    one tree per warp.  Same blocks as tree_kernel_launch; returns (uout,
    auxout, qout, fin [E, NF*16]).  Every event with aux[A_DONE] clear runs
    until its tree is done, unless its warp's it_cap iterations run out first
    (then its A_DONE stays clear); aux[A_ITERS] gets the serving warp's
    iteration count when the event stopped.  CPU tensors run
    tree_refill_launch_plain (128 lockstep lanes per partition); the results
    per event depend on neither schedule.  A scene the kernel refuses
    (check_tree_scene) raises on either device."""
    check_tree_scene(sc, cfg)
    if uin.device.type == "cpu":
        return tree_refill_launch_plain(uin, aux, uni, qin, sc, cfg, tcfg, nf=nf, qd=qd,
                                        epart=epart, refill_k=refill_k, it_cap=it_cap)
    _check_refill(epart, refill_k, it_cap, 1 if warps is None else warps)
    E = uin.shape[0]
    P = kernel_params(sc, cfg)
    variant = tree_variant(P)
    warps = refill_warps(E, epart, uin.device, variant) if warps is None else warps
    lib = cuda_lib.lib(variant)
    _require_blocks(uin, aux, uni, qin, qd)
    uout, auxout, qout = uin.clone(), aux.clone(), qin.clone()
    fin = torch.zeros((E, nf * ROWS), dtype=torch.float64, device=uin.device)
    heads = torch.zeros(-(-E // epart), dtype=torch.int32, device=uin.device)
    code = lib.art_treerefill(uout.data_ptr(), auxout.data_ptr(), uni.data_ptr(),
                              qout.data_ptr(), fin.data_ptr(), heads.data_ptr(), E, epart,
                              warps, refill_k, it_cap, P,
                              tree_params(tcfg, nf=nf, qd=qd, uu=uni.shape[1], it_cap=it_cap),
                              cuda_lib.stream_ptr(uin))
    cuda_lib.check(code, "treerefill launch")
    cuda_lib.count_launch("treerefill", variant)
    return uout, auxout, qout, fin


# ---------------------------------------------------------------------------
# forward_tree_kernel: the tree engine around K3 and K4
# ---------------------------------------------------------------------------


def _ceil_to(n, m):
    return ((n + m - 1) // m) * m


def stage_sizes(E: int, floor: int = 128):
    """Buffer widths of the staged relaunch: each stage 4x narrower, in
    multiples of 128, down to `floor` (treekernel.py:1264-1269 of the
    reference)."""
    sizes, n = [], _ceil_to(E, 128)
    while n > floor:
        n = max(((n // 4) // 128) * 128, floor)
        sizes.append(n)
    return sizes


def tree_inputs(keys, xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
                tcfg: TreeConfig, *, lnt_end):
    """K3's input blocks (uin, aux, uni, qin) for the roots of E events: the
    root state as the host engine launches it, popped at launch (count 1),
    and the pre-drawn uniforms fold_in(event_key, n), n = 1..UU.  The root
    state, its probability (at cfg.compute_dtype, treekernel.py:1114 of the
    reference) and the uniforms are computed in the state dtype, xpos's, as
    the host engine computes them; the blocks hold them in f64, the
    kernels' dtype."""
    from adiabatic_raytracer_tpu_torch.ops.tree import _prob_batch

    E = xpos.shape[0]
    dev, dt, f64 = xpos.device, xpos.dtype, torch.float64
    QD = int(tcfg.mc_nodes + 2)
    UU = _ceil_to(int(tcfg.max_nodes) + 1, 8)
    u0 = launch_state(xpos, k_init, sc, erg_inf, -torch.ones(E, dtype=dt, device=dev))
    prob0, _ = _prob_batch(xpos, k_init, erg_inf, sc, cfg.compute_dtype)
    ln_floor = math.exp(float(cfg.ln_t_start))
    lnt0 = torch.log(torch.clamp(torch.zeros(E, dtype=dt, device=dev), min=ln_floor))
    uin = torch.zeros((E, U_ROWS), dtype=f64, device=dev)
    uin[:, 0:7] = u0
    aux = torch.zeros((E, AUX_ROWS), dtype=f64, device=dev)
    for r, v in ((A_LNT, lnt0), (A_ERROLD, 1e-4), (A_ISPH, 1.0), (A_INFO, 1.0),
                 (A_COUNT, 1.0), (A_NALLOC, 1.0), (A_WCUR, 1.0), (A_PROB, prob0),
                 (A_PCONV, -1.0), (A_PCONV0, -1.0), (A_DW, -1.0), (A_ORD, 1.0),
                 (A_ERG, erg_inf), (A_LNT1, float(lnt_end))):
        aux[:, r] = v
    aux[:, A_X0X:A_X0Z + 1] = xpos
    node_ix = torch.arange(1, UU + 1, device=dev)
    uni = rng.uniform(rng.fold_in(keys[:, None, :], node_ix), dtype=dt).to(f64)
    qin = torch.zeros((E, QD * ROWS), dtype=f64, device=dev)
    return uin, aux, uni.contiguous(), qin


def _launch_packed(st, sc, cfg, tcfg, NF, QD, it_cap):
    """One relaunch: actives first (stable), then K3 over the buffer;
    finals merge on this launch's written flags."""
    order = torch.argsort(st["aux"][:, A_DONE], stable=True)
    st = {k: v[order] for k, v in st.items()}
    uo, ao, qo, f = tree_kernel_launch(st["uin"], st["aux"], st["uni"], st["qin"], sc, cfg,
                                       tcfg, nf=NF, qd=QD, it_cap=it_cap)
    B = f.shape[0]
    fr = f.reshape(B, NF, ROWS)
    took = fr[..., F_VALID] > 0.5
    fin = torch.where(took[..., None], fr, st["fin"].reshape(B, NF, ROWS)).reshape(B, -1)
    return dict(idx=st["idx"], uni=st["uni"], uin=uo, aux=ao, qin=qo, fin=fin)


def refill_partition(E: int, refill: int) -> int:
    """Events per K4 partition (treekernel.py:1164-1165 of the reference):
    1024 at tree_refill=1, else tree_refill but at least 128, rounded up to
    a multiple of 128 and no wider than the batch so rounded."""
    epc = 1024 if refill == 1 else max(int(refill), 128)
    return min(_ceil_to(E, 128), _ceil_to(epc, 128))


def run_tree_kernel(uin, aux, uni, qin, sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, *,
                    nf: int, qd: int):
    """Every event's tree to its end.  tree_refill > 0: one K4 launch over
    partitions of refill_partition(E, tree_refill) events, the card's
    resident warps shared among them, refill period tree_refill_k, it_cap
    per warp as at treekernel.py:1189 of the reference; an event left
    unfinished raises.  Else K3: one launch
    (tree_kernel_chunk = 0), or bounded relaunches of tree_kernel_chunk steps
    with staged straggler compaction (treekernel.py:1209-1290 of the
    reference): every launch packs the live events first; each stage runs
    until the live events fit the next, 4x narrower buffer, then cuts to it,
    and the step budget grows 4x.  Returns (auxout, fin) in input order."""
    it_full = (int(tcfg.max_nodes) + 2) * (int(cfg.max_steps) + 2)
    E = uin.shape[0]
    if int(cfg.tree_refill) > 0:
        ep = refill_partition(E, int(cfg.tree_refill))
        cap = min(it_full * ep, 2**31 - 2)
        _, auxout, _, fin = tree_refill_launch(uin, aux, uni, qin, sc, cfg, tcfg, nf=nf, qd=qd,
                                               epart=ep, refill_k=max(int(cfg.tree_refill_k), 1),
                                               it_cap=cap)
        left = int((auxout[:, A_DONE] < 0.5).sum())
        if left:
            raise RuntimeError(f"K4 left {left} of {E} events unfinished within {cap} "
                               f"iterations per warp")
        return auxout, fin
    chunk = int(cfg.tree_kernel_chunk)
    if chunk <= 0:
        _, auxout, _, fin = tree_kernel_launch(uin, aux, uni, qin, sc, cfg, tcfg, nf=nf, qd=qd,
                                               it_cap=it_full)
        return auxout, fin
    st = dict(idx=torch.arange(E, device=uin.device), uin=uin, aux=aux, qin=qin, uni=uni,
              fin=torch.zeros((E, nf * ROWS), dtype=uin.dtype, device=uin.device))
    acc_aux, acc_fin = aux.clone(), st["fin"].clone()
    alive = lambda s: int((s["aux"][:, A_DONE] < 0.5).sum())
    it_cap = chunk
    for target in stage_sizes(E):
        while 0 < alive(st) and alive(st) > target:
            st = _launch_packed(st, sc, cfg, tcfg, nf, qd, it_cap)
        acc_aux[st["idx"]] = st["aux"]
        acc_fin[st["idx"]] = st["fin"]
        order = torch.argsort(st["aux"][:, A_DONE], stable=True)
        st = {k: v[order][:target] for k, v in st.items()}
        it_cap = min(it_cap * 4, it_full)
    while alive(st) > 0:
        st = _launch_packed(st, sc, cfg, tcfg, nf, qd, it_cap)
    acc_aux[st["idx"]] = st["aux"]
    acc_fin[st["idx"]] = st["fin"]
    return acc_aux, acc_fin


def forward_tree_kernel(key, xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
                        tcfg: TreeConfig, *, lnt_end):
    """tree.forward_tree on the production (saveMode <= 1) contract through
    K3 or K4 (run_tree_kernel): whole
    trees in the kernel, then the exact host replay of the events
    that overflowed the NF finals slots (MC draws are keyed by event and node
    index, so the replay is the host engine's own result), merged.  The
    returned TreeResult's pools hold only the final nodes of the kernel's
    events (NF slots), concatenated with the replay's pools: what
    compact_finals_global and the driver read."""
    from adiabatic_raytracer_tpu_torch.ops.tree import (
        TreePools,
        TreeResult,
        _event_keys,
        forward_tree,
    )

    E = xpos.shape[0]
    dev, dtype = xpos.device, xpos.dtype
    NF = int(min(max(int(cfg.tree_kernel_finals), 1), tcfg.num_cutoff))
    # count_main never exceeds num_cutoff, so NF >= num_cutoff cannot overflow
    no_replay = NF >= tcfg.num_cutoff
    QD = int(tcfg.mc_nodes + 2)
    keys = _event_keys(key, E, dev)
    uin, aux, uni, qin = tree_inputs(keys, xpos, k_init, erg_inf, sc, cfg, tcfg,
                                     lnt_end=lnt_end)
    auxout, fin = run_tree_kernel(uin, aux, uni, qin, sc, cfg, tcfg, nf=NF, qd=QD)
    incomplete = auxout[:, A_INFO] == INFO_OVERFLOW
    complete = ~incomplete
    tr_fb = None
    if not no_replay and bool(incomplete.any()):
        fb_cfg = dataclasses.replace(cfg, tree_engine="queue", tree_window=0)
        tr_fb = forward_tree(keys, xpos, k_init, erg_inf, sc, fb_cfg, tcfg, lnt_end=lnt_end,
                             skip=complete)

    # finals-only pools of the kernel's events
    NS = cfg.n_save
    mass_eff = sc.mass_ns_eff
    fin = fin.reshape(E, NF, ROWS)
    ok = complete[:, None] & (fin[..., F_VALID] > 0.5)
    u_end = fin[..., F_U0:F_U0 + 7].to(dtype)
    x_sph = u_end[..., 0:3]
    a_l = lapse_interior(x_sph[..., 0], mass_eff, sc.r_ns)
    zero = torch.zeros((), dtype=dtype, device=dev)
    fpos = torch.where(ok[..., None], sph_to_cart(x_sph), zero)
    fmom = torch.where(ok[..., None], celerity_to_cart_vel(
        x_sph, u_end[..., 3:6] * erg_inf[:, None, None], mass_eff, a=a_l), zero)
    g = lambda row: torch.where(ok, fin[..., row].to(dtype), zero)
    z2 = torch.zeros((E, NF), dtype=dtype, device=dev)
    z3 = torch.zeros((E, NF, 3), dtype=dtype, device=dev)
    synth = TreePools(
        pos=z3, k=z3, t=g(F_TB), dw=z2, is_photon=fin[..., F_ISPH] > 0.5, prob=g(F_PROB),
        weight=g(F_W), parent_weight=z2, prob_conv=g(F_PCONV), prob_conv0=g(F_PCONV0),
        status=torch.where(ok, 2, 0).to(torch.int64),
        is_final=ok & (fin[..., F_ISFIN] > 0.5), fpos=fpos, fmom=fmom,
        ferg=torch.where(ok, u_end[..., 6], zero), ftime=z2,
        traj=torch.zeros((E, NF, NS, 3), dtype=dtype, device=dev),
        mom=torch.zeros((E, NF, NS, 3), dtype=dtype, device=dev),
        times=torch.zeros((E, NF, NS), dtype=dtype, device=dev), xc=z3, kc=z3, tcx=z2,
        dwcx=z2, pcx=z2, has_cross=torch.zeros((E, NF), dtype=torch.bool, device=dev),
        order=torch.where(ok, fin[..., F_ORD], zero).to(torch.int64))
    i64 = lambda r: auxout[:, r].to(torch.int64)
    count = i64(A_COUNT)
    info = i64(A_INFO)
    info = torch.where(count > tcfg.mc_nodes, -torch.abs(info), info)
    # the kernels have no host iterations: K3 reports the launches each event
    # ran in, K4 its warp's iteration count when the event stopped
    launches = i64(A_ITERS)
    out = dict(count=count, count_main=i64(A_CMAIN), info=info,
               tot_prob=auxout[:, A_TOTP].to(dtype), n_alloc=i64(A_NALLOC),
               dw_anomalies=i64(A_ANOM), n_iters=launches, done_it=launches)
    pools = synth
    if tr_fb is not None:
        out = {k: torch.where(incomplete, getattr(tr_fb, k), v) for k, v in out.items()}
        pools = TreePools(*(torch.cat([a, b], dim=1) for a, b in zip(synth, tr_fb.pools)))
    return TreeResult(pools=pools, **out)
