"""The plain models of the warp algorithms of K2, K3 and K4 (ops/treekernel.py:
_scan_roots_warp, _bisect_warp, _pop_best_warp; the kernels' own code is
csrc/tree_warp.cuh and csrc/tree_device.cuh) held bit for bit against the
serial algorithms (_scan_roots, _bisect, _pop_best): K3's and K4's event
scan with one crossing slot, K2's with up to 16.

Steps are made from a numpy seed at the production scene (MassA 1e-5, B0
1e14, ThetaM 0.2) and its default numerics (50 scan points, 4 coarse, 60
halvings, 3 roots per step): a launch state, one Euler step of its RHS, the
Hermite interpolant between.  The condition is memoized per (step, tau), so
both versions read one value per point: the comparison is of the
algorithms, not of the CPU kernels' rounding (sin, cos and exp may differ in
the last bit between a tensor's vectorized body and its scalar tail).  Each
case reshapes the condition through a function of (tau, g) to place its
roots; the steps and the condition stay the production ones."""

import math

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
from adiabatic_raytracer_tpu_torch.ops.megakernel import _condition, _hermite
from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

torch.set_num_threads(1)

F64 = torch.float64
SC = tcfg.Scene(mass_a=1e-5, theta_m=0.2, b0=1e14)
CFG = tcfg.NumericsConfig(atol=1e-6, rtol=1e-7, engine="mega", tree_engine="kernel")
P = tk.kernel_params(SC, CFG)
K = P.interp
FAR = torch.tensor([1e4, 1e4, 1e4], dtype=F64)   # no root is the start point


def steps(n, seed):
    """n accepted-step interpolants (u0, u1, f0, f1, h, lnt0) at the
    production scene: launch states at r 15-40 km, a step of h ~ 1e-2."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(15.0, 40.0, n)
    th = np.arccos(rng.uniform(-0.9, 0.9, n))
    ph = rng.uniform(-np.pi, np.pi, n)
    x = torch.as_tensor(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                                  r * np.cos(th)], 1), dtype=F64)
    k = torch.as_tensor(rng.normal(size=(n, 3)), dtype=F64)
    erg = torch.full((n,), 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2), dtype=F64)
    u0 = launch_state(x, k, SC, erg, -torch.ones(n, dtype=F64))
    lnt0 = torch.as_tensor(rng.uniform(-8.0, -1.0, n), dtype=F64)
    h = torch.as_tensor(rng.uniform(5e-3, 2e-2, n), dtype=F64)
    ph_ = torch.ones(n, dtype=F64)
    f0 = tk._f(P, u0, lnt0, erg, ph_)
    u1 = u0 + h[:, None] * f0
    f1 = tk._f(P, u1, lnt0 + h, erg, ph_)
    return u0, u1, f0, f1, h, lnt0


STEPS = steps(4, seed=20261017)


class Memo:
    """g_tau(rows, tau) of _scan_roots: the production condition on step
    row's interpolant at tau, passed through shape(row, tau, g) (tensors).
    Each point is evaluated once, with the other points new in the same
    call, and then read from the cache."""

    def __init__(self, shape, st=STEPS):
        self.shape, self.st, self.cache = shape, st, {}

    def __call__(self, rows, tau):
        rows, tau = torch.broadcast_tensors(rows, tau)
        keys = list(zip(rows.flatten().tolist(), tau.flatten().tolist()))
        new = list(dict.fromkeys(k for k in keys if k not in self.cache))
        if new:
            r = torch.tensor([k[0] for k in new])
            t = torch.tensor([k[1] for k in new], dtype=F64)
            u0, u1, f0, f1, h, lnt0 = self.st
            c = lambda a: tuple(a[r, i] for i in range(7))
            g = _condition(P, _hermite(c(u0), c(u1), c(f0), c(f1), h[r], t), lnt0[r] + t * h[r])
            self.cache.update(zip(new, self.shape(r, t, g).tolist()))
        return torch.tensor([self.cache[k] for k in keys], dtype=F64).reshape(tau.shape)

    def point(self, r, t):
        return self(torch.tensor([r]), torch.tensor([t], dtype=F64)).item()


def scan_both(g_tau, x0=None, p=P, rows=None, free=None):
    """_scan_roots and _scan_roots_warp on the steps `rows` (all by
    default) with `free` slots per row (default one); asserts every output
    bit for bit equal and returns them: (recorded [m], u_root [m, R, 7],
    lnt_root [m, R], dense, roots)."""
    rows = torch.arange(STEPS[0].shape[0]) if rows is None else torch.as_tensor(rows)
    u0, u1, f0, f1, h, lnt0 = (a[rows] for a in STEPS)
    m = rows.shape[0]
    sub = lambda r_, t: g_tau(rows[r_], t)
    ends = torch.arange(m)
    g0, g1 = sub(ends, torch.zeros(m, dtype=F64)), sub(ends, torch.ones(m, dtype=F64))
    x0 = FAR.expand(m, 3) if x0 is None else x0
    args = (p, x0, u0, u1, f0, f1, h, lnt0, g0, g1)
    warp = tk._scan_roots_warp(*args, g_tau=sub, free=free)
    ser = tk._scan_roots(*args, g_tau=sub, free=free)
    for a, b, name in zip(ser, warp, ("recorded", "u_root", "lnt_root", "dense", "roots")):
        assert torch.equal(a, b), (name, a, b)
    return ser


def both(g_tau, x0=None, p=P, rows=None):
    """scan_both with K3's one slot: (recorded [m] bool, u_root [m, 7],
    lnt_root [m], dense, roots)."""
    n_rec, u_s, lnt_s, dense, roots = scan_both(g_tau, x0, p, rows)
    assert int(n_rec.max()) <= 1
    return n_rec > 0, u_s[:, 0], lnt_s[:, 0], dense, roots


def roots_at(*ts):
    """A condition with its sign changes at the taus ts (per row: a tensor
    [rows] each), scaled by 1 + |g| of the production one."""
    def shape(r, t, g):
        out = 1.0 + g.abs()
        for tr in ts:
            out = out * (t - (tr[r] if torch.is_tensor(tr) else tr))
        return out
    return shape


def tau_of(lnt_s, rows):
    _, _, _, _, h, lnt0 = (a[rows] for a in STEPS)
    return (lnt_s - lnt0) / h


def test_flip_in_the_first_round():
    """A sign change between the points j = 5 + row and 6 + row: one root
    in round 0, recorded there."""
    at = (5.5 + torch.arange(4, dtype=F64)) / K
    rec, _, lnt_s, dense, roots = both(Memo(roots_at(at)))
    assert bool(rec.all()) and bool(dense.all()) and torch.equal(roots, torch.ones(4, dtype=F64))
    assert (tau_of(lnt_s, torch.arange(4)) - at).abs().max().item() < 1e-9


@pytest.mark.parametrize("j", [32, 33])
def test_flip_at_the_round_boundary(j):
    """The sign change between g(j - 1) and g(j) for j = 32 (lanes 30, 31
    of round 0) and j = 33 (lane 0 of round 1, whose left neighbour is round
    0's carry)."""
    rec, _, lnt_s, _, roots = both(Memo(roots_at((j - 0.5) / K)), rows=[0, 1])
    assert bool(rec.all()) and torch.equal(roots, torch.ones(2, dtype=F64))
    assert (tau_of(lnt_s, torch.tensor([0, 1])) - (j - 0.5) / K).abs().max().item() < 1e-9


def test_no_flip_gate_closed_and_open():
    """Far from the level the coarse gate closes (no dense pass, no root);
    just above it, with no sign change, the gate opens on |g| < theta and
    the dense pass finds nothing."""
    base = Memo(lambda r, t, g: g)
    grid = base(torch.arange(4)[:, None], (torch.arange(K + 1, dtype=F64) / K)[None, :])
    far = grid.amin(dim=1) - 10.0 * P.gate_theta
    rec, _, _, dense, roots = both(Memo(lambda r, t, g: g - far[r]))
    assert not bool(rec.any()) and not bool(dense.any()) and not bool(roots.any())
    near = lambda r, t, g: 0.5 * P.gate_theta + 0.01 * t * t * (1.0 + g.abs())
    rec, _, _, dense, roots = both(Memo(near))
    assert not bool(rec.any()) and bool(dense.all()) and not bool(roots.any())


def replay(tlo, thi, path):
    """The serial midpoints along `path` (1 = right half), then the node's
    own midpoint: what the warp's lane for that node rebuilds."""
    for b in path:
        m = 0.5 * (tlo + thi)
        tlo, thi = (m, thi) if b else (tlo, m)
    return 0.5 * (tlo + thi)


@pytest.mark.parametrize("path", [[], [1, 0, 1, 1], [0, 1, 1, 0, 1], [1, 1, 0, 0, 1, 0, 1, 1]])
def test_zero_exactly_at_a_bisection_midpoint(path):
    """g = 0 at a node of the bisection (the root, the last level of round
    1, the first of round 2, deep in round 2): sgn 0 differs from glo's, so
    both keep the left half there; the scan through it on step 0, then the
    bisection alone."""
    j = 21
    t_star = replay((j - 1) / K, j / K, path)
    memo = Memo(roots_at(t_star))
    assert memo.point(0, t_star) == 0.0
    rec, _, lnt_s, _, roots = both(memo, rows=[0])
    assert bool(rec.all()) and roots.item() == 1.0
    tlo = torch.tensor([(j - 1) / K], dtype=F64)
    thi = torch.tensor([j / K], dtype=F64)
    glo = torch.tensor([memo.point(0, (j - 1) / K)], dtype=F64)
    g_fn = lambda t: memo(torch.zeros_like(t, dtype=torch.int64), t)
    for iters in (5, 7, 60):
        a = tk._bisect(g_fn, tlo, thi, glo, iters)
        b = tk._bisect_warp(g_fn, tlo, thi, glo, iters)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), iters
    assert a[1].item() == t_star


def test_two_roots_in_order_and_start_duplicate():
    """Roots at tau 0.31 (round 0) and 0.81 (round 1): the first is recorded;
    with the start point at the first, it is filtered and the second
    recorded, after two bisections."""
    memo = Memo(roots_at(0.31, 0.81))
    rec, u_s, lnt_s, _, roots = both(memo, rows=[2])
    assert bool(rec.all()) and roots.item() == 1.0
    u0, u1, f0, f1, h, lnt0 = (a[2:3] for a in STEPS)
    assert abs(((lnt_s - lnt0) / h).item() - 0.31) < 1e-9
    x0 = tk._cart(u_s)
    rec2, _, lnt2, _, roots2 = both(memo, x0=x0, rows=[2])
    assert bool(rec2.all()) and roots2.item() == 2.0
    assert abs(((lnt2 - lnt0) / h).item() - 0.81) < 1e-9


@pytest.mark.parametrize("cap, want_roots, recorded", [(1, 1.0, False), (2, 2.0, True)])
def test_max_roots_cap(cap, want_roots, recorded):
    """Four roots in one step, the first filtered as the start point: at
    max_roots 1 the scan stops after it with nothing recorded, at 2 it
    records the second."""
    memo = Memo(roots_at(0.15, 0.45, 0.71, 0.91))
    _, u_s, _, _, _ = both(memo, rows=[3])
    p = tk.kernel_params(SC, CFG)
    p.max_roots = cap
    rec, _, _, _, roots = both(memo, x0=tk._cart(u_s), p=p, rows=[3])
    assert bool(rec.all()) == recorded and roots.item() == want_roots


P16 = tk.kernel_params(SC, CFG)
P16.max_crossings = 16     # K2's backtrace: 16 crossing slots


@pytest.mark.parametrize("case", ["three_roots", "cap_at_second", "start_root_recorded",
                                  "round_boundary"])
def test_k2_slots(case):
    """K2's scan with 16 slots on step 1: every root of a step recorded in
    order (three roots, max_roots 3); two free slots filled at the second of
    three roots, which ends the step; a root at the start point recorded
    because a crossing was recorded before (n_cross 1, the filter applies
    to the first crossing only); roots at j = 32 and 33, on both sides of
    the first round boundary."""
    ts, free, x0_at, want = {
        "three_roots": ((0.23, 0.53, 0.87), 16, None, 3),
        "cap_at_second": ((0.23, 0.53, 0.87), 2, None, 2),
        "start_root_recorded": ((0.23, 0.53, 0.87), 15, 0, 3),
        "round_boundary": ((31.5 / K, 32.5 / K), 16, None, 2)}[case]
    memo = Memo(roots_at(*ts))
    x0 = None
    if x0_at is not None:   # the start point at the first root (found at 16 slots)
        _, u_s, _, _, _ = scan_both(memo, p=P16, rows=[1], free=torch.tensor([16]))
        x0 = tk._cart(u_s[:, x0_at])
        first, _, _, _, _ = scan_both(memo, x0=x0, p=P16, rows=[1], free=torch.tensor([16]))
        assert first.item() == 2    # with no crossing before, the start root is filtered
    n_rec, _, lnt_s, dense, roots = scan_both(memo, x0=x0, p=P16, rows=[1],
                                              free=torch.tensor([free]))
    assert n_rec.item() == want and roots.item() == want and bool(dense.all())
    got = tau_of(lnt_s[0, :want], torch.tensor([1]))
    assert (got - torch.tensor(ts[:want], dtype=F64)).abs().max().item() < 1e-9


@pytest.mark.parametrize("qd", [7, 12, 40])
def test_pop_ties(qd):
    """The warp's argmax pop against the serial rule on random queues with
    tied weights (and tied pool slots, which fall to the lower slot index),
    empty queues included; QD 40 takes two slots per lane."""
    rng = np.random.default_rng(qd)
    n = 256
    q = torch.zeros((n, qd, tk.ROWS), dtype=F64)
    q[:, :, tk.Q_ST] = torch.as_tensor(rng.random((n, qd)) < 0.4, dtype=F64)
    q[:, :, tk.Q_W] = torch.as_tensor(rng.choice([0.125, 0.25, 0.5], size=(n, qd)))
    q[:, :, tk.Q_SLOT] = torch.as_tensor(rng.integers(0, 4 * qd, size=(n, qd)), dtype=F64)
    q[:8, :, tk.Q_ST] = 0.0
    fa, ba = tk._pop_best(q)
    fb, bb = tk._pop_best_warp(q)
    assert torch.equal(fa, fb) and torch.equal(ba[fa], bb[fb])
    assert not bool(fa[:8].any()) and bool(fa.sum() > n // 2)
    w = q[:, :, tk.Q_W].clone()
    w[q[:, :, tk.Q_ST] < 0.5] = -math.inf
    ties = ((w == w.amax(dim=1, keepdim=True)).sum(dim=1) > 1) & fa
    assert int(ties.sum()) > n // 4
