"""The in-kernel MC chain (NumericsConfig.mc_chain: K2's chain instantiation,
ops/megakernel.py, and the queue tree's chain mode, ops/tree.py) against the
JAX package's host engine at tree_k=1 (engine "pool", f64, no Pallas): the
reference that the JAX package's own chain test holds its chain to
(tests/test_tree_mega.py).  On the CPU the chain runs its plain version,
the pool engine segment by segment.  K2's chain kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 25).

Scene, tree and events are tests/test_torch_treekernel.py's (3 events,
num_cutoff 4, mc_nodes 1, max_nodes 10, 8 interpolation points, 2000
steps), so every node past the first is in MC mode and chains are long; the
chain is always on (gate 0) with 8 slots."""

import dataclasses

import pytest
import torch

from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state
from test_torch_treekernel import (  # noqa: F401  (events, jax_host: module fixtures)
    COUNTERS,
    NUM,
    SC,
    assert_matches,
    events,
    jax_host,
    run_port,
)

torch.set_num_threads(1)

CFG = tcfg.NumericsConfig(engine="mega", tree_engine="queue", **NUM)
CHAIN = dict(mc_chain=1, mc_chain_gate=0, mc_chain_slots=8)


@pytest.fixture(scope="module")
def chained(events):
    """The port's chained queue tree, and the in-kernel restarts of each of
    its chain launches (read from K2's outputs)."""
    restarts, real = [], mk.integrate_mega

    def spy(*args, **kw):
        out = real(*args, **kw)
        if kw.get("chain_cap") is not None:
            restarts.append(int(out[9].sum()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "integrate_mega", spy)
        tr = run_port(events, dataclasses.replace(CFG, **CHAIN))
    return tr, restarts


def test_chain_matches_jax_host_k1(events, chained, jax_host):
    """(a) forward_tree on the queue, engine mega, mc_chain 1, against the
    JAX host engine at tree_k=1 at K3's bar (rtol 1e-6; counters, orders
    and species exact): the chain's in-kernel birth is K3's, so a chained
    tree is the single-step tree.  Chains restarted in the kernel, and the
    tree took fewer iterations than the port's mc_chain=0 run."""
    tr, restarts = chained
    assert_matches(tr, jax_host, rtol=1e-6)
    assert sum(restarts) > 0, restarts
    single = run_port(events, CFG)
    assert int(tr.n_iters[0]) < int(single.n_iters[0]), (tr.n_iters, single.n_iters)


def test_chain_streaming_window_bitwise(events, chained):
    """(b) The chained tree under the streaming window (2 of the 3 events
    at a time) is the unwindowed chained tree bit for bit: every counter
    and every pools field."""
    tr, _ = chained
    win = run_port(events, dataclasses.replace(CFG, tree_window=2, **CHAIN))
    for name in COUNTERS + ("tot_prob",):
        assert torch.equal(getattr(win, name), getattr(tr, name)), name
    for name, a in win.pools._asdict().items():
        assert torch.equal(a, getattr(tr.pools, name)), name


def test_chain_cap_one_is_single_crossing(events):
    """(c) integrate_mega_plain with chain_cap 1 on every lane (8 slots) is
    the single-crossing output bit for bit: slot 0 the one crossing, the
    other slots zero, no restart, the species unchanged."""
    x, k, e = (torch.as_tensor(a) for a in events)
    B = x.shape[0]
    is_ph = torch.tensor([True, False, True])   # photon and axion lanes
    u0 = launch_state(x, k, SC, e, -torch.ones(B, dtype=torch.float64))
    lnt0 = torch.full((B,), float(CFG.ln_t_start), dtype=torch.float64)
    lnt1 = torch.zeros(B, dtype=torch.float64)
    kw = dict(is_photon=is_ph, species="mixed", with_prob=True)
    one = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, SC, CFG, max_crossings=1, **kw)
    cap1 = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, SC, CFG, max_crossings=8,
                                   chain_cap=torch.ones(B, dtype=torch.float64),
                                   uniforms=torch.rand(B, 8, dtype=torch.float64), **kw)
    assert int(one[4].sum()) > 0   # crossings were recorded
    for i in (0, 1, 2, 3, 4, 7, 9, 10, 11):
        assert torch.equal(cap1[i], one[i]), i
    for i in (5, 6, 8):
        assert torch.equal(cap1[i][:, :1], one[i]), i
        assert not bool(cap1[i][:, 1:].any()), i
