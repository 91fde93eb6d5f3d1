"""K3's and K4's plain versions and the port's in-kernel tree engine
(ops/treekernel.py) against the JAX package's own reference for K3: the host
work-queue engine at tree_k=1 (engine "pool", f64), which runs no Pallas
(tests/test_treekernel.py holds the TPU kernels to the same reference), and
K4 against K3; P1's plain version (ops/refill_probe.py) against the JAX
probe scripts/probe_refill_ops.py.
The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Scene and tree sizes are those of tests/test_treekernel.py (3 events,
num_cutoff 4, mc_nodes 1, max_nodes 10, 8 interpolation points, 2000 steps).
The 3 events are sampled once with the port's sampler and handed to both
packages as numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.ops import tree as jtree
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer_tpu_torch.ops import sampler, tree
from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.4, omega_pul=1.0, b0=1e14, r_ns=10.0,
          mass_ns=1.0)
TREE = dict(num_cutoff=4, mc_nodes=1, max_nodes=10)
NUM = dict(interp_points=8, max_crossings=8, max_steps=2000, in_kernel_prob=1, tree_k=1)
SEED = 11
SC = tcfg.Scene(**KW)
TC = tcfg.TreeConfig(**TREE)
CFG = tcfg.NumericsConfig(engine="mega", tree_engine="kernel", **NUM)
COUNTERS = ("count", "count_main", "info", "n_alloc", "dw_anomalies")


@pytest.fixture(scope="module")
def events():
    """(xpos, k_init, erg) of 3 conversion-surface events, numpy f64."""
    maxR = float(conversion_surface_radius(SC.mass_a, SC.theta_m, SC.omega_pul, SC.b0,
                                           SC.r_ns))
    n_grid = sampler.default_n_grid(maxR, scan_per_step=8)
    key = rng.PRNGKey(2)
    xs, vs, es = [], [], []
    while len(xs) < 3:
        key, sub = rng.split(key).unbind(0)
        r = sampler.sample_batch(sub, 16, maxR, SC, SC.mass_ns, n_grid=n_grid)
        for i in r.success.nonzero().squeeze(1).tolist():
            xs.append(r.xpos[i])
            vs.append(r.v_loc[i])
            es.append(r.erg_inf[i])
    x, v, e = torch.stack(xs[:3]), torch.stack(vs[:3]), torch.stack(es[:3])
    k = k_norm_cart(x, v, 0.0, e, SC, SC.mass_ns, is_photon=True, ax_fix=True)
    return x.numpy(), k.numpy(), e.numpy()


def run_port(ev, cfg, **kw):
    x, k, e = (torch.as_tensor(a) for a in ev)
    return tree.forward_tree(rng.PRNGKey(SEED), x, k, e, SC, cfg, TC, lnt_end=0.0, **kw)


@pytest.fixture(scope="module")
def jax_host(events):
    """The JAX host engine at tree_k=1, pool engine, f64 (no Pallas)."""
    x, k, e = (jax.numpy.asarray(a) for a in events)
    cfg = jcfg.NumericsConfig(engine="pool", **NUM)
    return jax.jit(lambda x, k, e: jtree.forward_tree(
        jax.random.PRNGKey(SEED), x, k, e, jcfg.Scene(**KW), cfg, jcfg.TreeConfig(**TREE),
        lnt_end=0.0))(x, k, e)


@pytest.fixture(scope="module")
def port_kernel(events):
    return run_port(events, CFG)


@pytest.fixture(scope="module")
def port_host(events):
    """The port's host engine at tree_k=1: what the overflow replay runs."""
    return run_port(events, dataclasses.replace(CFG, tree_engine="queue"))


def finals(tr, e):
    """(order -> record) of event e's final nodes, numpy."""
    pl = tr.pools
    st = np.asarray(pl.status[e])
    out = {}
    for p in np.nonzero(np.asarray(pl.is_final[e]) & (st == 2))[0]:
        out[int(pl.order[e, p])] = dict(
            is_ph=bool(pl.is_photon[e, p]), w=float(pl.weight[e, p]),
            prob=float(pl.prob[e, p]), pconv=float(pl.prob_conv[e, p]),
            pconv0=float(pl.prob_conv0[e, p]), t=float(pl.t[e, p]),
            ferg=float(pl.ferg[e, p]), fpos=np.asarray(pl.fpos[e, p]),
            fmom=np.asarray(pl.fmom[e, p]))
    return out


def assert_matches(a, b, rtol):
    """Counters, orders and species exact; records within rtol (rtol=0:
    bitwise); positions and momenta vector-relative."""
    for name in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)
    np.testing.assert_allclose(np.asarray(a.tot_prob), np.asarray(b.tot_prob), rtol=rtol)
    for e in range(3):
        fa, fb = finals(a, e), finals(b, e)
        assert set(fa) == set(fb), (e, sorted(fa), sorted(fb))
        for o, ra in fa.items():
            rb = fb[o]
            assert ra["is_ph"] == rb["is_ph"], (e, o)
            for nm in ("w", "prob", "pconv", "pconv0", "t", "ferg"):
                assert abs(ra[nm] - rb[nm]) <= rtol * abs(rb[nm]), (nm, e, o, ra[nm], rb[nm])
            for nm in ("fpos", "fmom"):
                d = float(np.linalg.norm(ra[nm] - rb[nm]))
                assert d <= rtol * float(np.linalg.norm(rb[nm])), (nm, e, o, d)


def test_tree_kernel_matches_jax_host_k1(port_kernel, jax_host):
    """(a) Plain K3 through forward_tree_kernel against the JAX host engine
    at tree_k=1.  rtol 1e-6: the port integrates with the hand-adjoint RHS
    and the strength-reduced condition, JAX's pool with autodiff and the
    canonical condition — equal to ~1e-13 per evaluation, amplified by the
    adaptive controller and by near-tangent crossing roots (the largest
    record gap measured is ~4e-9, on pconv at a deep node); the child birth
    state is renormalized in place instead of through Cartesian coordinates,
    which keeps phi unwrapped: on some production trees that moves records
    beyond 1e-6 (tests/test_torch_tree_engines.py), on these 3 events not."""
    assert_matches(port_kernel, jax_host, rtol=1e-6)
    assert int(np.sum(np.asarray(port_kernel.count_main))) > 3   # trees grew


def test_tree_kernel_overflow_replays_exactly(events, jax_host, port_host):
    """(b) tree_kernel_finals=1 sends every event with 2+ finals through the
    exact host replay (the host engine with skip=); those events equal the
    port's host engine bitwise, and the merged result still matches JAX."""
    kern1 = run_port(events, dataclasses.replace(CFG, tree_kernel_finals=1))
    host = port_host
    replayed = np.nonzero(np.asarray(host.count_main) > 1)[0]
    assert replayed.size >= 1
    for e in replayed:
        fa, fb = finals(kern1, int(e)), finals(host, int(e))
        assert set(fa) == set(fb)
        for o in fa:
            for nm in ("w", "prob", "pconv", "pconv0", "t", "ferg"):
                assert fa[o][nm] == fb[o][nm], (nm, e, o)
            np.testing.assert_array_equal(fa[o]["fpos"], fb[o]["fpos"])
            np.testing.assert_array_equal(fa[o]["fmom"], fb[o]["fmom"])
        for name in COUNTERS + ("tot_prob",):
            assert getattr(kern1, name)[e] == getattr(host, name)[e], name
    assert_matches(kern1, jax_host, rtol=1e-6)


def test_tree_kernel_chunked_matches_single(events, port_kernel):
    """(c) Bounded relaunches of 150 steps (the whole state round-trips
    through the blocks; f0 and g0 are recomputed from the committed state,
    which is what FSAL carried) reproduce the single launch: topology exact,
    records to 1e-10."""
    chunked = run_port(events, dataclasses.replace(CFG, tree_kernel_chunk=150))
    assert_matches(chunked, port_kernel, rtol=1e-10)
    assert int(np.max(np.asarray(chunked.n_iters))) > 1   # it did relaunch


@pytest.fixture(scope="module")
def k3_plain_blocks(events):
    """Input blocks of 6 events, the 3 events under SEED's keys and again
    under SEED + 1's (other tree draws), and K3's plain version's outputs on
    them, one uncut launch.  Rows 0-2 are the 3 events' own blocks."""
    x, k, e = (torch.as_tensor(a).repeat(2, *([1] * (a.ndim - 1))) for a in events)
    keys = torch.cat([tree._event_keys(rng.PRNGKey(s), 3, x.device) for s in (SEED, SEED + 1)])
    blocks = tk.tree_inputs(keys, x, k, e, SC, CFG, TC, lnt_end=0.0)
    out = tk.tree_kernel_launch_plain(*blocks, SC, CFG, TC, it_cap=10**6, nf=TC.num_cutoff,
                                      qd=TC.mc_nodes + 2)
    return blocks, out


def test_refill_plain_equals_tree_kernel_plain_per_event(k3_plain_blocks):
    """K4's plain version on K3's input blocks, 6 events in 2 partitions of
    3, each served by 2 lanes at the config's refill_k (as K4's warps serve
    several events each on the card): every event's output row but the
    serving lane's iteration count, and its finals block, are K3's plain
    version's bit for bit.  So chip_smoke.py holds K4 against K3's plain
    output (phase 10 against phase 6's)."""
    blocks, (_, a3, _, f3) = k3_plain_blocks
    _, a4, _, f4 = tk.tree_refill_launch_plain(*blocks, SC, CFG, TC, nf=TC.num_cutoff,
                                               qd=TC.mc_nodes + 2, epart=3,
                                               refill_k=CFG.tree_refill_k, it_cap=10**6,
                                               lanes=2)
    keep = [r for r in range(tk.AUX_ROWS) if r != tk.A_ITERS]
    assert torch.equal(a4[:, keep], a3[:, keep])
    assert torch.equal(f4, f3)
    # in each partition the third event started after another ended: its
    # lane's count is beyond its own steps
    later = (a4[:, tk.A_ITERS] > a4[:, tk.A_STEPTOT]).reshape(2, 3)
    assert bool(later.any(dim=1).all())


def test_tree_kernel_launch_plain_resumes(events, port_kernel, k3_plain_blocks):
    """(d) The block contract: one launch cut short at it_cap leaves every
    event live with its steps counted; a second launch resumes it and ends
    where the single uncut launch of forward_tree_kernel ended (counters
    exact, records to 1e-10), with the work counters the bound reads summed
    over both launches."""
    x, k, e = (torch.as_tensor(a) for a in events)
    keys = tree._event_keys(rng.PRNGKey(SEED), 3, x.device)
    uin, aux, uni, qin = tk.tree_inputs(keys, x, k, e, SC, CFG, TC, lnt_end=0.0)
    kw = dict(nf=TC.num_cutoff, qd=TC.mc_nodes + 2)
    u1, a1, q1, f1 = tk.tree_kernel_launch_plain(uin, aux, uni, qin, SC, CFG, TC, it_cap=60, **kw)
    assert torch.all(a1[:, tk.A_DONE] == 0) and torch.all(a1[:, tk.A_STEPTOT] == 60)
    _, a2, _, f2 = tk.tree_kernel_launch_plain(u1, a1, uni, q1, SC, CFG, TC, it_cap=10**6, **kw)
    assert torch.all(a2[:, tk.A_DONE] == 1) and torch.all(a2[:, tk.A_ITERS] == 2)
    ref = port_kernel
    info = a2[:, tk.A_INFO].long()
    info = torch.where(a2[:, tk.A_COUNT] > TC.mc_nodes, -info.abs(), info)
    for row, want in ((tk.A_COUNT, ref.count), (tk.A_CMAIN, ref.count_main),
                      (tk.A_NALLOC, ref.n_alloc), (tk.A_ANOM, ref.dw_anomalies)):
        torch.testing.assert_close(a2[:, row].long(), want, rtol=0, atol=0)
    torch.testing.assert_close(info, ref.info, rtol=0, atol=0)
    torch.testing.assert_close(a2[:, tk.A_TOTP], ref.tot_prob, rtol=1e-10, atol=0)
    # finals were written across the two launches; the reference's pools are
    # exactly its NF final slots (no replay: NF = num_cutoff)
    fr = lambda f: f.reshape(3, TC.num_cutoff, tk.ROWS)
    fin = torch.where((fr(f2)[..., tk.F_VALID] > 0.5)[..., None], fr(f2), fr(f1))
    pl = ref.pools
    torch.testing.assert_close(fin[..., tk.F_VALID] > 0.5, pl.status == 2, rtol=0, atol=0)
    ok = pl.status == 2
    for row, want in ((tk.F_ORD, pl.order.double()), (tk.F_W, pl.weight), (tk.F_PROB, pl.prob),
                      (tk.F_PCONV, pl.prob_conv), (tk.F_PCONV0, pl.prob_conv0),
                      (tk.F_TB, pl.t), (tk.F_U0 + 6, pl.ferg)):
        torch.testing.assert_close(fin[..., row][ok], want[ok], rtol=1e-10, atol=0)
    # work counters: the two launches add up to one uncut launch
    a_one = k3_plain_blocks[1][1][:3]
    work = [tk.A_STEPTOT, tk.A_STEPS_PH, tk.A_NACC, tk.A_NFINE, tk.A_NBISECT, tk.A_NCROSS]
    torch.testing.assert_close(a2[:, work], a_one[:, work], rtol=0, atol=0)
    ph, acc = a_one[:, tk.A_STEPS_PH], a_one[:, tk.A_NACC]
    assert torch.all(ph > 0) and bool(torch.any(ph < a_one[:, tk.A_STEPTOT]))  # both species
    assert torch.all(acc <= a_one[:, tk.A_STEPTOT]) and torch.all(acc > 0)
    assert torch.all(a_one[:, tk.A_NCROSS] <= a_one[:, tk.A_NBISECT])
    # every popped node was pushed by a crossing, which pushes one or two
    assert torch.all(2 * a_one[:, tk.A_NCROSS] >= a_one[:, tk.A_COUNT] - 1)


def run_refill(ev, lanes, **kw):
    """The port's tree engine through K4's plain version (forward_tree_kernel
    at tree_refill=128: one partition of the 3 events), its launches served
    by `lanes` lanes instead of 128."""
    x, k, e = (torch.as_tensor(a) for a in ev)
    cfg = dataclasses.replace(CFG, tree_refill=128, **kw)
    real = tk.tree_refill_launch_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, "tree_refill_launch_plain",
                   lambda *a, **kw: real(*a, **dict(kw, lanes=lanes)))
        return tk.forward_tree_kernel(rng.PRNGKey(SEED), x, k, e, SC, cfg, TC, lnt_end=0.0)


@pytest.fixture(scope="module")
def refill_2lanes(events):
    return run_refill(events, 2, tree_refill_k=4)


def test_refill_wide_matches_tree_kernel(events, port_kernel, jax_host):
    """(e) K4's plain version at 128 lanes: each lane serves one event, from
    the launch's first refill to its write-out, so the result is K3's plain
    version's bit for bit, and matches the JAX host engine as (a) does."""
    wide = run_refill(events, 128)
    assert_matches(wide, port_kernel, rtol=0.0)
    assert_matches(wide, jax_host, rtol=1e-6)
    # K4 reports each event's thread iteration count: here its own steps
    assert torch.equal(wide.n_iters, wide.done_it) and bool(torch.all(wide.n_iters > 1))


def test_refill_two_lanes_serves_events_in_turn(events, port_kernel, refill_2lanes):
    """(f) 3 events on 2 lanes: a lane writes its first event out and takes
    the third mid-run.  Counters, orders and species exact against plain K3;
    records to rtol 1e-12, the width-rounding class of the torch CPU kernels
    (a lane's ops run at another batch width than in K3's lockstep; the gap
    measured here is 0, the JAX test's is ~1e-3 in f32)."""
    assert_matches(refill_2lanes, port_kernel, rtol=1e-12)
    # the third event started after another ended: its thread's count is
    # beyond its own steps
    it = refill_2lanes.n_iters
    assert int(it.max()) > int(port_kernel.n_iters.max()) and int(it.min()) > 1


def test_refill_period_is_a_schedule_knob(events, refill_2lanes):
    """(g) refill_k 3 and 4 at 2 lanes give bitwise identical trees: an
    event's result does not depend on the iteration its lane took it at."""
    rk3 = run_refill(events, 2, tree_refill_k=3)
    assert_matches(rk3, refill_2lanes, rtol=0.0)


def test_refill_overflow_replays_exactly(events, port_host):
    """(h) tree_kernel_finals=1 through K4: the events with 2+ finals go
    through the exact host replay and equal the host engine bitwise, as (b)
    checks for K3."""
    kern1 = run_refill(events, 2, tree_kernel_finals=1)
    host = port_host
    replayed = np.nonzero(np.asarray(host.count_main) > 1)[0]
    assert replayed.size >= 1
    for e in replayed:
        fa, fb = finals(kern1, int(e)), finals(host, int(e))
        assert set(fa) == set(fb)
        for o in fa:
            for nm in ("w", "prob", "pconv", "pconv0", "t", "ferg"):
                assert fa[o][nm] == fb[o][nm], (nm, e, o)
            np.testing.assert_array_equal(fa[o]["fpos"], fb[o]["fpos"])
            np.testing.assert_array_equal(fa[o]["fmom"], fb[o]["fmom"])
        for name in COUNTERS + ("tot_prob",):
            assert getattr(kern1, name)[e] == getattr(host, name)[e], name


def test_refill_unfinished_event_raises(events, monkeypatch):
    """An event K4 could not finish within its thread's budget raises in the
    tree engine; the launch itself leaves it live, with its steps counted."""
    real = tk.tree_refill_launch_plain
    cut = lambda *a, **kw: real(*a, **dict(kw, it_cap=5))
    x, k, e = (torch.as_tensor(a) for a in events)
    keys = tree._event_keys(rng.PRNGKey(SEED), 3, x.device)
    blocks = tk.tree_inputs(keys, x, k, e, SC, CFG, TC, lnt_end=0.0)
    kw = dict(nf=TC.num_cutoff, qd=TC.mc_nodes + 2, epart=128, refill_k=4, lanes=2)
    _, a, _, _ = cut(*blocks, SC, CFG, TC, **kw)
    assert torch.all(a[:, tk.A_DONE] == 0)
    assert a[:, tk.A_STEPTOT].tolist() == [5.0, 5.0, 0.0]   # the third event never started
    monkeypatch.setattr(tk, "tree_refill_launch_plain", cut)
    with pytest.raises(RuntimeError, match="unfinished"):
        run_refill(events, 2)


def test_refill_probe_plain():
    """P1's plain version at the probe's shapes: ids round-trip, steps equal
    the quotas, every event written once, every flush at a refill boundary
    (4 rounds of 128 events, each flushed at the next boundary), rows
    2..SROWS-2 zero; and a skipped, doubled or misplaced flush shows."""
    from adiabatic_raytracer_tpu_torch.ops import refill_probe as rp

    tbl = rp.probe_table()
    out = rp.refill_probe(tbl)
    assert out.shape == (1, rp.SROWS, rp.EPART)
    assert all(ok for ok, _ in rp.checks(tbl, out).values())
    want_at = (torch.arange(rp.EPART) // rp.L + 1.0) * rp.REFILL_K
    assert torch.equal(out[0, -1], want_at) and torch.all(out[0, 2:-1] == 0)
    bad = out.clone()
    bad[0, 0, 7] *= 2.0
    bad[0, 0, 9] = 0.0
    bad[0, -1, 11] = 5.0
    got = rp.checks(tbl, bad)
    assert got["every event written once"] == (False, "events written != 1: 2")
    assert not got["gathered-id roundtrip"][0]
    assert got["flush at a refill boundary or the loop's end"] == (False, "misplaced 1")


def test_refill_probe_plain_matches_jax_probe(monkeypatch):
    """P1's plain version against the JAX probe itself (scripts/
    probe_refill_ops.py in interpret mode, its output taken from its
    pallas_call) on the probe's table: every row bit for bit."""
    import importlib.util
    import pathlib

    from jax.experimental import pallas as pl

    from adiabatic_raytracer_tpu_torch.ops import refill_probe as rp

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "probe_refill_ops.py"
    spec = importlib.util.spec_from_file_location("probe_refill_ops", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    real, got = pl.pallas_call, []

    def capture(*a, **kw):
        fn = real(*a, **kw)

        def call(*args):
            out = fn(*args)
            got.append(np.asarray(out))
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", capture)
    assert probe.main(False) == 0
    np.testing.assert_array_equal(rp.refill_probe(rp.probe_table()).numpy(), got[0])
