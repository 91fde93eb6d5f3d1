"""Weighted branching-tree Monte-Carlo engine, batched over events.

Port of adiabatic_raytracer_tpu/ops/tree.py (get_tree, MainRunner.jl:
126-352): the backtrace (`backtrace`, `backtrace_from_result`), the host
work-queue forward tree (`forward_tree`, unwindowed; K lanes per event per
iteration; `tree_engine='kernel'` dispatches to K3, ops/treekernel.py) and
the global finals pack (`compact_finals_global`).

Each iteration selects, per event, the K heaviest pending nodes, propagates
all selected nodes as one batch (pool engine or K2), and spawns children.
Per-lane results do not depend on which other lanes share a launch, so the
port launches only the valid lanes where the reference launched a padded
fixed width.  MC draws fold the per-event node index into the event key,
as in the reference, so the draw stream is the same.

Stop codes (`info`, MainRunner.jl:324-348): 1 worklist exhausted,
2 prob_cutoff, 3 num_cutoff, 4 max_nodes; negated once the pure-MC mode
(count > MC_nodes) was entered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.func import vmap

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.ops.conversion import get_prob_nonad
from adiabatic_raytracer_tpu_torch.ops.propagate import physics_dtype, propagate, to_physics
from adiabatic_raytracer_tpu_torch.utils import rng


def _negate_b(sc: Scene) -> Scene:
    """Backwards-in-time propagation: k -> -k and B -> -B (MainRunner.jl:580-586)."""
    return dataclasses.replace(sc, b0=-sc.b0)


def _prob_batch(pos, k, erg_eff, sc: Scene, compute_dtype: str = "state"):
    """P = 1 - exp(-P_nonAD) at a batch of points (MainRunner.jl:134-137),
    clamped to [0, 1]; returns (P, P_nonAD) in pos's dtype.
    compute_dtype="f32": P_nonAD evaluated in f32 on the f32 scene
    (tree.py:40-55 of the reference)."""
    if pos.shape[0] == 0:
        z = pos.new_zeros(0)
        return z, z
    out_dtype = pos.dtype
    sc, pos, k, erg_eff = to_physics(compute_dtype, sc, pos, k, erg_eff)
    p_nonad = vmap(lambda x, kk, e: get_prob_nonad(x, kk, e, sc))(pos, k, erg_eff)
    p_nonad = p_nonad.to(out_dtype)
    return torch.clamp(1.0 - torch.exp(-p_nonad), 0.0, 1.0), p_nonad


class BacktraceResult(NamedTuple):
    prob0: Any
    p_nonad0: Any
    weight: Any
    samp_back_weight: Any
    n_cross: Any
    xc: Any
    kc: Any
    tc: Any
    dwc: Any
    pc: Any
    valid: Any
    c_bck: Any
    traj: Any
    times: Any
    x_end: Any
    k_end: Any
    raw_n_cross: Any
    raw_tc: Any


def backtrace(xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
              tcfg: TreeConfig, *, lnt_end) -> BacktraceResult:
    """Backtrace the sampled axion to every level crossing it met
    (get_tree with -B0, -k, MainRunner.jl:581-589): through K2 at engine
    mega, the pool otherwise, in compacted chunks at pool_compact."""
    E = xpos.shape[0]
    dev, dt = xpos.device, xpos.dtype
    sc_b = _negate_b(sc)
    k_back = -k_init
    kw = dict(erg=erg_inf, delta_w=-torch.ones(E, dtype=dt, device=dev),
              lnt0=torch.full((E,), float(cfg.ln_t_start), dtype=dt, device=dev),
              lnt1=torch.full((E,), float(lnt_end), dtype=dt, device=dev),
              is_photon=torch.zeros(E, dtype=torch.bool, device=dev), species="axion")
    if cfg.engine == "mega":
        from adiabatic_raytracer_tpu_torch.ops.megakernel import propagate_mega

        res = propagate_mega(xpos, k_back, sc_b, cfg, max_crossings=cfg.max_crossings,
                             with_prob=bool(cfg.in_kernel_prob), **kw)
    elif cfg.engine == "pool_compact":
        # the pool in chunks, compacting the rays still running between them
        # (driver.py:315-393 of the reference); the tree runs the pool
        from adiabatic_raytracer_tpu_torch.ops.streaming import CompactedPropagator

        kw.pop("species")
        res = CompactedPropagator(sc_b, cfg, species="axion").run(
            xpos, k_back, kw["erg"], kw["delta_w"], kw["lnt0"], kw["lnt1"], kw["is_photon"],
            torch.full((E,), cfg.max_crossings, dtype=torch.int64, device=dev))
    else:
        res = propagate(xpos, k_back, sc_b, cfg,
                        max_crossings=torch.full((E,), cfg.max_crossings,
                                                 dtype=torch.int64, device=dev), **kw)
    return backtrace_from_result(xpos, k_back, erg_inf, res, sc, cfg)


def backtrace_from_result(xpos, k_back, erg_inf, res, sc: Scene,
                          cfg: NumericsConfig) -> BacktraceResult:
    """Dedup, survival weights, fallback and time re-zeroing of a backtrace
    PropagateResult (MainRunner.jl:227-245, 614-630)."""
    E = xpos.shape[0]
    dev = xpos.device
    sc_b = _negate_b(sc)
    prob0, p_nonad0 = _prob_batch(xpos, k_back, erg_inf, sc_b, cfg.compute_dtype)
    MAXC = cfg.max_crossings
    ar = torch.arange(MAXC, device=dev)[None, :]
    in_count = ar < res.n_cross[:, None]
    # coincident-crossing dedup: of two consecutive crossings closer than
    # 1e-5, drop the earlier one
    d = torch.linalg.norm(res.xc[:, 1:, :] - res.xc[:, :-1, :], dim=-1)
    next_valid = ar[:, 1:] < res.n_cross[:, None]
    keep_front = torch.where(next_valid, d > 1e-5, torch.ones_like(next_valid))
    valid = in_count & torch.cat([keep_front, torch.ones((E, 1), dtype=torch.bool,
                                                         device=dev)], dim=1)
    if res.pcx is not None:
        pc = torch.where(valid, res.pcx, torch.zeros_like(res.pcx))
    else:
        pc = torch.zeros(valid.shape, dtype=xpos.dtype, device=dev)
        if bool(valid.any()):
            ei, si = valid.nonzero(as_tuple=True)
            pc[ei, si] = _prob_batch(res.xc[ei, si], res.kc[ei, si],
                                     erg_inf[ei] * torch.abs(res.dwc[ei, si]), sc_b,
                                     cfg.compute_dtype)[0]
    weight = torch.prod(torch.where(valid, 1.0 - pc, torch.ones_like(pc)), dim=1)

    # fallback when no crossing was found: the MC point itself is the first
    # conversion (MainRunner.jl:614-624)
    none = res.n_cross == 0
    xc, kc, tc, dwc = res.xc.clone(), res.kc.clone(), res.tc.clone(), res.dwc.clone()
    xc[none, 0] = xpos[none]
    kc[none, 0] = k_back[none]
    tc[none, 0] = 0.0
    dwc[none, 0] = -1.0
    pc = pc.clone()
    pc[none, 0] = prob0[none]
    valid = torch.where(none[:, None], ar < 1, valid)
    n_valid = valid.sum(dim=1)

    # re-zero time at the last (earliest forward-time) crossing and flip sign
    last_idx = torch.where(n_valid > 0,
                           MAXC - 1 - torch.argmax(valid.flip(1).to(torch.int8), dim=1),
                           torch.zeros_like(n_valid))
    t_last = tc[torch.arange(E, device=dev), last_idx]
    tc = torch.where(valid, -(tc - t_last[:, None]), torch.zeros_like(tc))
    return BacktraceResult(
        prob0=prob0, p_nonad0=p_nonad0, weight=weight, samp_back_weight=prob0 * weight,
        n_cross=n_valid, xc=xc, kc=kc, tc=tc, dwc=dwc, pc=pc, valid=valid,
        c_bck=torch.ones(E, dtype=torch.int64, device=dev), traj=res.traj,
        times=res.times, x_end=res.traj[:, -1, :], k_end=res.mom[:, -1, :],
        raw_n_cross=res.n_cross, raw_tc=res.tc)


class TreePools(NamedTuple):
    """Per-event node pools [E, P, ...] (updated in place)."""
    pos: Any
    k: Any
    t: Any
    dw: Any
    is_photon: Any
    prob: Any
    weight: Any
    parent_weight: Any
    prob_conv: Any
    prob_conv0: Any
    status: Any        # 0 empty, 1 pending, 2 processed
    is_final: Any
    fpos: Any
    fmom: Any
    ferg: Any
    ftime: Any
    traj: Any          # [E, P, NS, 3]
    mom: Any
    times: Any         # [E, P, NS]
    xc: Any
    kc: Any
    tcx: Any
    dwcx: Any
    pcx: Any
    has_cross: Any
    order: Any         # processing order (1-based; 0 = unprocessed)


class TreeResult(NamedTuple):
    pools: TreePools
    count: Any
    count_main: Any
    info: Any
    tot_prob: Any
    n_alloc: Any
    dw_anomalies: Any
    n_iters: Any
    done_it: Any


def _alloc_pools(E, P, NS, dtype, dev):
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    i = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    return TreePools(
        pos=z(E, P, 3), k=z(E, P, 3), t=z(E, P), dw=z(E, P), is_photon=b(E, P),
        prob=z(E, P), weight=z(E, P), parent_weight=z(E, P), prob_conv=z(E, P),
        prob_conv0=z(E, P), status=i(E, P), is_final=b(E, P), fpos=z(E, P, 3),
        fmom=z(E, P, 3), ferg=z(E, P), ftime=z(E, P), traj=z(E, P, NS, 3),
        mom=z(E, P, NS, 3), times=z(E, P, NS), xc=z(E, P, 3), kc=z(E, P, 3),
        tcx=z(E, P), dwcx=z(E, P), pcx=z(E, P), has_cross=b(E, P), order=i(E, P))


def _stable_top(x, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (lax.top_k's order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _event_keys(key, E, dev):
    key = torch.as_tensor(key, device=dev)
    if key.dim() == 2 and key.shape[0] == E:
        return key
    return rng.fold_in(key, torch.arange(E, device=dev))


def kernel_covers(sc: Scene, cfg: NumericsConfig) -> bool:
    """Whether K3 runs this configuration: the mega engine with the in-kernel
    probability, on a scene megakernel.can_prob covers (treekernel.py:43-46
    of the reference)."""
    from adiabatic_raytracer_tpu_torch.ops.megakernel import can_prob

    return cfg.engine == "mega" and bool(cfg.in_kernel_prob) and can_prob(sc)


def check_tree_engine(sc: Scene, cfg: NumericsConfig):
    """Raise on a tree_engine='kernel' configuration K3 does not cover."""
    if cfg.tree_engine == "kernel" and not kernel_covers(sc, cfg):
        raise NotImplementedError(
            "tree_engine='kernel' covers engine='mega' with in_kernel_prob on an "
            "anisotropic Melrose, curved-space scene without boundary layer; other "
            "configurations run --tree_engine queue, where K2 runs each tree iteration "
            "(ROADMAP Queue 1, \"Left unported on purpose\": K3/K4 at scenes without "
            "the in-kernel probability)")


def forward_tree(key, xpos, k_init, erg_inf, sc: Scene, cfg: NumericsConfig,
                 tcfg: TreeConfig, *, lnt_end, skip=None) -> TreeResult:
    """Forward branching tree from the MC-selected conversion point
    (get_tree, MainRunner.jl:126-352; parent photon MainRunner.jl:653-664).
    `key`: per-event keys [E, 2] or one key (per-event keys then fold in the
    batch index).  Host work-queue engine, or, at cfg.tree_engine='kernel',
    the in-kernel tree engine K3 (ops/treekernel.forward_tree_kernel).

    cfg.tree_window = N (0 < N < E) runs the loop over an N-wide streaming
    window (tree.py:288-294 of the reference): the pools hold all E events,
    each iteration gathers the rows of the events the window holds, and a
    finished event's window lane takes the batch's next unstarted event.  At
    equal K every per-event field is bitwise the unwindowed engine's
    whenever the work queue covers all valid lanes; only n_iters and done_it
    differ.

    cfg.mc_chain (engine mega with the in-kernel probability on a scene
    can_prob covers; tree.py:329-338 of the reference) runs the in-kernel
    MC chain: an iteration with a chain lane launches K2's chain
    instantiation for all its lanes (megakernel.integrate_mega's
    chain_cap), and the chain's processed children are written from its
    crossing slots (_chain_children).  A chained tree is the single-step
    tree in fewer iterations.

    `skip`: optional [E] bool; events marked True start done (their pools
    hold only the seeded root).  K3's host replay uses it to run only the
    events that overflowed the kernel's finals slots (tree.py:282-287 of the
    reference)."""
    if cfg.tree_engine == "kernel" and skip is None:
        check_tree_engine(sc, cfg)
        from adiabatic_raytracer_tpu_torch.ops.treekernel import forward_tree_kernel

        return forward_tree_kernel(key, xpos, k_init, erg_inf, sc, cfg, tcfg,
                                   lnt_end=lnt_end)
    E = xpos.shape[0]
    dev, dtype = xpos.device, xpos.dtype
    P = 2 * tcfg.max_nodes + 4
    NS = cfg.n_save
    # Lanes per event per iteration (tree.py:320-327 of the reference): under
    # the window K = 1, the reference's exact per-node cutoffs; unwindowed
    # K = mc_nodes + 2, the bound on pending nodes, keeps a draining batch's
    # launches wide.
    if cfg.tree_k > 0:
        K = int(min(P, cfg.tree_k))
    elif cfg.tree_window > 0:
        K = 1
    else:
        K = int(min(P, tcfg.mc_nodes + 2))
    mega = cfg.engine == "mega"
    mega_chain = False
    if mega:
        from adiabatic_raytracer_tpu_torch.ops.megakernel import can_prob, propagate_mega

        mega_prob = bool(cfg.in_kernel_prob) and can_prob(sc)
        # the in-kernel MC chain (tree.py:329-338 of the reference): K2's
        # chain instantiation on a scene with the in-kernel probability
        mega_chain = bool(cfg.mc_chain) and mega_prob
    CH = int(max(1, min(cfg.mc_chain_slots, tcfg.max_nodes + 2)))
    keys = _event_keys(key, E, dev)
    skey = physics_dtype(cfg.compute_dtype, dtype)

    pl = _alloc_pools(E, P, NS, dtype, dev)
    prob0, _ = _prob_batch(xpos, k_init, erg_inf, sc, cfg.compute_dtype)
    pl.pos[:, 0] = xpos
    pl.k[:, 0] = k_init
    pl.dw[:, 0] = -1.0
    pl.is_photon[:, 0] = True
    pl.prob[:, 0] = prob0
    pl.weight[:, 0] = 1.0
    pl.parent_weight[:, 0] = 1.0
    pl.prob_conv[:, 0] = -1.0
    pl.prob_conv0[:, 0] = -1.0
    pl.status[:, 0] = 1

    zi = lambda: torch.zeros(E, dtype=torch.int64, device=dev)
    tot_prob = torch.zeros(E, dtype=dtype, device=dev)
    count, count_main, dw_anom, done_it = zi(), zi(), zi(), zi()
    info = torch.ones(E, dtype=torch.int64, device=dev)
    n_alloc = torch.ones(E, dtype=torch.int64, device=dev)
    done = (torch.zeros(E, dtype=torch.bool, device=dev) if skip is None
            else skip.to(device=dev, dtype=torch.bool).clone())
    it = 0

    # The window and the work-queue width (tree.py:374-386): lane i of the
    # window holds event aw[i]; W and the global compaction follow Ew.
    Ew = E if cfg.tree_window <= 0 else int(min(cfg.tree_window, E))
    streaming = Ew < E
    aw = torch.arange(Ew, device=dev)
    cursor = torch.tensor(Ew, device=dev)        # next unstarted event
    W = max(((2 * Ew + 127) // 128) * 128, 128)
    W = int(min(Ew * K, max(W, Ew)))
    jr = torch.arange(K, device=dev)[None, :]
    ln_floor = math.exp(float(cfg.ln_t_start))
    if streaming:
        # the window's makespan bound: Ew lanes, E events, each event
        # holding its lane for at most max_nodes + 2 iterations
        # (tree.py:992-999)
        it_cap = (E // Ew + 2) * (tcfg.max_nodes + 2)
        row = lambda a: a[aw]

        def put(full, new_w):
            full[aw] = new_w
            return full

        def running():
            return it <= it_cap and bool((~done[aw]).any() | (cursor < E))
    else:
        row = lambda a: a
        put = lambda full, new_w: new_w

        def running():
            return it <= tcfg.max_nodes + 1 and bool((~done).any())

    while running():
        eK = aw[:, None].expand(Ew, K)
        done_w, count_w = row(done), row(count)
        pending = row(pl.status) == 1
        has_pending = pending.any(dim=1)
        active = ~done_w & has_pending
        wts = row(pl.weight)
        wmask = torch.where(pending & active[:, None], wts,
                            torch.full_like(wts, -math.inf)).to(skey)
        top_w, top_idx = _stable_top(wmask, K)
        valid = torch.isfinite(top_w)
        g2 = lambda buf: buf[eK, top_idx]
        w_node = g2(pl.weight)
        is_ph = g2(pl.is_photon)
        dw_node = torch.where(valid, g2(pl.dw), torch.full_like(w_node, -1.0))
        prob_conv_parent = g2(pl.prob_conv)
        count_now = count_w[:, None] + 1 + jr

        if W < Ew * K:
            # global work-queue compaction; every event's lead lane outranks
            # all others so chains always progress
            gkey = torch.where(valid, w_node.to(skey), torch.full_like(top_w, -math.inf))
            gkey = gkey + torch.where(jr == 0, 4.0, 0.0).to(skey)
            topv, gsel = _stable_top(gkey.reshape(Ew * K), W)
            sel = torch.zeros(Ew * K, dtype=torch.bool, device=dev)
            sel[gsel] = torch.isfinite(topv)
            nsel = sel.reshape(Ew, K).sum(dim=1)
            valid = valid & (jr < nsel[:, None])

        vw, vj = valid.nonzero(as_tuple=True)          # window-major lane order
        ve = aw[vw]                                    # the lanes' events
        L = ve.shape[0]
        slot = top_idx[vw, vj]
        t_node = pl.t[ve, slot]
        lnt0 = torch.log(torch.clamp(t_node, min=ln_floor))
        erg_l = erg_inf[ve]
        kw = dict(erg=erg_l, delta_w=dw_node[vw, vj], lnt0=lnt0,
                  lnt1=torch.full((L,), float(lnt_end), dtype=dtype, device=dev),
                  is_photon=is_ph[vw, vj], species="mixed")
        # chain lanes (tree.py:476-516 of the reference): the lead lane of an
        # event in MC mode with one pending node, in the endgame when
        # mc_chain_gate > 0; cap bounds its recorded crossings by the node
        # budget (an index may reach max_nodes + 1) and the CH slots.  Their
        # uniforms are the host's draws of the node indices count_now + j.
        chainy = torch.zeros(L, dtype=torch.bool, device=dev)
        if mega_chain and L:
            n_pend = (pending & active[:, None]).sum(dim=1)
            chain_ev = (n_pend == 1) & (count_w + 1 > tcfg.mc_nodes)
            if cfg.mc_chain_gate > 0:
                chain_ev = chain_ev & (active.sum() * cfg.mc_chain_gate <= Ew)
            cap = torch.where(chain_ev[vw] & (vj == 0),
                              torch.clamp(tcfg.max_nodes + 2 - count_now[vw, vj], 1, CH),
                              torch.ones_like(vw))
            chainy = cap > 1
        chain_launch = bool(chainy.any())
        pcx_l = None
        if L == 0:
            res = None
        elif mega:
            chain_kw = {}
            if chain_launch:
                # one launch through the chain instantiation: every lane has
                # cap >= 1 (cap 1 stops at its first crossing, as one slot does)
                ci = chainy.nonzero().squeeze(1)
                uni = torch.zeros((L, CH), dtype=dtype, device=dev)
                ix = count_now[vw[ci], vj[ci]][:, None] + torch.arange(CH, device=dev)[None, :]
                uni[ci] = rng.uniform(rng.fold_in(keys[ve[ci]][:, None, :], ix), dtype=dtype)
                chain_kw = dict(chain_cap=cap.to(dtype), uniforms=uni)
            res = propagate_mega(pl.pos[ve, slot], pl.k[ve, slot], sc, cfg,
                                 max_crossings=CH if chain_launch else 1,
                                 with_prob=bool(cfg.in_kernel_prob), **chain_kw, **kw)
            pcx_l = res.pcx[:, 0] if (mega_prob and res.pcx is not None) else None
        else:
            res = propagate(pl.pos[ve, slot], pl.k[ve, slot], sc, cfg,
                            max_crossings=torch.ones(L, dtype=torch.int64, device=dev),
                            **kw)

        has_x = torch.zeros((Ew, K), dtype=torch.bool, device=dev)
        rare = torch.zeros_like(has_x)
        if chain_launch:
            chain_g = torch.zeros_like(has_x)        # chain lanes
            chain_end = torch.zeros_like(has_x)      # chain lanes that ended in the kernel
            chain_exit = torch.zeros_like(has_x)     # ... at an exit (a final node)
            chain_kids = torch.zeros((Ew, K), dtype=torch.int64, device=dev)
            chain_nodes = torch.zeros_like(chain_kids)
        if L:
            hx = res.n_cross >= 1
            kc0 = res.kc[:, 0]
            rr = hx & (torch.abs(kc0) > 1.0).any(dim=1)   # MainRunner.jl:213-224
            traj_l, mom_l, ferg_l, ftime_l = res.traj, res.mom, res.erg[:, -1], res.final_lnt
            if chain_launch:
                # the chain's outputs (tree.py:648-680 of the reference): r_ch
                # restarts in the kernel, so r_ch processed children; a stop
                # at the budget with a clean last crossing leaves one more
                # child pending; a stop below it was a rare crossing, which
                # the kernel decided (slot 0's too: a chain that went on past
                # slot 0 took it as clean)
                r_ch = torch.where(chainy, res.chain_nodes, torch.zeros_like(res.chain_nodes))
                ended3 = chainy & res.cut_short
                last = torch.clamp(res.n_cross - 1, 0, CH - 1)
                rare_last = (torch.abs(res.kc[torch.arange(L, device=dev), last]) > 1.0).any(dim=1)
                pend = ended3 & (res.n_cross >= cap) & ~rare_last
                rare_term = ended3 & ~pend
                exit3 = chainy & (r_ch >= 1) & ~res.cut_short
                rr = torch.where(chainy, rare_term & (r_ch == 0), rr)
                chain_g[vw, vj] = chainy
                chain_end[vw, vj] = exit3 | (rare_term & (r_ch >= 1))
                chain_exit[vw, vj] = exit3
                chain_kids[vw, vj] = r_ch + pend.to(torch.int64)
                chain_nodes[vw, vj] = r_ch
                # node A ended at crossing 0 where the chain restarted
                mid = r_ch >= 1
                traj_l, mom_l = traj_l.clone(), mom_l.clone()
                traj_l[mid, 1:] = res.xc[mid, 0][:, None]
                mom_l[mid, 1:] = res.kc[mid, 0][:, None]
                ferg_l = torch.where(mid, res.dwc[:, 0] * erg_l, ferg_l)
                ftime_l = torch.where(mid, torch.log(torch.clamp(res.tc[:, 0], min=1e-300)),
                                      ftime_l)
            has_x[vw, vj] = hx
            rare[vw, vj] = rr
            ok_l = hx & ~rr
            pcx_lane = torch.zeros(L, dtype=dtype, device=dev)
            if pcx_l is not None:
                pcx_lane = torch.where(ok_l, pcx_l, pcx_lane)
            elif bool(ok_l.any()):
                oi = ok_l.nonzero().squeeze(1)
                pcx_lane[oi] = _prob_batch(res.xc[oi, 0], kc0[oi],
                                           erg_l[oi] * torch.abs(res.dwc[oi, 0]), sc,
                                           cfg.compute_dtype)[0]
            # record propagation results on the processed nodes
            pl.status[ve, slot] = 2
            pl.fpos[ve, slot] = traj_l[:, -1]
            pl.fmom[ve, slot] = mom_l[:, -1]
            pl.ferg[ve, slot] = ferg_l
            pl.ftime[ve, slot] = ftime_l
            pl.traj[ve, slot] = traj_l
            pl.mom[ve, slot] = mom_l
            pl.times[ve, slot] = res.times
            pl.has_cross[ve, slot] = ok_l
            pl.order[ve, slot] = count_now[vw, vj]
            oi = ok_l.nonzero().squeeze(1)
            eo, so = ve[oi], slot[oi]
            pl.xc[eo, so] = res.xc[oi, 0]
            pl.kc[eo, so] = kc0[oi]
            pl.tcx[eo, so] = res.tc[oi, 0]
            pl.dwcx[eo, so] = res.dwc[oi, 0]
            pl.pcx[eo, so] = pcx_lane[oi]
            # no crossing: a final node (MainRunner.jl:200-207)
            ni = (~hx).nonzero().squeeze(1)
            r_end = torch.linalg.norm(res.traj[ni, -1], dim=-1)
            pl.is_final[ve[ni], slot[ni]] = r_end > sc.r_ns * 1.1

        cross_ok = has_x & ~rare
        no_cross = valid & ~has_x
        weight_out, final_out = no_cross | rare, no_cross
        if chain_launch:
            # a chain's last node ended without a crossing or at a rare one
            # (tree.py:775-790 of the reference)
            weight_out, final_out = weight_out | chain_end, final_out | chain_exit
        tot_prob_w = row(tot_prob) + torch.where(weight_out, w_node,
                                                 torch.zeros_like(w_node)).sum(dim=1)
        count_main_w = row(count_main) + final_out.sum(dim=1)
        dw_bad = valid & ((dw_node > -0.5) | (dw_node < -2.0))
        dw_anom_w = row(dw_anom) + dw_bad.sum(dim=1)
        if chain_launch:   # the children processed in the kernel, one dw each
            bad = ((torch.arange(CH, device=dev)[None, :] < r_ch[:, None])
                   & ((res.dwc > -0.5) | (res.dwc < -2.0)))
            dw_anom_w = dw_anom_w.index_add(0, vw, bad.sum(dim=1))
        dw_anom = put(dw_anom, dw_anom_w)

        # spawn children (MainRunner.jl:278-305); the MC draw folds the
        # per-event node index into the event key
        pcx = torch.zeros((Ew, K), dtype=dtype, device=dev)
        convert = torch.zeros_like(cross_ok)
        spawn = cross_ok
        if chain_launch:   # chain lanes spawn through _chain_children
            spawn = cross_ok & ~chain_g
        if L:
            pcx[vw, vj] = pcx_lane
            ci = spawn.nonzero(as_tuple=True)
            if ci[0].numel():
                sub = rng.fold_in(keys[aw[ci[0]]], count_now[ci])
                convert[ci] = rng.uniform(sub, dtype=dtype) < pcx[ci]
        mc_mode = count_now > tcfg.mc_nodes
        new_species = ~is_ph
        a_species = torch.where(mc_mode, torch.where(convert, new_species, is_ph),
                                new_species)
        a_prob = torch.where(mc_mode, torch.where(convert, pcx, 1.0 - pcx), pcx)
        a_weight = torch.where(mc_mode, w_node, pcx * w_node)
        a_pc0 = torch.where(mc_mode, torch.where(convert, pcx, prob_conv_parent), pcx)
        n_child = torch.where(spawn, torch.where(mc_mode, 1, 2), 0).to(torch.int64)
        if chain_launch:
            n_child = torch.where(chain_g, chain_kids, n_child)
        n_alloc_w = row(n_alloc)
        base = n_alloc_w[:, None] + torch.cumsum(n_child, dim=1) - n_child
        write_a = spawn & (base < P)
        write_b = spawn & ~mc_mode & (base + 1 < P)
        g_xc = g2(pl.xc)
        g_kc = g2(pl.kc)
        g_tc = g2(pl.tcx)
        g_dw = g2(pl.dwcx)
        for wr, sl, species, prob, weight, pc0 in (
                (write_a, base, a_species, a_prob, a_weight, a_pc0),
                (write_b, base + 1, is_ph, 1.0 - pcx, (1.0 - pcx) * w_node,
                 prob_conv_parent)):
            we, wj = wr.nonzero(as_tuple=True)
            ev = aw[we]
            s = sl[we, wj]
            pl.pos[ev, s] = g_xc[we, wj]
            pl.k[ev, s] = g_kc[we, wj]
            pl.t[ev, s] = g_tc[we, wj]
            pl.dw[ev, s] = g_dw[we, wj]
            pl.is_photon[ev, s] = species[we, wj]
            pl.prob[ev, s] = prob[we, wj]
            pl.weight[ev, s] = weight[we, wj]
            pl.parent_weight[ev, s] = w_node[we, wj]
            pl.prob_conv[ev, s] = pcx[we, wj]
            pl.prob_conv0[ev, s] = pc0[we, wj]
            pl.status[ev, s] = 1
        n_alloc_w = n_alloc_w + write_a.sum(dim=1) + write_b.sum(dim=1)
        if chain_launch:
            n_alloc_w = _chain_children(pl, res, chainy, cap, uni, vw, vj, ve, base, count_now,
                                        is_ph, w_node, prob_conv_parent, erg_l, r_ch, pend,
                                        rare_term, exit3, n_alloc_w, sc, P, CH)
        n_alloc = put(n_alloc, n_alloc_w)
        count_w = count_w + valid.sum(dim=1)
        if chain_launch:
            count_w = count_w + chain_nodes.sum(dim=1)

        # cutoffs (MainRunner.jl:324-339), checked once per iteration
        info_w = row(info)
        hit2 = active & (tot_prob_w >= 1.0 - tcfg.prob_cutoff)
        info_w = torch.where(hit2 & ~done_w, 2, info_w)
        done_w = done_w | hit2
        hit3 = active & (count_main_w >= tcfg.num_cutoff)
        info_w = torch.where(hit3 & ~done_w, 3, info_w)
        done_w = done_w | hit3
        hit4 = active & (count_w > tcfg.max_nodes)
        info_w = torch.where(hit4 & ~done_w, 4, info_w)
        done_w = done_w | hit4 | ~has_pending
        done_it_w = row(done_it)
        done_it_w = torch.where(done_w & (done_it_w == 0), it + 1, done_it_w)
        tot_prob = put(tot_prob, tot_prob_w)
        count_main = put(count_main, count_main_w)
        count = put(count, count_w)
        info = put(info, info_w)
        done = put(done, done_w)
        done_it = put(done_it, done_it_w)
        if streaming:
            # refill (tree.py:966-977): a finished event's lane takes the
            # next unstarted event, whose pools row is already seeded
            freed = done_w.to(torch.int64)
            rank = torch.cumsum(freed, dim=0) - freed
            navail = E - cursor
            aw = torch.where(done_w & (rank < navail), cursor + rank, aw)
            cursor = cursor + torch.minimum(freed.sum(), navail)
        it += 1

    info = torch.where(count > tcfg.mc_nodes, -torch.abs(info), info)
    return TreeResult(pools=pl, count=count, count_main=count_main, info=info,
                      tot_prob=tot_prob, n_alloc=n_alloc, dw_anomalies=dw_anom,
                      n_iters=torch.full((E,), it, dtype=torch.int64, device=dev),
                      done_it=torch.where(done_it > 0, done_it, it))


def _chain_children(pl, res, chainy, cap, uni, vw, vj, ve, base, count_now, is_ph, w_node,
                    prob_conv_parent, erg_l, r_ch, pend, rare_term, exit3, n_alloc_w, sc, P,
                    CH):
    """The chain lanes' children (tree.py:866-945 of the reference): the
    records the host engine writes one iteration at a time, from the kernel's
    crossing slots.  Child C_(j+1) is born at slot j; the r_ch processed ones
    end at slot j + 1 or, the last, at the launch's end; a child left at a
    budget stop is pending.  Species and probabilities replay the kernel's
    draws from the same uniforms and pcx.  Writes the pools in place;
    returns n_alloc_w with the children allocated."""
    ci = chainy.nonzero().squeeze(1)
    cw, cj, ce = vw[ci], vj[ci], ve[ci]
    base_c, rc, pc = base[cw, cj], r_ch[ci], pend[ci]
    ncl, rt, ex = res.n_cross[ci], rare_term[ci], exit3[ci]
    xcs, kcs, tcs, dwcs, pcs = res.xc[ci], res.kc[ci], res.tc[ci], res.dwc[ci], res.pcx[ci]
    erg_c, w_c = erg_l[ci], w_node[cw, cj]
    conv_all = uni[ci] < pcs
    sp = is_ph[cw, cj]
    end_pos, end_mom = res.traj[ci, -1], res.mom[ci, -1]
    end_ferg, end_ftime = res.erg[ci, -1], res.final_lnt[ci]
    final_end = torch.linalg.norm(end_pos, dim=-1) > sc.r_ns * 1.1
    NS = pl.traj.shape[2]
    added = torch.zeros_like(ci)
    for j in range(CH):
        is_proc = j < rc
        room = base_c + j < P
        wr = (is_proc | ((j == rc) & pc)) & room
        conv = conv_all[:, j]
        sp_child = torch.where(conv, ~sp, sp)
        p_j = pcs[:, j]
        pc0_parent = pcs[:, j - 1] if j >= 1 else prob_conv_parent[cw, cj]
        wi = wr.nonzero().squeeze(1)
        ev, s = ce[wi], base_c[wi] + j
        pl.pos[ev, s] = xcs[wi, j]
        pl.k[ev, s] = kcs[wi, j]
        pl.t[ev, s] = tcs[wi, j]
        pl.dw[ev, s] = dwcs[wi, j]
        pl.is_photon[ev, s] = sp_child[wi]
        pl.prob[ev, s] = torch.where(conv, p_j, 1.0 - p_j)[wi]
        pl.weight[ev, s] = w_c[wi]
        pl.parent_weight[ev, s] = w_c[wi]
        pl.prob_conv[ev, s] = p_j[wi]
        pl.prob_conv0[ev, s] = torch.where(conv, p_j, pc0_parent)[wi]
        pl.status[ev, s] = torch.where(is_proc, 2, 1)[wi]
        # a processed child's endpoint, crossing and order records
        nj = min(j + 1, CH - 1)
        at_slot = is_proc & (j + 1 < ncl)
        f_pos = torch.where(at_slot[:, None], xcs[:, nj], end_pos)
        f_mom = torch.where(at_slot[:, None], kcs[:, nj], end_mom)
        f_erg = torch.where(at_slot, dwcs[:, nj] * erg_c, end_ferg)
        f_time = torch.where(at_slot, torch.log(torch.clamp(tcs[:, nj], min=1e-300)), end_ftime)
        hasx = at_slot & ~(rt & (j + 1 == ncl - 1))
        pi = (is_proc & room).nonzero().squeeze(1)
        ev, s = ce[pi], base_c[pi] + j
        pl.order[ev, s] = count_now[cw, cj][pi] + j + 1
        pl.fpos[ev, s] = f_pos[pi]
        pl.fmom[ev, s] = f_mom[pi]
        pl.ferg[ev, s] = f_erg[pi]
        pl.ftime[ev, s] = f_time[pi]
        pl.traj[ev, s] = torch.cat([xcs[pi, j][:, None], f_pos[pi][:, None].expand(-1, NS - 1, -1)],
                                   dim=1)
        pl.mom[ev, s] = torch.cat([kcs[pi, j][:, None], f_mom[pi][:, None].expand(-1, NS - 1, -1)],
                                  dim=1)
        pl.has_cross[ev, s] = hasx[pi]
        pl.is_final[ev, s] = (ex & (j + 1 == rc) & final_end)[pi]
        xi = (hasx & room).nonzero().squeeze(1)
        ev, s = ce[xi], base_c[xi] + j
        pl.xc[ev, s] = xcs[xi, nj]
        pl.kc[ev, s] = kcs[xi, nj]
        pl.tcx[ev, s] = tcs[xi, nj]
        pl.dwcx[ev, s] = dwcs[xi, nj]
        pl.pcx[ev, s] = pcs[xi, nj]
        added = added + wr.to(added.dtype)
        sp = sp_child
    return n_alloc_w.index_add(0, cw, added)


def compact_finals_global(pools: TreePools, cap: int, out_dtype=None,
                          order_stride: int = 0):
    """The batch's final nodes as one [cap+1, 14] pack, rows
    [event, is_photon, ferg, weight, prob, prob_conv, prob_conv0, t, fpos(3),
    fmom(3)] ordered by (event, processing order), the finals count in the
    trailer row (tree.py:1053 of the reference)."""
    d = out_dtype or pools.pos.dtype
    E, P = pools.pos.shape[:2]
    S = max(int(order_stride), P)
    final = (pools.status == 2) & pools.is_final
    fe, fp = final.nonzero(as_tuple=True)
    order = torch.argsort(fe * S + pools.order[fe, fp], stable=True)
    n = int(fe.shape[0])
    fe, fp = fe[order][:cap], fp[order][:cap]
    g = lambda a: a[fe, fp].to(d)[:, None]
    rows = torch.cat([fe.to(d)[:, None], g(pools.is_photon), g(pools.ferg),
                      g(pools.weight), g(pools.prob), g(pools.prob_conv),
                      g(pools.prob_conv0), g(pools.t), pools.fpos[fe, fp].to(d),
                      pools.fmom[fe, fp].to(d)], dim=1)
    pack = torch.zeros((cap + 1, 14), dtype=d, device=pools.pos.device)
    pack[: rows.shape[0]] = rows
    pack[cap, 0] = n
    return pack
