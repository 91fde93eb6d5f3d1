"""Chunked ray propagation with straggler compaction.

Port of adiabatic_raytracer_tpu/ops/streaming.py.  The lockstep pool
integrator runs until its slowest ray finishes, and step counts are
heavy-tailed, so a monolithic pool runs mostly idle lanes.  This wrapper runs
the pool (ops/integrator.py) in chunks of `chunk_iters` loop iterations and,
between chunks, compacts the rays still running into a pool whose size is a
power of two (at least `min_pool`); finished rays are flushed to buffers in
the original ray order.  Compaction only reorders rays, so every ray takes
the step sequence of the monolithic `propagate` (engine="pool_compact" in
the driver runs the backtrace through it).

The state stays on the tensors' device: the gathers are index_select on the
card; the host only decides, once per chunk, whether to compact.
"""

from __future__ import annotations

import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene
from adiabatic_raytracer_tpu_torch.ops.integrator import PoolResult, PoolState, integrate_pool
from adiabatic_raytracer_tpu_torch.ops.propagate import (
    PropagateResult,
    condition_fn,
    finalize_propagate,
    launch_state,
    make_rhs,
)


def _pow2_at_least(n: int, floor: int = 128) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class CompactedPropagator:
    """Chunked `propagate` with straggler compaction between chunks."""

    def __init__(self, sc: Scene, cfg: NumericsConfig, *, species: str = "photon",
                 detect_events: bool = True, time0: float = 0.0, chunk_iters: int = 256,
                 min_pool: int = 128):
        self.sc = sc
        self.cfg = cfg
        self.detect_events = detect_events
        self.time0 = time0
        self.chunk_iters = chunk_iters
        self.min_pool = min_pool
        self.mass_eff = sc.mass_ns_eff
        # compute_dtype "f32": the physics in f32, the state in its dtype
        # (streaming.py:57-58 of the reference)
        self.rhs = make_rhs(sc, self.mass_eff, time0, species, cfg.compute_dtype)
        self.cond = condition_fn(sc, self.mass_eff, cfg.compute_dtype)
        self.chunks = 0          # chunks run by the last call of run()
        self.pool_sizes = []     # pool size of each of those chunks

    def _pool(self, state: PoolState, aux: dict, budget: int):
        return integrate_pool(
            self.rhs, self.cond, None, None, aux["lnt1"],
            {"erg": aux["erg"], "is_photon": aux["is_photon"]}, self.cfg,
            save_lnt=aux["save_lnt"], kill_at_surface=aux["is_photon"], r_ns=self.sc.r_ns,
            x0_cart=aux["x0"], max_crossings=aux["maxc"], detect_events=self.detect_events,
            init_state=state, iter_budget=budget, return_state=True)[1]

    def run(self, x0, k0, erg, delta_w, lnt0, lnt1, is_photon, max_crossings,
            max_chunks: int = 10_000) -> PropagateResult:
        """propagate(x0, k0, ...) for [B] rays; max_crossings an int tensor [B]."""
        B = int(x0.shape[0])
        dev = x0.device
        u0 = launch_state(x0, k0, self.sc, erg, delta_w, self.time0)
        frac = torch.linspace(0.0, 1.0, self.cfg.n_save, dtype=u0.dtype, device=dev)
        save_lnt = lnt0[:, None] + (lnt1 - lnt0)[:, None] * frac[None, :]
        aux = {"erg": erg, "is_photon": is_photon, "lnt1": lnt1, "save_lnt": save_lnt,
               "x0": x0, "maxc": max_crossings}
        # iter_budget 0: the initial state, no step taken
        _, state = integrate_pool(
            self.rhs, self.cond, u0, lnt0, lnt1, {"erg": erg, "is_photon": is_photon},
            self.cfg, save_lnt=save_lnt, kill_at_surface=is_photon, r_ns=self.sc.r_ns,
            x0_cart=x0, max_crossings=max_crossings, detect_events=self.detect_events,
            iter_budget=0, return_state=True)
        final = PoolState(*(t.clone() for t in state))   # in the original ray order
        orig_idx = torch.arange(B, device=dev)
        valid = torch.ones(B, dtype=torch.bool, device=dev)   # False: padding duplicates

        def flush(st):
            dst = orig_idx[valid]
            for buf, t in zip(final, st):
                buf[dst] = t[valid]

        self.chunks, self.pool_sizes = 0, []
        while True:
            self.pool_sizes.append(int(state.u.shape[0]))
            state = self._pool(state, aux, self.chunk_iters)
            self.chunks += 1
            if bool(state.done.all()) or self.chunks >= max_chunks:
                flush(state)
                break
            live = ~state.done & valid
            target = _pow2_at_least(int(live.sum()), self.min_pool)
            if target < state.u.shape[0]:
                flush(state)
                keep = live.nonzero().squeeze(1)
                pad = torch.cat([keep, keep[:1].expand(target - keep.shape[0])])
                orig_idx = orig_idx[pad]
                valid = torch.arange(target, device=dev) < keep.shape[0]
                state = PoolState(*(t[pad] for t in state))
                # padding duplicates start done, so they never step
                state = state._replace(done=state.done | ~valid)
                aux = {k: v[pad] for k, v in aux.items()}

        fs = final
        past_end = save_lnt > fs.lnt[:, None]
        res = PoolResult(
            u=fs.u, lnt=fs.lnt, save_u=torch.where(past_end[:, :, None], fs.u[:, None, :],
                                                   fs.save_u),
            cross_u=fs.cross_u, cross_lnt=fs.cross_lnt, n_cross=fs.n_cross,
            cut_short=fs.cut_short, ns_hit=fs.ns_hit, maxed=fs.maxed, steps=fs.steps,
            stalled=fs.stalled, n_bisect=fs.n_bisect)
        return finalize_propagate(res, erg, self.sc, self.mass_eff, save_lnt)
