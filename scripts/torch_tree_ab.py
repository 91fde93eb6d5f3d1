"""K1, K2, K3 and K4 of two checkouts of the PyTorch + CUDA port on one GPU, in turns.

    python3 scripts/torch_tree_ab.py --parent DIR     # DIR: another checkout
    python3 scripts/torch_tree_ab.py --parent DIR --sampler
    python3 scripts/torch_tree_ab.py --window

Runs the kernels of the checkout at DIR ("parent") and of this one ("this")
in separate processes, in the order parent, this, this, parent.

K1 (the sampler's line scan) on chip_smoke.py phase 3's input: 16384
production lines x the production grid; its [B, N] output is compared
element by element with the parent's.

K2 (the backtrace and queue-path megakernel) on: chip_smoke.py phase 5's
2048-ray axion backtrace (16 slots, in-kernel probability), with the gated
and the dense scan; a queue-path launch of 700 rays, photon and axion mixed,
one slot (a ragged batch); its first ray alone (B = 1); and a backtrace of
3 x this checkout's resident K2 warps.  Every ray whose 12 outputs are all
bit for bit the parent's is counted; the slowest ray's steps and dense
passes, and the microseconds per step of it, are printed.

K3 and K4 (the tree kernels) on the inputs of chip_smoke.py's phases 6, 10
and 11: 512 production events at the default cutoffs (K3 in one launch, K4
at tree_refill 1), 512 events in two partitions of 256 (K4 with its phase-10
schedule: 128 threads in a checkout whose K4 takes no `warps`, else 32
warps), and 2048 events at the default and the production cutoffs 50/10/100
(K3 in one launch, K4 at tree_refill 1 with its default schedule); how many
events' aux rows (the iteration count excepted) and finals are bit for bit
the parent's, and the microseconds per step of the slowest tree.

Each process builds its own checkout's kernels, prints their ptxas figures
and times each launch with CUDA events (mean of 3 after one warm-up).

With --sampler, each process (parent, this, this, parent, twice) times the
sampler and the warm kernel path instead: one `sample_batch` of 16384 lines
at the production default scene (MassA 1e-5, B0 1e14, ThetaM 0.2), f32 as
the card's CLI samples, through line_engine="kernel" (host clock with a
synchronise, the median of 3 calls after one warm-up; its successes); and
the kernel path through the CLI entry point (`cli.run_from_args`, the
card's defaults: engine mega, --tree_engine auto, event_batch 2048), 4096
events, saveMode 1, seed 1769, as chip_smoke.py phase 7 runs it: one run to
warm up, then a timed one (wall, events/s, gate check, sampling and
pipeline times, the output rows); then the medians per side.

With --window (no --parent), the forward tree's streaming window on this
checkout's queue path (driver.run: engine mega, tree_engine queue, f32
sampler, 2048 events in one batch, saveMode 1, seed 1769, the production
default scene), at the default cutoffs and at the production cutoffs
50/10/100: widths 64, 128, 256, 512 and 1024 at one lane per event (K = 1),
2048 (the batch: K = 1, no streaming) and 0 (unwindowed, K = mc_nodes + 2).
Three fresh processes, each one warm-up run and then every width once, in
turns (forward, backward, forward); per width the median of the three runs
and their spread (max - min) of events/s, the pipeline time and the tree
iterations, and whether the rows equal those of width 128 bit for bit.
Prints the card's name and power limit first.

Writes each run's log under chiprun_out/tree_ab/ and its raw outputs under
build/tree_ab/.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import inspect
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(HERE, "build", "tree_ab")
LOGS = os.path.join(HERE, "chiprun_out", "tree_ab")
K1_LINES = 16384
SAMPLER_EVENTS = 4096
K1_INPUT = f"K1 {K1_LINES} production lines"
K2_INPUTS = ("K2 backtrace 2048 rays, gated", "K2 backtrace 2048 rays, dense",
             "K2 queue-path launch 700 rays, mixed, one slot", "K2 backtrace 1 ray",
             "K2 backtrace 3 x resident warps")
INPUTS = (("512 events, default cutoffs", 512, 13, 2027, {}),
          ("512 events in 2 partitions of 256", 512, 19, 2029, {}),
          ("2048 events, default cutoffs", 2048, 17, 2028, {}),
          ("2048 events, production cutoffs 50/10/100", 2048, 17, 2028,
           dict(num_cutoff=50, mc_nodes=10, max_nodes=100)))

WINDOWS = (64, 128, 256, 512, 1024, 2048, 0)
WINDOW_EVENTS = 2048
WINDOW_CUTOFFS = (("default cutoffs", {}),
                  ("production cutoffs 50/10/100", dict(num_cutoff=50, mc_nodes=10,
                                                        max_nodes=100)))


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def k1_worker(smoke, dev, res):
    """Time and keep K1 of the imported checkout on phase 3's lines."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = smoke.scene_setup(dev)
    geo = sampler._draw(rng.split(rng.PRNGKey(20261016, device=dev), K1_LINES), maxR, sc,
                        220.0, True, torch.float32)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=dev).to(torch.float32)
    fn = lambda: line_scan.line_scan(geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid, sc,
                                     sc.mass_ns)
    res[K1_INPUT] = {"x": geo.x0.cpu(), "K1": fn().cpu(), "ms": smoke.cuda_ms(fn, 20)}


def k2_worker(smoke, dev, n3, res):
    """Time and keep K2 of the imported checkout on the K2_INPUTS."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    back = smoke.k2_backtrace_inputs(dev, 2048, seed=11)
    one = tuple(a[:1] if torch.is_tensor(a) else a for a in back[:5]) + back[5:7] + (
        {k: v[:1] if torch.is_tensor(v) else v for k, v in back[7].items()},)
    inputs = (back, back, smoke.k2_queue_inputs(dev, 700, seed=23), one,
              smoke.k2_backtrace_inputs(dev, n3, seed=29))
    for name, (u0, lnt0, lnt1, e, x, sc, cfg, kw) in zip(K2_INPUTS, inputs):
        if "dense" in name:
            cfg = dataclasses.replace(cfg, interp_coarse=0)
        fn = lambda: mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, cfg, **kw)
        out = tuple(t.cpu() for t in fn())
        if hasattr(mk, "launch_warps"):   # a checkout whose wrapper picks the warps
            warps = mk.launch_warps(u0.shape[0], dev)
        else:
            warps = min(u0.shape[0], mk.resident_warps(mk.mega_params(sc, cfg), dev))
        res[name] = {"x": x.cpu(), "K2": out, "ms": smoke.cuda_ms(fn, 3), "warps": warps}


def worker(root, save, n3):
    """Time and keep K2, K3 and K4 of the checkout at `root` on every
    input."""
    sys.path.insert(0, root)
    import torch

    import adiabatic_raytracer_tpu_torch as pkg
    from adiabatic_raytracer_tpu_torch.config import TreeConfig
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep)
    smoke = _smoke()
    dev = torch.device("cuda")
    cuda_lib.lib()
    summary = smoke.ptxas_summary(cuda_lib.BUILD_LOG)
    sc, cfg, _, maxR, n_grid = smoke.scene_setup(dev)
    warp_k4 = "warps" in inspect.signature(tk.tree_refill_launch).parameters
    res = {"gpu": smoke.smi_line(),
           "ptxas": {k: smoke.ptxas_figures(summary.get(k, ""))
                     for k in ("mega_kernel", "tree_kernel", "tree_refill_kernel")}}
    k1_worker(smoke, dev, res)
    k2_worker(smoke, dev, n3, res)
    for name, n, seed, kseed, cut in INPUTS:
        tcfg = TreeConfig(**cut)
        nf = int(min(cfg.tree_kernel_finals, tcfg.num_cutoff))
        qd = tcfg.mc_nodes + 2
        it_full = (tcfg.max_nodes + 2) * (cfg.max_steps + 2)
        x, k, e = smoke.sample_events(n, dev, sc, cfg, maxR, n_grid, seed=seed)
        keys = rng.fold_in(rng.PRNGKey(kseed, device=dev), torch.arange(n, device=dev))
        blocks = tk.tree_inputs(keys, x, k, e, sc, cfg, tcfg, lnt_end=0.0)
        ep = 256 if "partitions" in name else tk.refill_partition(n, 1)
        sched = dict(warps=32) if warp_k4 and "partitions" in name else {}
        runs = {"K4": lambda: tk.tree_refill_launch(*blocks, sc, cfg, tcfg, nf=nf, qd=qd,
                                                    epart=ep, refill_k=int(cfg.tree_refill_k),
                                                    it_cap=min(it_full * ep, 2**31 - 2),
                                                    **sched)}
        if "partitions" not in name:
            runs["K3"] = lambda: tk.tree_kernel_launch(*blocks, sc, cfg, tcfg, nf=nf, qd=qd,
                                                       it_cap=it_full)
        out = {"x": x.cpu()}
        for kname, fn in runs.items():
            _, a, _, f = fn()
            out[kname] = (a.cpu(), f.cpu(), smoke.cuda_ms(fn, 3))
        res[name] = out
    torch.save(res, save)


def sampler_worker(root, save):
    """Time sample_batch and the warm kernel path of the checkout at root."""
    sys.path.insert(0, root)
    import statistics

    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    smoke = _smoke()
    dev = torch.device("cuda")
    sc, _, _, maxR, n_grid = smoke.scene_setup(dev)
    key = rng.PRNGKey(1769, device=dev)
    sample = lambda: sampler.sample_batch(key, K1_LINES, maxR, sc, sc.mass_ns, n_grid=n_grid,
                                          compute_dtype="f32", line_engine="kernel")
    succ = int(sample().success.sum())
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.time()
        sample()
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    argv = lambda tag: (["--device", "cuda", "--event_batch", "2048", "--Nts",
                         str(SAMPLER_EVENTS + 1), "--saveMode", "1", "--seed", "1769",
                         "--dir_tag", os.path.join(RAW, "rows"), "--ftag", tag,
                         "--tree_engine", "auto"] + smoke.SCENE_ARGS)
    with open(os.devnull, "w") as null:
        stdout, sys.stdout = sys.stdout, null
        try:
            cli.run_from_args(argv("warm_up"))
            t0 = time.time()
            _, path, stats = cli.run_from_args(argv("timed"))
            wall = time.time() - t0
        finally:
            sys.stdout = stdout
    rows = np.load(path)
    torch.save({"gpu": smoke.smi_line(), "sample_s": statistics.median(walls),
                "sample_calls": walls, "successes": succ, "wall": wall,
                "events_per_s": stats.events / wall, "t_gate": stats.t_gate,
                "t_sample": stats.t_sample, "t_pipeline": stats.t_pipeline,
                "rows": int(rows.shape[0]), "weight_sum": float(rows[:, 8].sum())}, save)


def window_worker(save, order):
    """The queue path at every window width of `order`, after one warm-up run."""
    sys.path.insert(0, HERE)
    import torch

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.config import TreeConfig

    smoke = _smoke()
    dev = torch.device("cuda")
    sc, cfg, _, _, _ = smoke.scene_setup(dev)
    cfg = dataclasses.replace(cfg, tree_engine="queue")
    res = {}
    for name, cut in WINDOW_CUTOFFS:
        tcfg = TreeConfig(**cut)

        def run(w, tag):
            t0 = time.time()
            rows, _, st = driver.run(sc, dataclasses.replace(cfg, tree_window=w), tcfg,
                                     WINDOW_EVENTS + 1, seed=1769, save_mode=1,
                                     event_batch=WINDOW_EVENTS, verbose=False, device=dev,
                                     dir_tag=os.path.join(RAW, "window"), file_tag=tag)
            torch.cuda.synchronize()
            wall = time.time() - t0
            return {"wall": wall, "events_per_s": st.events / wall, "t_pipeline": st.t_pipeline,
                    "t_gate": st.t_gate, "tree_iters": st.tree_iters,
                    "rows": torch.from_numpy(rows)}

        run(128, "warm_up")
        for w in order:
            res[(name, w)] = run(w, f"w{w}")
    torch.save(res, save)


def report_window(runs):
    """Per cutoff set and width: medians and spreads over the runs, and
    whether the rows equal width 128's bit for bit."""
    import statistics

    import torch

    for name, _ in WINDOW_CUTOFFS:
        ref = runs[0][(name, 128)]["rows"]
        for w in WINDOWS:
            rs = [r[(name, w)] for r in runs]
            eps = [r["events_per_s"] for r in rs]
            pipe = [r["t_pipeline"] for r in rs]
            same = sum(torch.equal(r["rows"], ref) for r in rs)
            label = {0: "0 (unwindowed, K = mc_nodes + 2)",
                     WINDOW_EVENTS: f"{WINDOW_EVENTS} (the batch, K = 1)"}.get(w, f"{w} (K = 1)")
            print(f"[ab] window {name}, width {label}: events/s median "
                  f"{statistics.median(eps):.1f} spread {max(eps) - min(eps):.1f} (runs "
                  + ", ".join(f"{x:.1f}" for x in eps) + f"); pipeline median "
                  f"{statistics.median(pipe):.3f} s spread {max(pipe) - min(pipe):.3f}; gate "
                  f"{statistics.median(r['t_gate'] for r in rs):.3f} s; tree iterations "
                  f"{rs[0]['tree_iters']}; rows {tuple(ref.shape)}, bitwise width 128's in "
                  f"{same}/{len(rs)} runs", flush=True)


def report_sampler(runs):
    """One line per --sampler run, then the medians per side."""
    import statistics

    for i, (who, r) in enumerate(runs):
        print(f"[ab] run {i} ({who}): sample_batch {K1_LINES} lines {r['sample_s']:.4f} s "
              f"(calls " + ", ".join(f"{t:.4f}" for t in r["sample_calls"])
              + f"; {r['successes']} successes); kernel path {SAMPLER_EVENTS} events warm "
              f"{r['wall']:.2f} s = {r['events_per_s']:.1f} events/s (gate {r['t_gate']:.2f} s, "
              f"sample {r['t_sample']:.2f} s, pipeline {r['t_pipeline']:.2f} s), {r['rows']} "
              f"rows, weight sum {r['weight_sum']:.6g}")
    med = lambda who, k: statistics.median(r[k] for w, r in runs if w == who)
    print(f"[ab] {runs[0][1]['gpu']}; medians parent / this: " + "; ".join(
        f"{k} {med('parent', k):.4g} / {med('this', k):.4g}"
        for k in ("sample_s", "events_per_s", "wall", "t_gate", "t_sample", "t_pipeline")))


def rays_bitwise(a, b):
    """Rays whose 12 K2 outputs are all bit for bit equal (NaN included)."""
    import torch

    B = a[0].shape[0]
    same = torch.ones(B, dtype=torch.bool)
    for x, y in zip(a, b):
        x, y = x.reshape(B, -1).contiguous(), y.reshape(B, -1).contiguous()
        same &= (x.view(torch.int64) == y.view(torch.int64)).all(dim=1)
    return int(same.sum())


def bitwise(a, b):
    """Events whose aux rows (A_ITERS excepted) and finals are identical."""
    import torch

    keep = [r for r in range(a[0].shape[1]) if r != 23]   # A_ITERS
    return int(((a[0][:, keep] == b[0][:, keep]).all(dim=1)
                & (a[1] == b[1]).all(dim=1)).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the repo")
    ap.add_argument("--sampler", action="store_true",
                    help="time sample_batch and the warm kernel path instead of the kernels")
    ap.add_argument("--window", action="store_true",
                    help="sweep the forward tree's streaming window on the queue path")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--rays", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--order", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.window and args.worker:
        window_worker(args.save, [int(w) for w in args.order.split(",")])
        return 0
    if args.worker:
        if args.sampler:
            sampler_worker(args.worker, args.save)
        else:
            worker(args.worker, args.save, args.rays)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(RAW, exist_ok=True)
    os.makedirs(LOGS, exist_ok=True)
    if args.window:
        print(f"[ab] {_smoke().smi_line()}", flush=True)
        runs = []
        for i, order in enumerate((WINDOWS, WINDOWS[::-1], WINDOWS)):
            save = os.path.join(RAW, f"window{i}.pt")
            t0 = time.time()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--window",
                                   "--worker", HERE, "--save", save, "--order",
                                   ",".join(map(str, order))],
                                  cwd=HERE, capture_output=True, text=True, timeout=1800)
            with open(os.path.join(LOGS, f"window{i}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                print(f"window run {i} failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
                return 1
            runs.append(torch.load(save))
            print(f"[ab] window run {i} {time.time() - t0:.1f} s", flush=True)
        report_window(runs)
        return 0
    if not args.parent:
        ap.error("--parent is required without --window")
    sys.path.insert(0, HERE)
    import chip_smoke
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda", 0)
    # this checkout's resident K2 warps on this card, at the production scene
    n3 = 3 * mk.resident_warps(mk.mega_params(*chip_smoke.scene_setup(dev)[:2]), dev)
    summary = chip_smoke.ptxas_summary(cuda_lib.BUILD_LOG)
    print(f"[ab] this checkout: K2 resident warps {n3 // 3}; ptxas (registers, stack, spill "
          f"stores, loads) " + ", ".join(
              f"{k} {chip_smoke.ptxas_figures(summary.get(k, ''))}"
              for k in ("mega_kernel", "tree_kernel", "tree_refill_kernel")), flush=True)
    roots = {"parent": os.path.abspath(args.parent), "this": HERE}
    runs = []
    mode = ["--sampler"] if args.sampler else []
    for i, who in enumerate(("parent", "this", "this", "parent") * (2 if args.sampler else 1)):
        save = os.path.join(RAW, f"run{i}_{who}.pt")
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               roots[who], "--save", save, "--rays", str(n3)] + mode,
                              cwd=roots[who], capture_output=True, text=True, timeout=900)
        with open(os.path.join(LOGS, f"run{i}_{who}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"{who} run {i} failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        runs.append((who, torch.load(save)))
        built = {k: v for k, v in runs[-1][1].get("ptxas", {}).items() if v[0] is not None}
        print(f"[ab] run {i} ({who}) {time.time() - t0:.1f} s" + (
            "; ptxas (registers, stack, spill stores, loads) "
            + ", ".join(f"{k} {v}" for k, v in built.items()) if built else ""), flush=True)
    if args.sampler:
        report_sampler(runs)
        return 0
    print(f"[ab] {runs[0][1]['gpu']}")
    par, this = runs[0][1][K1_INPUT], runs[1][1][K1_INPUT]
    assert torch.equal(par["x"], this["x"])   # the same lines
    same = [int((r[K1_INPUT]["K1"].view(torch.int32) == par["K1"].view(torch.int32)).sum())
            for _, r in runs[1:3]]
    ms = " / ".join(f"{r[K1_INPUT]['ms']:.4f}" for _, r in runs)
    print(f"[ab] {K1_INPUT} x {par['K1'].shape[1]} points: K1 ms (parent / this / this / "
          f"parent) {ms}; points bitwise the parent's (runs 2, 3) {same[0]}/{par['K1'].numel()}, "
          f"{same[1]}/{par['K1'].numel()}", flush=True)
    for name in K2_INPUTS:
        par, this = runs[0][1][name], runs[1][1][name]
        assert torch.equal(par["x"], this["x"]), name   # the same rays
        B = par["x"].shape[0]
        ms = " / ".join(f"{r[name]['ms']:.3f}" for _, r in runs)
        same = [rays_bitwise(r[name]["K2"], par["K2"]) for _, r in runs[1:3]]
        steps = this["K2"][2]
        slow = int(steps.argmax())
        us = " -> ".join(f"{runs[i][1][name]['ms'] * 1e3 / steps[slow].item():.2f}"
                         for i in (0, 1))
        print(f"[ab] {name}: B {B}, K2 ms (parent / this / this / parent) {ms}; rays with all "
              f"12 outputs bitwise the parent's (runs 2, 3) {same[0]}/{B}, {same[1]}/{B}; slowest "
              f"ray {slow}: {int(steps[slow])} steps, {int(this['K2'][11][slow])} dense passes, "
              f"{int(this['K2'][4][slow])} crossings, us per step of it (parent -> this) {us}; "
              f"steps per ray mean {steps.mean().item():.1f}; warps launched (this) "
              f"{this['warps']}", flush=True)
    for name, *_ in INPUTS:
        par, this = runs[0][1][name], runs[1][1][name]
        assert torch.equal(par["x"], this["x"]), name   # the same events
        parts = []
        for kname in ("K3", "K4"):
            if kname not in this:
                continue
            ms = " / ".join(f"{r[name][kname][2]:.3f}" for _, r in runs)
            parts.append(f"{kname} ms (parent / this / this / parent) {ms}; bitwise this vs "
                         f"parent {bitwise(this[kname], par[kname])}/{par['x'].shape[0]}")
        steps = this[next(iter(this.keys() - {"x"}))][0][:, 26].max().item()   # A_STEPTOT
        per = lambda who, kname: runs[0 if who == "parent" else 1][1][name][kname][2]
        us = ", ".join(f"{kname} {per('parent', kname) * 1e3 / steps:.2f} / "
                       f"{per('this', kname) * 1e3 / steps:.2f}"
                       for kname in ("K3", "K4") if kname in this)
        same = (f"; this K4 vs this K3 bitwise {bitwise(this['K4'], this['K3'])}"
                if "K3" in this else "")
        print(f"[ab] {name}: " + "; ".join(parts) + f"; slowest tree {int(steps)} steps, us "
              f"per step of it (parent / this): {us}{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
