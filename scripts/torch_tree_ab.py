"""K3 and K4 of two checkouts of the PyTorch + CUDA port on one GPU, in turns.

    python3 scripts/torch_tree_ab.py --parent DIR     # DIR: another checkout

Runs the tree kernels of the checkout at DIR ("parent") and of this one
("this") in separate processes, in the order parent, this, this, parent, on
the inputs of chip_smoke.py's phases 6, 10 and 11: 512 production events at
the default cutoffs (K3 in one launch, K4 at tree_refill 1), 512 events in
two partitions of 256 (K4 with its phase-10 schedule: 128 threads in a
checkout whose K4 takes no `warps`, else 32 warps), and 2048 events at the
default and the production cutoffs 50/10/100 (K3 in one launch, K4 at
tree_refill 1 with its default schedule).  Each process builds its own
checkout's kernels and times each launch with CUDA events (mean of 3 after
one warm-up).  Prints one line per input: the device times in run order, the
microseconds per step of the slowest tree, and how many events' aux rows
(the iteration count excepted) and finals are bit for bit the parent's.
Writes each run's log and raw outputs under build/tree_ab/.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = os.path.join(HERE, "build", "tree_ab")
INPUTS = (("512 events, default cutoffs", 512, 13, 2027, {}),
          ("512 events in 2 partitions of 256", 512, 19, 2029, {}),
          ("2048 events, default cutoffs", 2048, 17, 2028, {}),
          ("2048 events, production cutoffs 50/10/100", 2048, 17, 2028,
           dict(num_cutoff=50, mc_nodes=10, max_nodes=100)))


def worker(root, save):
    """Time and keep K3 and K4 of the checkout at `root` on every input."""
    sys.path.insert(0, root)
    import torch

    import adiabatic_raytracer_tpu_torch as pkg
    from adiabatic_raytracer_tpu_torch.config import TreeConfig
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    sc, cfg, _, maxR, n_grid = smoke.scene_setup(dev)
    warp_k4 = "warps" in inspect.signature(tk.tree_refill_launch).parameters
    res = {"gpu": smoke.smi_line()}
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


def bitwise(a, b):
    """Events whose aux rows (A_ITERS excepted) and finals are identical."""
    import torch

    keep = [r for r in range(a[0].shape[1]) if r != 23]   # A_ITERS
    return int(((a[0][:, keep] == b[0][:, keep]).all(dim=1)
                & (a[1] == b[1]).all(dim=1)).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout of the repo")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.save)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(RAW, exist_ok=True)
    roots = {"parent": os.path.abspath(args.parent), "this": HERE}
    runs = []
    for i, who in enumerate(("parent", "this", "this", "parent")):
        save = os.path.join(RAW, f"run{i}_{who}.pt")
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               roots[who], "--save", save], cwd=roots[who],
                              capture_output=True, text=True, timeout=900)
        with open(os.path.join(RAW, f"run{i}_{who}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(f"{who} run {i} failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        print(f"[ab] run {i} ({who}) {time.time() - t0:.1f} s", flush=True)
        runs.append((who, torch.load(save)))
    print(f"[ab] {runs[0][1]['gpu']}")
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
