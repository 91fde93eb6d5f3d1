"""K3's time per tree step against the warps each SM runs, on one GPU.

    python3 scripts/torch_tree_occupancy.py

Takes the slowest tree of chip_smoke.py phase 6's input (512 production
events, default cutoffs) and runs K3 on copies of that one event only:
SMs x b blocks of 4 warps (b = 1 or 2 blocks an SM, K3 holding 2 at its
255 registers), with w live warps in each block (the other warps' events
marked done, so they return at once).  Every live warp then runs the same
tree for the whole launch, at b x w warps an SM.  Prints, for each b x w,
the device time (CUDA events, mean of 3 launches after one warm-up) over
the tree's steps, whether every live copy ended bit for bit as the tree
alone, and the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    dev = torch.device("cuda")
    sc, cfg, tcfg, maxR, n_grid = smoke.scene_setup(dev)
    nf = int(min(cfg.tree_kernel_finals, tcfg.num_cutoff))
    kw = dict(nf=nf, qd=tcfg.mc_nodes + 2, it_cap=(tcfg.max_nodes + 2) * (cfg.max_steps + 2))
    x, k, e = smoke.sample_events(512, dev, sc, cfg, maxR, n_grid, seed=13)   # phase 6's
    keys = rng.fold_in(rng.PRNGKey(2027, device=dev), torch.arange(512, device=dev))
    blocks = tk.tree_inputs(keys, x, k, e, sc, cfg, tcfg, lnt_end=0.0)
    _, a1, _, f1 = tk.tree_kernel_launch(*blocks, sc, cfg, tcfg, **kw)
    slow = int(torch.argmax(a1[:, tk.A_STEPTOT]))
    steps = a1[slow, tk.A_STEPTOT].item()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keep = [r for r in range(tk.AUX_ROWS) if r != tk.A_ITERS]
    print(f"[occ] {smoke.smi_line()}; {sms} SMs; event {slow} of phase 6's input, "
          f"{int(steps)} steps", flush=True)
    for b in (1, 2):
        for w in (1, 2, 3, 4):
            n = sms * b * 4
            idx = torch.full((n,), slow, dtype=torch.int64, device=dev)
            uin, aux, uni, qin = (t[idx].contiguous() for t in blocks)
            live = (torch.arange(n, device=dev) % 4) < w
            aux[~live, tk.A_DONE] = 1.0
            run = lambda: tk.tree_kernel_launch(uin, aux, uni, qin, sc, cfg, tcfg, **kw)
            _, a, _, f = run()
            same = bool(torch.equal(a[live][:, keep], a1[slow:slow + 1, keep].expand(
                int(live.sum()), -1)) and torch.equal(f[live], f1[slow:slow + 1].expand(
                    int(live.sum()), -1)))
            ms = smoke.cuda_ms(run, 3)
            print(f"[occ] {b} block(s) x {w} live warp(s) = {b * w} warps an SM "
                  f"({int(live.sum())} trees): {ms:.3f} ms, {ms * 1e3 / steps:.2f} us per step; "
                  f"every copy bitwise the tree alone {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
