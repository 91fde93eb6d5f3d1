"""The port's main path across the (MassA, B0) scan grid on one GPU: a
record of what each scene costs, not a benchmark.

    python3 scripts/torch_scene_grid.py              # every scene with events
    python3 scripts/torch_scene_grid.py --scenes 2 5 # chip_smoke.SCAN_GRID indices
    python3 scripts/torch_scene_grid.py --bndry_lyr 0.5   # the boundary-layer path

At each scene of chip_smoke.SCAN_GRID whose conversion surface lies outside
the star (seven of the nine; ThetaM 0.2, seed 1769, saveMode 1):

- the CLI at its card defaults (engine mega, event_batch 2048, compute
  dtype f32, --tree_engine auto -> K3 at --tree_kernel_chunk 64) on 16384
  events, once cold in a fresh process and then warm in this one under
  torch.profiler, at the default cutoffs 5/5/50 and at the production
  cutoffs 50/10/100 (bench_pipeline.py:84-86): wall, events/s, the census
  verdict and the stage times (t_gate, t_sample, t_pipeline), the device
  busy share and K1's, K2's and K3's device time and launches from the
  trace (chip_smoke.write_profile), the launch counters, and whether the
  rows are finite with weight > 0 (0 only where the survival weight is,
  chip_smoke.rows_ok) with the count of weight-0 rows;
- the host reads per batch: one more warm run at the default cutoffs under
  torch.cuda.set_sync_debug_mode("warn") (chip_smoke.count_host_reads);
- K2's gate at gate_trig "native" against the default on a 2048-ray
  backtrace (chip_smoke.k2_backtrace_inputs), at the default gate and at
  the census's: crossing counts identical, rays bitwise in all 12 outputs,
  and each gate's counts against the dense scan's;
- the queue path (--tree_engine queue) on the same 16384 events at the
  default cutoffs, and the warm kernel path's spectrum against it
  (chip_smoke.spectrum_gap: the pulse profile's worst bin of at least
  chip_smoke.SPECTRUM_MIN_ROWS rows and the total photon rate, in units of
  the Monte Carlo standard error), with the events whose scalars differ by
  more than chip_smoke.REC_P99 (chip_smoke.row_event_gaps); printed, not
  held (chip_smoke phase 27e holds it at the production scene).

With --bndry_lyr L > 0 the scenes carry the boundary layer, where
--tree_engine auto picks the queue path (the kernel tree engines do not
cover it): the CLI on 16384 events, cold and then warm under the profiler,
at the default cutoffs only, with the same fields (K3 launches none), the
tree iterations per batch, and the host reads per batch counted on one
batch of 2048 (chip_smoke.count_host_reads); the profiler records the
card's activity only (no host events); no production cutoffs, native gate
or spectrum.

Prints the card's name and power limit (nvidia-smi) first, then one JSON
line per scene.  Writes its profiles under chiprun_out/scene_grid/ and the
npy outputs under build/scene_grid/.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

EVENTS = 16384
BATCH = 2048
CUTOFFS = {"default": {}, "production": cs.PRODUCTION_CUTOFFS}
CUTOFF_FLAGS = {"default": [], "production": ["--numCutoff", "50", "--MCNodes", "10",
                                              "--maxNodes", "100"]}
RAW = os.path.join(HERE, "build", "scene_grid")
SUMMARY = re.compile(r"events=(\d+) .*wall=([\d.]+)s \(gate ([\d.]+) sample ([\d.]+) "
                     r"pipe ([\d.]+)")


def argv(scene, cut, tag, events=EVENTS):
    return (["--device", "cuda", "--event_batch", str(BATCH), "--Nts", str(events + 1),
             "--saveMode", "1", "--seed", "1769", "--ThetaM", "0.2", "--MassA",
             f"{scene['mass_a']:g}", "--B0", f"{scene['b0']:g}", "--dir_tag", RAW, "--ftag",
             tag] + CUTOFF_FLAGS[cut]
            + (["--bndry_lyr", f"{scene['bndry_lyr']:g}"] if "bndry_lyr" in scene else []))


def cold(scene, cut):
    """The CLI in a fresh process: its wall (imports and warm-up included)
    and the stage times it prints."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "adiabatic_raytracer_tpu_torch",
                           *argv(scene, cut, f"cold_{cut}")], cwd=HERE, capture_output=True,
                          text=True, timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cold CLI run at {scene} failed:\n{proc.stderr[-3000:]}")
    m = SUMMARY.search(proc.stdout)
    return dict(wall_s=wall, events_s=EVENTS / wall, run_wall_s=float(m[2]),
                t_gate=float(m[3]), t_sample=float(m[4]), t_pipeline=float(m[5]))


def warm(scene, cut, tag):
    """The CLI in this process under torch.profiler, the launch counters
    reset just before it.  With the boundary layer the profiler records the
    card's activity only: with the host's events too, the queue path's
    16384-event runs (over a million device events each) ran the card
    machine out of its 96 GiB at the fifth scene (the device busy share and
    kernel times read device events alone)."""
    import torch

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    acts = ([torch.profiler.ProfilerActivity.CUDA] if "bndry_lyr" in scene else
            [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
    with torch.profiler.profile(activities=acts) as prof:
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        rows, _, st = cli.run_from_args(argv(scene, cut, f"warm_{cut}"))
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    p = cs.write_profile(prof, wall, "grid", tag)
    return rows, dict(wall_s=wall, events_s=st.events / wall, verdict=st.scan_gate,
                       t_gate=st.t_gate, t_sample=st.t_sample, t_pipeline=st.t_pipeline,
                       tree_iters_per_batch=st.tree_iters / (EVENTS // BATCH),
                       rows=int(rows.shape[0]),
                       rows_ok=bool(cs.rows_ok(rows, zero_weight_ok=True)),
                       zero_weight_rows=int((rows[:, 8] == 0).sum()),
                       busy_share=p["busy_ms"] / 1e3 / wall, device_events=p["device_events"],
                       device_ms={k: v[0] for k, v in p["kernels"].items()},
                       device_launches={k: v[1] for k, v in p["kernels"].items()},
                       launches={k: launches[k]
                                 for k in ("line_roots", "megakernel", "treekernel")})


def spectrum(scene, rows_kernel):
    """The queue path at the default cutoffs on the warm kernel path's
    events, and the kernel path's spectrum against it."""
    from adiabatic_raytracer_tpu_torch import cli

    t0 = time.time()
    rows, _, st = cli.run_from_args(argv(scene, "default", "queue") + ["--tree_engine", "queue"])
    wall = time.time() - t0
    worst_bin, bins, total, total_rel = cs.spectrum_gap(rows_kernel, rows)
    gaps = cs.row_event_gaps(rows_kernel, rows)
    return dict(queue_wall_s=wall, queue_events_s=st.events / wall, rows_kernel=len(rows_kernel),
                rows_queue=len(rows), events_agreeing=cs.rows_agreement(rows_kernel, rows)[0],
                events_off=sum(g > cs.REC_P99 for g in gaps.values()),
                worst_gap=max(gaps.values(), default=0.0), worst_bin_sigma=worst_bin,
                bins_held=bins, total_sigma=total, total_rel=total_rel)


def host_reads(scene, events=EVENTS):
    """Synchronizing CUDA operations of one warm run of `events` events at
    the default cutoffs, per batch, and their top sites."""
    from adiabatic_raytracer_tpu_torch import cli

    _, n, sites = cs.count_host_reads(lambda: cli.run_from_args(argv(scene, "default",
                                                                     "reads", events)))
    return dict(per_batch=n / (events // BATCH), events=events, sites=sites)


def native_gate(device, scene, gate):
    """K2 at gate_trig native against precise on a 2048-ray backtrace, at
    the default gate and at the census's, each against the dense scan."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    u0, lnt0, lnt1, e, x, sc_b, cfg, kw = cs.k2_backtrace_inputs(device, 2048, seed=11, **scene)
    run = lambda c: mk.integrate_mega(u0, lnt0, lnt1, e, x, sc_b, c, **kw)
    dense = run(dataclasses.replace(cfg, interp_coarse=0))
    out = {}
    for name, c in (("default gate", cfg), ("census gate", gate)):
        pre, nat = run(c), run(dataclasses.replace(c, gate_trig="native"))
        out[name] = dict(coarse=c.interp_coarse, theta=c.scan_gate_theta,
                         counts_same=(pre[4] == nat[4]).double().mean().item(),
                         bitwise_rays=int(cs.bitwise_rays(pre, nat).sum()),
                         precise_vs_dense=(pre[4] == dense[4]).double().mean().item(),
                         native_vs_dense=(nat[4] == dense[4]).double().mean().item(),
                         native_missed=int((nat[4] < dense[4]).sum()),
                         precise_missed=int((pre[4] < dense[4]).sum()))
    torch.cuda.synchronize()
    return dict(rays=int(x.shape[0]), **out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, nargs="*", default=None,
                    help="chip_smoke.SCAN_GRID indices (default: every scene with events)")
    ap.add_argument("--bndry_lyr", type=float, default=-1.0,
                    help="> 0: the scenes with this boundary layer (the queue path)")
    args = ap.parse_args()
    bndry = args.bndry_lyr > 0

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scene_grid needs a CUDA device")
    device = torch.device("cuda")
    cs.OUT = os.path.join(HERE, "chiprun_out", "scene_grid")
    os.makedirs(RAW, exist_ok=True)
    smi = cs.smi_line()
    print(smi, flush=True)
    grid = cs.grid_scenes()
    for i in (range(len(grid)) if args.scenes is None else args.scenes):
        scene, ref, outside = grid[i]
        if not outside:
            continue
        t0 = time.time()
        if bndry:   # the census at the CLI's cfg, as its runs find it
            scene = dict(scene, bndry_lyr=args.bndry_lyr)
            gate, verdict = cs.census_cfg(device, cfg=cs.bndry_cfg(device, **scene), **scene)
        else:
            gate, verdict = cs.census_cfg(device, **scene)
        rec = dict(scene=scene, verdict=verdict, card=smi,
                   **{"reference_without_layer" if bndry else "reference": ref})
        for cut in (("default",) if bndry else CUTOFFS):
            rec[f"cold_{cut}"] = cold(scene, cut)
            rows, rec[f"warm_{cut}"] = warm(scene, cut, f"{i}_{cut}" + ("_bndry" if bndry else ""))
            if cut == "default" and not bndry:
                rec["spectrum"] = spectrum(scene, rows)
        rec["host_reads"] = host_reads(scene, BATCH if bndry else EVENTS)
        if not bndry:
            rec["native_gate"] = native_gate(device, scene, gate)
        rec["wall_s"] = time.time() - t0
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
