"""Command-line interface: the reference's flags (Gen_Samples.jl:15-134) plus
`--device {cpu,cuda}`.

Usage:  python -m adiabatic_raytracer_tpu_torch --device cuda --MassA 1e-5 ...

The run goes to the card (`--device cuda`, the default) unless `--device
cpu` asks for the CPU; without a card the default raises.  Defaults by
device: on cuda engine=mega (the K2 kernel), event_batch=2048, compute
dtype f32 (the JAX CLI's accelerator default); on cpu those of the JAX
package's CPU path (pool engine, event_batch=16, compute dtype "state").
`--precision f32` runs every tensor of the pipeline in f32, as the JAX CLI
does with x64 off; `--computeDtype f32` evaluates the physics in f32 under
an f64 state.  Rows are f64 either way.  `--tree_engine auto` picks the
in-kernel tree engine K3 (`kernel`) when the engine is mega, saveMode <= 1
and the scene is one the in-kernel probability covers, else the host work
queue (`queue`), as the JAX CLI does.  `--tree_window -1` (auto) runs the
queue's streaming window (2048 events, TREE_WINDOW) with one lane per event
whenever event_batch > 128, the JAX CLI's rule at the width the card ran
fastest.  `--pipeline_depth 0` (auto) is PIPELINE_DEPTH.  `--mesh N` shards
each batch over the first N cards (raising when there are fewer; on cpu, N
virtual shards).  `--coordinator host:port --nprocs N --procid P` joins a
torch.distributed group over gloo, each process on card P % device_count.
With `--mesh N` (N > 1) there the group runs one run over a mesh of the
first N processes' devices, one each: process 0's seed, process 0 writes
the files, every process prints the run's pulse profile.  With `--mesh 0/1`
each process runs its own shard of events (its own --seed and --ftag), the
reference's fan-out, and the processes' pulse profiles are summed over the
group and printed.  Options the port does not run raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# The streaming window's width under --tree_window auto.  Every width gives
# the same events at one lane per event; on the H100 the host's per-iteration
# glue sets the pace, so the widest window ran fastest: queue path, 2048
# events, pipeline medians 0.591 s at 2048 against 1.134 s at 128 (the JAX
# value) at the default cutoffs, 0.672 against 1.283 s at 50/10/100
# (scripts/torch_tree_ab.py --window, NVIDIA H100 80GB HBM3, 700 W; PERF.md).
TREE_WINDOW = 2048

# Batches in flight under --pipeline_depth 0 (auto).  Depth 2 never beat
# depth 1 by more than the larger spread, and in the last call it fell
# behind by more: kernel path, 8192 events in batches of 2048, three warm
# runs each in turns, events/s medians 3890.5 (spread 126.4) at depth 1
# against 3867.2 (845.2) at depth 2, 4989.8 (1450.4) against 4649.4
# (1185.2) in another call, and 6291.9 (353.8) against 5869.4 (416.6) in a
# third, 422.5 behind (chip_smoke.py phase 18, NVIDIA H100 80GB HBM3, 700 W;
# PERF.md).  The pipeline's host code reads from the card ~31 times a batch
# at either depth, so depth 2 can hide only the last read-back and the row
# assembly.
PIPELINE_DEPTH = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="adiabatic_raytracer_tpu_torch",
                                description="PyTorch + CUDA adiabatic axion-photon ray tracer")
    p.add_argument("--ThetaM", type=float, default=0.0, help="misalignment angle in rad")
    p.add_argument("--Nts", type=int, default=100, help="number photon trajectories")
    p.add_argument("--ftag", type=str, default="", help="file tag")
    p.add_argument("--rotW", type=float, default=1.0, help="rotational freq NS in 1/s")
    p.add_argument("--MassA", type=float, default=1e-5, help="axion mass in eV")
    p.add_argument("--Axg", type=float, default=1e-12, help="coupling in 1/GeV")
    p.add_argument("--B0", type=float, default=1e14, help="surface magnetic field in G")
    p.add_argument("--run_RT", type=int, default=1, help="should we run ray tracer?")
    p.add_argument("--run_Combine", type=int, default=0, help="should we combine file runs")
    p.add_argument("--side_runs", type=int, default=0, help="how many runs do we combine?")
    p.add_argument("--combine_renumber", type=int, default=0)
    p.add_argument("--combine_allow_missing", type=int, default=0)
    p.add_argument("--rNS", type=float, default=10.0, help="radius NS in km")
    p.add_argument("--Mass_NS", type=float, default=1.0, help="Mass NS in solar masses")
    p.add_argument("--vNS_x", type=float, default=0.0, help="vel NS x in c")
    p.add_argument("--vNS_y", type=float, default=0.0, help="vel NS y in c")
    p.add_argument("--vNS_z", type=float, default=0.0, help="vel NS z in c")
    p.add_argument("--saveMode", type=int, default=0, choices=range(4),
                   help="0: essentials npy; 1: more npy; 2: + clear text; 3: + full tree")
    p.add_argument("--probCutoff", type=float, default=1e-10)
    p.add_argument("--numCutoff", type=int, default=5)
    p.add_argument("--MCNodes", type=int, default=5)
    p.add_argument("--maxNodes", type=int, default=50)
    p.add_argument("--seed", type=int, default=-1, help="RNG seed; -1 = random")
    p.add_argument("--bndry_lyr", type=float, default=-1.0,
                   help="boundary-layer power-law index; negative disables")
    p.add_argument("--dir_tag", type=str, default="results")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                   help="torch device; 'cuda' (the default) without a card raises")
    p.add_argument("--event_batch", type=int, default=0,
                   help="events per batch; 0 = auto (2048 on cuda, 16 on cpu)")
    p.add_argument("--tree_window", type=int, default=-1,
                   help="forward-tree streaming window (active events per "
                        "iteration; finished events refill from the batch); "
                        "-1 = auto (2048 when event_batch > 128 on any "
                        "device), 0 = off")
    p.add_argument("--tree_engine", choices=["auto", "queue", "kernel"], default="auto",
                   help="auto = kernel (K3, whole trees in one kernel) when engine is "
                        "mega, saveMode <= 1 and the scene is covered; else queue")
    p.add_argument("--tree_kernel_chunk", type=int, default=64,
                   help="K3 steps per event per launch before a staged relaunch; "
                        "0 = one launch runs every tree to its end")
    p.add_argument("--backtrace_chunk", type=int, default=0,
                   help="engine mega: K2's backtrace relaunched in chunks of this many "
                        "steps per ray with staged compaction (NumericsConfig."
                        "backtrace_chunk); 0 = one launch.  K2's other branches take the "
                        "reference's environment overrides MEGA_COND=canonical, "
                        "MEGA_GATE_TRIG=native, MEGA_RHS=vjp")
    p.add_argument("--scan_gate_check", type=int, default=-1,
                   help="events for the per-scene gated-scan census check; "
                        "-1 = config default (256), 0 disables")
    p.add_argument("--precision", choices=["f32", "f64"], default="f64",
                   help="integration-state dtype of every tensor (the JAX CLI's x64 "
                        "off / on); K2-K4 compute in f64 inside at either")
    p.add_argument("--computeDtype", choices=["auto", "state", "f32"], default="auto",
                   help="physics-evaluation dtype; auto = f32 on cuda, the state's on cpu")
    p.add_argument("--engine", choices=["auto", "pool", "pool_compact", "mega"],
                   default="auto",
                   help="auto = mega (K2) on cuda, pool on cpu; pool_compact = pool with "
                        "the backtrace in chunks, compacting the rays still running")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard each batch over an N-device mesh (0/1 = one device): the "
                        "first N cards on cuda (fewer raises), N virtual shards on cpu; "
                        "with --coordinator, one device of each of the first N processes")
    p.add_argument("--pipeline_depth", type=int, default=0,
                   help="batches issued but not yet assembled; 0 = auto "
                        "(PIPELINE_DEPTH); rows are bitwise equal across depths")
    p.add_argument("--checkpoint", action="store_true",
                   help="write a per-batch resume state (RNG key + event "
                        "counter + partial rows) next to the output npy")
    p.add_argument("--resume", action="store_true",
                   help="resume a killed run from its checkpoint")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: the group's address host:port "
                        "(torch.distributed over gloo; the reference's SLURM "
                        "fan-out, runner_GR_tasks.sh)")
    p.add_argument("--nprocs", type=int, default=None,
                   help="multi-process: total number of processes")
    p.add_argument("--procid", type=int, default=None,
                   help="multi-process: this process's index")
    return p


def main(argv=None) -> int:
    run_from_args(argv)
    return 0


def run_from_args(argv=None):
    """Parse the flags and run; returns driver.run's (rows, path, stats), or
    None when the ray tracer is not run."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.driver import check_ported, run
    from adiabatic_raytracer_tpu_torch.parallel import mesh
    from adiabatic_raytracer_tpu_torch.utils.npyio import combine_files

    on_cuda = args.device == "cuda"
    sc = Scene(mass_a=args.MassA, ax_g=args.Axg, theta_m=args.ThetaM,
               omega_pul=args.rotW, b0=args.B0, r_ns=args.rNS, mass_ns=args.Mass_NS,
               bndry_lyr=args.bndry_lyr, rho_dm=0.45,
               v_ns=(args.vNS_x, args.vNS_y, args.vNS_z),
               flat=False, isotropic=False, melrose=True)
    compute_dtype = (("f32" if on_cuda else "state") if args.computeDtype == "auto"
                     else args.computeDtype)
    engine = ("mega" if on_cuda else "pool") if args.engine == "auto" else args.engine
    event_batch = args.event_batch if args.event_batch > 0 else (2048 if on_cuda else 16)
    # auto: the JAX CLI's rule (JAX cli.py:161-171); every width gives the
    # same events at one lane per event, so the width is a schedule choice
    tree_window = args.tree_window if args.tree_window >= 0 else (
        TREE_WINDOW if event_batch > 128 else 0)
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype=compute_dtype,
                         engine=engine, tree_window=tree_window,
                         tree_engine=args.tree_engine, tree_kernel_chunk=args.tree_kernel_chunk,
                         backtrace_chunk=args.backtrace_chunk,
                         **({"scan_gate_check": args.scan_gate_check}
                            if args.scan_gate_check >= 0 else {}))
    if args.tree_engine == "auto":
        from adiabatic_raytracer_tpu_torch.ops.tree import kernel_covers

        kernel = args.saveMode <= 1 and kernel_covers(sc, cfg)
        cfg = dataclasses.replace(cfg, tree_engine="kernel" if kernel else "queue")
        print(f"tree_engine auto -> {cfg.tree_engine}")
    tcfg = TreeConfig(prob_cutoff=args.probCutoff, num_cutoff=args.numCutoff,
                      mc_nodes=args.MCNodes, max_nodes=args.maxNodes)
    depth = args.pipeline_depth if args.pipeline_depth > 0 else PIPELINE_DEPTH
    check_ported(cfg, save_mode=args.saveMode, mesh_devices=args.mesh, pipeline_depth=depth,
                 checkpoint=args.checkpoint, resume=args.resume, processes=args.nprocs or 1)

    device = args.device
    had_group = mesh.process_group_exists()
    # a mesh over the group waits on the other processes at every batch:
    # bound each wait, so that a failed process ends the run
    grouped = mesh.init_distributed(args.coordinator, args.nprocs, args.procid,
                                    timeout_s=mesh.GROUP_TIMEOUT_S if args.mesh > 1 else None)
    over_group = grouped and args.mesh > 1
    try:
        if grouped:
            if on_cuda and torch.cuda.device_count():
                device = mesh.process_device("cuda")
                torch.cuda.set_device(device)
            print(f"distributed: process {mesh.process_index()}/{mesh.process_count()} "
                  f"on {device}" + (f", in a mesh of {args.mesh} over the group"
                                    if over_group else ""))
        print(f"Axion parameters: {args.MassA}\n{args.Axg}")
        t0 = time.time()
        out = None
        if args.run_RT == 1:
            if not over_group or mesh.process_index() == 0:   # the process that writes
                for sub in ("npy", "event", "tree"):
                    os.makedirs(os.path.join(args.dir_tag, sub), exist_ok=True)
            out = run(sc, cfg, tcfg, args.Nts, seed=args.seed, save_mode=args.saveMode,
                      file_tag=args.ftag, dir_tag=args.dir_tag, event_batch=event_batch,
                      mesh_devices=args.mesh, checkpoint=args.checkpoint,
                      resume=args.resume, profile_dir=args.profile_dir,
                      pipeline_depth=depth, device=device, precision=args.precision)
            if mesh.process_count() > 1:
                from adiabatic_raytracer_tpu_torch.parallel.reduce import pulse_profile_from_rows

                rows = out[0] if out is not None else np.zeros((0,))
                if over_group:
                    # every process holds the whole run's rows: summed over the
                    # group they would count P times
                    h_ph, h_ax = pulse_profile_from_rows(rows)
                    print("pulse profile of the run over the group: " + json.dumps(
                        {"processes": mesh.process_count(), "mesh": args.mesh,
                         "photon": h_ph.tolist(), "axion": h_ax.tolist()}))
                else:
                    # each process ran its own shard: sum the pulse profiles over the group
                    h_ph, h_ax = mesh.all_reduce_sum(*pulse_profile_from_rows(rows))
                    print("pulse profile summed over processes: " + json.dumps(
                        {"processes": mesh.process_count(), "photon": h_ph.tolist(),
                         "axion": h_ax.tolist()}))
        if args.run_Combine == 1:
            combined = combine_files(args.dir_tag, args.MassA, args.Axg, args.ThetaM,
                                     args.rotW, args.B0, args.Nts, 3, args.numCutoff,
                                     args.MCNodes, args.maxNodes, args.ftag, args.side_runs,
                                     renumber_events=bool(args.combine_renumber),
                                     allow_missing=bool(args.combine_allow_missing))
            print(f"combined -> {combined}")
    finally:
        if grouped and not had_group:
            mesh.leave_group()
    print(f"\ntime diff: {time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    sys.exit(main())
