"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the hand-written kernels (adiabatic_raytracer_tpu_torch/csrc/) from
this checkout, checks each against its plain PyTorch version on the card at
the shapes the main path gives it, then drives the port's main path through
its CLI entry point at the production default scene, and at a boundary-layer
and an isotropic scene, its saveMode 3 text and tree dumps, checkpoint and
resume, the forward tree's streaming window, pipeline depth 2, two processes
in one group, the mesh (in one process and over a group of processes),
engine pool_compact, the diagnostics and
analysis, --precision f32 / --computeDtype, and the in-kernel MC chain on
the queue tree (mc_chain), and checks the output.

    python3 chip_smoke.py            # needs one CUDA device

Phases (each prints one line of findings; any failure raises and exits
non-zero):
  1. device: torch.cuda must be available; nvidia-smi name and power limit
  2. build:  nvcc the kernel library, one process per source, all started
     together: K1 (its grid and fused kernels), K2-K4 and P1 (registers /
     spills from ptxas); K2's ptxas figures must equal K2_PTXAS, K3's and
     K4's are printed beside theirs before K2 shared their warp step
  3. K1 on a sampler chunk (16384 lines x the production grid): the grid
     kernel vs its plain version, g to f32 rounding; the fused kernel
     (line_roots: scan, 50-step bisection and filter in one launch) vs the
     torch route on the grid kernel's output, at f32 and f64: flip counts
     and first-16 intervals identical on every line, ok on all but 1 in
     1000, s* within the root bar (ROOT_BAR 2e-3 km in f32, ROOT_BAR_F64
     1e-8 km in f64); sample_batch through it vs the plain scan, same key, at f32 and
     f64: lines whose success or crossing count differs (f32 near-tangent
     root pairs, a root on the filter's threshold) at most 1 in 1000,
     sampled roots on the others within 2e-3 km, and within 1e-8 km at f64
     on the lines whose f32 and f64 scans give the same intervals (at f64,
     and at 13a, a line whose grid sign changes differ leaves the root bar
     only with an f64 witness); the kernels' times and bounds, the fused
     scan alone; one sample_batch call through the fused kernel vs the
     route before it (host clock, eager aten ops, device kernels,
     launches). The phase reports every failed check before it fails
  4. device functions of K2/K3 (probe) vs their torch twins, f64, rtol 1e-12
  5. K2 vs integrate_mega_plain on a 2048-event production backtrace; the
     slowest ray's steps, dense passes, bisected roots (plain version) and
     microseconds per step, the warps launched and resident
  6. K3 vs tree_kernel_launch_plain on 512 production events (one launch,
     default cutoffs): counters identical on >= 99% of events; on those, the
     steps, photon steps, accepted steps, dense passes and recorded
     crossings identical on >= 99% of those, orders identical, and the
     per-record relative error of their finals (compare_records) has median
     < 1e-8, p99 < 1e-6 and worst < 1e-5; then K3 on 2048 events
     (tree_kernel_chunk 0 and 64) against the host engine at tree_k=1 on K2,
     counters on >= 99%, and chunk 64's counters and finals against one
     launch's at the same bars; K3's time per step of the slowest tree.
     Phases 6, 10 and 11 log the five worst finals records of each
     comparison with where they stand (record_notes): end state, birth
     time, order, species, and the birth state found by integrating back,
     with the condition and its rate along the ray there
  7. the kernel path: cli with --device cuda --event_batch 2048 --Nts 4097
     --saveMode 1 (two full batches; --tree_engine auto -> kernel), cold in a
     fresh process, then warm under torch.profiler in this one, launch
     counters reset just before it;
     K1's fused kernel, K2 and K3 must each have launched, K1's grid kernel
     not (so in phases 8, 12, 13e and 13f); phases 7, 8 and 12 print the
     device time and launches of mega_kernel, tree_kernel and
     tree_refill_kernel from the profiler
  8. the queue path (--tree_engine queue, the auto window: 128 events at one
     lane each), one batch of 2048, counters reset just before it; K1 and K2
     must have launched
  9. P1 vs refill_probe_plain at the probe's shapes (512 events, 128 lanes):
     ids and steps identical, the probe's own checks, every event written
     once and flushed at a refill boundary or the loop's end, and its entry
     point (refill_probe.main) with the counters reset just before it
 10. K4 at the refill path's partitions against the plain output of phase
     6 on its 512 events (K4's plain version gives K3's plain version's
     output bit for bit, tests/test_torch_treekernel.py), in two partitions
     of 256, each served by 32 warps (eight events a warp): phase 6's bars,
     and some events must start after another ended
 11. K4 against K3 (one launch) on 2048 events at tree_refill 128 and 1,
     at the default cutoffs and at the reference's production cutoffs
     (num_cutoff 50, mc_nodes 10, max_nodes 100): phase 6's bars, whether
     bitwise; host-clock times and launches of K3 one launch, K3 chunk 64,
     K4 at 128 and K4 at 1 (K4 with its default, card-filling warps); the
     device times of K3 one launch and K4 at 1 on the same events, K4 / K3
 12. the refill path: driver.run with engine mega, tree_engine kernel,
     tree_refill 1, 2 x 2048 events, saveMode 1, warm under torch.profiler,
     counters reset just before it; K1, K2 and K4 must have launched, K3 not
 13. the boundary-layer and isotropic path (K2's other dispersion variants,
     the boundary layer in K1): (a) phase 3 at bndry_lyr 0.5; (b) phase 4's
     condition and RHS, photon, axion and mixed, at bndry_lyr 0.5 and at an
     isotropic scene; (c) K2 vs integrate_mega_plain at bndry_lyr 0.5 on a
     backtrace (axion, B flipped, 16 slots) and on a queue-path tree
     iteration (photon and axion mixed, one slot), 512 rays each (the plain
     version on the CPU, in plain_pool's processes while the card runs the
     rest), dense and gated, at phase 5's bars, with the slowest ray's
     steps and microseconds per step; (d) the mixed launch at the
     isotropic scene; (e) the CLI at --bndry_lyr 0.5, 2 x 2048 events
     (--tree_engine auto -> queue), warm under torch.profiler, counters
     reset just before it: K1 and K2 must launch, K3 not; events/s, the
     census verdict, mega_kernel's device time; (f) driver.run at the
     isotropic scene with the CLI's auto window, one batch of 2048, the same
     checks
 15. saveMode 3 through the CLI, one batch of 2048 (auto: the queue path
     and the window), warm, counters reset just before it: every text file
     parses (analysis/treeio.py), one tree_ file per event, final_ lines
     equal to the npy rows in the columns they share, event_ lines with
     every event and its node count, every tree's outgoing weight in (0, 1 +
     1e-9] and >= 1 - prob_cutoff - 1e-9 where prob_cutoff stopped it; rows
     bitwise phase 8's; K1 and K2 launched, K3 not; events/s, t_text, tree
     iterations, K2 launches
 16. checkpoint/resume on the kernel path (driver.run, K3 at chunk 64): 2 x
     1024 events uninterrupted against one batch, stopped with a checkpoint,
     then resumed; rows bitwise, the checkpoint cleared, K1, K2 and K3
     launched
 17. the window's contract: driver.run on the queue path, 2048 events,
     tree_k 4, window 128 against 0: rows bitwise
 18. pipeline depth 2: driver.run on the kernel path, 8192 events in
     batches of 2048, warm, depth 1 and 2 in turns (three runs each): rows
     bitwise across all six, medians and spreads of events/s and the stage
     times, the host reads per batch at each depth
     (torch.cuda.set_sync_debug_mode), a depth-2 run stopped after two
     batches and resumed bitwise
 19. two fresh CLI processes in one gloo group on the one card
     (--coordinator, 1024 events each, seeds 1769 + p): each shard bitwise
     the one-process shard, the --run_Combine outputs byte-identical, the
     pulse profile summed over the group equal to the one-process sum;
     each process's wall and stage times (a cold start)
 20. the mesh: two fresh CLI processes in one gloo group on the one card
     at --mesh 2 (one run over the group, phase 7's flags and the card
     defaults): process 0's rows against phase 7's at the mesh bar (event,
     species, node count, stop code and c_bck bitwise, the rest within
     1e-9 relative), process 1 writes no file, both print the rows' pulse
     profile and run the kernel path (K1 on process 0, which samples; K2
     and K3 on both), each process's wall, stage times and cold start;
     --mesh 2 against --mesh 1 where two cards exist; on one card --mesh 2
     without a group must raise naming cuda:1 and --mesh 1 give phase 7's
     rows bitwise; --profile_dir on a 256-event run, its trace holding
     kernels
 21. engine pool_compact: CompactedPropagator against propagate on 8
     photons of JAX's streaming-test input, compacting 8 -> 4 -> 2 (counts
     exact, traj and xc within 1e-12); then driver.run with engine pool and
     pool_compact (eager torch on the card: 2 events, a one-node tree):
     species and stop codes exact, the rest within rtol 1e-3
 22. the geometry diagnostics and tau_cyc / dwdt_vec on 4096 f64 states on
     the card against the CPU (1e-12 of each one's largest value), and
     flux.analyze on phase 7's rows (histogram totals = sum of weight *
     sln_prob per species)
 23. the precision path on the kernel path (driver.run, 2048 events, warm,
     twice each in turns): (a) the CLI's card defaults (compute f32, f64
     state), (b) compute_dtype "state", (c) precision "f32": events/s, the
     K1-K3 launches, K1's <float> instantiation under (a) and (c) (<double>
     under (b)); the same 2048 f32-sampled events through driver.pipeline,
     (a) and (c) against (b) per event, at tests/test_precision.py's bars:
     counters (the tree's count and info, the backtrace's crossings)
     identical on >= 99% of events and the final weights' relative error
     median < 5e-5; species and order exact where the counters match, for
     (c) on the events that drew no MC uniform (an f32 state draws f32
     uniforms, other bits than the f64 state's); max < 1e-3 on the events
     well-conditioned at f32 precision (PROBES = 8 f64 probes on inputs
     perturbed by 2^-23 move no counter, species or weight by more than
     ILL_REL = 1e-4); the ill-conditioned share at most ILL_SHARE = 0.2, and
     each ill-conditioned event (for (c): that drew no MC uniform) with the
     topology of (b) or of a probe and its weights within ILL_K = 10 times
     its probe spread of the nearest such f64 run; the worst events logged;
     (c) stopped after one batch of 1024 and resumed, rows bitwise
 24. r_NS below 10 km, where K2-K4's photon side takes the metric's
     interior branch (scene A: --rNS 9; scene B: --rNS 9 --MassA 3e-5, the
     conversion surface at 9-11 km): (a) K1 at scene B on 4096 lines at
     phase 3's bars and the share of its roots below 10 km; the probe
     (condition, RHS, prob_nd) at scene B's conversion points; (b) K2 mixed
     and backtrace at both scenes, 512 rays, at phase 13c's bars with the
     census verdict, the endpoint error split by start radius (below or
     above 10 km) and, at scene B's backtrace, a witness of the endpoints'
     own sensitivity: the plain version on inputs moved by one ulp;
     (c) on 512 events at scene B (compute "state"): K3 in one launch
     against its plain version and K4 against K3 at phase 6's bars, then
     K3's tree engine against the host engine at tree_k=1: counters on
     >= 99%, every column's median < 1e-8, weight, probabilities, birth
     time and energy at phase 6's p99 and worst bars, the final position
     and momentum's p99 and worst logged with a witness (the host engine
     at rtol 1e-10 on the worst records' events); the plain versions of
     (b) and (c) run in plain_pool while (a) runs; (d) the CLI at both
     scenes, 4096 events, on the kernel path, then driver.run with
     tree_refill 1, and at scene A the queue path (2048 events), warm under
     torch.profiler: events/s, the device busy share, the launches, and
     the photon steps and crossings the kernels ran below 10 km
     (zone_counts, whose few reductions per launch run inside the timed
     run); the kernel and refill paths must show both; the rows check
     lets a weight be 0 at scene B where the survival weight is 0
 25. the in-kernel MC chain (mc_chain, K2's chain instantiation
     mega_chain_kernel; phase_chain): (a) K2's chain against its plain
     version (plain_pool, four chunks) on 256 chain lanes of a production
     queue tree's MC tail (chain_capture, cutoffs 50/10/100, gate 0, two
     batches of 2048), each at cap 8
     with its own uniforms, dense scan: restarts, codes, crossing counts
     and final species identical on >= 99% of the lanes, on those the
     endpoints' and crossing states' median relative error < 1e-8 and the
     pcx over rtol 1e-8 on at most 1% of the slots, the gated kernel's
     counts on >= 99%; its time, bound (FLOP_* with FLOP_PROB per crossing
     and FLOP_BIRTH plus an axion RHS per restart) and work; (b) driver.run
     on the queue path (the CLI's auto window), 2048 events, at the default
     and the production cutoffs, mc_chain 0 and 1 (gate 4) in turns, two
     runs each, counters reset just before each: the chained rows against
     the unchained at phase 6's bars (events agreeing in rows, species,
     node count and stop code >= 99%, per-record median < 1e-8, p99 <
     1e-6, worst < 1e-5), the chain instantiation launched in every
     chained run and in no other; tree iterations, K2 launches and
     events/s with their spread; (c) saveMode 3 with mc_chain 1, one batch
     (dumps under build/chip_smoke_chain3/): the chain instantiation
     launched, K3 not, a tree file per event
 14. the kernels' JSON line: each kernel's launches on its path (K1's
     grid kernel, a check only, 0 on the main path; P1's through its entry
     point), and its time,
     plain time, error and bound from its comparison with its plain version
     (phases 3, 5, 6, 9, 10 and 25a, each on one input; K4's plain time is phase
     6's plain run, whose output K4 is held against, and its row says so in
     "plain_of"); the nvidia-smi line, the
     result line.  Every phase logs its wall time.

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) over 3.35
TB/s and its operations over the peak rate of their type (67 TFLOP/s f32,
34 TFLOP/s f64, both outside the tensor cores; NVIDIA H100 SXM data sheet).
Operations are counted from the sources (FLOP_* below: + - * / sqrt and
each transcendental as one) times the work this run's data needed: K1's
fused kernel the scan's points and 51 condition evaluations per bisected
root (the bisection's 50 and the filter), K2's
steps, dense passes and crossings from its diagnostics (its chain
instantiation also its restarts), K3's per-event work
counters (photon and axion steps, accepted steps, dense passes, bisected
roots, recorded crossings), the same for K4.

Writes its npy output, the build log and the profiler table under
chiprun_out/chip_smoke/.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SCENE_ARGS = ["--MassA", "1e-5", "--B0", "1e14", "--ThetaM", "0.2"]
# phase_slice's runs by phase: wall times (s) and the warm run's RunStats
SLICE_RUNS = {}

# K1's root bars, km: f32 bisections on two routes differ by the f32
# condition's rounding near the root (readings up to 1.5e-4 km); two f64
# bisections of one interval by the f64 rounding (up to 1.3e-12 km)
ROOT_BAR = 2e-3
ROOT_BAR_F64 = 1e-8

HBM_BYTES_PER_S = 3.35e12
F32_PER_S = 67e12
F64_PER_S = 34e12
# operations per evaluation, counted from csrc/ (see the module docstring)
FLOP_LINE_POINT = 130      # K1: one grid point of line_condition, f32
FLOP_RHS = {"photon": 290, "axion": 90}   # rhs + grad_h_hand, f64
FLOP_COND = 70             # art::condition
FLOP_HERMITE = 71          # one interpolant point, 7 components
FLOP_STEP_FIXED = 520      # stage sums, 5th-order update, error norm, controller
FLOP_PROB = 250            # prob_nd at a recorded crossing
# K2's chain restart (phase 25): child_birth, the rare guard, the initial
# step, the start point and the condition at the birth state (its RHS is
# counted apart, at the axion's cost)
FLOP_BIRTH = 210


def flop_step(species):
    """Every attempted DP5 step: 6 new RHS (FSAL), the condition at the new
    point."""
    return 6 * FLOP_RHS[species] + FLOP_STEP_FIXED + FLOP_COND


def flop_gate(interp_coarse):
    """The coarse gate's interior points, on every accepted step."""
    return max(interp_coarse - 1, 0) * (FLOP_HERMITE + FLOP_COND)


def flop_dense(interp):
    return (interp - 1) * (FLOP_HERMITE + FLOP_COND)


def flop_bisect(bisect):
    return (bisect + 1) * (FLOP_HERMITE + FLOP_COND)


# a K3 final record's columns compared between two runs: weight, prob,
# pconv, pconv0, t_birth, u_end (r, theta, phi, w_r, w_theta, w_phi, e7)
REC_NAMES = ("w", "prob", "pconv", "pconv0", "t_birth", "r", "theta", "phi", "w_r", "w_th",
             "w_ph", "e7")
# bars on the per-record relative error (phase 6).  K3 and its plain
# version take the same steps (the work counters below must agree), so their
# records differ by the device functions' rounding (~1e-15, phase 4) carried
# along the trajectory: ~1e-11 for most records, but a few rays amplify it to
# ~1e-6 (the theta momentum after a near-resonant birth; a probability at a
# near-tangent root, as K2's pcx in phase 5) -- K3 against itself, where a
# relaunch only recomputes f0 and g0, shows the same amplification.  The
# bars sit above that and far below the O(1e-3..1) gap of a wrong record.
REC_P99 = 1e-6
REC_WORST = 1e-5


def birth_states(P, u_end, lnt_end, lnt_b, erg, is_ph):
    """The states [n, 7] at log times lnt_b of the rays whose states at
    lnt_end are u_end: the pool engine run backwards in log time (s =
    -lnt) on the kernels' RHS twin (_rhs), rtol 1e-9, no event scan."""
    import torch

    from adiabatic_raytracer_tpu_torch.config import NumericsConfig
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops.integrator import integrate_pool

    n = u_end.shape[0]
    comp = lambda u: tuple(u[:, c] for c in range(7))
    rhs = lambda u, s, a: -torch.stack(mk._rhs(P, comp(u), -s, a["erg"], a["is_ph"]), dim=1)
    res = integrate_pool(rhs, lambda u, s: mk._condition(P, comp(u), -s), u_end, -lnt_end,
                         -lnt_b, {"erg": erg, "is_ph": is_ph},
                         NumericsConfig(rtol=1e-9, atol=1e-11), save_lnt=-lnt_end[:, None],
                         kill_at_surface=torch.zeros(n, dtype=torch.bool), r_ns=P.r_ns,
                         x0_cart=torch.zeros((n, 3), dtype=u_end.dtype),
                         max_crossings=torch.ones(n, dtype=torch.int64), detect_events=False)
    return res.u


def record_notes(fin, aux, ev, sl, scene=None):
    """Where each final record (fin [E, NF, 16] at events ev, slots sl; aux
    the run's [E, 32] rows) stands, as text: r, theta and |w| of its state
    columns (F_U0..: the state at the event's end time, where the record
    ends), its birth time t_b (F_TB), order and species; then its birth
    state, from the end state integrated back to log(t_b) (birth_states;
    records that ended inside 1.01 r_NS are skipped), with the condition g
    there (~0 for a node born at a crossing) and its rate along the ray
    dg/dlnt from the torch twins _rhs and _condition at lnt +- 1e-6.  A
    small rate marks a near-tangent, near-resonant birth."""
    import math

    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    sc, cfg, *_ = scene_setup(torch.device("cpu"), **(scene or {}))
    P = tk.kernel_params(sc, cfg)
    rec = fin[ev, sl].double().cpu()
    u_end = rec[:, tk.F_U0:tk.F_U0 + 7]
    lnt_end = aux[ev, tk.A_LNT1].double().cpu()
    erg = aux[ev, tk.A_ERG].double().cpu()
    is_ph = rec[:, tk.F_ISPH]
    lnt_b = torch.log(rec[:, tk.F_TB].clamp(min=math.exp(float(cfg.ln_t_start))))
    out = rec[:, tk.F_U0] > P.r_ns * 1.01
    u_b = torch.full_like(u_end, math.nan)
    if bool(out.any()):
        u_b[out] = birth_states(P, u_end[out], lnt_end[out], lnt_b[out], erg[out], is_ph[out])
    u = tuple(u_b[:, c] for c in range(7))
    f = mk._rhs(P, u, lnt_b, erg, is_ph)
    d = 1e-6
    g_at = lambda s: mk._condition(P, tuple(a + s * d * b for a, b in zip(u, f)), lnt_b + s * d)
    rate = (g_at(1.0) - g_at(-1.0)) / (2.0 * d)
    g_b = mk._condition(P, u, lnt_b)
    wn = u_end[:, 3:6].norm(dim=1)
    return [f"end r {u_end[i, 0].item():.6g} km theta {u_end[i, 1].item():.6g} |w| "
            f"{wn[i].item():.4g}; born t_b {rec[i, tk.F_TB].item():.6g} order "
            f"{int(rec[i, tk.F_ORD].item())} {'photon' if is_ph[i] > 0.5 else 'axion'} at r "
            f"{u_b[i, 0].item():.8g} km theta {u_b[i, 1].item():.8g}, g {g_b[i].item():.3g} "
            f"dg/dlnt {rate[i].item():.3g}" for i in range(rec.shape[0])]


def compare_records(fa, fb, slots, tag, phase=6, aux=None, scene=None):
    """Relative error of each K3 final record of fa against fb ([E, NF, 16]
    fin blocks) on `slots`, the worst over its REC_NAMES columns: each
    column relative to its own size, the angles relative to max(|value|,
    1 rad), the momentum components relative to the record's |w| (a
    component can pass through zero).  Logs the worst five records, with
    record_notes where aux (fa's [E, 32] rows) is given; returns (median,
    p99, worst)."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    cols = [tk.F_W, tk.F_PROB, tk.F_PCONV, tk.F_PCONV0, tk.F_TB] + list(range(tk.F_U0, 16))
    x, y = fa[slots][:, cols], fb[slots][:, cols]
    if x.shape[0] == 0:
        return 0.0, 0.0, 0.0
    scale = y.abs()
    scale[:, 6:8] = scale[:, 6:8].clamp(min=1.0)
    scale[:, 8:11] = y[:, 8:11].norm(dim=1, keepdim=True)
    rel, col = ((x - y).abs() / scale.clamp(min=1e-300)).max(dim=1)
    ev, sl = slots.nonzero(as_tuple=True)
    worst5 = [j for j in torch.argsort(rel, descending=True)[:5].tolist() if rel[j] > 0]
    notes = (record_notes(fa, aux, ev[worst5], sl[worst5], scene) if aux is not None and worst5
             else [""] * len(worst5))
    for j, note in zip(worst5, notes):
        c = int(col[j])
        log(phase, f"  {tag} worst record: event {int(ev[j])} slot {int(sl[j])} order "
               f"{int(fa[ev[j], sl[j], tk.F_ORD])} column {REC_NAMES[c]}: {x[j, c].item():.12g} "
               f"vs {y[j, c].item():.12g} (rel {rel[j].item():.2g})"
               + (f"; {note}" if note else ""))
    q = torch.quantile(rel, torch.tensor([0.5, 0.99], dtype=rel.dtype, device=rel.device))
    return q[0].item(), q[1].item(), rel.max().item()


def bound(nbytes, nflop, rate):
    """(bound_ms, bound_by) of work moving nbytes and doing nflop at rate."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nflop / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# The plain versions of K2 and K3 behind phases 13c-d and 24b-c run in a pool
# of CPU processes while this process runs the kernels on the card: they are
# eager torch, set by per-op host overhead (a DP5 step of a 512-ray batch
# took ~80 ms on one CPU thread, ~200 ms on the card), and four run at once.
PLAIN_WORKERS = 4
_PLAIN_POOL = []


def plain_pool():
    """The pool (spawned processes, one torch thread each), started at its
    first use; close_plain_pool stops it."""
    if not _PLAIN_POOL:
        import concurrent.futures
        import multiprocessing

        _PLAIN_POOL.append(concurrent.futures.ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_plain_worker_init))
    return _PLAIN_POOL[0]


def close_plain_pool():
    """Stops plain_pool's processes: queued jobs are dropped, running ones
    waited for."""
    while _PLAIN_POOL:
        _PLAIN_POOL.pop().shutdown(wait=True, cancel_futures=True)


def _plain_worker_init():
    import torch

    torch.set_num_threads(1)


def _plain_job(blob):
    """In a plain_pool process: K2's (kind "k2") or K3's ("k3") plain version
    on the pickled CPU inputs; returns the pickled (outputs, seconds)."""
    import pickle

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    kind, args, kwargs = pickle.loads(blob)
    fn = {"k2": mk.integrate_mega_plain, "k3": tk.tree_kernel_launch_plain}[kind]
    t0 = time.time()
    out = fn(*args, **kwargs)
    return pickle.dumps((out, time.time() - t0))


def submit_plain(kind, *args, **kwargs):
    """A future of the plain version `kind` on CPU copies of the inputs (sent
    as bytes: plain pickling, no shared memory)."""
    import pickle

    import torch

    cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    blob = pickle.dumps((kind, tuple(cpu(a) for a in args),
                         {n: cpu(v) for n, v in kwargs.items()}))
    return plain_pool().submit(_plain_job, blob)


def plain_result(fut, device):
    """(outputs on `device`, seconds) of a submit_plain future."""
    import pickle

    import torch

    out, sec = pickle.loads(fut.result())
    return tuple(o.to(device) if isinstance(o, torch.Tensor) else o for o in out), sec


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA device")
    smi = smi_line()
    log(1, f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
           f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


# (registers, stack, spill stores, spill loads) from ptxas.  K2's are
# checked: K2 must not change when the step does without a reason.  They
# were (255, 480, 88, 56) when K2 became one warp per ray on the step K3 and
# K4 run; since the photon hand adjoint gained its instantiation on the
# metric's interior branch (grad_h_photon<V, true>, r_NS < 10 km) they are
# these (NVIDIA H100 80GB HBM3 machine, CUDA 12.8), the exterior arithmetic
# bitwise the old (scripts/torch_tree_ab.py --parent).  K3's and K4's before
# K2 joined the warp step are printed beside their own.
K2_PTXAS = (255, 496, 128, 72)
TREE_PTXAS_BEFORE = {"tree_kernel": (255, 568, 188, 184),
                     "tree_refill_kernel": (255, 560, 184, 192)}


def phase_build():
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.lib()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "build_log.txt"), "w") as f:
        f.write(cuda_lib.BUILD_LOG)
    summary = ptxas_summary(cuda_lib.BUILD_LOG)
    log(2, f"built {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s; ptxas: "
           + " | ".join(f"{k}: {v}" for k, v in summary.items()))
    if not summary:
        log(2, "the library was built before this run: no ptxas figures to check")
        return
    for name, before in TREE_PTXAS_BEFORE.items():
        log(2, f"{name} registers, stack, spill stores/loads {ptxas_figures(summary.get(name, ''))}"
               f"; before K2 shared the warp step {before}")
    k2 = ptxas_figures(summary.get("mega_kernel", ""))
    log(2, f"mega_kernel registers, stack, spill stores/loads {k2}; expected {K2_PTXAS}; "
           f"same {k2 == K2_PTXAS}; its other dispersion variants: "
           + ", ".join(f"<{v}> {ptxas_figures(summary.get(f'mega_kernel<{v}>', ''))}"
                       for v in (1, 2, 3))
           + f"; its chain instantiation mega_chain_kernel "
             f"{ptxas_figures(summary.get('mega_chain_kernel', ''))}")
    if k2 != K2_PTXAS:
        raise AssertionError(f"K2's ptxas figures changed: {k2}, expected {K2_PTXAS}")


def ptxas_figures(text):
    """(registers, stack, spill stores, spill loads) in a ptxas_summary
    entry, None where absent."""
    grab = lambda pat: int(m.group(1)) if (m := re.search(pat, text)) else None
    return (grab(r"Used (\d+) registers"), grab(r"(\d+) bytes stack frame"),
            grab(r"(\d+) bytes spill stores"), grab(r"(\d+) bytes spill loads"))


KERNEL_NAMES = ("line_scan_kernel", "line_roots_kernel", "mega_kernel", "mega_chain_kernel",
                "probe_kernel", "tree_kernel", "tree_refill_kernel", "refill_probe_kernel")


def source_names(symbol):
    """The names in a symbol: the length-prefixed source names of an
    Itanium-mangled _Z... symbol, else the symbol itself."""
    if not symbol.startswith("_Z"):
        return {symbol}
    names, i = set(), 2
    while i < len(symbol):
        m = re.match(r"[1-9][0-9]*", symbol[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        names.add(symbol[j:j + int(m.group())])
        i = j + int(m.group())
    return names


def ptxas_summary(build_log):
    """{kernel: 'stack/spill; registers'} from nvcc -Xptxas -v output; a
    kernel is matched by its whole name.  A kernel template's instantiation
    on an int V other than 0 (K2's dispersion variants, csrc/physics.cuh
    art::Disp; 0 is the production Melrose one) is keyed 'name<V>', one on
    float or double (K1's fused kernel) 'name<float>' or 'name<double>'."""
    out, name = {}, None
    for ln in build_log.splitlines():
        if "Function properties for" in ln:
            symbol = ln.split("Function properties for", 1)[1].strip()
            name = next((k for k in KERNEL_NAMES if k in source_names(symbol)), None)
            if name:
                m = re.search(rf"{len(name)}{name}ILi(\d+)E", symbol)
                t = re.search(rf"{len(name)}{name}I([fd])E", symbol)
                if m and m.group(1) != "0":
                    name = f"{name}<{m.group(1)}>"
                elif t:
                    name = f"{name}<{'float' if t.group(1) == 'f' else 'double'}>"
                out[name] = ""
        elif name and ("registers" in ln or "spill" in ln):
            part = ln.split(":", 1)[-1].strip()
            out[name] = f"{out[name]}; {part}" if out[name] else part
    return out


def scene_setup(device, **scene):
    """The production default scene (with `scene`'s fields changed), its
    numerics and tree configs, maxR and the sampler's grid."""
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
    from adiabatic_raytracer_tpu_torch.ops import sampler

    sc = Scene(**{"mass_a": 1e-5, "theta_m": 0.2, "b0": 1e14, **scene})
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype="f32", engine="mega")
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    return sc, cfg, TreeConfig(), maxR, sampler.default_n_grid(maxR)


def phase_line_scan(device, n_lines, phase=3, **scene):
    """K1 on a sampler chunk of n_lines lines at the production scene (with
    `scene`'s fields changed): the grid kernel against its plain version;
    the fused kernel against the torch route on the grid kernel's output
    (line_roots_vs_grid) and sample_batch through it against the plain
    scan (sampling_check), each at both compute dtypes; their times and
    bounds.  Every check of the fused kernel runs before the phase fails,
    and the failure names each that failed.  Returns the JSON fields of both
    kernels: {"line_scan": ..., "line_roots": ...}."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device, **scene)
    key = rng.PRNGKey(20261016, device=device)
    geo = sampler._draw(rng.split(key, n_lines), maxR, sc, 220.0, True, torch.float32)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=device).to(torch.float32)
    args = (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid, sc, sc.mass_ns)
    g_k = line_scan.line_scan(*args)
    g_p = line_scan.line_scan_plain(*args)
    max_abs = torch.abs(g_k - g_p).max().item()
    # "agrees to f32 rounding": both f32 versions against the condition in
    # f64 on the same (f32-rounded) line parameters; the kernel's error must
    # not exceed the plain version's.  Near the poles (sin theta -> 0) and
    # deep inside the star both f32 evaluations are ill-conditioned, so the
    # bar is relative to the plain version, not a fixed number.
    par = line_scan.pack_params(*args[:4]).double()
    rel_k, rel_p = [], []
    for lo in range(0, n_lines, 2048):
        pp = par[lo:lo + 2048]
        p = pp[:, None, 0:3] + s_grid.double()[None, :, None] * pp[:, None, 3:6]
        g64 = sampler._line_condition(p, pp[:, None, 6:9], pp[:, None, 9], sc, sc.mass_ns)
        den = 1.0 + torch.abs(g64)
        rel_k.append((torch.abs(g_k[lo:lo + 2048].double() - g64) / den).flatten())
        rel_p.append((torch.abs(g_p[lo:lo + 2048].double() - g64) / den).flatten())
        del p, g64, den
    rel_k, rel_p = torch.cat(rel_k), torch.cat(rel_p)
    q = lambda t, x: torch.quantile(t[:: max(1, t.numel() // 4_000_000)], x).item()
    rel, rel_plain = rel_k.max().item(), rel_p.max().item()
    k999, p999 = q(rel_k, 0.999), q(rel_p, 0.999)
    away = torch.abs(g_p) > 1e-3
    sign_bad = int((torch.sign(g_k) != torch.sign(g_p))[away].sum())
    if not (rel <= 2.0 * rel_plain + 1e-6 and k999 <= 2.0 * p999 + 1e-7) or sign_bad:
        worst = (torch.argsort(rel_k, descending=True)[:5].tolist()
                 + torch.argsort(rel_p, descending=True)[:2].tolist())
        for i in worst:
            li, j = divmod(i, n_grid)
            pt = par[li, 0:3] + s_grid[j].double() * par[li, 3:6]
            g64 = sampler._line_condition(pt[None, None], par[li, None, None, 6:9],
                                          par[li, None, 9], sc, sc.mass_ns).item()
            rr = pt.norm().item()
            log(phase, f"  K1 grid worst point (kernel's 5, plain's 2): line {li} s "
                       f"{s_grid[j].item():.6g} r {rr:.6g} cos theta {pt[2].item() / rr:.6g}: "
                       f"f64 {g64:.9g}, kernel "
                       f"{g_k[li, j].item():.9g} (rel {rel_k[i].item():.3g}), plain "
                       f"{g_p[li, j].item():.9g} (rel {rel_p[i].item():.3g})")
        raise AssertionError(f"K1 disagrees: max rel err vs f64 {rel:.3g} (plain "
                             f"{rel_plain:.3g}), p99.9 {k999:.3g} (plain {p999:.3g}), "
                             f"sign flips away from roots {sign_bad}")
    del rel_k, rel_p
    # the fused kernel, at the compute dtypes of the card's CLI (f32) and of
    # driver.run's default (f64): the same key draws the same lines in each.
    # *_grid(sel): the lines sel's condition grid of the plain engine and in
    # f64 on the same lines
    roots, r_ms, fails = {}, {}, []
    for cd, dt in (("f32", torch.float32), ("state", torch.float64)):
        geo_t = sampler._draw(rng.split(key, n_lines), maxR, sc, 220.0, True, dt)
        s_t = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64, device=device).to(dt)
        roots[cd] = line_roots_vs_grid(geo_t, s_t, sc, phase, scene, fails)
        if cd == "f32":   # the plain engine's grid: line_scan_plain's on these lines
            plain_grid = lambda sel: g_p[sel]
            f64_grid = lambda sel: sampler._line_condition(
                par[sel, None, 0:3] + s_grid.double()[None, :, None] * par[sel, None, 3:6],
                par[sel, None, 6:9], par[sel, None, 9], sc, sc.mass_ns)
        else:             # the plain engine's grid is the f64 one
            plain_grid = f64_grid = (
                lambda sel, x0=geo_t.x0, v=geo_t.vvec, vl=geo_t.vvec_loc, e=geo_t.erg_inf,
                s=s_t: sampler._line_condition(x0[sel, None] + s[None, :, None] * v[sel, None],
                                               vl[sel, None], e[sel, None], sc, sc.mass_ns))
        sampling_check(key, n_lines, maxR, sc, tcfg, n_grid, cd, phase, scene, roots[cd],
                       plain_grid, f64_grid, fails)
        r_ms[cd] = cuda_ms(lambda: line_scan.line_roots(geo_t.x0, geo_t.vvec, geo_t.vvec_loc,
                                                        geo_t.erg_inf, s_t, sc, sc.mass_ns), 20)
        del geo_t
    if fails:
        raise AssertionError(f"K1{scene or ''} disagrees: " + "; ".join(fails))
    ms = cuda_ms(lambda: line_scan.line_scan(*args), 20)
    plain_ms = cuda_ms(lambda: line_scan.line_scan_plain(*args), 20)
    b_ms, b_by = bound(4 * (n_lines * 10 + n_grid + n_lines * n_grid),
                       FLOP_LINE_POINT * n_lines * n_grid, F32_PER_S)
    log(phase, f"K1 grid [{n_lines} x {n_grid}]{scene or ''} rel err vs f64: max {rel:.3g} (plain "
           f"f32 {rel_plain:.3g}), p99.9 {k999:.3g} (plain {p999:.3g}); kernel-plain max "
           f"abs {max_abs:.3g}, sign flips away from roots 0; kernel {ms:.3f} ms, plain "
           f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    scan_ms = cuda_ms(lambda: line_scan.line_roots_slots(*args, bisect_iters=0), 20)
    r_plain_ms = cuda_ms(lambda: line_scan.line_roots_plain(*args), 3)
    rb_ms, rb_by = roots_bound(n_lines, n_grid, roots["f32"]["bisected"], 4)
    rb64_ms, rb64_by = roots_bound(n_lines, n_grid, roots["state"]["bisected"], 8)
    log(phase, f"K1 fused [{n_lines} x {n_grid}]{scene or ''}: f32 {r_ms['f32']:.3f} ms (bound "
               f"{rb_ms:.4f} ms, {rb_by}; {roots['f32']['bisected']} roots bisected), f64 "
               f"bisection {r_ms['state']:.3f} ms (bound {rb64_ms:.4f} ms, {rb64_by}); its "
               f"scan alone (0 bisection steps) {scan_ms:.3f} ms; the grid kernel {ms:.3f} ms; "
               f"plain (f32 grid + _roots) {r_plain_ms:.3f} ms")
    return {"line_scan": {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
            "line_roots": {"max_abs_err": roots["f32"]["s_err"], "ms": r_ms["f32"],
                           "plain_ms": r_plain_ms, "bound_ms": rb_ms, "bound_by": rb_by,
                           "library_ms": None}}


def sample_batch_grid(key, batch, maxR, sc, n_grid, n_max, dtype):
    """sample_batch's kernel route before the fused kernel: the grid kernel's
    [batch, n_grid] condition, then the sampler's torch compaction,
    bisection and filter (_roots) and the draw (_pick)."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    geo = sampler._draw(rng.split(key, batch), maxR, sc, 220.0, True, dtype)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=key.device).to(dtype)
    lines = (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf)
    g = line_scan.line_scan(*lines, s_grid, sc, sc.mass_ns).to(dtype)
    s_star, ok, _ = sampler._roots(*lines, g, s_grid, sc, sc.mass_ns)
    return sampler._pick(geo, s_star, ok, sc, sc.mass_ns, n_max)


def eager_counts(fn):
    """(top-level aten ops, device kernels) of one fn() call under
    torch.profiler: aten ops not called by another op, and the events the
    card ran."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sum(1 for e in prof.events() if e.cpu_parent is None and e.name.startswith("aten::"))
    kernels = sum(1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() != DeviceType.CPU)
    return ops, kernels


def sample_route_costs(device, n_lines, phase=3):
    """One sample_batch call of n_lines lines at the production scene, f32
    (the card's CLI), through the fused kernel against the route before it
    (sample_batch_grid), same key: host-clock time with a synchronise (the
    median of 3 calls each, in turns old new new old old new), the top-level
    eager aten ops and device kernels of one call, and K1's launches.  The
    two must draw the same events: success identical, xpos within ROOT_BAR."""
    import statistics

    import torch

    from adiabatic_raytracer_tpu_torch.ops import cuda_lib, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
    key = rng.PRNGKey(1769, device=device)
    routes = {
        "new": lambda: sampler.sample_batch(key, n_lines, maxR, sc, sc.mass_ns, n_grid=n_grid,
                                            n_max=tcfg.n_max_sample, compute_dtype="f32",
                                            line_engine="kernel"),
        "old": lambda: sample_batch_grid(key, n_lines, maxR, sc, n_grid, tcfg.n_max_sample,
                                         torch.float32)}
    res = {k: fn() for k, fn in routes.items()}   # warm-up, and the events both draw
    torch.cuda.synchronize()
    same = torch.equal(res["new"].success, res["old"].success)
    ok = res["new"].success
    err = (res["new"].xpos - res["old"].xpos)[ok].abs().max().item() if bool(ok.any()) else 0.0
    wall = {"new": [], "old": []}
    for k in ("old", "new", "new", "old", "old", "new"):
        t0 = time.time()
        routes[k]()
        torch.cuda.synchronize()
        wall[k].append(time.time() - t0)
    parts = []
    for k in ("old", "new"):
        cuda_lib.reset_launch_counts()
        ops, kernels = eager_counts(routes[k])
        parts.append(f"{k} route {statistics.median(wall[k]):.4f} s (calls "
                     + ", ".join(f"{t:.4f}" for t in wall[k]) + f"), {ops} top-level aten ops, "
                     f"{kernels} device kernels, grid kernel launches "
                     f"{cuda_lib.LAUNCHES['line_scan']}, fused {cuda_lib.LAUNCHES['line_roots']}")
    log(phase, f"sample_batch of {n_lines} lines, f32, host clock with a synchronise: "
               + "; ".join(parts) + f"; same successes {same}, xpos max diff {err:.3g} km")
    if not (same and err <= ROOT_BAR):
        raise AssertionError("the fused route draws other events than the grid route")


def roots_bound(n_lines, n_grid, bisected, size):
    """(bound_ms, bound_by) of the fused kernel: the scan's points in f32 and
    BISECT_ITERS condition evaluations and the filter per bisected root in
    the compute dtype of `size` bytes; the lines' f32 parameters and grid
    read once (and their copies in the compute dtype when that is f64), the
    roots, ok and counts written once."""
    from adiabatic_raytracer_tpu_torch.ops.sampler import BISECT_ITERS, MAX_LINE_CROSSINGS

    nbytes = 4 * (n_lines * 10 + n_grid) + n_lines * (MAX_LINE_CROSSINGS * (size + 1) + 4)
    if size == 8:
        nbytes += 8 * (n_lines * 10 + n_grid)
    t_ops = (FLOP_LINE_POINT * n_lines * n_grid / F32_PER_S
             + (BISECT_ITERS + 1) * FLOP_LINE_POINT * bisected
             / (F32_PER_S if size == 4 else F64_PER_S))
    t_b = nbytes / HBM_BYTES_PER_S
    return (t_b * 1e3, "bytes") if t_b >= t_ops else (t_ops * 1e3, "operations")


def first_slots(g):
    """The first 16 sign-change intervals of each line of the grid g [B, N],
    -1 past the line's count (sampler._flip_slots)."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import sampler

    idx, _, n = sampler._flip_slots(g)
    has = torch.arange(sampler.MAX_LINE_CROSSINGS, device=g.device)[None, :] < n[:, None]
    return torch.where(has, idx, torch.full_like(idx, -1))


def line_roots_vs_grid(geo, s_grid, sc, phase, scene, fails):
    """The fused kernel (line_scan.line_roots_slots) against the torch route
    on the grid kernel's output on the same lines (the route the sampler
    took before it): flip counts and the first 16 intervals identical on
    every line (the same device function scans both); ok identical on all
    but 1 in 1000 lines, and s* on the roots of the others within the root
    bar of the lines' dtype (ROOT_BAR, ROOT_BAR_F64: both routes bisect the
    same interval from the same f32 value).  Appends what failed to fails.
    Returns {"s_err", "n_flips", "slots" (-1 past the count), "bisected"}."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler

    args = (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid, sc, sc.mass_ns)
    s_k, ok_k, n_k, idx_k = line_scan.line_roots_slots(*args)
    g = line_scan.line_scan(*args)
    n_t = sampler._flip_slots(g)[2]
    has = torch.arange(sampler.MAX_LINE_CROSSINGS, device=g.device)[None, :] < n_t[:, None]
    slots = idx_k.long()
    same_n = torch.equal(n_k, n_t)
    same_idx = torch.equal(slots, first_slots(g))
    s_p, ok_p, _ = sampler._roots(*args[:4], g.to(geo.x0.dtype), s_grid, sc, sc.mass_ns)
    ok_diff = (ok_k != ok_p).any(dim=1)
    n_ok = int(ok_diff.sum())
    held = has & ~ok_diff[:, None]
    s_err = (s_k - s_p).abs()[held].max().item() if bool(held.any()) else 0.0
    bar = ROOT_BAR_F64 if geo.x0.dtype == torch.float64 else ROOT_BAR
    B = g.shape[0]
    bisected = int(n_k.clamp(max=sampler.MAX_LINE_CROSSINGS).sum())
    tag = f"K1 fused vs the torch route on the grid kernel's output{scene or ''}, {geo.x0.dtype}"
    log(phase, f"{tag}: flip counts identical {same_n}, first-16 intervals identical "
               f"{same_idx} on {B} lines ({int(n_k.sum())} flips, {bisected} bisected, "
               f"{int(ok_k.sum())} accepted); ok differs on {n_ok} lines (bar "
               f"{max(1, B // 1000)}); s* max err {s_err:.3g} km (bar {bar:g}) on the roots of "
               f"the others")
    if not (same_n and same_idx) or n_ok > max(1, B // 1000) or not s_err <= bar:
        fails.append(f"{tag}: counts {same_n}, intervals {same_idx}, ok differs on {n_ok} "
                     f"lines, s* err {s_err:.3g} km (bar {bar:g})")
    return {"s_err": s_err, "n_flips": n_k.cpu(), "slots": slots, "bisected": bisected}


def sampling_check(key, n_lines, maxR, sc, tcfg, n_grid, cd, phase, scene, kernel, plain_grid,
                   f64_grid, fails):
    """sample_batch through the kernel against the plain scan, the same key,
    at compute dtype cd: lines whose success differs at most 1 in 1000, the
    sampled roots within ROOT_BAR on the lines both drew from, and within
    ROOT_BAR_F64 at f64 on those whose first 16 intervals are the same in
    the kernel's f32 scan and the plain engine's f64 one.  kernel: the
    fused kernel's "n_flips" and "slots" on these lines (line_roots_vs_grid);
    plain_grid(sel), f64_grid(sel): the lines sel's grid in the plain
    engine's scan and in f64.  Appends what failed to fails."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import sampler

    kw = dict(n_grid=n_grid, n_max=tcfg.n_max_sample, compute_dtype=cd)
    rk = sampler.sample_batch(key, n_lines, maxR, sc, sc.mass_ns, line_engine="kernel", **kw)
    rp = sampler.sample_batch(key, n_lines, maxR, sc, sc.mass_ns, line_engine="plain", **kw)
    same = rk.success == rp.success
    both = rk.success & rp.success
    n_diff = int((~same).sum())
    changes = lambda g: int((torch.sign(g[1:]) * torch.sign(g[:-1]) < 0).sum())
    # Phase 3 at f32 holds the root bar on every line both scans drew from.
    # At a boundary-layer scene (phase 13a) a root pair at the shell can be
    # so near tangency that f32 rounding decides whether the grid sees it;
    # such a line's crossing count differs between the two f32 scans and its
    # drawn root may be another one.  At f64 the plain engine scans in f64,
    # and the kernel's f32 scan can miss such a pair anywhere.  There a line
    # whose scans differ leaves the root bar only with a witness, and fails
    # the phase without one: the condition in f64 along it has as many grid
    # sign changes as exactly one of the two scans.  A line whose accepted
    # counts differ while both scans see the same sign changes (the kernel's
    # filter and torch's decided a root on the filter's threshold apart) is
    # counted against the allowance and held to the root bar.
    excusable = bool(scene) or cd == "state"
    excused = torch.zeros_like(both)
    n_thr = 0
    for i in (both & (rk.weight != rp.weight)).nonzero().squeeze(1).tolist():
        c_k, c_p = int(kernel["n_flips"][i]), changes(plain_grid([i])[0])
        if c_k == c_p:
            n_thr += 1
            log(phase, f"  {cd}: accepted counts differ on line {i}: kernel "
                       f"{int(rk.weight[i])} plain {int(rp.weight[i])}, grid sign changes "
                       f"{c_k} in both (a root on the filter's threshold); drawn root r "
                       f"{rk.xpos[i].norm().item():.6g} vs {rp.xpos[i].norm().item():.6g} km: "
                       f"counted, held to the root bar")
            continue
        c64 = changes(f64_grid([i])[0])
        witness = (c64 == c_k) != (c64 == c_p)
        log(phase, f"  {cd}: crossing counts differ on line {i}: kernel {int(rk.weight[i])} "
                   f"plain {int(rp.weight[i])}; grid sign changes kernel {c_k} plain {c_p} "
                   f"f64 {c64}; drawn root r {rk.xpos[i].norm().item():.6g} vs "
                   f"{rp.xpos[i].norm().item():.6g} km; f64 witness {witness}")
        if excusable and not witness:
            fails.append(f"sampling ({cd}): line {i}'s crossing counts differ without an f64 "
                         f"witness")
        excused[i] = excusable and witness
    held = both & ~excused
    n_exc = int(excused.sum())
    err = torch.abs(rk.xpos - rp.xpos).amax(dim=1)
    # at f64, the lines whose two scans bisect the same intervals are held to
    # the f64 bar
    strict = torch.zeros_like(held)
    if cd == "state":
        sel = held.nonzero().squeeze(1)
        for lo in range(0, sel.numel(), 2048):
            part = sel[lo:lo + 2048]
            strict[part] = (first_slots(plain_grid(part)) == kernel["slots"][part]).all(dim=1)
    worst = lambda m: err[m].max().item() if bool(m.any()) else 0.0
    root_err, strict_err = worst(held & ~strict), worst(strict)
    n_allow = n_diff + n_exc + n_thr
    tag = f"K1 sampling{scene or ''} {cd}, kernel vs plain scan"
    log(phase, f"{tag}: {int(rk.success.sum())} successes, {n_diff} flips, {n_exc} near-tangent "
               f"lines with an f64 witness and {n_thr} on the filter's threshold (bar "
               f"{max(1, n_lines // 1000)} together); root err {root_err:.3g} km (bar "
               f"{ROOT_BAR:g}) on {int((held & ~strict).sum())} other lines both drew from"
               + (f", {strict_err:.3g} km (bar {ROOT_BAR_F64:g}) on {int(strict.sum())} whose "
                  f"scans give the same intervals" if cd == "state" else ""))
    if (n_allow > max(1, n_lines // 1000) or not root_err <= ROOT_BAR
            or not strict_err <= ROOT_BAR_F64):
        fails.append(f"{tag}: {n_diff} success flips, {n_exc} near-tangent lines, {n_thr} on "
                     f"the threshold, root err {root_err:.3g} km, f64-held {strict_err:.3g} km")


def sample_events(n, device, sc, cfg, maxR, n_grid, seed):
    """n conversion-surface events (xpos, k_init, erg) on the device."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
    from adiabatic_raytracer_tpu_torch.utils import rng

    key = rng.PRNGKey(seed, device=device)
    xs, vs, es = [], [], []
    got = 0
    while got < n:
        key, sub = rng.split(key).unbind(0)
        r = sampler.sample_batch(sub, 4096, maxR, sc, sc.mass_ns, n_grid=n_grid,
                                 compute_dtype=cfg.compute_dtype,
                                 line_engine="kernel")
        ok = r.success.nonzero().squeeze(1)
        xs.append(r.xpos[ok])
        vs.append(r.v_loc[ok])
        es.append(r.erg_inf[ok])
        got += int(ok.shape[0])
    f64 = torch.float64
    x = torch.cat(xs)[:n].to(f64)
    v = torch.cat(vs)[:n].to(f64)
    e = torch.cat(es)[:n].to(f64)
    k = k_norm_cart(x, v, 0.0, e, sc, sc.mass_ns, is_photon=True, ax_fix=True)
    return x, k, e


def phase_probe(device, phase=4, funcs=("condition", "rhs"), **scene):
    """The device functions against their torch twins on conversion-surface
    states of the production scene; with `scene`'s fields changed (K2's
    other dispersion variants, r_NS below 10 km), `funcs` of each species
    (the RHS and the condition by default).  Logs how many of the states lie
    below 10 km."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device, **scene)
    x, k, e = sample_events(512, device, sc, cfg, maxR, n_grid, seed=7)
    B = x.shape[0]
    u = launch_state(x, k, sc, e, -torch.ones_like(e)).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(3)
    lnt = (torch.rand(B, generator=gen, dtype=torch.float64) * 10.0 - 10.0).to(device)
    is_ph = (torch.rand(B, generator=gen, dtype=torch.float64) > 0.5).to(torch.float64).to(device)
    worst = 0.0
    parts = []
    cases = [("photon", w) for w in mk.PROBE_FUNCS] + [("axion", "rhs"), ("mixed", "rhs")]
    if scene:
        cases = [(sp, w) for sp in ("photon", "axion", "mixed") for w in funcs]
    for species, which in cases:
        P = mk.mega_params(sc, cfg, species=species, with_prob=True)
        uu = u
        if which == "hermite":
            uu = torch.cat([u, u.flip(0), u * 1e-3, u.flip(0) * 1e-3,
                            torch.rand(B, 2, generator=gen, dtype=torch.float64).to(device)],
                           dim=1).contiguous()
        got = mk.probe(P, which, uu, lnt, e, is_ph, abs(float(sc.b0)))
        want = mk.probe_plain(P, which, uu.cpu(), lnt.cpu(), e.cpu(), is_ph.cpu(),
                              abs(float(sc.b0))).to(device)
        scale = torch.abs(want).amax(dim=0, keepdim=True).clamp(min=1e-300)
        err = (torch.abs(got - want) / (torch.abs(want) + scale)).max().item()
        ok_n = torch.isfinite(got).all().item() and torch.isfinite(want).all().item()
        if not (err < 1e-12 and ok_n):
            raise AssertionError(f"probe {which} ({species}): rel err {err:.3g}, "
                                 f"finite {ok_n}")
        worst = max(worst, err)
        parts.append(f"{which}/{species[0]} {err:.1e}")
    log(phase, f"probe{scene or ''} vs torch twins on {B} states ({int((u[:, 0] < 10.0).sum())} "
               f"below 10 km), f64: worst {worst:.2e} (bar 1e-12 of |value| + column scale); "
               + ", ".join(parts))
    return worst


def k2_backtrace_inputs(device, n, seed, **scene):
    """K2's inputs on the main path's backtrace of n production events (of
    the production scene with `scene`'s fields changed): (u0, lnt0, lnt1,
    erg, x0, flipped scene, cfg, keywords): species axion, 16 crossing
    slots, in-kernel probability."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state
    from adiabatic_raytracer_tpu_torch.ops.tree import _negate_b

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device, **scene)
    x, k, e = sample_events(n, device, sc, cfg, maxR, n_grid, seed=seed)
    B = x.shape[0]
    sc_b = _negate_b(sc)
    f64 = torch.float64
    u0 = launch_state(x, -k, sc_b, e, -torch.ones_like(e))
    lnt0 = torch.full((B,), float(cfg.ln_t_start), dtype=f64, device=device)
    lnt1 = torch.zeros(B, dtype=f64, device=device)
    kw = dict(max_crossings=cfg.max_crossings, is_photon=torch.zeros(B, dtype=torch.bool,
                                                                     device=device),
              species="axion", with_prob=True)
    return u0, lnt0, lnt1, e, x, sc_b, cfg, kw


def k2_queue_inputs(device, n, seed, **scene):
    """K2's inputs as the queue path's tree iterations give them: n
    production events (of the production scene with `scene`'s fields
    changed), photon and axion nodes mixed (each species with probability
    1/2, numpy seed), forward from the conversion point to the end, one
    crossing slot, in-kernel probability; the tuple of k2_backtrace_inputs."""
    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device, **scene)
    x, k, e = sample_events(n, device, sc, cfg, maxR, n_grid, seed=seed)
    B = x.shape[0]
    f64 = torch.float64
    is_ph = torch.as_tensor(np.random.default_rng(seed).random(B) < 0.5, device=device)
    u0 = launch_state(x, k, sc, e, -torch.ones_like(e))
    lnt0 = torch.full((B,), float(cfg.ln_t_start), dtype=f64, device=device)
    lnt1 = torch.zeros(B, dtype=f64, device=device)
    kw = dict(max_crossings=1, is_photon=is_ph, species="mixed", with_prob=True)
    return u0, lnt0, lnt1, e, x, sc, cfg, kw


def phase_megakernel(device, n_events):
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    u0, lnt0, lnt1, e, x, sc_b, cfg, kw = k2_backtrace_inputs(device, n_events, seed=11)
    B = x.shape[0]
    dense = dataclasses.replace(cfg, interp_coarse=0)

    def run_kernel(c):
        return mk.integrate_mega(u0, lnt0, lnt1, e, x, sc_b, c, **kw)

    out_k = run_kernel(dense)
    torch.cuda.synchronize()
    t0 = time.time()
    out_p = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, sc_b, cfg, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3   # host clock around one synced run
    out_g = run_kernel(cfg)
    ms = cuda_ms(lambda: run_kernel(cfg), 3)
    ms_dense = cuda_ms(lambda: run_kernel(dense), 3)

    nc_k, nc_p, nc_g = out_k[4], out_p[4], out_g[4]
    same = nc_k == nc_p
    frac = same.double().mean().item()
    mism = (~same).nonzero().squeeze(1).tolist()
    for i in mism[:20]:
        log(5, f"  crossing-count mismatch ray {i}: kernel {int(nc_k[i])} plain {int(nc_p[i])} "
               f"codes {int(out_k[3][i])}/{int(out_p[3][i])}")
    end = (out_k[3] == 1) & (out_p[3] == 1)
    rel = (torch.abs(out_k[0] - out_p[0]) / (torch.abs(out_p[0]) + 1e-30)).amax(dim=1)
    med = rel[end].median().item()
    max_abs = torch.abs(out_k[0] - out_p[0])[end].max().item()
    used = (torch.arange(cfg.max_crossings, device=device)[None, :] < nc_p[:, None]) & same[:, None]
    pcx_rel = (torch.abs(out_k[8] - out_p[8]) / torch.clamp(torch.abs(out_p[8]), min=1e-300))[used]
    pcx_bad = int((pcx_rel > 1e-8).sum())
    # the kernel's pcx is exactly its _prob_nd at its own crossing states; a
    # kernel-vs-plain pcx gap is the two engines' crossing roots differing in
    # the last bits where the root is near-tangent (ill-conditioned), so it is
    # printed with the crossing-state gap that explains it
    P = mk.mega_params(sc_b, cfg, max_crossings=cfg.max_crossings, species="axion",
                       with_prob=True)
    bi, si = used.nonzero(as_tuple=True)
    cru_k = out_k[5][bi, si].cpu()
    own = mk._prob_nd(P, tuple(cru_k[:, c] for c in range(7)), e[bi].cpu())
    pk, pp = out_k[8][bi, si], out_p[8][bi, si]
    own_rel = (torch.abs(pk.cpu() - own) / own.abs().clamp(min=1e-300)).max().item()
    state_gap = (torch.abs(out_k[5] - out_p[5])
                 / torch.abs(out_p[5]).clamp(min=1e-300)).amax(dim=2)[used]
    for j in torch.argsort(pcx_rel, descending=True)[: min(pcx_bad, 10)].tolist():
        log(5, f"  pcx gap: ray {int(bi[j])} slot {int(si[j])}: kernel {pk[j].item():.10g} "
               f"plain {pp[j].item():.10g} (rel {pcx_rel[j].item():.2g}); "
               f"crossing-state rel gap {state_gap[j].item():.2g}")
    gate_same = (nc_g == nc_p).double().mean().item()
    fine = (out_g[11] / torch.clamp(out_g[2], min=1)).mean().item()
    # the gated run's own work: steps, dense passes, crossings (each bisected,
    # with its probability); inputs u0 + aux, outputs uf, lntf, diag, cru,
    # crlnt, save_mid, pcx.  K2's diagnostics count neither accepted steps
    # nor unrecorded roots: every attempted step is charged the coarse gate
    # (a rejected one skips it) and only recorded crossings a bisection
    S = cfg.max_crossings
    nflop = (out_g[2].sum().item() * (flop_step("axion") + flop_gate(cfg.interp_coarse))
             + out_g[11].sum().item() * flop_dense(cfg.interp_points)
             + out_g[4].sum().item() * (flop_bisect(cfg.bisect_iters) + FLOP_PROB))
    b_ms, b_by = bound(8 * B * (7 + 8 + 7 + 1 + 4 + 7 * S + S + 7 + S), nflop, F64_PER_S)
    log(5, f"K2 backtrace {B} rays (species axion, 16 slots, in-kernel prob): dense-scan "
           f"kernel vs plain: identical crossing counts {frac:.4f} (bar 0.99), endpoint "
           f"median rel err {med:.3g} (bar 1e-8) on {int(end.sum())} end-reached rays, "
           f"pcx over rtol 1e-8: {pcx_bad}/{int(used.sum())} (kernel pcx vs its own "
           f"crossing states through the torch twin: max rel {own_rel:.2g}); gated kernel (coarse "
           f"{cfg.interp_coarse}, theta {cfg.scan_gate_theta}) vs plain dense scan: "
           f"identical counts {gate_same:.4f}, dense-pass share of steps {fine:.3f}; "
           f"kernel {ms:.3f} ms gated / {ms_dense:.3f} ms dense, plain {plain_ms:.1f} ms; "
           f"steps {int(out_g[2].sum().item())}, bound {b_ms:.4f} ms ({b_by})")
    # the slowest ray (most steps, gated run): a launch cannot end before it,
    # so steps x one warp's step time is the launch's floor; its bisected
    # roots from the plain version (the pool counts them, K2's diag does not)
    slow = int(torch.argmax(out_g[2]).item())
    sl = slice(slow, slow + 1)
    pool = mk.pool_run(u0[sl], lnt0[sl], lnt1[sl], e[sl], x[sl], sc_b, cfg,
                       max_crossings=S, is_photon=kw["is_photon"][sl], species="axion")
    steps_slow, steps_slow_d = out_g[2][slow].item(), out_k[2].max().item()
    resident = mk.resident_warps(P, device)
    log(5, f"K2 slowest ray {slow}: {int(steps_slow)} steps, {int(out_g[11][slow].item())} dense "
           f"passes, {int(pool.n_bisect[0].item())} bisected roots (plain version, dense scan), "
           f"{int(out_g[4][slow].item())} crossings; {ms * 1e3 / steps_slow:.2f} us per step of "
           f"it gated, {ms_dense * 1e3 / steps_slow_d:.2f} dense ({int(steps_slow_d)} steps); "
           f"warps launched {min(B, resident)}, resident warps {resident}; steps per ray "
           f"mean {out_g[2].mean().item():.1f}")
    if not (frac >= 0.99 and med < 1e-8 and pcx_bad <= 0.01 * int(used.sum())
            and own_rel < 1e-10 and gate_same >= 0.99):
        raise AssertionError("K2 disagrees with its plain version")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def census_cfg(device, **scene):
    """The gate configuration the main path runs at the production scene with
    `scene`'s fields changed: driver._apply_scan_gate_guard's choice
    (default gate, widened, or the dense scan) and its verdict."""
    from adiabatic_raytracer_tpu_torch import driver

    sc, cfg, _, maxR, _ = scene_setup(device, **scene)
    stats = driver.RunStats()
    out = driver._apply_scan_gate_guard(sc, cfg, maxR, 0.0, stats, device)
    return out, stats.scan_gate


def k2_variant_job(device, n, launch, witness=False, **scene):
    """phase_k2_variant's inputs, made on the card, with K2's plain version on
    them submitted to plain_pool; with `witness`, also the plain version on
    the same inputs with u0 moved by one ulp (u0 * (1 + 2^-52))."""
    make = k2_backtrace_inputs if launch == "backtrace" else k2_queue_inputs
    u0, lnt0, lnt1, e, x, sc, cfg, kw = make(device, n, seed=43, **scene)
    args = (u0, lnt0, lnt1, e, x, sc, cfg)
    job = dict(launch=launch, scene=scene, args=args, kw=kw,
               plain=submit_plain("k2", *args, **kw))
    if witness:
        job["ulp"] = submit_plain("k2", u0 * (1.0 + 2.0 ** -52), *args[1:], **kw)
    return job


def endpoint_rel(out_a, out_b):
    """Per ray, the largest relative difference of K2's final states of two
    runs over their 7 components, and the mask of rays both ended at lnt1."""
    import torch

    rel = (torch.abs(out_a[0] - out_b[0]) / (torch.abs(out_b[0]) + 1e-30)).amax(dim=1)
    return rel, (out_a[3] == 1) & (out_b[3] == 1)


def phase_k2_variant(device, job, phase):
    """K2's instantiation for a scene with `scene`'s fields changed (the
    boundary-layer or isotropic dispersion variant, r_NS below 10 km) against
    integrate_mega_plain at phase 5's bars, with the dense scan and with the
    gate the main path runs there (the scan-gate census's choice, whose
    verdict is printed; the production default gate's agreement is printed
    beside it), on a k2_variant_job: `launch` "backtrace" (axion, B
    flipped, 16 slots) or "mixed" (one queue-path tree iteration: photon and
    axion, one slot).  The plain version runs on the CPU (plain_pool); on
    the card it took ~34 s at 2048 rays (phase 5), set by the slowest ray.
    Where rays start below 10 km, the endpoint error is also split by start
    radius with the worst rays' radii, and a witness job's plain version on
    inputs moved by one ulp is held against the plain version alike: the
    endpoints' own sensitivity to rounding."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    launch, scene, kw = job["launch"], job["scene"], job["kw"]
    u0, lnt0, lnt1, e, x, sc, cfg = job["args"]
    B = x.shape[0]
    dense = dataclasses.replace(cfg, interp_coarse=0)
    gate, verdict = census_cfg(device, **scene)
    run = lambda c: mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, c, **kw)
    out_d, out_g, out_0 = run(dense), run(gate), run(cfg)
    ms, ms_dense = cuda_ms(lambda: run(gate), 3), cuda_ms(lambda: run(dense), 3)
    out_p, plain_s = plain_result(job["plain"], device)
    nc_p = out_p[4]
    same = lambda out: (out[4] == nc_p).double().mean().item()
    same_d, same_g, same_0 = same(out_d), same(out_g), same(out_0)
    rel, end = endpoint_rel(out_d, out_p)
    med = rel[end].median().item() if bool(end.any()) else float("nan")
    finite = bool(torch.isfinite(out_g[0]).all() and torch.isfinite(out_d[0]).all())
    for i in (out_0[4] != nc_p).nonzero().squeeze(1).tolist()[:5]:
        log(phase, f"  default gate vs plain, ray {i}: {int(out_0[4][i])} vs {int(nc_p[i])} "
                   f"crossings at lnt {out_p[6][i, :int(nc_p[i])].tolist()}")
    slow = int(torch.argmax(out_g[2]).item())
    steps_slow = out_g[2][slow].item()
    used = torch.arange(out_g[5].shape[1], device=device)[None, :] < out_g[4][:, None]
    below = int((used & (out_g[5][..., 0] < mk.METRIC_R_NS)).sum())
    species = {"backtrace": "axion, B flipped, 16 slots", "mixed": "photon and axion, 1 slot"}
    log(phase, f"K2 {launch} {B} rays {scene} ({species[launch]}): dense kernel vs plain "
               f"identical "
               f"crossing counts {same_d:.4f} (bar 0.99), endpoint median rel err {med:.3g} "
               f"(bar 1e-8) on {int(end.sum())} end-reached rays; census {verdict} (coarse "
               f"{gate.interp_coarse}, theta {gate.scan_gate_theta}): gated vs plain identical "
               f"counts {same_g:.4f} (bar 0.99); the production default gate (coarse "
               f"{cfg.interp_coarse}, theta {cfg.scan_gate_theta}) {same_0:.4f}; crossings "
               f"{int(nc_p.sum().item())} ({below} of the kernel's below {mk.METRIC_R_NS:g} km); "
               f"kernel {ms:.3f} ms gated / {ms_dense:.3f} ms dense, "
               f"plain {plain_s:.1f} s on one CPU thread (plain_pool); slowest ray {slow}: "
               f"{int(steps_slow)} steps, "
               f"{int(out_g[11][slow].item())} dense passes, {ms * 1e3 / steps_slow:.2f} us per "
               f"step of it gated; steps per ray mean {out_g[2].mean().item():.1f}")
    inside = u0[:, 0] < mk.METRIC_R_NS
    split = lambda r, m: (f"{r[m].median().item():.3g} on {int(m.sum())}"
                          if bool(m.any()) else "none")
    if bool(inside.any()):
        log(phase, f"  endpoint rel err by start radius: below {mk.METRIC_R_NS:g} km median "
                   f"{split(rel, end & inside)}, above {split(rel, end & ~inside)}")
        comp = torch.abs(out_d[0] - out_p[0]) / (torch.abs(out_p[0]) + 1e-30)
        for i in torch.argsort(torch.where(end, rel, torch.zeros_like(rel)),
                               descending=True)[:3].tolist():
            log(phase, f"  worst ray {i}: rel {rel[i].item():.3g} in component "
                       f"{int(comp[i].argmax())}; start r {u0[i, 0].item():.6g} km, end r "
                       f"{out_p[0][i, 0].item():.6g} km, end k_r {out_p[0][i, 3].item():.3g}, "
                       f"crossings at r {out_p[5][i, :int(nc_p[i]), 0].tolist()}")
    if "ulp" in job:
        out_u, ulp_s = plain_result(job["ulp"], device)
        rel_u, end_u = endpoint_rel(out_u, out_p)
        log(phase, f"  witness: the plain version on u0 moved by one ulp vs the plain version: "
                   f"identical counts {(out_u[4] == nc_p).double().mean().item():.4f}, endpoint "
                   f"median rel err {split(rel_u, end_u)} rays, below {mk.METRIC_R_NS:g} km "
                   f"{split(rel_u, end_u & inside)}, above {split(rel_u, end_u & ~inside)} "
                   f"({ulp_s:.1f} s)")
    if not (same_d >= 0.99 and same_g >= 0.99 and med < 1e-8 and finite
            and int(end.sum()) > 0 and verdict != "off"):
        raise AssertionError(f"K2 {launch} at {scene} disagrees with its plain version")


def phase_treekernel(device, n_plain, n_tree):
    """K3 against its plain version on the same blocks (one launch), then the
    tree engine around it against the host engine at tree_k=1."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import cuda_lib, tree
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel")
    lnt_end = 0.0   # log(1 / omega_pul) at the production scene
    nf = int(min(cfg.tree_kernel_finals, tcfg.num_cutoff))
    qd = tcfg.mc_nodes + 2
    it_full = (tcfg.max_nodes + 2) * (cfg.max_steps + 2)

    # --- kernel vs plain on the same blocks, one launch ---
    x, k, e = sample_events(n_plain, device, sc, cfg, maxR, n_grid, seed=13)
    keys = rng.fold_in(rng.PRNGKey(2027, device=device), torch.arange(n_plain, device=device))
    blocks = blocks_plain = tk.tree_inputs(keys, x, k, e, sc, cfg, tcfg, lnt_end=lnt_end)
    launch = lambda: tk.tree_kernel_launch(*blocks, sc, cfg, tcfg, nf=nf, qd=qd, it_cap=it_full)
    _, a_k, _, f_k = launch()
    torch.cuda.synchronize()
    t0 = time.time()
    _, a_p, _, f_p = tk.tree_kernel_launch_plain(*blocks, sc, cfg, tcfg, nf=nf, qd=qd,
                                                 it_cap=it_full)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3   # host clock around one synced run
    ms = cuda_ms(launch, 3)
    r = tree_agreement(a_k, f_k, a_p, f_p, nf, "K3 vs plain", 6)
    same = (a_k[:, [tk.A_COUNT, tk.A_CMAIN, tk.A_INFO, tk.A_NALLOC, tk.A_ANOM]]
            == a_p[:, [tk.A_COUNT, tk.A_CMAIN, tk.A_INFO, tk.A_NALLOC, tk.A_ANOM]]).all(dim=1)
    bis_same = (a_k[:, tk.A_NBISECT] == a_p[:, tk.A_NBISECT])[same].double().mean().item()
    tot = lambda r: a_k[:, r].sum().item()
    steps = a_k[:, tk.A_STEPTOT]
    n_ph = tot(tk.A_STEPS_PH)
    b_ms, b_by = tree_bound(a_k, blocks[2].shape[1], nf, qd, cfg)
    log(6, f"K3 vs plain on {n_plain} events, one launch (default cutoffs, NF {nf}, QD {qd}): "
           f"{r['text']}; bisection counts identical {bis_same:.4f}; steps per event mean "
           f"{steps.mean().item():.1f} max {int(steps.max().item())}, photon steps {int(n_ph)} "
           f"of {int(tot(tk.A_STEPTOT))}, accepted {int(tot(tk.A_NACC))}, dense passes "
           f"{int(tot(tk.A_NFINE))}, bisections {int(tot(tk.A_NBISECT))}, recorded crossings "
           f"{int(tot(tk.A_NCROSS))}; kernel {ms:.3f} ms, "
           f"{ms * 1e3 / steps.max().item():.2f} us per step of the slowest tree; plain "
           f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not r["ok"]:
        raise AssertionError("K3 disagrees with its plain version")
    max_abs = r["max_abs"]

    # --- the tree engine on 2048 events vs the host engine at tree_k=1 ---
    x, k, e = sample_events(n_tree, device, sc, cfg, maxR, n_grid, seed=17)
    keys = rng.fold_in(rng.PRNGKey(2028, device=device), torch.arange(n_tree, device=device))
    host_cfg = dataclasses.replace(cfg, tree_engine="queue", tree_k=1, compute_dtype="state")
    torch.cuda.synchronize()
    t0 = time.time()
    host = tree.forward_tree(keys, x, k, e, sc, host_cfg, tcfg, lnt_end=lnt_end)
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3
    parts, ends = [], {}
    for chunk in (0, 64):
        kc = dataclasses.replace(cfg, tree_kernel_chunk=chunk)
        run = lambda: tree.forward_tree(keys, x, k, e, sc, kc, tcfg, lnt_end=lnt_end)
        run()
        torch.cuda.synchronize()
        n0 = cuda_lib.LAUNCHES["treekernel"]
        t0 = time.time()
        kern = run()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        n_launch = cuda_lib.LAUNCHES["treekernel"] - n0
        same = torch.ones(n_tree, dtype=torch.bool, device=device)
        for name in ("count", "count_main", "info", "n_alloc", "dw_anomalies"):
            same &= getattr(kern, name) == getattr(host, name)
        frac_h = same.double().mean().item()
        blocks = tk.tree_inputs(keys, x, k, e, sc, kc, tcfg, lnt_end=lnt_end)
        ends[chunk] = tk.run_tree_kernel(*blocks, sc, kc, tcfg, nf=nf, qd=qd)
        st = ends[chunk][0][:, tk.A_STEPTOT]
        parts.append(f"chunk {chunk}: forward_tree {wall:.1f} ms host clock ({n_launch} "
                     f"launches), identical counters "
                     f"vs host {frac_h:.4f}, steps/event mean {st.mean().item():.1f} max "
                     f"{int(st.max().item())} total {int(st.sum().item())}")
        if frac_h < 0.99:
            raise AssertionError(f"K3 (chunk {chunk}) disagrees with the host engine: {frac_h}")
    # a cut launch resumes: the relaunched events' counters and finals
    # against those of one launch
    rc = tree_agreement(*ends[64], *ends[0], nf, "chunk 64 vs one launch", 6)
    log(6, f"K3 tree engine on {n_tree} events vs host engine at tree_k=1 on K2 "
           f"({host_ms:.1f} ms, host clock): " + "; ".join(parts) + f"; chunk 64 vs one "
           f"launch: {rc['text']}")
    if not rc["ok"]:
        raise AssertionError("K3's relaunch disagrees with one launch")
    k3 = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
          "bound_by": b_by, "library_ms": None}
    return k3, {"blocks": blocks_plain, "aux": a_p, "fin": f_p, "plain_ms": plain_ms}


def tree_bound(a, uu, nf, qd, cfg):
    """(bound_ms, bound_by) of one K3 or K4 run whose aux output is a: the
    run's work by species (attempted steps, photon steps at the photon RHS,
    the rest at the axion RHS), the coarse gate of accepted steps, dense
    passes, bisected roots, one prob_nd per recorded crossing; the bytes of
    its inputs uin, aux, uni, qin and outputs uout, auxout, qout, fin."""
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    tot = lambda r: a[:, r].sum().item()
    n_ph = tot(tk.A_STEPS_PH)
    nflop = (n_ph * flop_step("photon") + (tot(tk.A_STEPTOT) - n_ph) * flop_step("axion")
             + tot(tk.A_NACC) * flop_gate(cfg.interp_coarse)
             + tot(tk.A_NFINE) * flop_dense(cfg.interp_points)
             + tot(tk.A_NBISECT) * flop_bisect(cfg.bisect_iters) + tot(tk.A_NCROSS) * FLOP_PROB)
    n = a.shape[0]
    nbytes = 8 * n * 2 * (tk.U_ROWS + tk.AUX_ROWS + qd * tk.ROWS) + 8 * n * (uu + nf * tk.ROWS)
    return bound(nbytes, nflop, F64_PER_S)


def tree_agreement(a_k, f_k, a_r, f_r, nf, tag, phase, scene=None):
    """Phase 6's comparison of a kernel run (a_k, f_k: aux and fin blocks)
    with a reference run of the same events: counters identical (tree done)
    on >= 99% of events; on those the steps, photon steps, accepted steps,
    dense passes and recorded crossings on >= 99% (bisected roots may
    differ: a child is born at a root, where the sign of the condition is
    rounding noise, and a flip there is bisected and then filtered as the
    start point), orders identical, and the per-record relative error of
    their finals (compare_records) median < 1e-8, p99 < REC_P99, worst <
    REC_WORST.  Returns a dict with "ok", "text" and the numbers; "bitwise"
    says whether every row but A_ITERS and every finals slot is
    identical."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    n = a_k.shape[0]
    rows = [tk.A_COUNT, tk.A_CMAIN, tk.A_INFO, tk.A_NALLOC, tk.A_ANOM]
    work = [tk.A_STEPTOT, tk.A_STEPS_PH, tk.A_NACC, tk.A_NFINE, tk.A_NCROSS]
    same = (a_k[:, rows] == a_r[:, rows]).all(dim=1) & (a_k[:, tk.A_DONE] == 1)
    for i in (~same).nonzero().squeeze(1).tolist()[:10]:
        log(phase, f"  {tag} counter mismatch event {i}: {a_k[i, rows].tolist()} vs "
                   f"{a_r[i, rows].tolist()}")
    fk, fr = f_k.reshape(n, nf, tk.ROWS), f_r.reshape(n, nf, tk.ROWS)
    slots = same[:, None] & (fk[..., tk.F_VALID] > 0.5) & (fr[..., tk.F_VALID] > 0.5)
    med, p99, worst = compare_records(fk, fr, slots, tag, phase, aux=a_k, scene=scene)
    cols = [tk.F_W, tk.F_PROB, tk.F_PCONV, tk.F_PCONV0, tk.F_TB] + list(range(tk.F_U0, 16))
    d = torch.abs(fk[slots][:, cols] - fr[slots][:, cols])
    keep = [r for r in range(tk.AUX_ROWS) if r != tk.A_ITERS]
    r = dict(frac=same.double().mean().item(),
             work=(a_k[:, work] == a_r[:, work]).all(dim=1)[same].double().mean().item(),
             records=int(slots.sum()), med=med, p99=p99, worst=worst,
             max_abs=d.max().item() if d.numel() else 0.0,
             orders=bool((fk[slots][:, tk.F_ORD] == fr[slots][:, tk.F_ORD]).all()),
             bitwise=bool(torch.equal(a_k[:, keep], a_r[:, keep]) and torch.equal(fk, fr)))
    r["ok"] = (r["frac"] >= 0.99 and r["work"] >= 0.99 and med < 1e-8 and p99 < REC_P99
               and worst < REC_WORST and r["orders"])
    r["text"] = (f"identical counters {r['frac']:.4f} (bar 0.99), work counters identical on "
                 f"those {r['work']:.4f} (bar 0.99), {r['records']} records, orders identical "
                 f"{r['orders']}, per-record rel err median {med:.3g} p99 {p99:.3g} worst "
                 f"{worst:.3g} (bars 1e-8, {REC_P99:g}, {REC_WORST:g}), max abs "
                 f"{r['max_abs']:.3g}, bitwise {r['bitwise']}")
    return r


def phase_refill_probe(device):
    """P1 against its plain version at the probe's shapes, the probe's own
    checks, then its entry point (refill_probe.main) with the launch
    counters reset just before it and read just after."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.ops import refill_probe as rp

    tbl = rp.probe_table().to(device)
    out_k = rp.refill_probe(tbl)
    torch.cuda.synchronize()
    t0 = time.time()
    out_p = rp.refill_probe_plain(tbl)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3   # host clock around one synced run
    ms = cuda_ms(lambda: rp.refill_probe(tbl), 20)
    # rows 0..SROWS-2 do not depend on the schedule; the flush iteration
    # (last row) depends on which thread took the event when: checks() holds
    # it to a refill boundary or the loop's end
    max_abs = (out_k[:, :-1] - out_p[:, :-1]).abs().max().item()
    chk = rp.checks(tbl, out_k)
    buf = io.StringIO()
    cuda_lib.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = rp.main(["--device", torch.device(device).type])
    launches = cuda_lib.LAUNCHES["refill_probe"]
    quota = tbl[:, 0].sum().item()
    # it reads each event's quota and id (table rows 0-1) and writes its
    # whole output column once (zeroing in the kernel; rows 0, 1 and
    # SROWS-1 added to); one subtraction and one addition per unit of quota
    parts, _, epart = tbl.shape
    b_ms, b_by = bound(4 * parts * epart * (2 + rp.SROWS), 2 * quota, F32_PER_S)
    log(9, f"P1 [{rp.EPART} events, {rp.L} lanes, refill_k {rp.REFILL_K}] kernel vs plain: rows "
           f"0-{rp.SROWS - 2} max abs {max_abs:g}; " + "; ".join(
               f"{k}: {'OK' if ok else 'FAIL'} ({v})"
                                    for k, (ok, v) in chk.items())
           + f"; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.6f} ms ({b_by}); "
           f"entry point rc {rc}, launches {launches}: "
           + " | ".join(buf.getvalue().strip().splitlines()))
    if not (max_abs == 0.0 and all(ok for ok, _ in chk.values()) and rc == 0 and launches > 0):
        raise AssertionError("P1 disagrees with its plain version or fails its checks")
    return launches, {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}


def phase_refill_plain(device, plain, epart, warps):
    """K4 at the refill path's partitions against the plain output of phase
    6: phase 6's blocks (its n_plain production events) in partitions of
    `epart`, each served by `warps` warps.  K4's plain version gives K3's
    plain version's blocks on the same inputs bit for bit, with lanes
    serving several events in turn (tests/test_torch_treekernel.py::
    test_refill_plain_equals_tree_kernel_plain_per_event), so phase 6's
    tree_kernel_launch_plain output is K4's plain output and its time the
    plain time of K4's row.  Returns the kernels' JSON row numbers."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    sc, cfg, tcfg, _, _ = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel")
    nf = int(min(cfg.tree_kernel_finals, tcfg.num_cutoff))
    qd = tcfg.mc_nodes + 2
    it_full = (tcfg.max_nodes + 2) * (cfg.max_steps + 2)
    blocks, a_p, f_p = plain["blocks"], plain["aux"], plain["fin"]
    n_events = blocks[0].shape[0]
    kw = dict(nf=nf, qd=qd, epart=epart, refill_k=int(cfg.tree_refill_k),
              it_cap=min(it_full * epart, 2**31 - 2))
    launch = lambda: tk.tree_refill_launch(*blocks, sc, cfg, tcfg, warps=warps, **kw)
    _, a_k, _, f_k = launch()
    torch.cuda.synchronize()
    ms = cuda_ms(launch, 3)
    b_ms, b_by = tree_bound(a_k, blocks[2].shape[1], nf, qd, cfg)
    r = tree_agreement(a_k, f_k, a_p, f_p, nf, "K4 vs plain", 10)
    served = a_k[:, tk.A_ITERS] - a_k[:, tk.A_STEPTOT]   # > 0: started after another event
    later = int((served > 0).sum())
    parts = -(-n_events // epart)
    log(10, f"K4 vs the plain output of phase 6 on its {n_events} events, {parts} partitions "
            f"of {epart}, {warps} warps each (default cutoffs, refill_k "
            f"{cfg.tree_refill_k}): {r['text']}; events started after another ended {later}, "
            f"warp iterations max {int(a_k[:, tk.A_ITERS].max().item())}; kernel {ms:.3f} ms, "
            f"plain {plain['plain_ms']:.1f} ms (phase 6's run), bound {b_ms:.4f} ms ({b_by})")
    if not (r["ok"] and bool((a_k[:, tk.A_DONE] == 1).all())):
        raise AssertionError("K4 disagrees with its plain version")
    if later == 0:
        raise AssertionError("K4's queue handed no warp a second event")
    return {"max_abs_err": r["max_abs"], "ms": ms, "plain_ms": plain["plain_ms"],
            "plain_of": "tree_kernel_launch_plain, phase 6 (equal to K4's plain version per "
                        "event)", "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


PRODUCTION_CUTOFFS = dict(num_cutoff=50, mc_nodes=10, max_nodes=100)   # bench_pipeline.py:84-86


def phase_refill_vs_tree(device, n_tree):
    """K4 at tree_refill 128 and 1 against K3 in one launch on n_tree
    events, at the default and the production cutoffs, with host-clock
    times (two runs each) and launches of K3 one launch, K3 chunk 64, K4 at
    128 and K4 at 1; then, at each cutoff set, the device times of K3 in one
    launch and of K4 at tree_refill 1 (the main path's K4) on these events."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.config import TreeConfig
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, _, maxR, n_grid = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel")
    x, k, e = sample_events(n_tree, device, sc, cfg, maxR, n_grid, seed=17)
    keys = rng.fold_in(rng.PRNGKey(2028, device=device), torch.arange(n_tree, device=device))
    variants = (("K3 one launch", dict(tree_kernel_chunk=0)),
                ("K3 chunk 64", dict(tree_kernel_chunk=64)),
                ("K4 at 128", dict(tree_refill=128)), ("K4 at 1", dict(tree_refill=1)))
    for cut_name, cut in (("default", {}), ("production", PRODUCTION_CUTOFFS)):
        tcfg = TreeConfig(**cut)
        nf = int(min(cfg.tree_kernel_finals, tcfg.num_cutoff))
        qd = tcfg.mc_nodes + 2
        blocks = tk.tree_inputs(keys, x, k, e, sc, cfg, tcfg, lnt_end=0.0)
        res, parts = {}, []
        for name, kw in variants:
            vc = dataclasses.replace(cfg, **kw)
            walls = []
            for _ in range(2):
                n0 = cuda_lib.LAUNCHES["treekernel"] + cuda_lib.LAUNCHES["treerefill"]
                torch.cuda.synchronize()
                t0 = time.time()
                res[name] = tk.run_tree_kernel(*blocks, sc, vc, tcfg, nf=nf, qd=qd)
                torch.cuda.synchronize()
                walls.append((time.time() - t0) * 1e3)
                n_launch = cuda_lib.LAUNCHES["treekernel"] + cuda_lib.LAUNCHES["treerefill"] - n0
            parts.append(f"{name} {walls[0]:.1f} / {walls[1]:.1f} ms ({n_launch} launches)")
        a3, f3 = res["K3 one launch"]
        st = a3[:, tk.A_STEPTOT]
        log(11, f"{cut_name} cutoffs {tcfg.num_cutoff}/{tcfg.mc_nodes}/{tcfg.max_nodes} on "
                f"{n_tree} events (steps/event mean {st.mean().item():.1f} max "
                f"{int(st.max().item())}), run_tree_kernel host clock, two runs each: "
                + "; ".join(parts))
        for name in ("K4 at 128", "K4 at 1", "K3 chunk 64"):
            r = tree_agreement(*res[name], a3, f3, nf, f"{name} vs K3 ({cut_name})", 11)
            log(11, f"  {cut_name} cutoffs, {name} vs K3 one launch: {r['text']}")
            if name != "K3 chunk 64" and not r["ok"]:
                raise AssertionError(f"{name} disagrees with K3 at the {cut_name} cutoffs")
        # device times on these events: K3 in one launch, K4 at tree_refill 1
        # with its default warps (the main path's K4 at the default cutoffs)
        it_full = (tcfg.max_nodes + 2) * (cfg.max_steps + 2)
        ep = tk.refill_partition(n_tree, 1)
        k3 = lambda: tk.tree_kernel_launch(*blocks, sc, cfg, tcfg, nf=nf, qd=qd, it_cap=it_full)
        k4 = lambda: tk.tree_refill_launch(*blocks, sc, cfg, tcfg, nf=nf, qd=qd, epart=ep,
                                           refill_k=int(cfg.tree_refill_k),
                                           it_cap=min(it_full * ep, 2**31 - 2))
        ms3, ms4 = cuda_ms(k3, 3), cuda_ms(k4, 3)
        _, a4, _, f4 = k4()
        b_ms, b_by = tree_bound(a4, blocks[2].shape[1], nf, qd, cfg)
        r = tree_agreement(a4, f4, a3, f3, nf, "K4 launch vs K3", 11)
        slow = st.max().item()
        warps = tk.refill_warps(n_tree, ep, blocks[0].device)
        log(11, f"{cut_name} cutoffs, device time (CUDA events): K3 one launch {ms3:.3f} ms "
                f"({ms3 * 1e3 / slow:.2f} us per step of the slowest tree, {int(slow)} steps); "
                f"K4 at tree_refill 1 (partitions of {ep}, {warps} warps each) {ms4:.3f} ms "
                f"({ms4 * 1e3 / slow:.2f} us per step of the slowest tree; busiest warp "
                f"{int(a4[:, tk.A_ITERS].max().item())} iterations), K4 / K3 {ms4 / ms3:.2f}; "
                f"K4 bound {b_ms:.4f} ms ({b_by}); K4 vs K3 bitwise {r['bitwise']}")


def rows_ok(rows, zero_weight_ok=False):
    """Rows finite and every weight (column 8) positive.  With
    zero_weight_ok (phase 24d's scene B only), a weight may be 0 exactly
    where its event's backtrace survival weight (column 25) is: a backtrace
    crossing converted with probability 1 (1 - exp(-P_nonAD) rounds to 1 in
    f64 at P_nonAD > ~37, as at the r_NS 9 km, MassA 3e-5 scene)."""
    import numpy as np

    w, sbw = rows[:, 8], rows[:, 25]
    pos = (w > 0) | ((w == 0) & (sbw == 0)) if zero_weight_ok else w > 0
    return bool(np.all(np.isfinite(rows)) and np.all(pos))


def profiled_driver_run(device, sc, cfg, tcfg, n_events, batch, phase, tag, what,
                        must_launch, must_not_launch, zero_weight_ok=False):
    """driver.run on the card, warm under torch.profiler, with the launch
    counters reset just before it and read just after: the rows must be
    finite with positive weights (rows_ok), every kernel of must_launch must have
    launched and none of must_not_launch, and the scan-gate census must have
    run.  Logs events/s, the stage times and the launches; returns (launches,
    rows, stats)."""
    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch.driver import run
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        _, path, stats = run(sc, cfg, tcfg, n_events + 1, seed=1769, save_mode=1,
                             file_tag=f"smoke_{tag}", dir_tag=os.path.join(OUT, "slice"),
                             event_batch=batch, verbose=False, device=device)
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    write_profile(prof, wall, phase, tag)
    rows = np.load(path)
    if not (rows.ndim == 2 and rows.shape[1] == 29 and rows.shape[0] > 0):
        raise AssertionError(f"{what} output has shape {rows.shape}")
    if not rows_ok(rows, zero_weight_ok):
        raise AssertionError(f"{what} rows not finite or weights not positive")
    if not all(launches[n] > 0 for n in must_launch):
        raise AssertionError(f"{what} did not launch {must_launch}: {launches}")
    if any(launches[n] for n in must_not_launch):
        raise AssertionError(f"{what} launched one of {must_not_launch}: {launches}")
    if stats.scan_gate == "off":
        raise AssertionError("scan-gate census check did not run")
    log(phase, f"{what}: {stats.events} events, {rows.shape[0]} rows; warm run {wall:.2f} s = "
               f"{stats.events / wall:.1f} events/s (gate check {stats.t_gate:.2f} s, sample "
               f"{stats.t_sample:.2f} s, pipeline {stats.t_pipeline:.2f} s, rows "
               f"{stats.t_rows:.2f} s, tree iterations or K4 warp iterations max per batch "
               f"summed {stats.tree_iters}); scan_gate={stats.scan_gate}; info "
               f"{stats.info_hist}; launches {launches}")
    return launches, rows, stats


def phase_refill_path(device, n_events, batch):
    """The refill path through driver.run: engine mega, tree_engine kernel,
    tree_refill 1, saveMode 1; K1, K2 and K4 must launch, K3 not."""
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig

    sc = Scene(mass_a=1e-5, theta_m=0.2, b0=1e14)
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype="f32", engine="mega",
                         tree_engine="kernel", tree_kernel_chunk=64, tree_refill=1)
    launches, rows, _ = profiled_driver_run(
        device, sc, cfg, TreeConfig(), n_events, batch, 12, "refill",
        "refill path (driver.run, tree_refill 1)", ("line_roots", "megakernel", "treerefill"),
        ("treekernel", "line_scan"))
    return launches, rows


def phase_driver_iso(device, n_events, batch, phase):
    """driver.run at the production scene made isotropic (K2's isotropic
    variant; the forward tree on the host queue with the CLI's auto window,
    as --tree_engine auto picks there): K1 and K2 must launch, K3 and K4
    not."""
    import dataclasses

    from adiabatic_raytracer_tpu_torch.cli import TREE_WINDOW

    sc, cfg, tcfg, _, _ = scene_setup(device, isotropic=True)
    cfg = dataclasses.replace(cfg, tree_window=TREE_WINDOW)
    profiled_driver_run(device, sc, cfg, tcfg, n_events, batch, phase, "iso",
                        "driver.run isotropic", ("line_roots", "megakernel"),
                        ("treekernel", "treerefill", "line_scan"))


def phase_variants(device):
    """Phase 13: the boundary-layer and isotropic path (K1 with the boundary
    layer, K2's boundary-layer and isotropic instantiations)."""
    bndry, iso = dict(bndry_lyr=0.5), dict(isotropic=True)
    jobs = [k2_variant_job(device, 512, "backtrace", **bndry),
            k2_variant_job(device, 512, "mixed", **bndry),
            k2_variant_job(device, 512, "mixed", **iso)]
    timed("13a", phase_line_scan, device, 16384, phase="13a", **bndry)
    timed("13b", phase_probe, device, phase="13b", **bndry)
    timed("13b", phase_probe, device, phase="13b", **iso)
    for tag, job in zip(("13c", "13c", "13d"), jobs):
        timed(tag, phase_k2_variant, device, job, tag)
    timed("13e", phase_slice, device, 4096, 2048, "auto", "13e", cold_run=False,
          extra=["--bndry_lyr", "0.5"], uses_tree_kernel=False)
    timed("13f", phase_driver_iso, device, 2048, 2048, "13f")


def phase_savemode3(device, n_events, batch, rows_queue):
    """Phase 15: the CLI at --saveMode 3 (the tree dumps: auto picks the
    queue path, with the auto window), warm, counters reset just before it.
    Every text file parses with the port's treeio: one tree_ file per event,
    the final_ lines equal the npy rows in the columns they share, and the
    event_ lines carry every event and its node count; every tree's outgoing
    weight lies in (0, 1 + 1e-9] and reaches 1 - prob_cutoff - 1e-9 on the
    events stopped by prob_cutoff (JAX tests/test_e2e.py:76-100); the rows
    are bitwise phase 8's (saveMode 1 on the queue path, the same window and
    seed); K1 and K2 launched, K3 not."""
    import shutil

    import numpy as np

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.analysis import treeio
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    d = os.path.join(ROOT, "build", "chip_smoke_sm3")   # 2048 tree files: kept off OUT
    shutil.rmtree(d, ignore_errors=True)
    argv = (["--device", "cuda", "--event_batch", str(batch), "--Nts", str(n_events + 1),
             "--saveMode", "3", "--seed", "1769", "--dir_tag", d, "--ftag", "sm3"]
            + SCENE_ARGS)
    cuda_lib.reset_launch_counts()
    t0 = time.time()
    rows, _, stats = cli.run_from_args(argv)
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    t1 = time.time()
    fails = []
    if not (launches["line_roots"] and launches["megakernel"]) or launches["treekernel"] \
            or launches["line_scan"]:
        fails.append(f"launches {launches}: K1's fused kernel and K2 must launch, K3 and the "
                     "grid K1 not")
    if not np.array_equal(rows, rows_queue):
        fails.append(f"rows {rows.shape} differ from phase 8's {rows_queue.shape}")
    trees = sorted(os.listdir(os.path.join(d, "tree")))
    if trees != sorted(f"tree_sm3{e}" for e in range(1, n_events + 1)):
        fails.append(f"{len(trees)} tree files for {n_events} events")
    num, w, species, th, ph, _, thx, phx, absx, _ = treeio.load_final_info(
        os.path.join(d, "event", "final_sm3"))
    shared = np.stack([num, species, th, ph, thx, phx, absx, w], axis=1)
    if not np.array_equal(shared, rows[:, [0, 1, 2, 3, 4, 5, 6, 8]]):
        fails.append("final_ lines differ from the npy rows")
    ev = treeio.load_event_info(os.path.join(d, "event", "event_sm3"))
    ev_no, nodes = ev[0].astype(int), ev[-1].astype(int)
    first = np.searchsorted(rows[:, 0], ev_no)
    has = first < rows.shape[0]
    has[has] = rows[first[has], 0] == ev_no[has]
    if not (np.array_equal(ev_no, np.arange(1, n_events + 1))
            and np.array_equal(nodes[has], rows[first[has], 20].astype(int))):
        fails.append("event_ lines miss events or disagree on node counts with the rows")
    info = dict(zip(rows[:, 0].astype(int), rows[:, 21].astype(int)))
    sums, n_full = [], 0
    for e in range(1, n_events + 1):
        s = treeio.tree_weight_sum(treeio.load_tree(os.path.join(d, "tree", f"tree_sm3{e}")))
        sums.append(s)
        if info.get(e) == 2:
            n_full += 1
            if s < 1.0 - 1e-10 - 1e-9:
                fails.append(f"event {e} stopped by prob_cutoff has weight sum {s!r}")
    if not (min(sums) > 0.0 and max(sums) <= 1.0 + 1e-9) or n_full == 0:
        fails.append(f"weight sums in [{min(sums)!r}, {max(sums)!r}], {n_full} events with info 2")
    log(15, f"saveMode 3 (CLI, --tree_engine auto -> queue, window auto): {stats.events} events, "
            f"{rows.shape[0]} rows, warm run {wall:.2f} s = {stats.events / wall:.1f} events/s "
            f"(gate check {stats.t_gate:.2f} s, sample {stats.t_sample:.2f} s, pipeline "
            f"{stats.t_pipeline:.2f} s, rows {stats.t_rows:.2f} s, text {stats.t_text:.2f} s); "
            f"tree iterations {stats.tree_iters}; K2 launches {launches['megakernel']}; "
            f"{len(trees)} tree files, {n_full} events stopped by prob_cutoff, weight sums "
            f"{min(sums):.12g} .. {max(sums):.12g}; files parsed and checked in "
            f"{time.time() - t1:.1f} s; launches {launches}")
    if fails:
        raise AssertionError("phase 15: " + "; ".join(fails[:10]))


def phase_resume(device, n_events, batch):
    """Phase 16: checkpoint/resume on the kernel path (driver.run as the
    CLI's kernel path runs it: K3 at chunk 64): an uninterrupted run of two
    batches against one batch with checkpoint=True, stopped, then resumed;
    the rows bitwise equal, the checkpoint cleared, and K1, K2 and K3
    launched (counters reset just before the three runs)."""
    import dataclasses
    import glob
    import shutil

    import numpy as np

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    sc, cfg, tcfg, _, _ = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel", tree_kernel_chunk=64)
    dirs = {k: os.path.join(OUT, f"resume_{k}") for k in ("full", "split")}
    for v in dirs.values():
        shutil.rmtree(v, ignore_errors=True)
    kw = dict(seed=1769, save_mode=1, event_batch=batch, verbose=False, device=device,
              file_tag="resume")
    run = lambda k, **more: driver.run(sc, cfg, tcfg, n_events + 1, dir_tag=dirs[k], **kw,
                                       **more)
    cuda_lib.reset_launch_counts()
    t0 = time.time()
    rows_full, _, st_full = run("full")
    t1 = time.time()
    part = run("split", checkpoint=True, max_batches=1)
    ck = glob.glob(os.path.join(dirs["split"], "npy", ".ckpt_*.json"))
    t2 = time.time()
    rows, _, st = run("split", checkpoint=True, resume=True)
    t3 = time.time()
    launches = dict(cuda_lib.LAUNCHES)
    fails = []
    if len(ck) != 1 or part[2].events != batch:
        fails.append(f"the stopped run left {len(ck)} checkpoints after {part[2].events} events")
    if glob.glob(os.path.join(dirs["split"], "npy", ".ckpt_*")):
        fails.append("the checkpoint was not cleared")
    if not np.array_equal(rows, rows_full) or st.f_inx != st_full.f_inx:
        fails.append(f"resumed rows {rows.shape} (f_inx {st.f_inx}) differ from the "
                     f"uninterrupted {rows_full.shape} (f_inx {st_full.f_inx})")
    if not all(launches[n] for n in ("line_roots", "megakernel", "treekernel")) \
            or launches["treerefill"]:
        fails.append(f"launches {launches}: K1, K2 and K3 must launch, K4 not")
    log(16, f"resume on the kernel path, {n_events} events in batches of {batch}: "
            f"uninterrupted {t1 - t0:.2f} s, stopped after one batch {t2 - t1:.2f} s, resumed "
            f"{t3 - t2:.2f} s; rows {rows.shape} bitwise {np.array_equal(rows, rows_full)}; "
            f"launches {launches}")
    if fails:
        raise AssertionError("phase 16: " + "; ".join(fails))


def phase_window(device, n_events, tree_k):
    """Phase 17: the window's contract on the card: driver.run on the queue
    path, one batch of n_events, at tree_window 128 against 0 at one tree_k:
    the rows bitwise equal."""
    import dataclasses

    import numpy as np

    from adiabatic_raytracer_tpu_torch import driver

    sc, cfg, tcfg, _, _ = scene_setup(device)
    out = {}
    for w in (128, 0):
        c = dataclasses.replace(cfg, tree_engine="queue", tree_window=w, tree_k=tree_k)
        t0 = time.time()
        rows, _, st = driver.run(sc, c, tcfg, n_events + 1, seed=1769, save_mode=1,
                                 event_batch=n_events, verbose=False, device=device,
                                 dir_tag=os.path.join(OUT, "window"), file_tag=f"w{w}")
        out[w] = (rows, st, time.time() - t0)
    same = np.array_equal(out[128][0], out[0][0])
    log(17, f"queue path, {n_events} events, tree_k {tree_k}: window 128 {out[128][2]:.2f} s, "
            f"{out[128][1].tree_iters} iterations; window 0 {out[0][2]:.2f} s, "
            f"{out[0][1].tree_iters} iterations; rows {out[0][0].shape} bitwise {same}")
    if not same:
        raise AssertionError("phase 17: the windowed tree's rows differ from the unwindowed")


def spread(xs):
    """(median, max - min) of a list of numbers."""
    import numpy as np

    return float(np.median(xs)), float(max(xs) - min(xs))


def count_host_reads(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result, the
    number of synchronizing CUDA operations it ran, the top sites by
    count as "file:line n")."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs)
    return out, len(syncs), ", ".join(f"{k} {n}" for k, n in sites.most_common(8))


def phase_depth(device, n_events, batch):
    """Phase 18: pipeline depth 2 on the card.  driver.run on the kernel
    path (K3 at chunk 64, as the CLI runs it), warm, depth 1 and depth 2 in
    turns (1, 2, 2, 1, 1, 2): rows bitwise equal across all the runs;
    medians and spreads of events/s and t_pipeline; the host reads per
    batch (synchronizing CUDA operations, set_sync_debug_mode) at each
    depth; a depth-2 run stopped after two batches and resumed writes the
    uninterrupted rows bit for bit."""
    import dataclasses
    import glob
    import shutil

    import numpy as np

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    sc, cfg, tcfg, _, _ = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel", tree_kernel_chunk=64)
    d = os.path.join(OUT, "depth")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(seed=1769, save_mode=1, event_batch=batch, verbose=False, device=device)
    run = lambda tag, n=n_events, **more: driver.run(sc, cfg, tcfg, n + 1, dir_tag=d,
                                                     file_tag=tag, **kw, **more)
    run("warm", n=batch)
    stats, rows = {1: [], 2: []}, None
    fails = []
    cuda_lib.reset_launch_counts()
    for i, depth in enumerate((1, 2, 2, 1, 1, 2)):
        t0 = time.time()
        r, _, st = run(f"d{depth}_{i}", pipeline_depth=depth)
        stats[depth].append((n_events / (time.time() - t0), st))
        if rows is None:
            rows = r
        elif not np.array_equal(r, rows):
            fails.append(f"run {i} at depth {depth}: rows differ from the first run's")
    same = not fails
    launches = dict(cuda_lib.LAUNCHES)
    if not all(launches[n] for n in ("line_roots", "megakernel", "treekernel")):
        fails.append(f"launches {launches}: K1, K2 and K3 must launch")
    log(18, f"launches over the six runs: {launches}")
    summary = {}
    for depth in (1, 2):
        ev = spread([e for e, _ in stats[depth]])
        pipe = spread([st.t_pipeline for _, st in stats[depth]])
        fetch = spread([st.t_fetch for _, st in stats[depth]])
        issue = spread([st.t_issue for _, st in stats[depth]])
        summary[depth] = ev
        log(18, f"depth {depth}, {n_events} events in batches of {batch}, 3 warm runs: "
                f"events/s median {ev[0]:.1f} (spread {ev[1]:.1f}), t_pipeline {pipe[0]:.3f} s "
                f"({pipe[1]:.3f}), t_fetch {fetch[0]:.4f} s ({fetch[1]:.4f}), t_issue "
                f"{issue[0]:.3f} s ({issue[1]:.3f}); runs "
                + ", ".join(f"{e:.1f}" for e, _ in stats[depth]))
    gain = summary[2][0] - summary[1][0]
    log(18, f"depth 2 - depth 1 median events/s {gain:.1f} against the larger spread "
            f"{max(summary[1][1], summary[2][1]):.1f}: depth 2 "
            f"{'ahead' if gain > max(summary[1][1], summary[2][1]) else 'not ahead'}")
    no_gate = dataclasses.replace(cfg, scan_gate_check=0)
    for depth in (1, 2):
        _, n_sync, sites = count_host_reads(
            lambda: driver.run(sc, no_gate, tcfg, n_events + 1, dir_tag=d,
                               file_tag=f"sync{depth}", pipeline_depth=depth, **kw))
        log(18, f"depth {depth}: {n_sync} synchronizing CUDA operations in "
                f"{n_events // batch} batches = {n_sync / (n_events // batch):.1f} per batch "
                f"(no census); top sites: {sites}")
    part = run("resume", pipeline_depth=2, checkpoint=True, max_batches=2)
    ck = glob.glob(os.path.join(d, "npy", ".ckpt_*resume*.json"))
    r, _, st = run("resume", pipeline_depth=2, checkpoint=True, resume=True)
    if len(ck) != 1 or part[2].events != 2 * batch:
        fails.append(f"the stopped run left {len(ck)} checkpoints after {part[2].events} events")
    if not np.array_equal(r, rows):
        fails.append("the resumed depth-2 rows differ from the uninterrupted run's")
    log(18, f"depth 2 stopped after 2 batches and resumed: rows {r.shape} bitwise "
            f"{np.array_equal(r, rows)}; all six runs' rows bitwise {same}")
    if fails:
        raise AssertionError("phase 18: " + "; ".join(fails))


def phase_processes(device, n_events):
    """Phase 19: two processes on the one card.  Two fresh processes run the
    CLI in one gloo group (--coordinator 127.0.0.1:<free port> --nprocs 2
    --procid p), n_events each on the kernel path, seeds 1769 + p, --ftag
    mh_p; the same flags without --coordinator in this process.  Each
    shard bitwise the one-process shard; the two --run_Combine outputs
    byte-identical; the pulse profile both processes print (all_reduce over
    the group) equal to the sum of the one-process shards'.  Logs each
    process's wall and its run's stage times (a cold start)."""
    import shutil
    import socket

    import numpy as np

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.parallel.reduce import pulse_profile_from_rows

    dirs = {k: os.path.join(OUT, f"mh_{k}") for k in ("group", "one")}
    for v in dirs.values():
        shutil.rmtree(v, ignore_errors=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    shard = ["--device", "cuda", "--Nts", str(n_events + 1), "--saveMode", "1"] + SCENE_ARGS
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "adiabatic_raytracer_tpu_torch", *shard, "--seed",
         str(1769 + p), "--dir_tag", dirs["group"], "--ftag", f"mh_{p}", "--coordinator",
         f"127.0.0.1:{port}", "--nprocs", "2", "--procid", str(p)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    logs, walls = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            walls.append(time.time() - t0)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 19: a group process failed:\n{out[-3000:]}")
    cuda_lib.reset_launch_counts()
    for p in range(2):
        cli.run_from_args(shard + ["--seed", str(1769 + p), "--dir_tag", dirs["one"],
                                   "--ftag", f"mh_{p}"])
    launches = dict(cuda_lib.LAUNCHES)
    fails, shards = [], []
    if not all(launches[n] for n in ("line_roots", "megakernel", "treekernel")):
        fails.append(f"launches {launches}: K1, K2 and K3 must launch")
    for p in range(2):
        (name,) = [f for f in os.listdir(os.path.join(dirs["one"], "npy"))
                   if f.endswith(f"_mh_{p}.npy")]
        a = np.load(os.path.join(dirs["group"], "npy", name))
        b = np.load(os.path.join(dirs["one"], "npy", name))
        shards.append(b)
        if not np.array_equal(a, b):
            fails.append(f"process {p}'s shard {a.shape} differs from the one-process {b.shape}")
    hists = [pulse_profile_from_rows(shards[0])[i] + pulse_profile_from_rows(shards[1])[i]
             for i in range(2)]
    for p, out in enumerate(logs):
        (line,) = re.findall(r"pulse profile summed over processes: (\{.*\})", out)
        got = json.loads(line)
        if not (np.array_equal(got["photon"], hists[0].numpy())
                and np.array_equal(got["axion"], hists[1].numpy())):
            fails.append(f"process {p}'s summed pulse profile differs from the one-process sum")
        summary = next(ln for ln in out.splitlines() if ln.startswith("events="))
        log(19, f"process {p}: wall {walls[p]:.2f} s from both starts; "
                f"{summary.split(' -> ')[0]}")
    merged = []
    for d in dirs.values():
        cli.run_from_args(["--run_RT", "0", "--run_Combine", "1", "--side_runs", "2", "--Nts",
                           str(n_events + 1), "--saveMode", "1", "--device", "cuda",
                           "--ftag", "mh_", "--dir_tag", d] + SCENE_ARGS)
        (name,) = [f for f in os.listdir(d) if f.endswith(".npy")]
        with open(os.path.join(d, name), "rb") as f:
            merged.append(f.read())
    if merged[0] != merged[1]:
        fails.append("the combined npy differs")
    log(19, f"the one-process shards here launched {launches}")
    log(19, f"two processes, {n_events} events each: shards bitwise {not fails}; photon "
            f"and axion pulse profiles summed over the group {float(hists[0].sum()):.6g}, "
            f"{float(hists[1].sum()):.6g}; combined npy {len(merged[0])} bytes, identical "
            f"{merged[0] == merged[1]}")
    if fails:
        raise AssertionError("phase 19: " + "; ".join(fails))


# A CLI process that prints its kernels' launch counts when its run ends
# (the counters start at 0 in the fresh process).
COUNTED_CLI = ("import json, sys\n"
               "from adiabatic_raytracer_tpu_torch import cli\n"
               "from adiabatic_raytracer_tpu_torch.ops import cuda_lib\n"
               "cli.main(sys.argv[1:])\n"
               "print('launches ' + json.dumps(cuda_lib.LAUNCHES))\n")


def mesh_bar(rows, ref):
    """The mesh bar: event, species, node count, stop code and c_bck
    bitwise, every other column within 1e-9 relative."""
    import numpy as np

    return (rows.shape == ref.shape
            and all(np.array_equal(rows[:, c], ref[:, c]) for c in (0, 1, 20, 21, 27))
            and np.allclose(rows, ref, rtol=1e-9, atol=1e-300))


def mesh_over_group(n_events, rows_kernel):
    """Phase 20's mesh over a process group: two fresh CLI processes in one
    gloo group on the one card (--mesh 2 --coordinator --nprocs 2 --procid
    p, the card defaults, phase 7's flags), one run over the group.
    Process 0's npy against phase 7's rows at the mesh bar (whether bitwise
    logged); process 1 wrote no file; both printed the run's pulse
    profile, that of process 0's rows and of phase 7's (within the bar's
    1e-9 unless bitwise); both logged tree_engine auto -> kernel; process 0
    launched K1, K2 and K3, process 1 K2 and K3, neither K1's grid kernel.
    Logs each process's wall from both starts, its run's stage times and
    the cold start (wall less the run's own), beside phase 7's run in one
    process."""
    import shutil
    import socket

    import numpy as np

    from adiabatic_raytracer_tpu_torch.parallel.reduce import pulse_profile_from_rows

    dirs = [os.path.join(OUT, f"mesh_group_{p}") for p in range(2)]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", COUNTED_CLI, "--device", "cuda", "--Nts", str(n_events + 1),
         "--saveMode", "1", "--seed", "1769", "--mesh", "2", "--dir_tag", dirs[p],
         "--ftag", "group", "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2",
         "--procid", str(p)] + SCENE_ARGS,
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    logs, walls = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            walls.append(time.time() - t0)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 20: a process of the mesh over the group failed:\n"
                                 f"{out[-3000:]}")
    fails = []
    npys = [f for f in os.listdir(os.path.join(dirs[0], "npy")) if f.endswith(".npy")]
    if len(npys) != 1:
        fails.append(f"process 0 wrote {npys}")
    rows = np.load(os.path.join(dirs[0], "npy", npys[0]))
    if os.path.exists(dirs[1]):
        fails.append(f"process 1 wrote {os.listdir(dirs[1])}")
    within, bitwise = mesh_bar(rows, rows_kernel), np.array_equal(rows, rows_kernel)
    if not within:
        fails.append(f"rows {rows.shape} beyond the mesh bar of phase 7's {rows_kernel.shape}")
    mine, ref = pulse_profile_from_rows(rows), pulse_profile_from_rows(rows_kernel)
    cold = []
    for p, out in enumerate(logs):
        (line,) = re.findall(r"pulse profile of the run over the group: (\{.*\})", out)
        got = json.loads(line)
        for i, sp in enumerate(("photon", "axion")):
            if not (np.array_equal(got[sp], mine[i].numpy())
                    and np.allclose(got[sp], ref[i].numpy(), rtol=1e-9, atol=0)):
                fails.append(f"process {p}'s {sp} pulse profile differs from the rows'")
        if "tree_engine auto -> kernel" not in out:
            fails.append(f"process {p} did not log tree_engine auto -> kernel")
        (launch_line,) = re.findall(r"^launches (\{.*\})$", out, re.M)
        launches = json.loads(launch_line)
        need = ("line_roots", "megakernel", "treekernel") if p == 0 else ("megakernel",
                                                                          "treekernel")
        if not all(launches[n] for n in need) or launches["line_scan"]:
            fails.append(f"process {p} launched {launches}: it must launch {need}, not "
                         "line_scan")
        summary = next(ln for ln in out.splitlines() if ln.startswith("events="))
        run_wall = float(re.search(r"wall=([0-9.]+)s", summary).group(1))
        cold.append(walls[p] - run_wall)
        log(20, f"mesh over the group, process {p}: wall {walls[p]:.2f} s from both starts, "
                f"{walls[p] - run_wall:.2f} s of it before its run (cold start); launches "
                f"{launches}; {summary.split(' -> ')[0]}")
    one = SLICE_RUNS.get(7)
    if one:
        st = one["stats"]
        log(20, f"phase 7 in one process, the same {n_events} events: cold run {one['cold']:.2f} "
                f"s (a fresh process), warm run {one['warm']:.2f} s (gate {st.t_gate:.2f} sample "
                f"{st.t_sample:.2f} pipe {st.t_pipeline:.2f} fetch {st.t_fetch:.2f} rows "
                f"{st.t_rows:.2f})")
    log(20, f"mesh over a group of 2 processes on one card, {n_events} events: rows "
            f"{rows.shape} within the mesh bar of phase 7's {within}, bitwise {bitwise}; "
            f"pulse profiles photon {float(mine[0].sum()):.6g}, axion {float(mine[1].sum()):.6g} "
            f"(phase 7's {float(ref[0].sum()):.6g}, {float(ref[1].sum()):.6g}); cold starts "
            f"{cold[0]:.2f} / {cold[1]:.2f} s")
    if fails:
        raise AssertionError("phase 20: " + "; ".join(fails))


def phase_mesh(device, n_events, batch, rows_kernel):
    """Phase 20: the mesh.  First the mesh over a process group
    (mesh_over_group).  With two cards, --mesh 2 against --mesh 1 on the
    kernel path at the mesh bar (mesh_bar).  With one card, --mesh 2
    without a group must raise naming the missing card, and --mesh 1 gives
    phase 7's rows bitwise.  Then --profile_dir on a 256-event run: its
    trace (under build/) must hold kernels."""
    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    mesh_over_group(n_events, rows_kernel)

    def argv(tag, mesh):
        return (["--device", "cuda", "--event_batch", str(batch), "--Nts", str(n_events + 1),
                 "--saveMode", "1", "--seed", "1769", "--dir_tag", os.path.join(OUT, "mesh"),
                 "--ftag", tag, "--mesh", str(mesh)] + SCENE_ARGS)

    cuda_lib.reset_launch_counts()
    t0 = time.time()
    rows1 = cli.run_from_args(argv("mesh1", 1))[0]
    t1 = time.time()
    launches = dict(cuda_lib.LAUNCHES)
    if not all(launches[n] for n in ("line_roots", "megakernel", "treekernel")):
        raise AssertionError(f"phase 20: --mesh 1 launches {launches}: K1, K2 and K3 must")
    if torch.cuda.device_count() >= 2:
        rows2 = cli.run_from_args(argv("mesh2", 2))[0]
        ok = mesh_bar(rows2, rows1)
        log(20, f"--mesh 2 on {torch.cuda.device_count()} cards vs --mesh 1: rows {rows2.shape} "
                f"within the mesh bar {ok}, bitwise {np.array_equal(rows2, rows1)}")
        if not ok:
            raise AssertionError("phase 20: --mesh 2 rows differ from --mesh 1's")
    else:
        try:
            cli.run_from_args(argv("mesh2", 2))
        except RuntimeError as e:
            if "cuda:1 is missing" not in str(e):
                raise
            log(20, f"--mesh 2 on one card raised: {e}")
        else:
            raise AssertionError("phase 20: --mesh 2 on one card did not raise")
    same = np.array_equal(rows1, rows_kernel)
    log(20, f"--mesh 1, {n_events} events: {t1 - t0:.2f} s, rows {rows1.shape} bitwise "
            f"phase 7's {same}; launches {launches}; multi-card meshes are not verified on a "
            f"one-card machine")
    if not same:
        raise AssertionError("phase 20: --mesh 1 rows differ from phase 7's")
    prof_dir = os.path.join(ROOT, "build", "chip_smoke_profile")
    t0 = time.time()
    cli.run_from_args(["--device", "cuda", "--Nts", "257", "--event_batch", "256", "--seed",
                       "1769", "--dir_tag", os.path.join(OUT, "mesh"), "--ftag", "prof",
                       "--profile_dir", prof_dir] + SCENE_ARGS)
    t1 = time.time()
    path = os.path.join(prof_dir, "trace_prof_p0.json")
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    n_kernels = sum(1 for e in trace if e.get("cat") == "kernel")
    log(20, f"--profile_dir, 256 events: {t1 - t0:.2f} s; trace {os.path.getsize(path) / 1e6:.1f} "
            f"MB, {len(trace)} events, {n_kernels} kernels")
    if not n_kernels:
        raise AssertionError("phase 20: the --profile_dir trace holds no kernel")


def phase_pool_compact(device, n_events, batch, n_rays):
    """Phase 21: engine pool_compact on the card, where the pool engine is
    eager torch at ~0.1 s a DP5 step.  (a) CompactedPropagator against the
    monolithic propagate on the first n_rays photons of JAX's
    tests/test_streaming.py input (chunk_iters 16, min_pool 2, so the pool
    compacts): n_cross and steps exact, traj and xc within 1e-12.  (b)
    driver.run with engine pool and pool_compact, the production scene at
    that test's numerics (interp_points 8, max_crossings 8) and a one-node
    tree (the tree runs the pool in both engines): species and stop codes
    exact, the rest within rtol 1e-3 (the worst difference logged); both
    walls; K1 launches, K2-K4 not.  At the driver's defaults (chunk_iters
    256, min_pool 128, as in JAX) a production backtrace ends within its
    first chunk and never compacts (256 events did so in an earlier run),
    so in (b) the backtrace's CompactedPropagator runs at chunk_iters 16 and
    min_pool 1, and its pool sizes must shrink."""
    import shutil

    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib, streaming
    from adiabatic_raytracer_tpu_torch.ops.propagate import propagate
    from adiabatic_raytracer_tpu_torch.ops.streaming import CompactedPropagator

    fails = []
    # (a) the propagator alone, JAX's 64-ray input (its first n_rays rays)
    rng = np.random.default_rng(3)
    r = rng.uniform(14.0, 24.0, 64)
    th = np.arccos(rng.uniform(-0.9, 0.9, 64))
    ph = rng.uniform(-np.pi, np.pi, 64)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)[:n_rays]
    v = rng.normal(size=(64, 3))[:n_rays]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f64 = torch.float64
    t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    sc_p = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
                 mass_ns=1.0)
    cfg_p = NumericsConfig(interp_points=8)
    kw = dict(erg=t(np.full(n_rays, 1.0000005e-5)), delta_w=t(-np.ones(n_rays)),
              lnt0=t(np.full(n_rays, cfg_p.ln_t_start)),
              lnt1=t(np.full(n_rays, np.log(3e-3))),
              is_photon=torch.ones(n_rays, dtype=torch.bool, device=device),
              max_crossings=torch.ones(n_rays, dtype=torch.int64, device=device))
    t0 = time.time()
    ref = propagate(t(x), t(v), sc_p, cfg_p, species="photon", **kw)
    torch.cuda.synchronize()
    t1 = time.time()
    cp = CompactedPropagator(sc_p, cfg_p, species="photon", chunk_iters=16, min_pool=2)
    got = cp.run(t(x), t(v), kw["erg"], kw["delta_w"], kw["lnt0"], kw["lnt1"],
                 kw["is_photon"], kw["max_crossings"])
    torch.cuda.synchronize()
    t2 = time.time()
    g = {k: getattr(got, k).cpu().numpy() for k in ("n_cross", "steps", "traj", "xc")}
    e = {k: getattr(ref, k).cpu().numpy() for k in ("n_cross", "steps", "traj", "xc")}
    exact = all(np.array_equal(g[k], e[k]) for k in ("n_cross", "steps"))
    close = all(np.allclose(g[k], e[k], rtol=1e-12, atol=1e-12) for k in ("traj", "xc"))
    bitwise = all(np.array_equal(g[k], e[k]) for k in ("traj", "xc"))
    if not (exact and close) or min(cp.pool_sizes) >= n_rays:
        fails.append(f"CompactedPropagator vs propagate: counts exact {exact}, traj/xc within "
                     f"1e-12 {close}, pool sizes {cp.pool_sizes}")
    log(21, f"CompactedPropagator on {n_rays} photons (chunk 16, min pool 2): propagate "
            f"{t1 - t0:.2f} s, {int(e['steps'].max())} steps of the slowest; compacted "
            f"{t2 - t1:.2f} s in {cp.chunks} chunks at pool sizes {sorted(set(cp.pool_sizes))}; "
            f"n_cross and steps exact {exact}, traj and xc bitwise {bitwise}")
    # (b) the driver, engine pool against pool_compact, the backtrace's
    # propagator at small chunks so that it compacts
    class SmallChunks(CompactedPropagator):
        sizes = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "chunk_iters": 16, "min_pool": 1})

        def run(self, *a, **kw):
            res = super().run(*a, **kw)
            SmallChunks.sizes.append(list(self.pool_sizes))
            return res

    sc, _, _, _, _ = scene_setup(device)
    tcfg = TreeConfig(num_cutoff=1, mc_nodes=1, max_nodes=1)
    d = os.path.join(OUT, "pool_compact")
    shutil.rmtree(d, ignore_errors=True)
    out = {}
    for eng in ("pool", "pool_compact"):
        cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype="f32", interp_points=8,
                             max_crossings=8, engine=eng)
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        streaming.CompactedPropagator = SmallChunks
        try:
            rows, _, st = driver.run(sc, cfg, tcfg, n_events + 1, seed=1769, save_mode=1,
                                     event_batch=batch, verbose=False, device=device,
                                     dir_tag=d, file_tag=eng)
        finally:
            streaming.CompactedPropagator = CompactedPropagator
        out[eng] = (rows, st, time.time() - t0, dict(cuda_lib.LAUNCHES))
    sizes = SmallChunks.sizes
    if len(sizes) != 1 or sizes[0][-1] >= sizes[0][0]:
        fails.append(f"the driver's backtrace did not compact: pool sizes {sizes}")
    (a, sa, wa, la), (b, _, wb, lb) = out["pool"], out["pool_compact"]
    if a.shape != b.shape or a.shape[0] == 0:
        fails.append(f"row shapes {a.shape} vs {b.shape}")
    else:
        if not (np.array_equal(a[:, 1], b[:, 1]) and np.array_equal(a[:, 21], b[:, 21])):
            fails.append("species or stop codes differ")
        if not np.allclose(a, b, rtol=1e-3, atol=1e-12):
            fails.append("rows differ beyond rtol 1e-3")
    for la_ in (la, lb):
        if not la_["line_roots"] or any(la_[k] for k in ("megakernel", "treekernel",
                                                          "treerefill")):
            fails.append(f"launches {la_}: K1 only")
    worst = (float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-300)))
             if a.shape == b.shape and a.size else float("nan"))
    log(21, f"driver.run, {n_events} events, batch {batch}: pool {wa:.2f} s ({sa.tree_iters} "
            f"tree iterations), pool_compact {wb:.2f} s, its backtrace in "
            f"{len(sizes[0]) if sizes else 0} chunks of 16 at pool sizes "
            f"{sorted(set(sizes[0])) if sizes else []}; rows {a.shape}, bitwise "
            f"{a.shape == b.shape and np.array_equal(a, b)}, worst relative difference "
            f"{worst:.3g} (bar 1e-3); launches {lb}")
    if fails:
        raise AssertionError("phase 21: " + "; ".join(fails))


def phase_diagnostics(device, n_states, rows_kernel):
    """Phase 22: the geometry diagnostics (surf_norm and its normal,
    angle_vg_snorm, theta_b_cart, dtheta_dr_proj, dwdr_abs_proj,
    d2wdr2_abs_vec; torch.func.vmap over n_states f64 states) and tau_cyc /
    dwdt_vec (n_states radial trajectories) on the card against the same
    calls on the CPU: the worst difference relative to each diagnostic's
    largest value, bar 1e-12 (the element-wise worst logged).  Then
    analysis.flux.analyze on phase 7's rows: each species' histogram total
    equals its sum of weight * sln_prob (relative 1e-12)."""
    import numpy as np
    import torch
    from torch.func import vmap

    from adiabatic_raytracer_tpu_torch.analysis import flux
    from adiabatic_raytracer_tpu_torch.ops import geometry as g
    from adiabatic_raytracer_tpu_torch.ops import radiative as rad
    from adiabatic_raytracer_tpu_torch.ops.dispersion import omega_function

    sc, _, _, _, _ = scene_setup(device)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(n_states, 3))
    x *= rng.uniform(12.0, 60.0, (n_states, 1)) / np.linalg.norm(x, axis=1, keepdims=True)
    k = rng.normal(size=(n_states, 3))
    ns = 16
    u = rng.normal(size=(n_states, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    xt = np.linspace(11.0, 2e5, ns)[None, :, None] * u[:, None, :]
    kt = np.broadcast_to(u[:, None, :] * 1e-5, xt.shape).copy()
    tarr, t0 = np.linspace(0.0, 1e-2, ns), rng.uniform(0.0, 1.0, n_states)
    # dwdt_vec's frequency: the photon's (omega_function); omega_p alone has a
    # sqrt(|B_z|) cusp on the null surface, where one ulp of position moves
    # its time derivative by ~3e-12 of the largest value on one CPU alone
    om = lambda xx, kk, t, s: omega_function(g.cart_to_sph(xx),
                                             g.celerity_from_cart(xx, kk, s.mass_ns), t, s,
                                             s.mass_ns)
    calls = {
        "surf_norm": lambda X, K: vmap(lambda a, b: g.surf_norm(a, b, 0.25, sc,
                                                                sc.mass_ns))(X, K),
        "surf_norm normal": lambda X, K: vmap(lambda a, b: g.surf_norm(
            a, b, 0.25, sc, sc.mass_ns, return_vec=True)[1])(X, K),
        "angle_vg_snorm": lambda X, K: vmap(lambda a, b: g.angle_vg_snorm(
            a, b, 0.25, sc, sc.mass_ns))(X, K),
        "theta_b_cart": lambda X, K: vmap(lambda a, b: g.theta_b_cart(a, b, 0.25, sc))(X, K),
        "dtheta_dr_proj": lambda X, K: vmap(lambda a, b: g.dtheta_dr_proj(a, b, 0.25,
                                                                          sc))(X, K),
        "dwdr_abs_proj": lambda X, K: vmap(lambda a, b: g.dwdr_abs_proj(a, b, 0.25,
                                                                        sc))(X, K),
        "d2wdr2_abs_vec": lambda X, K: vmap(lambda a, b: g.d2wdr2_abs_vec(a, b, 0.25,
                                                                          sc))(X, K),
    }
    traj_calls = {
        "tau_cyc": lambda X, K, T, T0: rad.tau_cyc(X, K, T, T0, sc),
        "dwdt_vec": lambda X, K, T, T0: rad.dwdt_vec(X, K, T, T0, sc, om),
    }
    # the bar is on the difference relative to the diagnostic's largest
    # value over the states: near a zero of a cosine, or where d2wdr2's two
    # terms cancel, one ulp of input moves a value by up to 2e-11 of itself
    # on one CPU alone, so element-wise ratios are logged, not barred
    worst = {}
    for dev_args, calls_ in (((x, k), calls), ((xt, kt, tarr, t0), traj_calls)):
        for name, fn in calls_.items():
            t1 = time.time()
            got = fn(*(torch.as_tensor(a, device=device) for a in dev_args)).cpu().numpy()
            t_dev = time.time() - t1
            want = fn(*(torch.as_tensor(a) for a in dev_args)).numpy()
            diff = np.abs(got - want)
            den = np.maximum(np.abs(got), np.abs(want))
            elem = float(np.max(np.where(den > 0, diff / np.where(den > 0, den, 1.0), 0.0)))
            scale = float(np.max(np.abs(want)))
            worst[name] = (float(diff.max()) / scale if scale > 0 else float("inf"), elem,
                           t_dev, int(np.count_nonzero(want)))
    log(22, f"{n_states} f64 states on the card vs the CPU: worst difference relative to "
            f"the largest value (bar 1e-12), worst element-wise ratio, card s, nonzero "
            f"values: " + "; ".join(f"{n} {w:.3g}, {e:.3g}, {t:.2f} s, {nz}"
                                    for n, (w, e, t, nz) in worst.items()))
    bad = [n for n, (w, _, _, nz) in worst.items() if not w <= 1e-12 or nz == 0]
    path = os.path.join(OUT, "phase22_rows.npy")
    np.save(path, rows_kernel)
    r = flux.analyze(path)
    pid = rows_kernel[:, 1].astype(int)
    pps = rows_kernel[:, 8] * rows_kernel[:, 7]
    tot = {"photon": (float(r.photon_hist.sum()), float(np.sum(pps[pid == 1]))),
           "axion": (float(r.axion_hist.sum()), float(np.sum(pps[pid == 0])))}
    log(22, f"flux.analyze on phase 7's rows ({rows_kernel.shape[0]}): histogram totals vs "
            "sum of weight * sln_prob: " + ", ".join(
                f"{k} {h:.12g} vs {s:.12g}" for k, (h, s) in tot.items())
        + f"; {r.n_events} events, stop reasons {r.stop_reasons}")
    bad += [k for k, (h, s) in tot.items() if not abs(h - s) <= 1e-12 * abs(s)]
    if bad:
        raise AssertionError(f"phase 22: {bad} beyond the bar")


def precision_events(device, n, sc, maxR, n_grid, seed):
    """n conversion-surface events (xpos, v_loc, erg_inf) drawn by the f32
    sampler (K1's <float> route, the card's default): f32 values, so every
    state dtype takes the same events."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    key = rng.PRNGKey(seed, device=device)
    xs, vs, es, got = [], [], [], 0
    while got < n:
        key, sub = rng.split(key).unbind(0)
        r = sampler.sample_batch(sub, 4096, maxR, sc, sc.mass_ns, n_grid=n_grid,
                                 compute_dtype="f32", line_engine="kernel")
        ok = r.success.nonzero().squeeze(1)
        xs.append(r.xpos[ok]), vs.append(r.v_loc[ok]), es.append(r.erg_inf[ok])
        got += int(ok.shape[0])
    return tuple(torch.cat(a)[:n] for a in (xs, vs, es))


def per_event_finals(fin, ev, bt):
    """driver.pipeline's packs and backtrace as f64 numpy, per event:
    {"count", "info", "nbt" (the backtrace's crossings), "drew" (the tree
    entered MC mode, count > mc_nodes: info < 0), "ev"
    (the per-event pack), "fin" (each event's final rows, in processing
    order), "w" (each final's weight: its tree weight times the event's
    backtrace weight, the row's column 8 before the optical-depth factor,
    1 here)}."""
    import numpy as np

    fin = fin.double().cpu().numpy()
    ev = ev.double().cpu().numpy()
    f = fin[:int(fin[-1, 0])]
    e = f[:, 0].astype(np.int64)
    w = f[:, 3] * ev[e, 5]
    lo = np.searchsorted(e, np.arange(ev.shape[0]))
    hi = np.searchsorted(e, np.arange(ev.shape[0]), side="right")
    info = ev[:, 3].astype(np.int64)
    return {"count": ev[:, 2].astype(np.int64), "info": info,
            "nbt": bt.n_cross.cpu().numpy().astype(np.int64), "drew": info < 0, "ev": ev,
            "fin": [f[a:b] for a, b in zip(lo, hi)], "w": [w[a:b] for a, b in zip(lo, hi)]}


def compare_precision(a, b, tag, events, worst=True):
    """Per event, a run's packs (per_event_finals) against the reference's
    on the events selected by the bool mask `events`: the share with
    identical counters (the tree's count and info, the backtrace's
    crossings), whether the finals' species and order
    agree on all of those, and the relative error of their final weights
    (median, p99, max).  Logs the three worst events: counters, each
    final's species, tree weight, prob and prob_conv in both runs, and the
    backtrace's samp_back_weight and prob0.  Returns a dict with "ok"
    (counters >= 0.99, species and order exact, median < 5e-5, max < 1e-3:
    tests/test_precision.py's bars) and "text"."""
    import numpy as np

    same = (a["count"] == b["count"]) & (a["info"] == b["info"]) & (a["nbt"] == b["nbt"])
    sel = np.nonzero(events)[0]
    order_ok, rels, per_ev = True, [], []
    for i in sel[same[sel]]:
        fa, fb = a["fin"][i], b["fin"][i]
        if fa.shape != fb.shape or not np.array_equal(fa[:, 1], fb[:, 1]):
            order_ok = False
            log(23, f"  {tag}: event {i} species differ: {fa[:, 1].tolist()} vs "
                    f"{fb[:, 1].tolist()} (count {a['count'][i]}, info {a['info'][i]})")
            continue
        if fa.shape[0]:
            r = np.abs(a["w"][i] - b["w"][i]) / np.maximum(np.abs(b["w"][i]), 1e-300)
            rels.append(r)
            per_ev.append((float(r.max()), int(i)))
    rel = np.concatenate(rels) if rels else np.zeros(1)
    frac = float(same[sel].mean()) if sel.size else 1.0
    for r_max, i in sorted(per_ev, reverse=True)[:3 if worst else 0]:
        fa, fb, ea, eb = a["fin"][i], b["fin"][i], a["ev"][i], b["ev"][i]
        log(23, f"  {tag}: event {i} worst final rel {r_max:.3g}; count {a['count'][i]} info "
                f"{a['info'][i]}; species {fa[:, 1].astype(int).tolist()}; tree weight "
                f"{fa[:, 3].tolist()} vs {fb[:, 3].tolist()}; prob {fa[:, 4].tolist()} vs "
                f"{fb[:, 4].tolist()}; prob_conv {fa[:, 5].tolist()} vs {fb[:, 5].tolist()}; "
                f"samp_back_weight {ea[5]:.9g} vs {eb[5]:.9g}; prob0 {ea[6]:.9g} vs "
                f"{eb[6]:.9g}")
    out = {"median": float(np.median(rel)), "p99": float(np.quantile(rel, 0.99)),
           "max": float(rel.max()), "over": int((rel > 1e-3).sum()), "finals": int(rel.size),
           "worst": max(per_ev)[1] if per_ev else -1}
    out["ok"] = {"counters": frac >= 0.99, "order": order_ok, "median": out["median"] < 5e-5,
                 "max": out["max"] < 1e-3}
    out["text"] = (f"{tag}: {sel.size} events, identical counters {frac:.4f} (bar 0.99), "
                   f"species and order {'exact' if order_ok else 'DIFFER'} on those, "
                   f"{out['finals']} finals' weights rel err median {out['median']:.3g} (bar "
                   f"5e-5) p99 {out['p99']:.3g} max {out['max']:.3g} (bar 1e-3; {out['over']} "
                   f"finals above), worst event {out['worst']}")
    return out


# Phase 23's conditioning probes, fixed before any run: (b) on its inputs
# perturbed by 2^-23 relative (one f32 ulp), a random sign per component.
# An event is ill-conditioned when a probe changes its counters or species or
# moves a final weight by more than ILL_REL (a tenth of the max bar): no f32
# evaluation can be held to the bar there.  At most ILL_SHARE of the events
# may be so, and each of them is held to ILL_K times its own probe spread.
# ILL_K allows for an f32 path rounding at many places where a probe perturbs
# once (sqrt(100) independent roundings of the probe's size).
PROBES = 8
ILL_REL = 1e-4
ILL_SHARE = 0.2
ILL_K = 10.0


def topology(p, i):
    """Event i's counters and final species in per_event_finals p."""
    return (int(p["count"][i]), int(p["info"][i]), int(p["nbt"][i]),
            tuple(p["fin"][i][:, 1].astype(int).tolist()))


def max_rel(wa, wb):
    import numpy as np

    return float((np.abs(wa - wb) / np.maximum(np.abs(wb), 1e-300)).max()) if wb.size else 0.0


def probe_spread(probes, ref):
    """Per event, from the f64 probes and `ref` (per_event_finals of the
    unperturbed f64 run): "spread", the largest relative weight move
    between two of these f64 runs of one topology (0 where no two share
    one), and "ill" (a probe changed the topology, or the spread is above
    ILL_REL)."""
    import numpy as np

    runs = [ref] + probes
    n = ref["count"].shape[0]
    spread, flip = np.zeros(n), np.zeros(n, dtype=bool)
    for i in range(n):
        topo = [topology(r, i) for r in runs]
        flip[i] = len(set(topo)) > 1
        for j, rj in enumerate(runs):
            for k in range(j):
                if topo[j] == topo[k]:
                    spread[i] = max(spread[i], max_rel(rj["w"][i], runs[k]["w"][i]))
    return {"spread": spread, "ill": flip | (spread > ILL_REL)}


def ill_agreement(x, ref, probes, sp, events, tag):
    """The ill-conditioned events among `events`: each must take the
    topology of ref or of a probe, and its weights must lie within ILL_K x
    max(its spread, ILL_REL) relative of the nearest f64 run of that
    topology.  Returns (ok, text); the three worst events are logged."""
    import numpy as np

    sel = np.nonzero(events & sp["ill"])[0]
    bad, worst = [], []
    for i in sel:
        t = topology(x, i)
        cands = [r for r in [ref] + probes if topology(r, i) == t]
        lim = ILL_K * max(sp["spread"][i], ILL_REL)
        if not cands:
            bad.append(f"event {i} topology {t} is no f64 run's")
            continue
        err = min(max_rel(x["w"][i], r["w"][i]) for r in cands)
        worst.append((err / lim, int(i), err, lim, len(cands)))
        if err > lim:
            bad.append(f"event {i} weights {err:.3g} off, limit {lim:.3g}")
    for q, i, err, lim, nc in sorted(worst, reverse=True)[:3]:
        log(23, f"  {tag}: event {i} rel {err:.3g} of limit {lim:.3g} (spread "
                f"{sp['spread'][i]:.3g}; {nc} f64 runs of its topology)")
    q = max(worst)[0] if worst else 0.0
    text = (f"{tag}: {sel.size} ill-conditioned events, each within {ILL_K:g} x its probe "
            f"spread of an f64 run of its topology: {sel.size - len(bad)} (largest share of "
            f"the limit {q:.3g})" + (f"; {'; '.join(bad[:5])}" if bad else ""))
    return not bad, text


def phase_precision(device, n_events, batch):
    """Phase 23: the precision path on the kernel path.  Three
    configurations of driver.run: (a) the CLI's card defaults (compute f32,
    f64 state), (b) compute_dtype "state" (f64 physics), (c) precision
    "f32" (every tensor f32), each warm, twice in turns (a b c a b c) on
    n_events events: events/s and the K1-K3 launches of each, K1's
    instantiation from the sampler's launches (c: <float>).  Then the same
    n_events f32-sampled events through driver.pipeline under (a), (b) and
    (c), and (b) on inputs perturbed by 2^-23 PROBES times (probe_spread);
    (a) and (c) against (b) per event (compare_precision, ill_agreement),
    each bar on the events it applies to (the module docstring, 23); and a
    resume of (c):
    stopped after one batch of batch / 2 and resumed, rows bitwise the
    uninterrupted (c)'s."""
    import dataclasses
    import glob
    import shutil

    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib, line_scan
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="kernel", tree_kernel_chunk=64)
    confs = {"a": (dataclasses.replace(cfg, compute_dtype="f32"), "f64"),
             "b": (dataclasses.replace(cfg, compute_dtype="state"), "f64"),
             "c": (dataclasses.replace(cfg, compute_dtype="f32"), "f32")}
    d = os.path.join(OUT, "precision")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(seed=1769, save_mode=1, verbose=False, device=device)
    fails = []
    # K1's instantiation: the dtype of the lines each fused launch took
    k1_dtypes, real_launch = [], line_scan._launch_roots

    def launch_roots(x0, *a, **k):
        k1_dtypes.append(x0.dtype)
        return real_launch(x0, *a, **k)

    line_scan._launch_roots = launch_roots
    try:
        for tag, (c, prec) in confs.items():    # warm
            driver.run(sc, c, tcfg, batch + 1, dir_tag=d, file_tag=f"warm_{tag}",
                       event_batch=batch, precision=prec, **kw)
        res = {t: [] for t in confs}
        for i, tag in enumerate("abcabc"):
            c, prec = confs[tag]
            cuda_lib.reset_launch_counts()
            k1_dtypes.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            rows, _, st = driver.run(sc, c, tcfg, n_events + 1, dir_tag=d,
                                     file_tag=f"{tag}{i}", event_batch=batch, precision=prec,
                                     **kw)
            wall = time.time() - t0
            res[tag].append((n_events / wall, dict(cuda_lib.LAUNCHES), set(k1_dtypes), rows,
                             st))
    finally:
        line_scan._launch_roots = real_launch
    for tag, runs in res.items():
        evs = [r[0] for r in runs]
        launches, dts, rows, st = runs[0][1], runs[0][2], runs[0][3], runs[0][4]
        want_k1 = {torch.float32} if confs[tag][0].compute_dtype == "f32" else {torch.float64}
        if not all(launches[n] for n in ("line_roots", "megakernel", "treekernel")) \
                or launches["line_scan"] or launches["treerefill"]:
            fails.append(f"({tag}) launches {launches}: K1 fused, K2 and K3 must launch")
        if dts != want_k1:
            fails.append(f"({tag}) K1 ran at {dts}, not {want_k1}")
        if not (rows.dtype == np.float64 and rows.ndim == 2 and rows.shape[1] == 29
                and np.all(np.isfinite(rows)) and np.all(rows[:, 8] > 0)):
            fails.append(f"({tag}) rows {rows.shape} {rows.dtype} not finite f64 with "
                         "positive weights")
        if not all(np.array_equal(r[3], rows) for r in runs[1:]):
            fails.append(f"({tag}) the two runs' rows differ")
        log(23, f"({tag}) compute {confs[tag][0].compute_dtype}, precision {confs[tag][1]}: "
                f"{n_events} events, {rows.shape[0]} rows; events/s "
                + " / ".join(f"{e:.1f}" for e in evs) + f" (two warm runs); launches "
                f"{launches}; K1 lines {sorted(str(t) for t in dts)}; info {st.info_hist}")
    # per event: the same f32-sampled events through driver.pipeline
    x, v, e = precision_events(device, n_events, sc, maxR, n_grid, seed=23)
    keys = rng.fold_in(rng.PRNGKey(1769, device=device),
                       torch.arange(n_events, device=device) + 1)
    packs = {}
    for tag, (c, prec) in confs.items():
        dt = driver.state_dtype(prec)
        fin, ev, bt, _ = driver.pipeline(keys, x.to(dt), v.to(dt), e.to(dt), sc, c, tcfg,
                                         maxR, 0.0)
        want = torch.float32 if c.compute_dtype == "f32" else dt
        if fin.dtype != want or ev.dtype != want:
            fails.append(f"({tag}) packs {fin.dtype} / {ev.dtype}, not {want}")
        packs[tag] = per_event_finals(fin, ev, bt)
    # the conditioning probes (PROBES, ILL_REL): (b) on the events perturbed
    # by 2^-23 relative, a random sign per component
    every = np.ones(n_events, dtype=bool)
    probes = []
    for seed in range(2311, 2311 + PROBES):
        g = torch.Generator().manual_seed(seed)
        pert = lambda a: (a.double() * (1.0 + 2.0**-23 * (2 * torch.randint(
            0, 2, a.shape, generator=g) - 1).to(a.device)))
        fin, ev, bt, _ = driver.pipeline(keys, pert(x), pert(v), pert(e), sc, confs["b"][0],
                                         tcfg, maxR, 0.0)
        probes.append(per_event_finals(fin, ev, bt))
        r = compare_precision(probes[-1], packs["b"], f"(b) on inputs perturbed by 2^-23 "
                              f"(seed {seed}) vs (b)", every, worst=seed == 2311)
        log(23, r["text"])
    sp = probe_spread(probes, packs["b"])
    well, ill_share = ~sp["ill"], float(sp["ill"].mean())
    # the MC draws of an f32 state are f32 uniforms, other bits than the f64
    # state's (jax.random.uniform at either dtype): (c)'s trees match (b)'s
    # species where neither entered MC mode
    drew = packs["b"]["drew"] | packs["c"]["drew"]
    log(23, f"{int(well.sum())} of {n_events} events well-conditioned at f32 precision "
            f"({PROBES} probes, ILL_REL {ILL_REL:g}): ill share {ill_share:.4f} (bar "
            f"{ILL_SHARE:g}); {int(drew.sum())} entered MC mode in (b) or (c)")
    if ill_share > ILL_SHARE:
        fails.append(f"ill-conditioned share {ill_share:.4f} above {ILL_SHARE:g}")
    for tag, events, what, gates in (
            ("a", every, "every event", ("counters", "order", "median")),
            ("a", well, "well-conditioned events", ("max",)),
            ("c", every, "every event", ("counters", "median")),
            ("c", ~drew, "events with no MC draw", ("order",)),
            ("c", ~drew & well, "well-conditioned events with no MC draw", ("max",))):
        r = compare_precision(packs[tag], packs["b"], f"({tag}) vs (b), {what}", events)
        log(23, r["text"] + f"; gates: {', '.join(gates)}")
        if not all(r["ok"][k] for k in gates):
            fails.append(r["text"])
    for tag, events in (("a", every), ("c", ~drew)):
        ok, text = ill_agreement(packs[tag], packs["b"], probes, sp, events, f"({tag}) vs (b)")
        log(23, text)
        if not ok:
            fails.append(text)
    # a resume of (c), bitwise the uninterrupted (c)
    c, prec = confs["c"]
    rkw = dict(kw, event_batch=batch // 2, precision=prec, file_tag="resume_c")
    full, _, _ = driver.run(sc, c, tcfg, batch + 1, dir_tag=os.path.join(d, "full"), **rkw)
    part = driver.run(sc, c, tcfg, batch + 1, dir_tag=os.path.join(d, "split"),
                      checkpoint=True, max_batches=1, **rkw)
    ck = glob.glob(os.path.join(d, "split", "npy", ".ckpt_*.json"))
    resumed, _, _ = driver.run(sc, c, tcfg, batch + 1, dir_tag=os.path.join(d, "split"),
                               checkpoint=True, resume=True, **rkw)
    if len(ck) != 1 or part[2].events != batch // 2:
        fails.append(f"(c) the stopped run left {len(ck)} checkpoints after "
                     f"{part[2].events} events")
    if not np.array_equal(resumed, full):
        fails.append("(c) the resumed rows differ from the uninterrupted run's")
    log(23, f"(c) {batch} events in batches of {batch // 2}, stopped after one batch and "
            f"resumed: rows {resumed.shape} bitwise {np.array_equal(resumed, full)}")
    if fails:
        raise AssertionError("phase 23: " + "; ".join(fails))


# r_NS below 10 km (phase 24): scene A keeps the production defaults but for
# r_NS 9 km (the conversion surface far outside 10 km but for the null cone of
# B_z), scene B also takes MassA 3e-5 (the surface at 9-11 km)
RNS_SCENES = {"A": dict(r_ns=9.0), "B": dict(r_ns=9.0, mass_a=3e-5)}
RNS_FLAGS = {"A": ["--rNS", "9"], "B": ["--rNS", "9", "--MassA", "3e-5"]}


@contextlib.contextmanager
def zone_counts(device):
    """While active, counts what the kernels did below r_metric (10 km),
    where the metric takes its interior branch: the photon steps K3 and K4
    began and the crossings they recorded there (their uio rows U_PH_IN and
    U_CROSS_IN, summed over launches as deltas), and the crossings K2
    recorded there (its crossing states).  Yields a dict of device tensors,
    read after the run, so that counting adds no host read to it; it does
    add ~6 small device ops per K3/K4 launch and ~7 per K2 launch to the
    run it counts (phase 24d's runs are timed with them)."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    c = {n: torch.zeros((), dtype=torch.float64, device=device)
         for n in ("k34_steps", "k34_cross", "k2_cross")}
    saved = {n: getattr(tk, n) for n in ("tree_kernel_launch", "tree_refill_launch")}
    k2 = mk.integrate_mega
    rows = [tk.U_PH_IN, tk.U_CROSS_IN]

    def tree_wrap(fn):
        def launch(uin, *args, **kwargs):
            out = fn(uin, *args, **kwargs)
            d = (out[0][:, rows] - uin[:, rows]).sum(dim=0)
            c["k34_steps"] += d[0]
            c["k34_cross"] += d[1]
            return out
        return launch

    def k2_wrap(*args, **kwargs):
        out = k2(*args, **kwargs)
        used = torch.arange(out[5].shape[1], device=out[5].device)[None, :] < out[4][:, None]
        c["k2_cross"] += (used & (out[5][..., 0] < mk.METRIC_R_NS)).sum()
        return out

    for n, fn in saved.items():
        setattr(tk, n, tree_wrap(fn))
    mk.integrate_mega = k2_wrap
    try:
        yield c
    finally:
        for n, fn in saved.items():
            setattr(tk, n, fn)
        mk.integrate_mega = k2


def zone_text(c):
    """The counts of zone_counts as (text, photon steps, crossings)."""
    steps, cross = int(c["k34_steps"].item()), int(c["k34_cross"].item() + c["k2_cross"].item())
    return (f"below 10 km: K3/K4 photon steps {steps}, crossings recorded by K3/K4 "
            f"{int(c['k34_cross'].item())} and by K2 {int(c['k2_cross'].item())}", steps, cross)


def phase_rns_k1(device, n_lines, phase):
    """K1 at scene B: phase 3's checks on n_lines lines, then the share of
    the fused kernel's roots (every recorded slot of every line) that lie
    below 10 km."""
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    phase_line_scan(device, n_lines, phase=phase, **RNS_SCENES["B"])
    sc, cfg, _, maxR, n_grid = scene_setup(device, **RNS_SCENES["B"])
    key = rng.PRNGKey(20261018, device=device)
    geo = sampler._draw(rng.split(key, n_lines), maxR, sc, 220.0, True, torch.float32)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64,
                            device=device).to(torch.float32)
    s_star, ok, _ = line_scan.line_roots(geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid,
                                         sc, sc.mass_ns)
    r = torch.linalg.vector_norm(geo.x0[:, None, :] + s_star[..., None] * geo.vvec[:, None, :],
                                 dim=-1)
    n_ok, n_in = int(ok.sum()), int((ok & (r < 10.0)).sum())
    log(phase, f"K1 at scene B {RNS_SCENES['B']}: {n_ok} roots on {n_lines} lines, {n_in} "
               f"below 10 km (share {n_in / max(n_ok, 1):.4f})")
    if n_in == 0:
        raise AssertionError("K1 found no root below 10 km at scene B")


def tree_finals(tr, n_ord):
    """(values [E, n_ord, 12], present [E, n_ord]) of a TreeResult's final
    nodes indexed by order: weight, prob, pconv, pconv0, t, ferg, fpos (3),
    fmom (3)."""
    import torch

    pl = tr.pools
    E = pl.weight.shape[0]
    ev, sl = (pl.is_final & (pl.status == 2)).nonzero(as_tuple=True)
    order = pl.order[ev, sl]
    vals = torch.stack([pl.weight[ev, sl], pl.prob[ev, sl], pl.prob_conv[ev, sl],
                        pl.prob_conv0[ev, sl], pl.t[ev, sl], pl.ferg[ev, sl]], dim=1)
    vals = torch.cat([vals, pl.fpos[ev, sl], pl.fmom[ev, sl]], dim=1).double()
    table = torch.zeros((E, n_ord, 12), dtype=torch.float64, device=vals.device)
    present = torch.zeros((E, n_ord), dtype=torch.bool, device=vals.device)
    table[ev, order] = vals
    present[ev, order] = True
    return table, present


def rns_tree_job(device, n):
    """phase_rns_tree's inputs: n events at scene B, compute dtype "state",
    their K3 blocks made on the card and K3's plain version on them
    submitted to plain_pool."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device, **RNS_SCENES["B"])
    cfg = dataclasses.replace(cfg, tree_engine="kernel", compute_dtype="state")
    x, k, e = sample_events(n, device, sc, cfg, maxR, n_grid, seed=19)
    keys = rng.fold_in(rng.PRNGKey(2029, device=device), torch.arange(n, device=device))
    kw = dict(nf=int(min(cfg.tree_kernel_finals, tcfg.num_cutoff)), qd=tcfg.mc_nodes + 2,
              it_cap=(tcfg.max_nodes + 2) * (cfg.max_steps + 2))
    blocks = tk.tree_inputs(keys, x, k, e, sc, cfg, tcfg, lnt_end=0.0)
    return dict(sc=sc, cfg=cfg, tcfg=tcfg, x=x, k=k, e=e, keys=keys, kw=kw, blocks=blocks,
                plain=submit_plain("k3", *blocks, sc, cfg, tcfg, **kw))


# Phase 24c's witness for the final positions the host engine gives: its
# tolerances for a rerun of the worst records' events
HOST_TIGHT = dict(rtol=1e-10, atol=1e-9)


def phase_rns_tree(device, job, phase):
    """K3, K4 and the tree engine on a rns_tree_job's events at scene B:
    K3 in one launch against its plain version at phase 6's bars
    (tree_agreement) and K4 (tree_refill 1) against K3 at the same bars;
    then K3's tree engine against the host engine at tree_k=1 (K2 per
    iteration): counters identical on >= 99% of events, and on those the
    final records by order (orders identical): weight, probabilities, birth
    time and energy, each relative to itself, at phase 6's REC_P99 and
    REC_WORST; every column's median, fpos and fmom vector-relative, below
    1e-8 (their p99 and worst logged).  The host engine is not K3's plain version: a child
    starts from a Cartesian round trip of its birth state and its
    probability comes from get_prob_nonad, and the final position of an
    axion born bound (end r ~8000 km) is sensitive to both; the witness
    reruns the host engine on the worst records' events at its own and at
    HOST_TIGHT's tolerances.  K3 and K4 must each run photon steps and
    record crossings below 10 km."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import tree
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    sc, cfg, tcfg, blocks, kw = job["sc"], job["cfg"], job["tcfg"], job["blocks"], job["kw"]
    keys, x, k, e = job["keys"], job["x"], job["k"], job["e"]
    n, nf = x.shape[0], kw["nf"]
    with zone_counts(device) as zc3:
        _, a3, _, f3 = tk.tree_kernel_launch(*blocks, sc, cfg, tcfg, **kw)
    with zone_counts(device) as zc4:
        a4, f4 = tk.run_tree_kernel(*blocks, sc, dataclasses.replace(cfg, tree_refill=1), tcfg,
                                    nf=nf, qd=kw["qd"])
    (_, a_p, _, f_p), plain_s = plain_result(job["plain"], device)
    r3 = tree_agreement(a3, f3, a_p, f_p, nf, "K3 vs plain (scene B)", phase, RNS_SCENES["B"])
    st = a3[:, tk.A_STEPTOT]
    log(phase, f"K3 one launch vs its plain version on {n} events at scene B "
               f"{RNS_SCENES['B']}: {r3['text']}; steps per event mean {st.mean().item():.1f} "
               f"max {int(st.max().item())}; plain {plain_s:.1f} s on one CPU thread "
               f"(plain_pool); K3 {zone_text(zc3)[0]}")
    r4 = tree_agreement(a4, f4, a3, f3, nf, "K4 vs K3 (scene B)", phase, RNS_SCENES["B"])
    log(phase, f"K4 (tree_refill 1) vs K3 one launch on the same events: {r4['text']}; K4 "
               f"{zone_text(zc4)[0]}")
    if not (r3["ok"] and r4["ok"]):
        raise AssertionError("K3 or K4 disagrees with its reference at scene B")
    z3, z4 = zone_text(zc3), zone_text(zc4)
    if min(z3[1], z3[2], z4[1], z4[2]) == 0:
        raise AssertionError("K3/K4 ran no photon step or recorded no crossing below 10 km")

    host_cfg = dataclasses.replace(cfg, tree_engine="queue", tree_k=1)
    torch.cuda.synchronize()
    t0 = time.time()
    with zone_counts(device) as zc_h:
        host = tree.forward_tree(keys, x, k, e, sc, host_cfg, tcfg, lnt_end=0.0)
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3
    kern = tree.forward_tree(keys, x, k, e, sc, cfg, tcfg, lnt_end=0.0)
    same = torch.ones(n, dtype=torch.bool, device=device)
    for name in ("count", "count_main", "info", "n_alloc", "dw_anomalies"):
        same &= getattr(kern, name) == getattr(host, name)
    frac = same.double().mean().item()
    n_ord = int(max(int(host.pools.order.max()), int(kern.pools.order.max()))) + 1
    (vk, pk), (vh, ph) = tree_finals(kern, n_ord), tree_finals(host, n_ord)
    orders = bool((pk[same] == ph[same]).all())
    both = same[:, None] & pk & ph
    a, b = vk[both], vh[both]
    rel = final_rel(a, b)
    qs = torch.tensor([0.5, 0.99], dtype=rel.dtype, device=device)
    med = torch.quantile(rel, 0.5, dim=0)
    sq = torch.quantile(rel[:, :6].amax(dim=1), qs)
    s_p99, s_worst = sq[1].item(), rel[:, :6].max().item()
    vq = torch.quantile(rel[:, 6:].amax(dim=1), qs)
    ev, order = both.nonzero(as_tuple=True)
    names = ("w", "prob", "pconv", "pconv0", "t", "ferg", "fpos", "fmom")
    worst_rel, worst_col = rel.max(dim=1)
    worst = torch.argsort(worst_rel, descending=True)[:5].tolist()
    for i in worst:
        e_i = int(ev[i])
        log(phase, f"  K3 tree engine vs host worst record: event {e_i} order {int(order[i])} "
                   f"column {names[int(worst_col[i])]} (rel {worst_rel[i].item():.3g}); w, prob, "
                   f"pconv, pconv0, t, ferg: K3 {[float(f'{v:.10g}') for v in a[i, :6].tolist()]}, "
                   f"host {[float(f'{v:.10g}') for v in b[i, :6].tolist()]}; |fpos| "
                   f"{a[i, 6:9].norm().item():.6g} / {b[i, 6:9].norm().item():.6g} km; the "
                   f"event's root at r {x[e_i].norm().item():.6g} km")
    log(phase, f"K3 tree engine vs host engine at tree_k=1 on the same {n} events: identical "
               f"counters {frac:.4f} (bar 0.99), orders identical {orders}, {int(both.sum())} "
               f"finals; per-column median rel err "
               f"{dict(zip(names, [float(f'{v:.3g}') for v in med.tolist()]))} (bar "
               f"1e-8); w, prob, pconv, pconv0, t, ferg: p99 {s_p99:.3g} worst "
               f"{s_worst:.3g} (bars {REC_P99:g}, {REC_WORST:g}); fpos, fmom: "
               f"p99 {vq[1].item():.3g} worst {rel[:, 6:].max().item():.3g} (logged); host "
               f"engine {host_ms:.1f} ms host clock, {zone_text(zc_h)[0]}")
    host_witness(device, job, host_cfg, kern, host, ev[worst], order[worst], n_ord, phase)
    if not (frac >= 0.99 and orders and bool((med < 1e-8).all())
            and s_p99 < REC_P99 and s_worst < REC_WORST):
        raise AssertionError("K3's tree engine disagrees with the host engine at scene B")


def final_rel(a, b):
    """Per final record ([N, 12] tree_finals values of two runs), the
    relative difference of w, prob, pconv, pconv0, t and ferg, each to
    itself, and of fpos and fmom, vector-relative: [N, 8]."""
    import torch

    rel_s = (a[:, :6] - b[:, :6]).abs() / b[:, :6].abs().clamp(min=1e-300)
    rel_v = torch.stack([(a[:, s] - b[:, s]).norm(dim=1) / b[:, s].norm(dim=1).clamp(min=1e-300)
                         for s in (slice(6, 9), slice(9, 12))], dim=1)
    return torch.cat([rel_s, rel_v], dim=1)


def host_witness(device, job, host_cfg, kern, host, ev, order, n_ord, phase):
    """The witness for phase 24c's worst records (events ev, orders order):
    the host engine rerun on those events alone, at its tolerances (it must
    give the full run's records, events being independent) and at
    HOST_TIGHT's; per record, fpos and fmom of K3's tree engine and of the
    host engine against the tight run.  Where the host engine moves as far
    between its two tolerances as it lies from K3, the gap is the
    integration's, not the kernel's."""
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import tree

    sc, tcfg, keys, x, k, e = (job[n] for n in ("sc", "tcfg", "keys", "x", "k", "e"))
    uniq = torch.unique(ev)
    runs = [tree.forward_tree(keys[uniq], x[uniq], k[uniq], e[uniq], sc, c, tcfg, lnt_end=0.0)
            for c in (host_cfg, dataclasses.replace(host_cfg, **HOST_TIGHT))]
    (v_re, p_re), (v_t, p_t) = (tree_finals(r, n_ord) for r in runs)
    vk, _ = tree_finals(kern, n_ord)
    vh, _ = tree_finals(host, n_ord)
    at = torch.searchsorted(uniq, ev)
    for j in range(ev.shape[0]):
        i, o, u = int(ev[j]), int(order[j]), int(at[j])
        if not bool(p_re[u, o]) or not bool(p_t[u, o]):
            log(phase, f"  witness, event {i} order {o}: no such final in the rerun "
                       f"(own tolerances {bool(p_re[u, o])}, tight {bool(p_t[u, o])})")
            continue
        row = lambda v: v[None, :]
        rerun = final_rel(row(v_re[u, o]), row(vh[i, o]))[0].max().item()
        k_t = final_rel(row(vk[i, o]), row(v_t[u, o]))[0, 6:].tolist()
        h_t = final_rel(row(vh[i, o]), row(v_t[u, o]))[0, 6:].tolist()
        k_h = final_rel(row(vk[i, o]), row(vh[i, o]))[0, 6:].tolist()
        log(phase, f"  witness, event {i} order {o}: host rerun vs the full run {rerun:.3g}; "
                   f"fpos, fmom rel: K3 vs host {k_h[0]:.3g}, {k_h[1]:.3g}; host vs host at "
                   f"{HOST_TIGHT} {h_t[0]:.3g}, {h_t[1]:.3g}; K3 vs host at it {k_t[0]:.3g}, "
                   f"{k_t[1]:.3g}")


def phase_rns_cli(device, name, n_events, batch, phase):
    """The CLI at scene `name` on the kernel path (auto -> K3), then
    driver.run with tree_refill 1 (K4), each warm under torch.profiler with
    the launch counters reset just before it (phase_slice,
    profiled_driver_run); at scene A also the CLI on the queue path (K2 per
    tree iteration).  Each run counts its kernels' work below 10 km
    (zone_counts, inside the timed run); the kernel and refill paths must
    show photon steps and recorded crossings there.  At scene B a row may
    have weight 0 where its survival weight is 0 (rows_ok)."""
    import dataclasses

    sc, cfg, tcfg, _, _ = scene_setup(device, **RNS_SCENES[name])
    zw = name == "B"
    runs = [("kernel path", lambda: phase_slice(device, n_events, batch, "auto",
                                                f"{phase}{name}", cold_run=False,
                                                extra=RNS_FLAGS[name], uses_tree_kernel=True,
                                                zero_weight_ok=zw)),
            ("refill path", lambda: profiled_driver_run(
                device, sc, dataclasses.replace(cfg, tree_engine="kernel", tree_kernel_chunk=64,
                                                tree_refill=1), tcfg, n_events, batch,
                f"{phase}{name}", f"refill_{phase}{name}",
                f"refill path (driver.run, tree_refill 1) at scene {name}",
                ("line_roots", "megakernel", "treerefill"), ("treekernel", "line_scan"),
                zero_weight_ok=zw))]
    if name == "A":
        runs.append(("queue path", lambda: phase_slice(
            device, n_events // 2, batch, "queue", f"{phase}{name}", cold_run=False,
            extra=RNS_FLAGS[name])))
    for what, run in runs:
        with zone_counts(device) as zc:
            run()
        text, steps, cross = zone_text(zc)
        log(phase, f"scene {name} {RNS_SCENES[name]}, {what}: {text}")
        if what != "queue path" and (steps == 0 or cross == 0):
            raise AssertionError(f"scene {name}'s {what} did no work below 10 km")


def phase_rns(device):
    """Phase 24: --rNS below 10 km, where the photon side of K2-K4 takes
    the metric's interior branch.  The plain versions of 24b and 24c are
    submitted to plain_pool first and run while 24a runs."""
    jobs = [k2_variant_job(device, 512, launch, witness=(name, launch) == ("B", "backtrace"),
                           **RNS_SCENES[name])
            for name in ("A", "B") for launch in ("mixed", "backtrace")]
    tree_job = rns_tree_job(device, 512)
    timed("24a", phase_rns_k1, device, 4096, "24a")
    timed("24a", phase_probe, device, phase="24a", funcs=("condition", "rhs", "prob"),
          **RNS_SCENES["B"])
    for job in jobs:
        timed("24b", phase_k2_variant, device, job, "24b")
    timed("24c", phase_rns_tree, device, tree_job, "24c")
    for name in ("A", "B"):
        timed("24d", phase_rns_cli, device, name, 4096, 2048, "24d")


# the in-kernel MC chain (phase 25): K2's chain lanes, their cap, and the
# chain gate the queue-path runs take (NumericsConfig's defaults)
CHAIN_LANES = 256
CHAIN_CAP = 8
CHAIN_GATE = 4


def chain_capture(device, sc, cfg, tcfg, n_events, batch, n_lanes):
    """driver.run on the queue path with mc_chain 1 (cfg's gate; phase 25
    gives gate 0), n_events production events in batches of `batch`, with
    integrate_mega wrapped to keep the
    inputs of the first n_lanes chain lanes (cap > 1) of its chain
    launches: the MC tail of a production tree.  Returns (u0, lnt0, lnt1,
    erg, x0, is_photon, uniforms) on the card and the run's wall time."""
    import torch

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    kept, real = [], mk.integrate_mega

    def keep(u0, lnt0, lnt1, erg, x0, sc_, cfg_, **kw):
        cap = kw.get("chain_cap")
        if cap is not None and sum(k[0].shape[0] for k in kept) < n_lanes:
            i = (cap > 1.5).nonzero().squeeze(1)
            kept.append(tuple(a[i].clone() for a in (u0, lnt0, lnt1, erg, x0,
                                                     kw["is_photon"], kw["uniforms"])))
        return real(u0, lnt0, lnt1, erg, x0, sc_, cfg_, **kw)

    mk.integrate_mega = keep
    try:
        t0 = time.time()
        driver.run(sc, cfg, tcfg, n_events + 1, seed=1769, save_mode=1,
                   event_batch=batch, verbose=False, device=device,
                   dir_tag=os.path.join(OUT, "chain"), file_tag="capture")
        wall = time.time() - t0
    finally:
        mk.integrate_mega = real
    lanes = tuple(torch.cat(c)[:n_lanes] for c in zip(*kept))
    if lanes[0].shape[0] < n_lanes:
        raise AssertionError(f"phase 25: {lanes[0].shape[0]} chain lanes, want {n_lanes}")
    return lanes, wall


def chain_rows_agreement(a, b):
    """Rows of a chained and an unchained driver.run (the same events):
    the share of events whose rows agree in number, species, node count
    and stop code, and over those events' rows the per-record relative
    error, the worst over the tree's columns (the final's angles relative
    to max(|value|, 1 rad)); returns (share, median, p99, worst)."""
    import numpy as np

    ev = np.union1d(a[:, 0], b[:, 0])
    ok = []
    for e in ev:
        ra, rb = a[a[:, 0] == e], b[b[:, 0] == e]
        ok.append(ra.shape == rb.shape
                  and all(np.array_equal(ra[:, c], rb[:, c]) for c in (1, 20, 21)))
    ok = np.array(ok)
    keep = np.isin(a[:, 0], ev[ok]) if ok.any() else np.zeros(len(a), bool)
    keep_b = np.isin(b[:, 0], ev[ok]) if ok.any() else np.zeros(len(b), bool)
    cols = [2, 3, 4, 5, 6, 8, 12, 13, 22, 23, 24]
    x, y = a[keep][:, cols], b[keep_b][:, cols]
    scale = np.abs(y)
    scale[:, :4] = np.maximum(scale[:, :4], 1.0)
    rel = (np.abs(x - y) / np.maximum(scale, 1e-300)).max(axis=1) if len(x) else np.zeros(1)
    return (float(ok.mean()), float(np.median(rel)), float(np.quantile(rel, 0.99)),
            float(rel.max()))


def phase_chain(device, n_events, n_lanes):
    """Phase 25: the in-kernel MC chain (mc_chain=1).  (a) K2's chain
    instantiation against its plain version on n_lanes chain lanes of a
    production queue tree's MC tail (chain_capture at the production
    cutoffs, gate 0, on two batches of n_events: one batch of 2048 gave 197
    chain lanes), each at cap CHAIN_CAP with its own uniforms: the plain version
    in plain_pool's processes, four chunks, while the card runs (b); with
    the dense scan, restarts, codes, crossing counts and final species
    identical on >= 99% of the lanes, and on those the endpoints' and the
    recorded crossing states' median relative error < 1e-8, the pcx over
    rtol 1e-8 at most 1% of the slots; with the main path's gate, the same
    counts on >= 99%; its time, bound and work.  (b) driver.run on the
    queue path (the CLI's auto window), n_events events, at the default and the
    production cutoffs, mc_chain 0 and 1 (gate CHAIN_GATE) in turns, two
    runs each, counters reset just before each: the chained rows against the
    unchained at phase 6's bars (events whose rows agree in number,
    species, node count and stop code >= 99%, their per-record error median
    < 1e-8, p99 < 1e-6, worst < 1e-5); K2's chain instantiation launched in
    every chained run and never in the others; tree iterations, K2
    launches and events/s with their spread (findings; nothing is claimed).
    (c) driver.run at saveMode 3 with mc_chain 1 and tree_engine kernel
    (saveMode 3 runs the queue tree), one batch: the chain instantiation
    launched, K3 not, one tree file per event, the rows finite.
    Returns the chain kernel's JSON fields and its launches in the first
    chained run at the default cutoffs."""
    import dataclasses

    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.cli import TREE_WINDOW
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk

    sc, cfg, tcfg, _, _ = scene_setup(device)
    cfg = dataclasses.replace(cfg, tree_engine="queue", tree_window=TREE_WINDOW,
                              mc_chain_gate=CHAIN_GATE)
    prod = dataclasses.replace(tcfg, **PRODUCTION_CUTOFFS)
    lanes, cap_wall = chain_capture(device, sc, dataclasses.replace(cfg, mc_chain=1,
                                                                    mc_chain_gate=0),
                                    prod, 2 * n_events, n_events, n_lanes)
    u0, lnt0, lnt1, e, x, is_ph, uni = lanes
    B, S = u0.shape[0], CHAIN_CAP
    uni = uni[:, :S].contiguous()
    cap = torch.full((B,), float(S), dtype=torch.float64, device=device)
    dense = dataclasses.replace(cfg, interp_coarse=0)
    kw = dict(max_crossings=S, is_photon=is_ph, species="mixed", with_prob=True,
              chain_cap=cap, uniforms=uni)
    step = -(-B // PLAIN_WORKERS)
    chunks = [slice(i, i + step) for i in range(0, B, step)]
    jobs = [submit_plain("k2", u0[c], lnt0[c], lnt1[c], e[c], x[c], sc, dense,
                         **{**kw, "is_photon": is_ph[c], "chain_cap": cap[c], "uniforms": uni[c]})
            for c in chunks]
    log(25, f"(a) {B} chain lanes captured from a production queue tree (cutoffs 50/10/100, "
            f"gate 0, 2 x {n_events} events) in {cap_wall:.2f} s; their plain version submitted in "
            f"{len(chunks)} chunks")

    # (b) the queue path, mc_chain 0 and 1 in turns
    runs = {}
    chain_launches = None
    for name, tc in (("default", tcfg), ("production", prod)):
        for chain in (0, 1, 1, 0):
            c = dataclasses.replace(cfg, mc_chain=chain)
            cuda_lib.reset_launch_counts()
            t0 = time.time()
            rows, _, st = driver.run(sc, c, tc, n_events + 1, seed=1769, save_mode=1,
                                     event_batch=n_events, verbose=False, device=device,
                                     dir_tag=os.path.join(OUT, "chain"),
                                     file_tag=f"{name}_{chain}")
            wall = time.time() - t0
            launches = dict(cuda_lib.LAUNCHES)
            if chain and chain_launches is None:
                chain_launches = launches["megakernel_chain"]
            if bool(launches["megakernel_chain"]) != bool(chain):
                raise AssertionError(f"phase 25: mc_chain {chain} launched {launches}")
            if not rows_ok(rows):
                raise AssertionError("phase 25: rows not finite or weights not positive")
            runs.setdefault((name, chain), []).append((rows, st, wall, launches))
    ok = True
    for name in ("default", "production"):
        r0, r1 = runs[(name, 0)], runs[(name, 1)]
        share, med, p99, worst = chain_rows_agreement(r1[0][0], r0[0][0])
        same0 = np.array_equal(r0[0][0], r0[1][0])
        same1 = np.array_equal(r1[0][0], r1[1][0])
        ok = ok and share >= 0.99 and med < 1e-8 and p99 < REC_P99 and worst < REC_WORST
        for chain, rr in ((0, r0), (1, r1)):
            eps = [st.events / wall for _, st, wall, _ in rr]
            m, sp = spread(eps)
            log(25, f"(b) {name} cutoffs, mc_chain {chain}: events/s {', '.join(f'{v:.1f}' for v in eps)} "
                    f"(median {m:.1f}, spread {sp:.1f}); tree iterations "
                    f"{[st.tree_iters for _, st, _, _ in rr]}; K2 launches "
                    f"{[l['megakernel'] for *_, l in rr]} + chain {[l['megakernel_chain'] for *_, l in rr]}; "
                    f"rows {rr[0][0].shape[0]}; finals {rr[0][1].finals}, nodes {rr[0][1].tot_nodes}, "
                    f"info {rr[0][1].info_hist}")
        log(25, f"(b) {name} cutoffs: chained vs unchained rows: events agreeing {share:.4f} "
                f"(bar 0.99), per-record rel err median {med:.3g} p99 {p99:.3g} worst {worst:.3g} "
                f"(bars 1e-8, {REC_P99:g}, {REC_WORST:g}); runs of one setting bitwise: "
                f"unchained {same0}, chained {same1}")

    # (c) saveMode 3 with the chain: tree_engine kernel, which saveMode 3
    # turns into the queue tree, on one batch
    c3 = dataclasses.replace(cfg, tree_engine="kernel", mc_chain=1)
    dump = os.path.join(ROOT, "build", "chip_smoke_chain3")
    cuda_lib.reset_launch_counts()
    t0 = time.time()
    rows3, _, st3 = driver.run(sc, c3, tcfg, n_events + 1, seed=1769, save_mode=3,
                               event_batch=n_events, verbose=False, device=device,
                               dir_tag=dump, file_tag="chain3")
    wall3 = time.time() - t0
    launches3 = dict(cuda_lib.LAUNCHES)
    trees = len(os.listdir(os.path.join(dump, "tree")))
    log(25, f"(c) saveMode 3, mc_chain 1, {n_events} events: {wall3:.2f} s, text "
            f"{st3.t_text:.2f} s, {trees} tree files, rows {rows3.shape[0]}; launches {launches3}")
    ok = (ok and launches3["megakernel_chain"] > 0 and not launches3["treekernel"]
          and trees >= n_events and rows_ok(rows3))

    # (a) the kernel on the captured lanes
    out_k = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, dense, **kw)
    out_g = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, cfg, **kw)
    ms = cuda_ms(lambda: mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, cfg, **kw), 3)
    ms_dense = cuda_ms(lambda: mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, dense, **kw), 3)
    parts = [plain_result(j, device) for j in jobs]
    out_p = tuple(torch.cat([p[0][i] for p in parts]) for i in range(12))
    plain_s = sum(p[1] for p in parts)
    same = ((out_k[9] == out_p[9]) & (out_k[3] == out_p[3]) & (out_k[4] == out_p[4])
            & (out_k[10] == out_p[10]))
    frac = same.double().mean().item()
    for i in (~same).nonzero().squeeze(1).tolist()[:10]:
        log(25, f"  lane {i}: kernel restarts/code/crossings/species {int(out_k[9][i])}/"
                f"{int(out_k[3][i])}/{int(out_k[4][i])}/{int(out_k[10][i])}, plain "
                f"{int(out_p[9][i])}/{int(out_p[3][i])}/{int(out_p[4][i])}/{int(out_p[10][i])}")
    rel = (torch.abs(out_k[0] - out_p[0]) / (torch.abs(out_p[0]) + 1e-30)).amax(dim=1)
    med = rel[same].median().item()
    max_abs = torch.abs(out_k[0] - out_p[0])[same].max().item()
    used = (torch.arange(S, device=device)[None, :] < out_p[4][:, None]) & same[:, None]
    st_rel = (torch.abs(out_k[5] - out_p[5])
              / torch.abs(out_p[5]).clamp(min=1e-300)).amax(dim=2)[used]
    pcx_rel = (torch.abs(out_k[8] - out_p[8]) / out_p[8].abs().clamp(min=1e-300))[used]
    pcx_bad = int((pcx_rel > 1e-8).sum())
    gate_same = ((out_g[9] == out_p[9]) & (out_g[4] == out_p[4])).double().mean().item()
    restarts = int(out_g[9].sum().item())
    nflop = (out_g[2].sum().item() * (flop_step("axion") + flop_gate(cfg.interp_coarse))
             + out_g[11].sum().item() * flop_dense(cfg.interp_points)
             + out_g[4].sum().item() * (flop_bisect(cfg.bisect_iters) + FLOP_PROB)
             + restarts * (FLOP_BIRTH + FLOP_RHS["axion"]))
    b_ms, b_by = bound(8 * B * (7 + 8 + S + 7 + 1 + 4 + 7 * S + S + 7 + S + 2), nflop,
                       F64_PER_S)
    log(25, f"(a) K2 chain {B} lanes (cap {S}, species mixed, in-kernel prob): dense kernel vs "
            f"plain: restarts, codes, crossings and species identical {frac:.4f} (bar 0.99); on "
            f"those, endpoint median rel err {med:.3g} (bar 1e-8), crossing-state median rel err "
            f"{st_rel.median().item():.3g} (bar 1e-8), pcx over rtol 1e-8: {pcx_bad}/"
            f"{int(used.sum())}; gated kernel (coarse {cfg.interp_coarse}) vs plain: restarts and "
            f"crossings identical {gate_same:.4f}; restarts in the kernel {restarts} (plain "
            f"{int(out_p[9].sum().item())}), crossings {int(out_g[4].sum().item())}, steps "
            f"{int(out_g[2].sum().item())} (slowest lane {int(out_g[2].max().item())}); kernel "
            f"{ms:.3f} ms gated / {ms_dense:.3f} ms dense, plain {plain_s:.1f} s on one CPU "
            f"thread summed over its chunks (plain_pool); bound {b_ms:.4f} ms ({b_by})")
    if not (frac >= 0.99 and med < 1e-8 and st_rel.median().item() < 1e-8
            and pcx_bad <= 0.01 * int(used.sum()) and gate_same >= 0.99 and restarts > 0
            and chain_launches and ok):
        raise AssertionError("phase 25: the in-kernel MC chain disagrees")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}, chain_launches


def phase_slice(device, n_events, batch, tree_engine, phase, cold_run=True, extra=(),
                uses_tree_kernel=None, zero_weight_ok=False):
    """The main path through the CLI: a cold run when asked (one CLI
    invocation in a fresh process, what a user's call costs), then a warm run
    in this process under torch.profiler, with the launch counters reset just
    before it and read just after.  `extra`: more CLI flags; K3 must launch
    when uses_tree_kernel is true (default: tree_engine "auto"), and must
    not when it is false; zero_weight_ok as in rows_ok."""
    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    def argv(tag):
        return (["--device", "cuda", "--event_batch", str(batch), "--Nts",
                 str(n_events + 1), "--saveMode", "1", "--seed", "1769", "--dir_tag",
                 os.path.join(OUT, "slice"), "--ftag", tag, "--tree_engine", tree_engine]
                + SCENE_ARGS + list(extra))

    cold_msg, cold_wall = "", None
    if cold_run:   # one CLI invocation in a fresh process: imports and warm-up included
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "adiabatic_raytracer_tpu_torch",
                               *argv(f"cold_{tree_engine}")], cwd=ROOT, capture_output=True,
                              text=True, timeout=900)
        cold_wall = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cold CLI run failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        summary = next(ln for ln in proc.stdout.splitlines() if ln.startswith("events="))
        cold_msg = (f"cold run (a fresh process) {cold_wall:.2f} s = "
                    f"{n_events / cold_wall:.1f} events/s ({summary.split(' -> ')[0]}); ")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tag = tree_engine + (f"_{phase}" if extra else "")
    with torch.profiler.profile(activities=acts) as prof:
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        rows, path, stats = cli.run_from_args(argv(f"smoke_{tag}"))
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    write_profile(prof, wall, phase, tag)
    SLICE_RUNS[phase] = dict(cold=cold_wall, warm=wall, stats=stats)
    rows = np.load(path)
    if not (rows.ndim == 2 and rows.shape[1] == 29 and rows.shape[0] > 0):
        raise AssertionError(f"slice output has shape {rows.shape}")
    if not rows_ok(rows, zero_weight_ok):
        raise AssertionError("slice rows not finite or weights not positive")
    if uses_tree_kernel is None:
        uses_tree_kernel = tree_engine == "auto"
    need = ("line_roots", "megakernel") + (("treekernel",) if uses_tree_kernel else ())
    if not all(launches[n] > 0 for n in need):
        raise AssertionError(f"main path did not launch every kernel: {launches}")
    if launches["line_scan"]:
        raise AssertionError(f"the main path launched K1's grid kernel: {launches}")
    if not uses_tree_kernel and launches["treekernel"]:
        raise AssertionError(f"the queue path launched K3: {launches}")
    if stats.scan_gate == "off":
        raise AssertionError("scan-gate census check did not run")
    log(phase, f"slice --tree_engine {tree_engine} {' '.join(extra)}: {stats.events} events, "
               f"{rows.shape[0]} rows; "
               f"{cold_msg}warm run {wall:.2f} s = {stats.events / wall:.1f} events/s (gate "
               f"check {stats.t_gate:.2f} s, sample {stats.t_sample:.2f} s, pipeline "
               f"{stats.t_pipeline:.2f} s, rows {stats.t_rows:.2f} s, tree iterations or "
               f"launches {stats.tree_iters}); scan_gate={stats.scan_gate}; info "
               f"{stats.info_hist}; launches {launches}")
    return launches, rows


def write_profile(prof, wall, phase, tag):
    """Device busy share and the device time and launches of the top kernels
    and of K2-K4, read from the raw trace (key_averages() takes minutes on a
    trace of millions of host ops): only events on the card count, an eager
    op's kernel once, not again under the op that launched it.  The top 40
    kernels and the top 40 host events by summed duration (a host op's time
    includes the ops it calls) go to profile_<tag>.txt."""
    from torch.autograd import DeviceType

    per = {DeviceType.CPU: {}, DeviceType.CUDA: {}}
    for e in prof.profiler.kineto_results.events():
        side = per[DeviceType.CPU if e.device_type() == DeviceType.CPU else DeviceType.CUDA]
        t, n = side.get(e.name(), (0.0, 0))
        side[e.name()] = (t + e.duration_ns() / 1e3, n + 1)
    ranked = {k: sorted(v.items(), key=lambda kv: -kv[1][0]) for k, v in per.items()}
    busy_us = sum(t for t, _ in per[DeviceType.CUDA].values())
    n_dev = sum(n for _, n in per[DeviceType.CUDA].values())
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"profile_{tag}.txt"), "w") as f:
        for side, title in ((DeviceType.CUDA, "device kernels"), (DeviceType.CPU, "host events")):
            f.write(f"# {title}: total us, count, name\n")
            f.writelines(f"{t:14.1f} {n:8d}  {k}\n" for k, (t, n) in ranked[side][:40])
    top = ", ".join(f"{k[:40]} {t / 1e3:.1f} ms x{n}" for k, (t, n) in ranked[DeviceType.CUDA][:8])
    log(phase, f"profile ({tag}): device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
           f"({100 * busy_us / 1e6 / wall:.1f}% busy, summed kernel time; {n_dev} device "
           f"events: kernels and copies); top kernels: {top}")
    for name in ("mega_kernel", "tree_kernel", "tree_refill_kernel"):
        hits = [v for k, v in per[DeviceType.CUDA].items() if re.search(rf"\b{name}\b", k)]
        log(phase, f"profile ({tag}): {name} device time {sum(t for t, _ in hits) / 1e3:.1f} ms "
                   f"over {sum(n for _, n in hits)} launches")


def timed(tag, fn, /, *args, **kwargs):
    """fn(*args, **kwargs), with its wall time logged under phase `tag`."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    log(tag, f"phase wall {time.time() - t0:.1f} s")
    return out


def main():
    import torch

    t_start = time.time()
    smi = phase_device()
    device = torch.device("cuda")
    timed(2, phase_build)
    k1 = timed(3, phase_line_scan, device, 16384)
    timed(3, sample_route_costs, device, 16384)
    timed(4, phase_probe, device)
    k2 = timed(5, phase_megakernel, device, 2048)
    k3, k3_plain = timed(6, phase_treekernel, device, 512, 2048)
    launches, rows_kernel = timed(7, phase_slice, device, 4096, 2048, "auto", 7)
    _, rows_queue = timed(8, phase_slice, device, 2048, 2048, "queue", 8, cold_run=False)
    p1_launches, p1 = timed(9, phase_refill_probe, device)
    k4 = timed(10, phase_refill_plain, device, k3_plain, 256, 32)
    timed(11, phase_refill_vs_tree, device, 2048)
    refill_launches, rows_refill = timed(12, phase_refill_path, device, 4096, 2048)
    same_shape = rows_refill.shape == rows_kernel.shape
    log(12, f"refill path rows vs the kernel path's (same seed; K3 there relaunched at chunk "
            f"64): same shape {same_shape}" + (
                f", weight max rel diff "
                f"{float(abs(rows_refill[:, 8] / rows_kernel[:, 8] - 1).max()):.3g}"
                if same_shape else ""))
    phase_variants(device)
    timed(15, phase_savemode3, device, 2048, 2048, rows_queue)
    timed(16, phase_resume, device, 2048, 1024)
    timed(17, phase_window, device, 2048, 4)
    timed(18, phase_depth, device, 8192, 2048)
    timed(19, phase_processes, device, 1024)
    timed(20, phase_mesh, device, 4096, 2048, rows_kernel)
    timed(21, phase_pool_compact, device, 2, 2, 8)
    timed(22, phase_diagnostics, device, 4096, rows_kernel)
    timed(23, phase_precision, device, 2048, 2048)
    timed(24, phase_rns, device)
    k2_chain, chain_launches = timed(25, phase_chain, device, 2048, CHAIN_LANES)
    log(14, f"chip_smoke wall {time.time() - t_start:.1f} s")
    kernels = [
        {"name": "line_roots", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/line_scan.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/pallas_kernels.py:121",
         "launches": launches["line_roots"], **k1["line_roots"]},
        {"name": "line_scan", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/line_scan.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/pallas_kernels.py:121",
         "launches": launches["line_scan"], "on_main_path": False, **k1["line_scan"]},
        {"name": "megakernel", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/megakernel.py:1436",
         "launches": launches["megakernel"], **k2},
        {"name": "megakernel_chain", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/megakernel.py:862",
         "variant": "with_chain", "launches": chain_launches, **k2_chain},
        {"name": "treekernel", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/treekernel.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/treekernel.py:775",
         "launches": launches["treekernel"], **k3},
        {"name": "treerefill", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/treerefill.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/treekernel.py:1026",
         "launches": refill_launches["treerefill"], **k4},
        {"name": "refill_probe", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/refill_probe.cu",
         "replaces": "scripts/probe_refill_ops.py:147", "launches": p1_launches, **p1},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_plain_pool()
    sys.exit(rc)
