"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Builds the hand-written kernels (adiabatic_raytracer_tpu_torch/csrc/) from
this checkout, checks each against its plain PyTorch version on the card at
the shapes the main path gives it, then drives the port's main path through
its CLI entry point at the production default scene and checks the output.

    python3 chip_smoke.py            # needs one CUDA device

Phases (each prints one line of findings; any failure raises and exits
non-zero):
  1. device: torch.cuda must be available; nvidia-smi name and power limit
  2. build:  nvcc the kernel library (registers / spills from ptxas)
  3. K1 line scan vs its plain version on a sampler chunk (16384 lines x the
     production grid): g to f32 rounding, sampled roots within 2e-3 km
  4. device functions of K2 (probe) vs their torch twins, f64, rtol 1e-12
  5. K2 vs integrate_mega_plain on a 2048-event production backtrace
  6. the slice: cli with --device cuda --event_batch 2048 --Nts 4097
     --saveMode 1 (two full batches), cold, then warm under torch.profiler
     with the launch counters reset just before it
  7. the kernels' JSON line, the nvidia-smi line, the result line

Writes its npy output, the build log and the profiler table under
chiprun_out/chip_smoke/.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SCENE_ARGS = ["--MassA", "1e-5", "--B0", "1e14", "--ThetaM", "0.2"]


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


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA device")
    smi = smi_line()
    log(1, f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
           f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build():
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.lib()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "build_log.txt"), "w") as f:
        f.write(cuda_lib.BUILD_LOG)
    used = [ln.strip() for ln in cuda_lib.BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    log(2, f"built {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s; "
           f"ptxas: {' | '.join(used[-6:])}")


def scene_setup(device):
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
    from adiabatic_raytracer_tpu_torch.ops import sampler

    sc = Scene(mass_a=1e-5, theta_m=0.2, b0=1e14)
    cfg = NumericsConfig(atol=1e-6, rtol=1e-7, compute_dtype="f32", engine="mega")
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    return sc, cfg, TreeConfig(), maxR, sampler.default_n_grid(maxR)


def phase_line_scan(device, n_lines):
    import torch

    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
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
        raise AssertionError(f"K1 disagrees: max rel err vs f64 {rel:.3g} (plain "
                             f"{rel_plain:.3g}), p99.9 {k999:.3g} (plain {p999:.3g}), "
                             f"sign flips away from roots {sign_bad}")
    # sampled events through the kernel vs the plain scan, same key
    kw = dict(n_grid=n_grid, n_max=tcfg.n_max_sample, compute_dtype="f32")
    rk = sampler.sample_batch(key, n_lines, maxR, sc, sc.mass_ns, line_engine="kernel", **kw)
    rp = sampler.sample_batch(key, n_lines, maxR, sc, sc.mass_ns, line_engine="plain", **kw)
    same = rk.success == rp.success
    both = rk.success & rp.success
    root_err = torch.abs(rk.xpos - rp.xpos)[both].max().item() if bool(both.any()) else 0.0
    n_diff = int((~same).sum())
    if n_diff > max(1, n_lines // 1000) or not root_err <= 2e-3:
        raise AssertionError(f"K1 sampling disagrees: {n_diff} success flips, "
                             f"root err {root_err:.3g} km")
    ms = cuda_ms(lambda: line_scan.line_scan(*args), 20)
    plain_ms = cuda_ms(lambda: line_scan.line_scan_plain(*args), 20)
    log(3, f"K1 [{n_lines} x {n_grid}] rel err vs f64: max {rel:.3g} (plain f32 "
           f"{rel_plain:.3g}), p99.9 {k999:.3g} (plain {p999:.3g}); kernel-plain max "
           f"abs {max_abs:.3g}, sign flips away from roots 0; sampling: "
           f"{int(rk.success.sum())} successes, {n_diff} flips, root err "
           f"{root_err:.3g} km (bar 2e-3); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


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


def phase_probe(device):
    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
    x, k, e = sample_events(512, device, sc, cfg, maxR, n_grid, seed=7)
    B = x.shape[0]
    u = launch_state(x, k, sc, e, -torch.ones_like(e)).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(3)
    lnt = (torch.rand(B, generator=gen, dtype=torch.float64) * 10.0 - 10.0).to(device)
    is_ph = (torch.rand(B, generator=gen, dtype=torch.float64) > 0.5).to(torch.float64).to(device)
    worst = 0.0
    parts = []
    cases = [("photon", w) for w in mk.PROBE_FUNCS] + [("axion", "rhs"), ("mixed", "rhs")]
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
    log(4, f"probe vs torch twins on {B} states, f64: worst {worst:.2e} (bar 1e-12 of "
           f"|value| + column scale); " + ", ".join(parts))
    return worst


def phase_megakernel(device, n_events):
    import dataclasses

    import torch

    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state
    from adiabatic_raytracer_tpu_torch.ops.tree import _negate_b

    sc, cfg, tcfg, maxR, n_grid = scene_setup(device)
    x, k, e = sample_events(n_events, device, sc, cfg, maxR, n_grid, seed=11)
    B = x.shape[0]
    sc_b = _negate_b(sc)
    f64 = torch.float64
    u0 = launch_state(x, -k, sc_b, e, -torch.ones_like(e))
    lnt0 = torch.full((B,), float(cfg.ln_t_start), dtype=f64, device=device)
    lnt1 = torch.zeros(B, dtype=f64, device=device)
    kw = dict(max_crossings=cfg.max_crossings, is_photon=torch.zeros(B, dtype=torch.bool,
                                                                     device=device),
              species="axion", with_prob=True)
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
    log(5, f"K2 backtrace {B} rays (species axion, 16 slots, in-kernel prob): dense-scan "
           f"kernel vs plain: identical crossing counts {frac:.4f} (bar 0.99), endpoint "
           f"median rel err {med:.3g} (bar 1e-8) on {int(end.sum())} end-reached rays, "
           f"pcx over rtol 1e-8: {pcx_bad}/{int(used.sum())} (kernel pcx vs its own "
           f"crossing states through the torch twin: max rel {own_rel:.2g}); gated kernel (coarse "
           f"{cfg.interp_coarse}, theta {cfg.scan_gate_theta}) vs plain dense scan: "
           f"identical counts {gate_same:.4f}, dense-pass share of steps {fine:.3f}; "
           f"kernel {ms:.3f} ms gated / {ms_dense:.3f} ms dense, plain {plain_ms:.1f} ms")
    if not (frac >= 0.99 and med < 1e-8 and pcx_bad <= 0.01 * int(used.sum())
            and own_rel < 1e-10 and gate_same >= 0.99):
        raise AssertionError("K2 disagrees with its plain version")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase_slice(device, n_events, batch):
    """The main path through the CLI, twice in one process: a cold run (what
    one CLI invocation costs) and a warm run (steady state, under
    torch.profiler, launch counters reset just before it)."""
    import numpy as np
    import torch

    from adiabatic_raytracer_tpu_torch import cli
    from adiabatic_raytracer_tpu_torch.ops import cuda_lib

    def argv(tag):
        return (["--device", "cuda", "--event_batch", str(batch), "--Nts",
                 str(n_events + 1), "--saveMode", "1", "--seed", "1769", "--dir_tag",
                 os.path.join(OUT, "slice"), "--ftag", tag] + SCENE_ARGS)

    t0 = time.time()
    _, _, cold = cli.run_from_args(argv("cold"))
    cold_wall = time.time() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cuda_lib.reset_launch_counts()
        t0 = time.time()
        rows, path, stats = cli.run_from_args(argv("smoke"))
        wall = time.time() - t0
        launches = dict(cuda_lib.LAUNCHES)
    write_profile(prof, wall)
    rows = np.load(path)
    if not (rows.ndim == 2 and rows.shape[1] == 29 and rows.shape[0] > 0):
        raise AssertionError(f"slice output has shape {rows.shape}")
    if not np.all(np.isfinite(rows)) or not np.all(rows[:, 8] > 0):
        raise AssertionError("slice rows not finite or weights not positive")
    if not (launches["line_scan"] > 0 and launches["megakernel"] > 0):
        raise AssertionError(f"main path did not launch every kernel: {launches}")
    if stats.scan_gate == "off":
        raise AssertionError("scan-gate census check did not run")
    log(6, f"slice {stats.events} events, {rows.shape[0]} rows; cold run {cold_wall:.2f} s = "
           f"{cold.events / cold_wall:.1f} events/s (gate check {cold.t_gate:.2f} s, sample "
           f"{cold.t_sample:.2f} s, pipeline {cold.t_pipeline:.2f} s); warm run {wall:.2f} s "
           f"= {stats.events / wall:.1f} events/s (gate check {stats.t_gate:.2f} s, sample "
           f"{stats.t_sample:.2f} s, pipeline {stats.t_pipeline:.2f} s, rows "
           f"{stats.t_rows:.2f} s, tree iterations {stats.tree_iters}); "
           f"scan_gate={stats.scan_gate}; info {stats.info_hist}; launches {launches}")
    return launches


def write_profile(prof, wall):
    """Device busy share and the top operators of the profiled warm run."""
    ka = prof.key_averages()
    rows = sorted(ka, key=lambda e: getattr(e, "self_device_time_total", 0.0), reverse=True)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in ka)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=40))
    top = ", ".join(f"{e.key[:40]} {getattr(e, 'self_device_time_total', 0.0) / 1e3:.1f} ms"
                    f" x{e.count}" for e in rows[:8])
    log(6, f"profile: device busy {busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall "
           f"({100 * busy_us / 1e6 / wall:.1f}% busy, summed kernel time); top: {top}")


def main():
    import torch

    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    k1 = phase_line_scan(device, 16384)
    phase_probe(device)
    k2 = phase_megakernel(device, 2048)
    launches = phase_slice(device, 4096, 2048)
    kernels = [
        {"name": "line_scan", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/line_scan.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/pallas_kernels.py:121",
         "launches": launches["line_scan"], **k1},
        {"name": "megakernel", "route": "cuda",
         "source": "adiabatic_raytracer_tpu_torch/csrc/megakernel.cu",
         "replaces": "adiabatic_raytracer_tpu/ops/megakernel.py:1436",
         "launches": launches["megakernel"], **k2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
