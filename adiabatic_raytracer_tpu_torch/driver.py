"""Top-level driver: the event pipeline (MainRunner.jl:355-765).

Port of adiabatic_raytracer_tpu/driver.py.  Per batch: conversion-surface
sampling -> launch kinematics and importance weights -> axion backtrace ->
forward photon tree -> row assembly and npy output, and at saveMode 2/3 the
reference's event_/final_ text and per-event tree dumps.  Everything up to
row assembly runs as torch on `device` (or on each card of a mesh); row
assembly and file writing are host numpy.  The batch loop keeps
`pipeline_depth` batches in flight between issue and assembly.
checkpoint=True writes a resume state after every batch, in the JAX
package's format, so either package resumes a run the other stopped.

Sampling-attempt accounting reproduces the reference's f_inx bookkeeping
(MainRunner.jl:401,469-477,711-713,749), and the random stream is the JAX
driver's: one split of the carried key per batch, chunk j of a batch drawn
from fold_in(batch_key, j), per-event tree keys fold_in(base_key, event_no).

Precision, as in the JAX package: `precision` ("f64" or "f32", the CLI's
--precision) is the state dtype every tensor of the pipeline carries, the
JAX run with x64 on or off; cfg.compute_dtype "f32" evaluates the physics
(sampler, kinematics, probabilities, the pool's RHS and condition) in f32
under that state, and ships the packs in f32 (driver.py:94-137, 345 of the
reference).  The kernels K2-K4 compute in f64 inside at either state
dtype.  The event weight's ~1e36-1e42 scalar factor (sln_scale) stays one
host f64 float applied at row assembly, beyond any f32 value on the
device; the rows are f64 numpy at either precision.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW
from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer_tpu_torch.ops import sampler, tree
from adiabatic_raytracer_tpu_torch.ops.conversion import dwp_ds, g_det, jacobian_fv
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart, k_sphere
from adiabatic_raytracer_tpu_torch.ops.geometry import cart_to_sph
from adiabatic_raytracer_tpu_torch.ops.propagate import physics_dtype, to_physics
from adiabatic_raytracer_tpu_torch.utils import rng
from adiabatic_raytracer_tpu_torch.utils.npyio import save_npy, tree_filename
from adiabatic_raytracer_tpu_torch.utils.textio import EventFiles, TreeFile


@dataclass
class RunStats:
    seed: int = 0
    events: int = 0
    finals: int = 0
    sample_attempts: int = 0
    f_inx: int = 0
    tot_nodes: int = 0
    tree_iters: int = 0
    info_hist: dict = field(default_factory=dict)
    dw_warnings: int = 0
    wall_time: float = 0.0
    t_sample: float = 0.0     # reading the sampler's chunks back, with any top-up (s)
    t_pipeline: float = 0.0   # kinematics + backtrace + tree to the packs on the host (s)
    t_rows: float = 0.0       # host row assembly (s)
    t_gate: float = 0.0       # per-scene scan-gate census check (s)
    t_text: float = 0.0       # saveMode >= 2 text and tree writers (s)
    t_fetch: float = 0.0      # waiting for a batch's packs at assembly (s)
    t_issue: float = 0.0      # issuing a batch: inputs up, the pipeline's host code (s)
    t_sampd: float = 0.0      # issuing the next batch's primary sampler chunk (s)
    t_gather: float = 0.0     # mesh over a group: gathering the shards' packs, in t_issue (s)
    vns: tuple = (0.0, 0.0, 0.0)
    scan_gate: str = "off"    # "off" | "ok" | "widened" | "fallback_plain" | "unchecked"


def check_ported(cfg: NumericsConfig, *, save_mode: int = 0, mesh_devices: int = 0,
                 pipeline_depth: int = 0, checkpoint: bool = False,
                 resume: bool = False, processes: int = 1):
    """Raise NotImplementedError on options the port does not run, naming
    the ROADMAP item; none of them quietly runs something else.  Every run
    option comes through here, so one that is not ported fails before
    anything runs.  A tree_engine='kernel' configuration K3 does not cover
    raises in tree.forward_tree.  `processes`, the size of the process
    group: a mesh over a group takes one device per process, so a mesh
    larger than the group raises ValueError, naming the missing device."""
    todo = [
        (cfg.engine not in ("pool", "mega", "pool_compact"), f"engine={cfg.engine!r}"),
        (cfg.backtrace_chunk > 0, "backtrace_chunk > 0, K2's chunked relaunch, not ported yet "
         "(ROADMAP Queue 2a, K2's branches still to port)"),
        (cfg.rhs_mode != "hand" or cfg.cond_mode != "fast" or cfg.gate_trig != "precise",
         "rhs_mode='vjp' / cond_mode='canonical' / gate_trig='native', not ported yet "
         "(ROADMAP Queue 2a, K2's branches still to port)"),
    ]
    for bad, what in todo:
        if bad:
            raise NotImplementedError(f"not ported: {what}")
    if processes > 1 and mesh_devices > processes:
        raise ValueError(f"a mesh of {mesh_devices} devices over a group of {processes} "
                         f"processes, one device each: process {processes}'s device is "
                         "missing")


def sln_scale(sc: Scene, maxR, tcfg: TreeConfig) -> float:
    """Scalar factor of the event weight sln_prob (MainRunner.jl:552-558):
    2 pi maxR^2 rho_dm 1e9 / mass_a (1e5)^2 c[km/s] 1e5 n_max_sample."""
    return (2.0 * math.pi * float(maxR) ** 2 * float(sc.rho_dm) * 1e9 / float(sc.mass_a)
            * (1e5 ** 2) * C_KM * 1e5 * float(tcfg.n_max_sample))


def state_dtype(precision: str):
    """The state dtype of --precision: "f64" the JAX run with x64 on, "f32"
    with it off."""
    if precision not in ("f32", "f64"):
        raise ValueError(f"precision must be 'f32' or 'f64', got {precision!r}")
    return torch.float32 if precision == "f32" else torch.float64


def _event_kinematics(xpos, v_loc, erg_inf, sc: Scene, compute_dtype: str = "state"):
    """Launch momentum and per-event weight factor (MainRunner.jl:498-558).
    Returns (k_init, sln_base, cos_w, jac_v) in xpos's dtype; the full
    weight is sln_base * sln_scale(...), applied on the host.
    compute_dtype="f32": evaluated in f32 on the f32 scene (driver.py:104-110
    of the reference)."""
    out_dtype = xpos.dtype
    sc, xpos, v_loc, erg_inf = to_physics(compute_dtype, sc, xpos, v_loc, erg_inf)
    rmag = torch.linalg.norm(xpos, dim=1)
    k_init = k_norm_cart(xpos, v_loc, 0.0, erg_inf, sc, sc.mass_ns,
                         is_photon=True, ax_fix=True, flat=sc.flat)
    ksph = k_sphere(xpos, k_init, sc.mass_ns, flat=sc.flat)
    erg_ax = erg_inf / torch.sqrt(1.0 - 2.0 * G_NEW * sc.mass_ns / rmag / C_KM**2)
    bundle = vmap(lambda x, k, w: dwp_ds(x, k, 0.0, w, sc, sc.mass_ns, flat=sc.flat,
                                         bndry_lyr=sc.bndry_lyr))(xpos, ksph, erg_ax)
    cos_w = bundle[3]
    jac_gr = vmap(lambda x: g_det(x, 0.0, sc, sc.mass_ns, flat=sc.flat,
                                  bndry_lyr=sc.bndry_lyr))(cart_to_sph(xpos))
    jac_v = vmap(lambda x, v: jacobian_fv(x, v, mass_ns=1.0))(xpos, v_loc)
    dense_extra = 2.0 / math.sqrt(math.pi) * (1.0 / (220.0 / C_KM)) * torch.sqrt(
        2.0 * sc.mass_ns * G_NEW / C_KM**2 / rmag)
    redshift = torch.sqrt(1.0 - 2.0 * G_NEW * sc.mass_ns / rmag / C_KM**2)
    sln_base = torch.abs(cos_w) * redshift * dense_extra * jac_gr
    return tuple(a.to(out_dtype) for a in (k_init, sln_base, cos_w, jac_v))


def line_engine_for(device) -> str:
    """The K1 kernel on the card, the plain line scan on the CPU (the
    reference picks Pallas off-CPU the same way)."""
    return "kernel" if torch.device(device).type == "cuda" else "plain"


def packed_sample(key, b, maxR, sc: Scene, cfg: NumericsConfig, n_grid, n_max,
                  flat_sampling: bool, cap: int, dtype=torch.float64):
    """The first min(cap, b) successes of a b-draw chunk, in draw order, as
    [min(cap,b)+1, 11] rows (pos_in_chunk, xpos, v_loc, erg_inf, v_ifty) with
    the chunk's success count in the trailer row (the reference's
    _build_sampler pack), in the sampler's dtype: f32 at compute_dtype f32,
    else the state dtype `dtype`."""
    res = sampler.sample_batch(key, b, maxR, sc, sc.mass_ns, n_grid=n_grid,
                               n_max=n_max, flat_sampling=flat_sampling,
                               compute_dtype=cfg.compute_dtype,
                               line_engine=line_engine_for(key.device), state_dtype=dtype)
    d = res.xpos.dtype
    rows = torch.cat([torch.arange(b, dtype=d, device=key.device)[:, None],
                      res.xpos.to(d), res.v_loc.to(d), res.erg_inf.to(d)[:, None],
                      res.v_ifty.to(d)], dim=1)
    kk = min(cap, b)
    sel = res.success.nonzero().squeeze(1)[:kk]
    pack = torch.zeros((kk + 1, 11), dtype=d, device=key.device)
    pack[: sel.shape[0]] = rows[sel]
    pack[kk, 0] = res.success.sum().to(d)
    return pack


def scan_gate_census_check(sc: Scene, cfg: NumericsConfig, maxR, lnt_end, *,
                           n_events: int = 256, seed: int = 0x5CA9,
                           rel_tol: float = 1e-2, device="cuda", dtype=torch.float64):
    """Per-scene validation of the gated event scan (driver.py:181 of the
    reference): backtrace an n_events conversion-surface ensemble with the
    gate and with the plain dense scan (interp_coarse=0), compare per-event
    crossing counts and times; the ensemble in the state dtype `dtype`.
    Returns (ok, n_mismatch, n_checked)."""
    key = rng.fold_in(rng.PRNGKey(seed, device=device), 1)
    n_grid = sampler.default_n_grid(maxR)
    xs, vs, es = [], [], []
    got = 0
    chunk = max(2048, n_events)
    for _ in range(64):
        key, sub = rng.split(key).unbind(0)
        res = sampler.sample_batch(sub, chunk, maxR, sc, sc.mass_ns, n_grid=n_grid,
                                   compute_dtype=cfg.compute_dtype,
                                   line_engine=line_engine_for(device), state_dtype=dtype)
        ok_i = res.success.nonzero().squeeze(1)
        xs.append(res.xpos[ok_i])
        vs.append(res.v_loc[ok_i])
        es.append(res.erg_inf[ok_i])
        got += int(ok_i.shape[0])
        if got >= n_events:
            break
    if got == 0:
        return True, 0, 0
    n_events = min(n_events, got)
    x = torch.cat(xs)[:n_events].to(dtype)
    v = torch.cat(vs)[:n_events].to(dtype)
    e = torch.cat(es)[:n_events].to(dtype)
    k_init = k_norm_cart(x, v, 0.0, e, sc, sc.mass_ns, is_photon=True, ax_fix=True,
                         flat=sc.flat)
    plain = dataclasses.replace(cfg, interp_coarse=0)
    bt_g = tree.backtrace(x, k_init, e, sc, cfg, TreeConfig(), lnt_end=lnt_end)
    bt_p = tree.backtrace(x, k_init, e, sc, plain, TreeConfig(), lnt_end=lnt_end)
    nc_g = bt_g.raw_n_cross.cpu().numpy().astype(int)
    nc_p = bt_p.raw_n_cross.cpu().numpy().astype(int)
    tc_g = bt_g.raw_tc.cpu().numpy()
    tc_p = bt_p.raw_tc.cpu().numpy()
    bad = 0
    for i in range(n_events):
        if nc_g[i] != nc_p[i]:
            bad += 1
            continue
        tg, tp = tc_g[i, :nc_g[i]], tc_p[i, :nc_p[i]]
        if nc_p[i] and np.any(np.min(np.abs(tg[None, :] - tp[:, None]), axis=1)
                              > rel_tol * np.maximum(np.abs(tp), 1e-30)):
            bad += 1
    return bad == 0, bad, n_events


def _apply_scan_gate_guard(sc: Scene, cfg: NumericsConfig, maxR, lnt_end,
                           stats: RunStats, device,
                           dtype=torch.float64) -> NumericsConfig:
    """Validate the gate on this scene; widen it one notch (coarse x2,
    theta x2) or fall back to the plain 50-point scan on a census mismatch
    (driver.py:257 of the reference)."""
    if not (cfg.engine == "mega" and cfg.scan_gate_check > 0
            and 0 < cfg.interp_coarse < cfg.interp_points):
        return cfg
    n = int(cfg.scan_gate_check)
    ok, n_bad, n_chk = scan_gate_census_check(sc, cfg, maxR, lnt_end, n_events=n,
                                              device=device, dtype=dtype)
    if n_chk == 0:
        stats.scan_gate = "unchecked"
        return cfg
    if ok:
        stats.scan_gate = "ok"
        return cfg
    wide = dataclasses.replace(
        cfg, interp_coarse=min(2 * cfg.interp_coarse, cfg.interp_points - 1),
        scan_gate_theta=2.0 * float(cfg.scan_gate_theta))
    ok_w, n_bad_w, n_chk_w = scan_gate_census_check(sc, wide, maxR, lnt_end,
                                                    n_events=n, device=device, dtype=dtype)
    if ok_w and n_chk_w > 0:
        stats.scan_gate = "widened"
        print(f"NOTE: gated event scan missed crossings on this scene "
              f"({n_bad}/{n_chk} events) — widened to coarse={wide.interp_coarse}, "
              f"theta={float(wide.scan_gate_theta):g} (census clean)")
        return wide
    stats.scan_gate = "fallback_plain"
    print(f"WARNING: gated event scan missed crossings on this scene even widened "
          f"({n_bad}/{n_chk} default, {n_bad_w}/{n_chk_w} widened) — falling back "
          f"to the plain {cfg.interp_points}-point scan for this run")
    return dataclasses.replace(cfg, interp_coarse=0)


def pipeline(keys, xpos, v_loc, erg_inf, sc: Scene, cfg: NumericsConfig,
             tcfg: TreeConfig, maxR, lnt_end):
    """Kinematics -> backtrace -> forward tree for one batch.  Returns the
    finals pack [cap+1, 14], the per-event pack [E, 12] (the reference's
    combined pack without its padding), the backtrace result and the tree's
    pools (the last two for the saveMode >= 2 writers).  The packs are f32
    at compute_dtype f32, else in the state dtype (driver.py:345 of the
    reference)."""
    E = xpos.shape[0]
    k_init, sln_base, cos_w, _ = _event_kinematics(xpos, v_loc, erg_inf, sc, cfg.compute_dtype)
    bt = tree.backtrace(xpos, k_init, erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
    tr = tree.forward_tree(keys, xpos, k_init, erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
    d = physics_dtype(cfg.compute_dtype, xpos.dtype)
    fin = tree.compact_finals_global(tr.pools, cfg.finals_cap_per_event * E, out_dtype=d,
                                     order_stride=2 * tcfg.max_nodes + 4)
    one = lambda a: a.to(d)[:, None]
    ev = torch.cat([one(sln_base), one(cos_w), one(tr.count), one(tr.info),
                    one(tr.dw_anomalies), one(bt.samp_back_weight), one(bt.prob0),
                    one(bt.c_bck), k_init.to(d), one(tr.n_iters)], dim=1)
    return fin, ev, bt, tr.pools


def vns_spherical(v_ns):
    """Spherical decomposition of the NS velocity (MainRunner.jl:418-421)."""
    v = np.asarray(v_ns, np.float64)
    mag = float(np.sqrt(np.sum(v**2)))
    if mag > 0:
        return mag, float(np.arccos(v[2] / mag)), float(np.arctan2(v[1], v[0]))
    return mag, 0.0, 0.0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _ckpt_paths(out_path: str):
    d, base = os.path.split(out_path)
    return (os.path.join(d, f".ckpt_{base}.json"),
            os.path.join(d, f".ckpt_{base}.partial.npy"))


def _write_checkpoint(out_path: str, key, succ_rate, event_no, remaining,
                      stats: RunStats, rows):
    """The resume state after a batch (driver.py:414-436 of the reference, in
    its format): the carried key as a list of uint32, the sampler's success
    estimate, the event counter and the accounting in JSON, the partial rows
    in a sibling .npy."""
    jpath, npath = _ckpt_paths(out_path)
    os.makedirs(os.path.dirname(jpath) or ".", exist_ok=True)
    if rows:
        np.save(npath, np.concatenate(rows, axis=0))
    state = {
        "key": rng.key_to_jax(key).tolist(),
        "succ_rate": succ_rate,
        "event_no": event_no,
        "remaining": remaining,
        "stats": {k: v for k, v in dataclasses.asdict(stats).items() if k != "info_hist"},
        "info_hist": {str(k): v for k, v in stats.info_hist.items()},
        "has_rows": bool(rows),
    }
    with open(jpath + ".tmp", "w") as f:
        json.dump(state, f)
    os.replace(jpath + ".tmp", jpath)


def _load_checkpoint(out_path: str, stats: RunStats):
    """The resume state next to out_path, written by either package, or None:
    (key, succ_rate, event_no, remaining, rows).  Sets the fields of `stats`
    the port has and ignores the reference's other timers."""
    jpath, npath = _ckpt_paths(out_path)
    if not os.path.exists(jpath):
        return None
    with open(jpath) as f:
        state = json.load(f)
    names = {f.name for f in dataclasses.fields(RunStats)} - {"info_hist"}
    for k, v in state["stats"].items():
        if k in names:
            setattr(stats, k, v)
    stats.info_hist = {int(k): v for k, v in state["info_hist"].items()}
    rows = [np.load(npath)] if state.get("has_rows") and os.path.exists(npath) else []
    return (rng.key_from_jax(state["key"]), state["succ_rate"], state["event_no"],
            state["remaining"], rows)


def _clear_checkpoint(out_path: str):
    for p in _ckpt_paths(out_path):
        if os.path.exists(p):
            os.remove(p)


def _agree_on_run(seed: int, drawn: int, run_args: dict) -> int:
    """The seed of a run over a process group: process 0's, drawn there at
    seed <= 0.  Raises ValueError on every process, before anything runs,
    when a process was given another positive seed or other run
    parameters than process 0's."""
    from adiabatic_raytracer_tpu_torch.parallel.mesh import gather_objects

    got = gather_objects((seed, drawn, run_args))
    run_seed, first = got[0][1], got[0][2]
    for p, (given, _, args) in enumerate(got):
        if given > 0 and given != run_seed:
            raise ValueError(f"a run over the process group takes process 0's seed "
                             f"{run_seed}; process {p} was given seed {given}")
        diff = sorted(k for k in first if args.get(k) != first[k])
        if diff:
            raise ValueError(f"a run over the process group takes one set of run "
                             f"parameters; process {p}'s {', '.join(diff)} differ from "
                             "process 0's")
    return run_seed


def _host(nt, names):
    """The named fields of a result tuple as numpy, one copy each."""
    return {n: getattr(nt, n).cpu().numpy() for n in names}


def _write_text(ev_files: EventFiles, save_mode: int, dir_tag: str, file_tag: str,
                event_no: int, t_event: float, bt, pools, ev: dict, fin: dict):
    """One batch's event_/final_ lines and, at saveMode 3, its tree_ files
    (driver.py:803-858 of the reference).  The event head carries the
    incoming axion, the backtrace's endpoint (nb.x[end], nb.kx[end],
    MainRunner.jl:600-607); a tree file holds the backtraced axion, then the
    processed nodes in processing order."""
    batch = ev["count"].shape[0]
    b = _host(bt, ("x_end", "k_end") + (("raw_n_cross", "weight", "prob0", "xc", "raw_tc",
                                          "traj", "times") if save_mode > 2 else ()))
    if save_mode > 2:
        p = _host(pools, ("order", "status", "has_cross", "is_photon", "weight", "prob",
                          "parent_weight", "xc", "tcx", "traj", "times"))
    fstart = np.searchsorted(fin["e_ids"], np.arange(batch))
    fend = np.searchsorted(fin["e_ids"], np.arange(batch), side="right")
    for e in range(batch):
        en = event_no + e
        ev_files.write_event_head(en, ev["v_ifty"][e], float(ev["sln"][e]), b["x_end"][e],
                                  b["k_end"][e], ev["xpos"][e], ev["k_init"][e])
        if save_mode > 2:
            tree_f = TreeFile(dir_tag, file_tag, en)
            nraw = int(b["raw_n_cross"][e])
            cross = (dict(xc=b["xc"][e, :nraw, 0], yc=b["xc"][e, :nraw, 1],
                          zc=b["xc"][e, :nraw, 2], tc=b["raw_tc"][e, :nraw]) if nraw else {})
            tree_f.save_node("axion", float(b["weight"][e]), float(b["prob0"][e]), 1.0,
                             traj=b["traj"][e], times=b["times"][e], **cross)
            proc = np.nonzero(p["status"][e] == 2)[0]
            proc = proc[np.argsort(p["order"][e][proc], kind="stable")]
            for q in proc:
                cross = (dict(xc=[p["xc"][e, q, 0]], yc=[p["xc"][e, q, 1]],
                              zc=[p["xc"][e, q, 2]], tc=[p["tcx"][e, q]])
                         if p["has_cross"][e, q] else {})
                tree_f.save_node("photon" if p["is_photon"][e, q] else "axion",
                                 float(p["weight"][e, q]), float(p["prob"][e, q]),
                                 float(p["parent_weight"][e, q]), traj=p["traj"][e, q],
                                 times=p["times"][e, q], **cross)
            tree_f.close()
        for j in range(fstart[e], fend[e]):
            ev_files.write_final(en, float(fin["weight"][j]), int(fin["species"][j]),
                                 float(fin["theta_f"][j]), float(fin["phi_f"][j]),
                                 float(fin["absf"][j]), float(fin["theta_fx"][j]),
                                 float(fin["phi_fx"][j]), float(fin["absfx"][j]),
                                 float(fin["t"][j]))
        ev_files.write_event_tail(t_event, int(ev["count"][e]))


def _to_host(t: torch.Tensor):
    """Start t's copy to the host: on the card into pinned memory with
    non_blocking=True, behind an event; (host tensor, event or None)."""
    if t.device.type != "cuda":
        return t, None
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return h, ev


def _from_host(handle) -> np.ndarray:
    """The numpy array of a _to_host copy, once the copy has landed."""
    h, ev = handle
    if ev is not None:
        ev.synchronize()
    return h.numpy()


def run(sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, n_trajs: int, *,
        seed: int = -1, save_mode: int = 0, file_tag: str = "",
        dir_tag: str = "results", event_batch: int = 16, fix_time: float = 0.0,
        ntimes: int = 3, verbose: bool = True, mesh_devices: int = 0,
        checkpoint: bool = False, resume: bool = False,
        max_batches: Optional[int] = None, profile_dir: Optional[str] = None,
        pipeline_depth: int = 0, device="cuda", precision: str = "f64") -> Optional[tuple]:
    """Run the pipeline on `device` (the card unless the caller asks for the
    CPU); returns (rows, output path, stats), or None when the conversion
    surface lies inside the star (MainRunner.jl:389-396).  `device` is used
    as given: "cuda" without a card raises.

    save_mode 2/3 also writes <dir_tag>/event/event_<file_tag> and final_,
    and at 3 one <dir_tag>/tree/tree_<file_tag><event> per event.
    checkpoint=True writes the resume state next to the output file after
    every batch; resume=True continues from it with the same random stream,
    appending to the text streams.  max_batches stops early: the checkpoint
    stays, and the npy is written only when the run completes.

    pipeline_depth: batches issued but not yet assembled (0, auto, is 1).
    At depth 2 batch i+1 is sampled and its pipeline issued before batch i's
    packs are read back (copied to pinned memory behind an event) and its
    rows assembled; batch i+1's primary sampler chunk is issued before batch
    i's pipeline at every depth.  Rows, text files and checkpoints are
    bitwise those of depth 1.

    mesh_devices > 1 shards each batch over a mesh (parallel/mesh.py): on
    cuda the first mesh_devices cards (fewer raises), on cpu virtual shards.
    The batch is padded to a multiple of the mesh with copies of its last
    event, keys come from global event numbers, each shard runs the pipeline
    on its device, and the padding's rows are dropped; engine pool_compact
    runs as pool there.  profile_dir: a torch.profiler trace of the run is
    written there, one per process (p<rank>).

    Under a torch.distributed group the mesh spans the group, one device per
    process (parallel/mesh.make_mesh), and every process of the group calls
    run with the same arguments: one run over the group.  Its seed is
    process 0's (drawn there at seed <= 0); a process given another positive
    seed, or other run parameters, raises on every process before anything
    runs.  Process 0 runs the scan-gate census, samples every batch and
    reads the checkpoint, and sends each result to the group; each process
    runs its own shards, every shard's packs are gathered, and every process
    assembles the same rows and returns them.  Only process 0 writes files
    (the npy, the text and tree files, the checkpoint).  mesh_devices <= 1
    under a group runs this process's own run, the reference's fan-out.

    precision: the state dtype of every tensor of the pipeline, "f64" or
    "f32" (the JAX CLI's --precision: x64 on or off).  Rows are f64 numpy
    either way."""
    from adiabatic_raytracer_tpu_torch.parallel import mesh as pmesh

    check_ported(cfg, save_mode=save_mode, mesh_devices=mesh_devices,
                 pipeline_depth=pipeline_depth, checkpoint=checkpoint, resume=resume,
                 processes=pmesh.process_count())
    dtype = state_dtype(precision)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is false")
    n_sh = int(mesh_devices) if mesh_devices and mesh_devices > 1 else 1
    mesh = pmesh.make_mesh(n_sh, device) if n_sh > 1 else [device]
    group = pmesh.spans_group(mesh)
    device = pmesh.home_device(mesh)
    # the process that runs the census, samples, and reads and writes the files
    lead = not group or pmesh.process_index() == 0
    run_args = dict(scene=sc, numerics=cfg, tree=tcfg, n_trajs=n_trajs, save_mode=save_mode,
                    event_batch=event_batch, fix_time=fix_time, ntimes=ntimes,
                    mesh_devices=n_sh, checkpoint=checkpoint, resume=resume,
                    max_batches=max_batches, pipeline_depth=pipeline_depth,
                    precision=precision, device=device.type)
    if save_mode > 1 and cfg.tree_engine == "kernel":
        # the dumps need every node's records, which K3 keeps for the finals
        # only: the reference's recorded choice (driver.py:492-505 there)
        cfg = dataclasses.replace(cfg, tree_engine="queue")
        if verbose:
            print("saveMode >= 2 writes every node's records: tree_engine kernel -> queue")
    if n_sh > 1 and cfg.engine == "pool_compact":
        # the compacted backtrace runs on one device (driver.py:319 of the reference)
        cfg = dataclasses.replace(cfg, engine="pool")
        if verbose:
            print("a mesh runs engine pool_compact as pool")
    depth = max(int(pipeline_depth), 1)
    t_run0 = time.time()
    stats = RunStats()
    if seed < 0:
        stats.seed = int(np.random.randint(0, 100000001))
    elif seed == 0:
        stats.seed = int(np.random.SeedSequence().entropy % (2**31))
    else:
        stats.seed = seed
    if group:
        stats.seed = _agree_on_run(seed, stats.seed, run_args)

    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul,
                                           sc.b0, sc.r_ns, t_in=fix_time))
    if maxR < float(sc.r_ns):
        print("Too small Max R.... quitting....")
        return None
    lnt_end = float(np.log(1.0 / float(sc.omega_pul)))
    n_grid = sampler.default_n_grid(maxR)
    out_path = tree_filename(dir_tag, sc.mass_a, sc.ax_g, sc.theta_m, sc.omega_pul,
                             sc.b0, n_trajs, ntimes, tcfg.num_cutoff, tcfg.mc_nodes,
                             tcfg.max_nodes, file_tag)

    rows: list = []
    event_no = 1
    remaining = n_trajs - 1   # the reference loop runs while photon_trajs < Ntajs
    succ_rate = 0.25
    key = rng.PRNGKey(stats.seed, device=device)
    ck = None
    if resume and group:    # process 0's checkpoint, its state sent to every process
        ck, st = pmesh.run_on_first(lambda: (_load_checkpoint(out_path, stats),
                                             dataclasses.asdict(stats)))
        for k, v in st.items():
            setattr(stats, k, v)
    elif resume:
        ck = _load_checkpoint(out_path, stats)
    if ck is not None:
        key, succ_rate, event_no, remaining, rows = ck
        key = key.to(device)
        if verbose:
            print(f"Resuming at event {event_no} ({remaining} remaining)")
    if verbose:
        print(f"Using seed {stats.seed}")
    t_g0 = time.time()
    if group:   # process 0's census verdict runs on every process
        cfg, stats.scan_gate = pmesh.run_on_first(lambda: (
            _apply_scan_gate_guard(sc, cfg, maxR, lnt_end, stats, device, dtype),
            stats.scan_gate))
    else:
        cfg = _apply_scan_gate_guard(sc, cfg, maxR, lnt_end, stats, device, dtype)
    _sync(device)
    stats.t_gate += time.time() - t_g0

    base_key = rng.PRNGKey(stats.seed, device=device)
    stats.vns = vns_spherical(sc.v_ns)
    scale = sln_scale(sc, maxR, tcfg)
    ev_files = (EventFiles(dir_tag, file_tag, append=ck is not None)
                if save_mode > 1 and lead else None)
    batches_done = 0
    batches_issued = 0
    issue_event_no = event_no
    issue_remaining = remaining

    def chunk(bkey, j, sb):
        return _to_host(packed_sample(rng.fold_in(bkey, j), sb, maxR, sc, cfg, n_grid,
                                      tcfg.n_max_sample, tcfg.flat_sampling,
                                      int(event_batch), dtype))

    def sample_dispatch(batch):
        """Split the carried key for the next batch and issue its primary
        chunk, sized for `batch` events at the current success rate."""
        nonlocal key
        t0 = time.time()
        key, bkey = rng.split(key).unbind(0)
        sb = 1 << max(int(batch / max(succ_rate, 0.02) * 1.5) - 1, 7).bit_length()
        pk = chunk(bkey, 0, sb)
        stats.t_sampd += time.time() - t0
        return {"bkey": bkey, "sb": sb, "pk": pk}

    def sample_collect(s, batch):
        """Read the primary chunk back; top up chunk by chunk on a shortfall
        (chunk j draws from fold_in(batch_key, j))."""
        nonlocal succ_rate
        t0 = time.time()
        xs, kept_pos = [], []
        got, chunk_off, j = 0, 0, 0
        pk, sb = s["pk"], s["sb"]
        while True:
            p = _from_host(pk)
            n_succ = int(p[-1, 0])
            succ_rate = max(0.5 * succ_rate + 0.5 * n_succ / sb, 0.02)
            take = min(n_succ, batch - got)
            xs.append(p[:take, 1:])
            kept_pos.append(chunk_off + p[:take, 0].astype(np.int64))
            chunk_off += sb
            got += take
            if got >= batch:
                break
            if chunk_off > 8_000_000 and got * 1_000_000 < chunk_off:
                raise RuntimeError(
                    f"conversion-surface sampler produced {got} valid events in "
                    f"{chunk_off} draws — check the scene parameters (mass_a/B0/"
                    f"omega_pul place the surface at maxR={maxR:.3g})")
            j += 1
            sb = 1 << max(int((batch - got) / max(succ_rate, 0.02) * 1.3) - 1,
                          7).bit_length()
            pk = chunk(s["bkey"], j, sb)
        attempts = int(np.concatenate(kept_pos)[batch - 1]) + 1
        samp = np.concatenate(xs, axis=0).astype(np.float64)
        return samp, attempts, time.time() - t0

    samp_next = None

    def sample_next(batch):
        """This batch's samples, then the next batch's primary chunk issued
        (the first batch's own primary chunk on the first call)."""
        nonlocal samp_next
        if samp_next is None:
            samp_next = sample_dispatch(batch)
        samp, attempts, t_sample = sample_collect(samp_next, batch)
        rng_snap = (key, succ_rate)
        # the next batch's primary chunk goes ahead of this batch's pipeline
        left = issue_remaining - batch
        samp_next = (sample_dispatch(min(event_batch, left))
                     if left > 0 and (max_batches is None or batches_issued + 1 < max_batches)
                     else None)
        return samp, attempts, t_sample, rng_snap

    def shard_pipeline(keys, xpos, v_loc, erg_inf):
        fin_t, ev_t, bt, pl = pipeline(keys, xpos, v_loc, erg_inf, sc, cfg, tcfg, maxR, lnt_end)
        return (fin_t, ev_t) + ((bt, pl) if save_mode > 1 else (None, None))

    # one shard after another from this thread (parallel/mesh.py); a single
    # device is a mesh of one; on a mesh over a group, this process's shards
    run_shards = pmesh.shard_over_events(mesh, shard_pipeline)
    t_gather0 = stats.t_gather    # a resumed run's gathers before the stop

    def issue_batch(samp, batch, attempts, t_sample, rng_snap):
        """Run one batch's pipeline over the mesh (its host code, which waits
        on the card where it reads from it) and start its packs' copies to
        the host."""
        nonlocal issue_event_no, issue_remaining, batches_issued
        t0 = time.time()
        bp = -(-batch // n_sh) * n_sh
        pad = (lambda a: a) if bp == batch else (
            lambda a: np.concatenate([a] + [a[-1:]] * (bp - batch), axis=0))
        tens = lambda a: torch.as_tensor(np.ascontiguousarray(pad(a)), dtype=dtype,
                                         device=device)
        keys = rng.fold_in(base_key, torch.arange(bp, device=device) + issue_event_no)
        fin_t, ev_t, bt, pl = run_shards(keys, tens(samp[:, 0:3]), tens(samp[:, 3:6]),
                                         tens(samp[:, 6]))
        t_issue = time.time() - t0
        stats.t_issue += t_issue
        stats.t_gather = t_gather0 + run_shards.t_gather
        rec = {"batch": batch, "event_no": issue_event_no, "packs": (fin_t, ev_t),
               "host": (_to_host(fin_t), _to_host(ev_t)), "bt": bt, "pools": pl,
               "xpos": samp[:, 0:3], "v_ifty": samp[:, 7:10], "attempts": attempts,
               "t_sample": t_sample, "t_issue": t_issue, "rng_after": rng_snap}
        issue_event_no += batch
        issue_remaining -= batch
        batches_issued += 1
        return rec

    def assemble(rec):
        """Read one batch's packs back, assemble its rows (MainRunner.jl:
        670-729), write its text, apply its sampling accounting, checkpoint."""
        nonlocal event_no, remaining, batches_done
        batch = rec["batch"]
        if rec["event_no"] != event_no:
            raise RuntimeError(f"batch of event {rec['event_no']} assembled at {event_no}")
        stats.sample_attempts += rec["attempts"]
        stats.f_inx += rec["attempts"] - batch
        stats.t_sample += rec["t_sample"]
        t1 = time.time()
        fp_all, evp_all = (_from_host(h) for h in rec["host"])
        t_fetch = time.time() - t1
        stats.t_fetch += t_fetch
        t_batch = rec["t_issue"] + t_fetch
        stats.t_pipeline += t_batch

        # --- host row assembly (MainRunner.jl:670-729), in f64 whatever the
        # packs' dtype: f32 * sln_scale would overflow to inf ---
        t2 = time.time()
        # the finals pack holds one [cap+1, 14] block per shard, with the
        # shard's local event indices and its count in the trailer row; mesh
        # padding duplicates (event index >= batch) are dropped
        blk = fp_all.shape[0] // n_sh
        shard_e = evp_all.shape[0] // n_sh
        fins = []
        for s in range(n_sh):
            fp = fp_all[s * blk:(s + 1) * blk]
            cap = blk - 1
            cnt = int(fp[cap, 0])
            if cnt > cap:
                raise RuntimeError(f"finals pack overflow: {cnt} finals exceed the "
                                   f"{cap}-row capacity — raise "
                                   "NumericsConfig.finals_cap_per_event")
            f = np.array(fp[:cnt], np.float64)
            f[:, 0] += s * shard_e
            fins.append(f)
        fin = np.concatenate(fins, axis=0)
        fin = fin[fin[:, 0] < batch]
        evp = evp_all[:batch].astype(np.float64)
        stats.tree_iters += int(evp[:, 11].max())
        xpos_np, v_ifty = rec["xpos"], rec["v_ifty"]
        sln_np = evp[:, 0] * scale
        cosw_np = evp[:, 1]
        count_np = evp[:, 2].astype(np.int64)
        info_np = evp[:, 3].astype(np.int64)
        sbw_ev = evp[:, 5]
        bt_prob0 = evp[:, 6]
        bt_c_bck = evp[:, 7].astype(np.int64)
        k_init_np = evp[:, 8:11]
        stats.tot_nodes += int(count_np.sum())
        stats.dw_warnings += int(evp[:, 4].sum())
        for iv, c in zip(*np.unique(info_np, return_counts=True)):
            stats.info_hist[int(iv)] = stats.info_hist.get(int(iv), 0) + int(c)

        e_ids = fin[:, 0].astype(np.int64)
        nfin = len(e_ids)
        species_id = fin[:, 1]
        fpos = fin[:, 8:11]
        fmom = fin[:, 11:14]
        absf = np.linalg.norm(fmom, axis=1)
        absfx = np.linalg.norm(fpos, axis=1)
        theta_f, phi_f = np.arccos(fmom[:, 2] / absf), np.arctan2(fmom[:, 1], fmom[:, 0])
        theta_fx, phi_fx = np.arccos(fpos[:, 2] / absfx), np.arctan2(fpos[:, 1], fpos[:, 0])
        weight = fin[:, 3] * sbw_ev[e_ids]                   # MainRunner.jl:686
        optical_depth = np.zeros(nfin)
        weight_c = np.ones(nfin)
        weight_tmp = weight * (weight_c**2 * np.exp(-optical_depth))
        vel_eng = np.sum(v_ifty**2, axis=1) / 2.0
        base = np.stack([
            (event_no + e_ids).astype(np.float64), species_id, theta_f, phi_f, theta_fx,
            phi_fx, absfx, sln_np[e_ids], weight_tmp, xpos_np[e_ids, 0], xpos_np[e_ids, 1],
            xpos_np[e_ids, 2], fin[:, 2] / float(sc.mass_a) + vel_eng[e_ids]], axis=1)
        if save_mode > 0:
            extra = np.stack([
                weight, optical_depth, weight_c, k_init_np[e_ids, 0],
                k_init_np[e_ids, 1], k_init_np[e_ids, 2], cosw_np[e_ids],
                count_np[e_ids].astype(np.float64), info_np[e_ids].astype(np.float64),
                fin[:, 4], fin[:, 5], fin[:, 6], sbw_ev[e_ids], absfx,
                bt_c_bck[e_ids].astype(np.float64), bt_prob0[e_ids]], axis=1)
            base = np.concatenate([base, extra], axis=1)
        if nfin:
            rows.append(base)
        stats.f_inx += int((species_id == 1).sum())          # MainRunner.jl:711-713
        stats.finals += nfin
        stats.t_rows += time.time() - t2

        if save_mode > 1 and lead:
            t3 = time.time()
            _write_text(ev_files, save_mode, dir_tag, file_tag, event_no, t_batch / batch,
                        rec["bt"], rec["pools"],
                        dict(v_ifty=v_ifty, sln=sln_np, xpos=xpos_np, k_init=k_init_np,
                             count=count_np),
                        dict(e_ids=e_ids, weight=weight, species=species_id.astype(np.int64),
                             theta_f=theta_f, phi_f=phi_f, absf=absf, theta_fx=theta_fx,
                             phi_fx=phi_fx, absfx=absfx, t=fin[:, 7]))
            stats.t_text += time.time() - t3
        event_no += batch
        stats.events += batch
        remaining -= batch
        batches_done += 1
        if checkpoint and lead:
            ck_key, ck_rate = rec["rng_after"]
            _write_checkpoint(out_path, ck_key, ck_rate, event_no, remaining, stats, rows)

    prof = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    # The batch loop (driver.py:575-628 of the reference).  RNG: each batch
    # takes one split of the carried key and chunk j of a batch draws from
    # fold_in(batch_key, j), so how issues interleave changes no draw; the
    # checkpoint after batch i stores the (key, succ_rate) of right after
    # batch i's collect, the state batch i+1's sampling starts from.  On a
    # mesh over a group process 0 samples and sends each batch's samples
    # (and that state) to every process.
    inflight: deque = deque()
    try:
        while issue_remaining > 0 or inflight:
            nxt = None
            if issue_remaining > 0 and (max_batches is None or batches_issued < max_batches):
                try:
                    batch = min(event_batch, issue_remaining)
                    t0 = time.time()
                    samp, attempts, t_sample, rng_snap = (
                        pmesh.run_on_first(lambda: sample_next(batch)) if group
                        else sample_next(batch))
                    if not lead:
                        t_sample = time.time() - t0
                    nxt = issue_batch(samp, batch, attempts, t_sample, rng_snap)
                except Exception:
                    # a failure while sampling or issuing keeps the batches in
                    # flight: assemble (and checkpoint) them, then raise
                    while inflight:
                        assemble(inflight.popleft())
                    raise
            if nxt is not None:
                inflight.append(nxt)
            while len(inflight) > depth or (nxt is None and inflight):
                assemble(inflight.popleft())
            if nxt is None and issue_remaining > 0:
                break
    finally:
        if prof is not None:
            prof.stop()
            trace = os.path.join(profile_dir, f"trace_{file_tag or 'run'}_"
                                              f"p{pmesh.process_index()}.json")
            prof.export_chrome_trace(trace)
            if verbose:
                print(f"profile -> {trace}")

    _sync(device)
    save_all = (np.concatenate(rows, axis=0).astype(np.float64) if rows
                else np.zeros((0,)))
    if remaining > 0:
        if verbose:
            print(f"Stopping after {batches_done} batches ({remaining} events remaining; "
                  f"checkpoint {'written' if checkpoint else 'NOT written'})")
        stats.wall_time = time.time() - t_run0
        return save_all, out_path, stats
    if save_all.size:
        save_all[:, 7] /= float(stats.f_inx) if stats.f_inx else 1.0
    if lead:
        save_npy(out_path, save_all)
        _clear_checkpoint(out_path)
    stats.wall_time = time.time() - t_run0
    if verbose:
        print(f"events={stats.events} finals={stats.finals} f_inx={stats.f_inx} "
              f"nodes={stats.tot_nodes} info={stats.info_hist} "
              f"wall={stats.wall_time:.1f}s (gate {stats.t_gate:.1f} sample "
              f"{stats.t_sample:.1f} pipe {stats.t_pipeline:.1f} fetch {stats.t_fetch:.1f} "
              f"rows {stats.t_rows:.1f} issue {stats.t_issue:.1f} sampd {stats.t_sampd:.1f} "
              f"text {stats.t_text:.1f}" + (f" gather {stats.t_gather:.1f}" if group else "")
              + f") -> {out_path}")
    return save_all, out_path, stats
