"""Event-axis sharding over cards, and process groups.

Port of adiabatic_raytracer_tpu/parallel/mesh.py.  The reference scales by
forking N independent processes and merging npy files (runner_example.sh,
combine_files); the JAX package shards the event axis over a device mesh with
shard_map.  Here a mesh is a list of torch devices: `make_mesh(n, "cuda")`
the first n cards (raising when there are fewer), `make_mesh(n, "cpu")` n
virtual shards on the one CPU device, the counterpart of the JAX tests' 8
virtual CPU devices.  `shard_over_events` is the one sharding loop: the
driver runs each batch through it (a single device is a mesh of one), and
`event_pipeline_sharded` is built on it.  Each shard runs the unchanged
per-batch pipeline on its own slice of events and device, one shard after
another from the host thread.  The pipeline's host code waits on its card
where it reads from it, so a mesh of N cards does about the work of one:
a scan spreads over cards as processes (`init_distributed`, the CLI's
--coordinator), one card each.  The driver's per-event RNG keys come from
global event numbers, so rows do not depend on the mesh.

Processes form a torch.distributed group over gloo (`init_distributed`, the
counterpart of jax.distributed and of the reference's SLURM fan-out,
runner_GR_tasks.sh).  The sharded pipeline needs no collective on device
tensors; the only reduction is the two pulse-profile histograms, summed over
the group on the CPU (`all_reduce_sum`).
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.parallel.reduce import pulse_profile_from_pools


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the process group at tcp://<coordinator> (host:port) as rank
    process_id of num_processes, over gloo.  A no-op when the group already
    exists, or when no argument is given and the environment names no group
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torchrun sets them).
    A group that fails to form raises.  Returns whether a group exists."""
    if dist.is_initialized():
        return True
    if coordinator is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                             "RANK")):
            return False
        dist.init_process_group("gloo", init_method="env://")
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number of processes "
                         f"and this process's id (got {coordinator!r}, {num_processes!r}, "
                         f"{process_id!r})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def process_group_exists() -> bool:
    return dist.is_initialized()


def leave_group():
    """Leave the process group (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_reduce_sum(*tensors):
    """Each tensor summed over the process group (itself without a group);
    the sum runs on CPU copies (gloo), the results come back on each
    tensor's device."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tensors
    out = []
    for t in tensors:
        c = t.detach().to("cpu", copy=True)
        dist.all_reduce(c, op=dist.ReduceOp.SUM)
        out.append(c.to(t.device))
    return tuple(out)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """The mesh's devices: on cuda the first n cards (all by default; fewer
    cards than n raises), on cpu n virtual shards of the CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if have < n:
            raise RuntimeError(f"a mesh of {n} cards needs {n} CUDA devices; "
                               f"torch.cuda.device_count() is {have}, so card cuda:{have} "
                               "is missing")
        return [torch.device("cuda", i) for i in range(n)]
    if n_devices is None:
        raise ValueError("a CPU mesh needs its number of virtual shards")
    return [torch.device("cpu")] * int(n_devices)


def device_context(dev):
    """The device context a shard's work runs in (kernels launch on the
    current card)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def concat_events(parts, device):
    """Concatenate shard results along the event axis: tensors, named
    tuples of them (recursively) and None."""
    first = parts[0]
    if len(parts) == 1 or first is None:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts], dim=0)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(concat_events([getattr(p, f) for p in parts], device)
                             for f in first._fields))
    if isinstance(first, tuple):
        return tuple(concat_events([p[i] for p in parts], device) for i in range(len(first)))
    raise TypeError(f"cannot concatenate shard results of type {type(first)}")


def shard_over_events(mesh: list, fn):
    """fn(*args) with every argument and output event-major [E, ...]: the
    wrapped function splits E (a multiple of the mesh size) into one
    contiguous slice per shard, runs fn on each shard's device, and
    concatenates the outputs on the first shard's device (a mesh of one
    returns fn's outputs as they are).  The shards run one after another.
    RNG must already be carried per event for the result to be
    mesh-size-invariant."""
    n = len(mesh)

    def sharded(*args):
        E = args[0].shape[0]
        if E % n:
            raise ValueError(f"{E} events do not split over a mesh of {n}")
        m = E // n
        outs = []
        for s, dev in enumerate(mesh):
            with device_context(dev):
                outs.append(fn(*(a[s * m:(s + 1) * m].to(dev) for a in args)))
        return concat_events(outs, mesh[0])

    return sharded


class ShardedPipelineResult(NamedTuple):
    k_init: torch.Tensor
    sln_base: torch.Tensor
    cos_w: torch.Tensor
    bt: tuple            # tree.BacktraceResult
    tr: tuple            # tree.TreeResult
    hists: tuple         # (photon_hist, axion_hist), summed over shards and processes


def event_pipeline_sharded(mesh: list, sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, *,
                           maxR, lnt_end, nbins: int = 50):
    """The per-batch event pipeline sharded over the mesh: returns
    fn(seeds [E] int, xpos [E,3], v_loc [E,3], erg_inf [E]) ->
    ShardedPipelineResult.  E must divide over the mesh; each event's tree
    key is PRNGKey(seed), as in the JAX package's function (the driver
    folds the global event number into the run's key instead), so the
    draws do not depend on the mesh.  The
    histograms are in sln_base units: multiply by driver.sln_scale for the
    reference's pps."""
    from adiabatic_raytracer_tpu_torch.driver import _event_kinematics
    from adiabatic_raytracer_tpu_torch.ops import tree

    def local(seeds, xpos, v_loc, erg_inf):
        k_init, sln_base, cos_w, _ = _event_kinematics(xpos, v_loc, erg_inf, sc)
        bt = tree.backtrace(xpos, k_init, erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
        s = seeds.to(torch.int64)    # PRNGKey(seed) per event: the seed's two 32-bit words
        keys = torch.stack([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], dim=-1)
        tr = tree.forward_tree(keys, xpos, k_init, erg_inf, sc, cfg, tcfg, lnt_end=lnt_end)
        h = pulse_profile_from_pools(tr.pools, bt.samp_back_weight, sln_base, nbins=nbins)
        return k_init, sln_base, cos_w, bt, tr, (h[0][None], h[1][None])

    sharded = shard_over_events(mesh, local)

    def fn(seeds, xpos, v_loc, erg_inf):
        k_init, sln_base, cos_w, bt, tr, (h_ph, h_ax) = sharded(seeds, xpos, v_loc, erg_inf)
        hists = all_reduce_sum(h_ph.sum(dim=0), h_ax.sum(dim=0))
        return ShardedPipelineResult(k_init, sln_base, cos_w, bt, tr, tuple(hists))

    return fn


def shard_inputs(mesh: list, *arrays):
    """Host arrays as tensors on the mesh's first device, f64 for floats
    (shard_over_events moves each shard's slice to its own device)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append(t.to(mesh[0], dtype=torch.float64 if t.is_floating_point() else t.dtype))
    return tuple(out)
