"""Event-axis sharding over cards, and process groups.

Port of adiabatic_raytracer_tpu/parallel/mesh.py.  The reference scales by
forking N independent processes and merging npy files (runner_example.sh,
combine_files); the JAX package shards the event axis over a device mesh with
shard_map.  Without a process group a mesh is a list of torch devices:
`make_mesh(n, "cuda")` the first n cards (raising when there are fewer),
`make_mesh(n, "cpu")` n virtual shards on the one CPU device, the
counterpart of the JAX tests' 8 virtual CPU devices.  `shard_over_events`
is the one sharding loop: the driver runs each batch through it (a single
device is a mesh of one), and `event_pipeline_sharded` is built on it.  Each
shard runs the unchanged per-batch pipeline on its own slice of events and
device, one shard after another from the host thread.  The pipeline's host
code waits on its card where it reads from it, so a mesh of N cards in one
process does about the work of one.  The driver's per-event RNG keys come
from global event numbers, so rows do not depend on the mesh.

Processes form a torch.distributed group over gloo (`init_distributed`, the
counterpart of jax.distributed and of the reference's SLURM fan-out,
runner_GR_tasks.sh).  Under a group `make_mesh` spans it, as JAX's takes
the first n of the group's global devices: each process contributes one
device, its card cuda:(rank % device_count) (two processes on a one-card
machine share cuda:0) or one virtual CPU shard, and the mesh is a list of
`Shard(process, device)` in rank order.  `shard_over_events` then runs only
this process's shards and gathers every shard's outputs over the group in
mesh order (CPU copies over gloo, shapes free to differ), so every process
holds what a one-process mesh returns.  A process beyond the mesh's size
owns no shard and still takes part in every collective.  The collectives
ship host objects: `gather_objects`, and `run_on_first`, which runs a step
on process 0 and sends its result, or its failure, to every process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.parallel.reduce import pulse_profile_from_pools


# A global mesh's collectives wait at most this long (s) for another
# process (the group's timeout, init_distributed(timeout_s=)): a process
# that fails ends its group's run within it instead of the default 30 min.
# The longest wait of a healthy run is process 0's scan-gate census or a
# kernel build while the others wait for its verdict.
GROUP_TIMEOUT_S = 300.0


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group at tcp://<coordinator> (host:port) as rank
    process_id of num_processes, over gloo, its collectives bounded by
    timeout_s (torch's default, 30 min, when None).  A no-op when the group
    already exists, or when no argument is given and the environment names
    no group (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torchrun sets
    them).  A group that fails to form raises.  Returns whether a group
    exists."""
    if dist.is_initialized():
        return True
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                             "RANK")):
            return False
        dist.init_process_group("gloo", init_method="env://", **kw)
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number of processes "
                         f"and this process's id (got {coordinator!r}, {num_processes!r}, "
                         f"{process_id!r})")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id), **kw)
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


def process_device(device="cuda") -> torch.device:
    """This process's device of the given type: under a group on cuda its
    card cuda:(rank % device_count), the card the CLI gives it; else the
    device as given."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized() and torch.cuda.device_count():
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return device


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


def map_tensors(fn, x):
    """fn applied to every tensor in x: tensors, tuples and named tuples of
    them (recursively), dicts, lists; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    return x


def _on_cpu(x):
    return map_tensors(lambda t: t.detach().cpu(), x)


def gather_objects(obj) -> list:
    """obj of every process in rank order ([obj] without a group); tensors
    travel as CPU copies."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, _on_cpu(obj))
    return out


class ProcessFailed(RuntimeError):
    """Another process of the group failed in a step that this one waits on."""


def run_on_first(fn):
    """fn() on process 0, its result sent to every process of the group
    (tensors as CPU copies; fn() itself without a group).  When fn raises on
    process 0, it raises there and ProcessFailed, naming the error, on every
    other process, so none waits for a result that never comes."""
    if not dist.is_initialized():
        return fn()
    box = [None]
    err = None
    if dist.get_rank() == 0:
        try:
            out = fn()
            box[0] = ("ok", _on_cpu(out))
        except Exception as e:          # noqa: BLE001 -- re-raised below, after the send
            err = e
            box[0] = ("failed", f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    status, val = box[0]
    if status != "ok":
        raise ProcessFailed(f"process 0 failed: {val}")
    return out if dist.get_rank() == 0 else val


class Shard(NamedTuple):
    """One device of a mesh that spans a process group: the process that
    runs it and its device there."""
    process: int
    device: torch.device


def spans_group(mesh) -> bool:
    """Whether the mesh spans a process group (made by make_mesh under one)."""
    return isinstance(mesh[0], Shard)


def home_device(mesh) -> torch.device:
    """Where shard_over_events leaves its outputs: the first device of a
    mesh in one process; this process's device of a mesh over a group."""
    return process_device(mesh[0].device) if spans_group(mesh) else mesh[0]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """The mesh's devices.  Without a process group: on cuda the first n
    cards (all by default; fewer cards than n raises), on cpu n virtual
    shards of the CPU device.  Under a group: the first n (all by default)
    of one device per process in rank order, as Shard(process, device), on
    cuda each process's card cuda:(rank % device_count), on cpu one virtual
    shard each; n above the group's size raises, naming the missing
    device."""
    device = torch.device(device)
    if dist.is_initialized():
        procs = dist.get_world_size()
        n = procs if n_devices is None else int(n_devices)
        have = torch.cuda.device_count() if device.type == "cuda" else 1
        if device.type == "cuda" and not have:
            raise RuntimeError(f"a mesh of {n} cards over a group of {procs} processes needs "
                               "CUDA devices; torch.cuda.device_count() is 0, so card cuda:0 "
                               "is missing")
        if n > procs:
            name = f"cuda:{procs % have}" if device.type == "cuda" else "cpu"
            raise RuntimeError(f"a mesh of {n} devices over a group of {procs} processes, one "
                               f"device each: process {procs}'s device ({name} there) is "
                               "missing; start the group with --nprocs >= --mesh")
        return [Shard(p, torch.device("cuda", p % have) if device.type == "cuda" else device)
                for p in range(n)]
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
    concatenates the outputs on home_device(mesh) (a mesh of one in one
    process returns fn's outputs as they are).  The shards run one after
    another.  On a mesh over a group this process runs only its own shards,
    then every shard's outputs are gathered over the group (gather_objects),
    so every process returns the same; a shard that raises raises on its
    process and ProcessFailed on the others.  The wrapped function's
    `t_gather` adds up the seconds spent in the gather, most of them
    waiting for the other processes' shards.  RNG must already be carried
    per event for the result to be mesh-size-invariant."""
    n = len(mesh)
    group = spans_group(mesh)
    devs = [sh.device for sh in mesh] if group else mesh
    mine = [s for s in range(n) if not group or mesh[s].process == process_index()]
    home = home_device(mesh)

    def sharded(*args):
        E = args[0].shape[0]
        if E % n:
            raise ValueError(f"{E} events do not split over a mesh of {n}")
        m = E // n
        outs = [None] * n
        err = None
        try:
            for s in mine:
                with device_context(devs[s]):
                    outs[s] = fn(*(a[s * m:(s + 1) * m].to(devs[s]) for a in args))
        except Exception as e:          # noqa: BLE001 -- re-raised below, after the gather
            if not group:
                raise
            err = e
        if group:
            sent = ({"failed": f"{type(err).__name__}: {err}"} if err is not None
                    else {s: outs[s] for s in mine})
            t0 = time.perf_counter()
            got = gather_objects(sent)
            sharded.t_gather += time.perf_counter() - t0
            if err is not None:
                raise err
            for p, d in enumerate(got):
                if "failed" in d:
                    raise ProcessFailed(f"process {p} failed in its shard: {d['failed']}")
                for s, o in d.items():
                    if outs[s] is None:
                        outs[s] = map_tensors(lambda t: t.to(home), o)
        return concat_events(outs, home)

    sharded.t_gather = 0.0
    return sharded


class ShardedPipelineResult(NamedTuple):
    k_init: torch.Tensor
    sln_base: torch.Tensor
    cos_w: torch.Tensor
    bt: tuple            # tree.BacktraceResult
    tr: tuple            # tree.TreeResult
    hists: tuple         # (photon_hist, axion_hist), summed over the events of every process


def event_pipeline_sharded(mesh: list, sc: Scene, cfg: NumericsConfig, tcfg: TreeConfig, *,
                           maxR, lnt_end, nbins: int = 50):
    """The per-batch event pipeline sharded over the mesh: returns
    fn(seeds [E] int, xpos [E,3], v_loc [E,3], erg_inf [E]) ->
    ShardedPipelineResult.  E must divide over the mesh; each event's tree
    key is PRNGKey(seed), as in the JAX package's function (the driver
    folds the global event number into the run's key instead), so the
    draws do not depend on the mesh.  The histograms are summed over the
    shards and, on a mesh in one process under a group (each process its
    own events), over the group; a mesh over the group already holds every
    process's shards, so they are summed once.  They are in sln_base units:
    multiply by driver.sln_scale for the reference's pps."""
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
        hists = (h_ph.sum(dim=0), h_ax.sum(dim=0))
        if not spans_group(mesh):
            hists = all_reduce_sum(*hists)
        return ShardedPipelineResult(k_init, sln_base, cos_w, bt, tr, tuple(hists))

    return fn


def shard_inputs(mesh: list, *arrays):
    """Host arrays as tensors on home_device(mesh), f64 for floats
    (shard_over_events moves each shard's slice to its own device)."""
    home = home_device(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append(t.to(home, dtype=torch.float64 if t.is_floating_point() else t.dtype))
    return tuple(out)
