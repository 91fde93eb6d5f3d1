"""P1: K4's queue mechanism in isolation (csrc/refill_probe.cu).

Replaces the Pallas probe of scripts/probe_refill_ops.py (pallas_call at
:147), at its own shapes: one partition of EPART = 512 events served by
L = 128 lanes, ROWS = 16 table rows and SROWS = 24 output rows per event,
refill period REFILL_K = 4, at most N_IT = 64 iterations.  Event e has a work
quota of 1 to 4 units (table row 0) and an id (row 1, e + 1000).  Lanes take
events from a shared queue and burn the quota one unit per iteration; an
event is flushed (scatter-added into its output column) at the refill
boundary where its lane takes another event, or after the loop: row 0 the
gathered id, row 1 the steps burned, row SROWS-1 the flush iteration, rows
2..SROWS-2 zero.  These are the probe's rows.  A queue fault shows as a
skipped event (row 0 zero) or a doubled one (row 0 twice the id); a lost
last flush as a zero column.

`refill_probe_plain` runs the probe's own schedule (lockstep lanes, ranks in
lane order, the loop ending once the queue is drained and every quota spent,
or at N_IT) and gives the JAX probe's output bit for bit at its shapes, with
one difference: a lane flushed at a refill that finds no event left for it
is not flushed again after the loop (the JAX probe would add its event
twice; at its own shapes every lane finds one).  The kernel's threads do not
run in lockstep, so its flush iterations (row SROWS-1) depend on which
thread took which event when; its other rows are the plain version's.

`refill_probe` launches the kernel on a CUDA tensor and runs
`refill_probe_plain` on a CPU tensor.  Run the probe as the script runs, on
the card unless asked:

    python -m adiabatic_raytracer_tpu_torch.ops.refill_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from adiabatic_raytracer_tpu_torch.ops import cuda_lib

L = 128          # lanes
EPART = 512      # events per partition
ROWS = 16        # table rows per event
SROWS = 24       # output rows per event
N_IT = 64        # iterations per lane
REFILL_K = 4     # refill period


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.art_refill_probe.argtypes = [p, p, i, i, i, i, i, i, i, p]
    lib.art_refill_probe.restype = ctypes.c_int


def probe_table(seed: int = 0) -> torch.Tensor:
    """The probe's table [1, ROWS, EPART] f32 (probe_refill_ops.py:141-145):
    row 0 the quota, drawn from numpy.random.default_rng(seed) in 1..4, row
    1 the event id + 1000."""
    rng = np.random.default_rng(seed)
    quota = rng.integers(1, 5, EPART).astype(np.float32)
    tbl = np.zeros((ROWS, EPART), np.float32)
    tbl[0] = quota
    tbl[1] = np.arange(EPART) + 1000.0
    return torch.from_numpy(tbl)[None]


def refill_probe_plain(tbl, *, lanes: int = L, refill_k: int = REFILL_K, n_it: int = N_IT,
                       srows: int = SROWS):
    """P1's plain version, each partition's lanes in lockstep as in the
    probe: at every multiple of refill_k, while the queue holds events and a
    lane is idle, the idle lanes flush their events and take the next ones
    in lane order; every busy lane burns one unit per iteration; the loop
    ends at n_it, or once the queue is drained and every quota spent, and
    flushes the lanes' last events.  tbl [parts, rows, epart] f32; returns
    out [parts, srows, epart] f32."""
    parts, _, epart = tbl.shape
    dev = tbl.device
    out = torch.zeros((parts, srows, epart), dtype=torch.float32, device=dev)
    for p in range(parts):
        t, o = tbl[p], out[p]
        ev = torch.full((lanes,), -1, dtype=torch.int64, device=dev)
        work = torch.zeros(lanes, dtype=torch.float32, device=dev)
        steps = torch.zeros_like(work)

        def flush(lane, it):
            e = ev[lane]
            o[0].index_add_(0, e, t[1, e])
            o[1].index_add_(0, e, steps[lane])
            o[srows - 1].index_add_(0, e, torch.full_like(steps[lane], float(it)))
            ev[lane] = -1

        head = it = 0
        while it < n_it and (head < epart or bool((work > 0.5).any())):
            idle = work < 0.5
            if it % refill_k == 0 and head < epart and bool(idle.any()):
                flush(idle & (ev >= 0), it)
                take = idle.nonzero().squeeze(1)[:epart - head]
                ev[take] = torch.arange(head, head + take.numel(), device=dev)
                work[take] = t[0, ev[take]]
                steps[take] = 0.0
                head += take.numel()
            steps += (work > 0.5).to(torch.float32)
            work = torch.clamp(work - 1.0, min=0.0)
            it += 1
        flush(ev >= 0, it)
    return out


def refill_probe(tbl, *, lanes: int = L, refill_k: int = REFILL_K, n_it: int = N_IT,
                 srows: int = SROWS):
    """One P1 launch: one block of `lanes` threads per partition of tbl
    [parts, rows, epart] (f32, contiguous).  Returns out [parts, srows,
    epart] f32 (module docstring).  CPU tensors run refill_probe_plain."""
    if tbl.device.type == "cpu":
        return refill_probe_plain(tbl, lanes=lanes, refill_k=refill_k, n_it=n_it, srows=srows)
    cuda_lib.require(tbl, "tbl", torch.float32)
    parts, rows, epart = tbl.shape
    out = torch.empty((parts, srows, epart), dtype=torch.float32, device=tbl.device)
    code = cuda_lib.lib().art_refill_probe(tbl.data_ptr(), out.data_ptr(), parts * epart, epart,
                                           rows, srows, lanes, refill_k, n_it,
                                           cuda_lib.stream_ptr(tbl))
    cuda_lib.check(code, "refill_probe launch")
    cuda_lib.LAUNCHES["refill_probe"] += 1
    return out


def checks(tbl, out, refill_k: int = REFILL_K, n_it: int = N_IT) -> dict:
    """The probe's own checks (probe_refill_ops.py:163-174), the write count
    and the flush schedule: ids round-trip, steps equal the quotas, every
    event written once (row 0 holds its id once), and every flush at a
    refill boundary no earlier than the quota, or at the loop's end (the
    partition's last flush, at most n_it).  Values are (ok, detail)."""
    t, o = tbl.cpu(), out.cpu()
    id_err = (o[:, 0] - t[:, 1]).abs().max().item()
    bad_steps = int(((o[:, 1] - t[:, 0]).abs() > 0).sum())
    bad_once = int((torch.round(o[:, 0] / t[:, 1]) != 1.0).sum())
    at = o[:, -1]
    end = at.amax(dim=1, keepdim=True)
    boundary = (torch.remainder(at, refill_k) == 0) & (at >= t[:, 0])
    bad_flush = int((~(boundary | (at == end))).sum()) + int((end > n_it).sum())
    return {"gathered-id roundtrip": (id_err == 0.0, f"max err {id_err}"),
            "per-event steps == quota": (bad_steps == 0, f"mismatches {bad_steps}"),
            "every event written once": (bad_once == 0, f"events written != 1: {bad_once}"),
            "flush at a refill boundary or the loop's end": (bad_flush == 0,
                                                             f"misplaced {bad_flush}")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    tbl = probe_table().to(dev)
    t0 = time.time()
    out = refill_probe(tbl)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu-plain"
    print(f"platform={name} wall={wall:.3f}s")
    ok = True
    for what, (good, detail) in checks(tbl, out).items():
        print(f"{what}: {'OK' if good else 'FAIL'} ({detail})")
        ok &= good
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
