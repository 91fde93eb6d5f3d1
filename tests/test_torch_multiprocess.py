"""Processes of the port in one torch.distributed group (gloo).

The reference's fan-out: two CLI processes, each its own shard, against the
same shards run in one process, as tests/test_multihost.py:62-110 holds the
JAX CLI under jax.distributed: each shard bitwise, the pulse profiles summed
over the group equal to the one-process sum, the combined npy
byte-identical.  The shards are the golden flags' (tests/test_torch_e2e.py)
with two events instead of three (--Nts 3), at seeds 1769 + p, ~8 s each on
the eager CPU engine.

A mesh over the group (--mesh 2 with --coordinator): two CLI processes at
the golden flags and saveMode 3 run one run, held against one process's
--mesh 2 run; and two processes of this file's worker (__main__ below):
the counterpart of tests/test_multihost.py::test_two_process_mesh_psum, a
run stopped after one batch and resumed over the group, and the group's
refusals (seeds that differ, a failing shard, a mesh larger than the
group).  Every process starts in the module fixture, the --mesh 2 run's
one-process reference among them, and runs while this process computes
the fan-out's references.
"""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch.cli import run_from_args
from adiabatic_raytracer_tpu_torch.parallel import reduce as treduce

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD = ["--Nts", "3", "--ThetaM", "0.2", "--saveMode", "1", "--event_batch", "3",
         "--device", "cpu"]
COMBINE = ["--run_RT", "0", "--run_Combine", "1", "--side_runs", "2", "--Nts", "3",
           "--ThetaM", "0.2", "--saveMode", "1", "--device", "cpu", "--ftag", "mh_",
           "--numCutoff", "5", "--MCNodes", "5", "--maxNodes", "50"]
# the golden flags (tests/test_torch_e2e.py) at saveMode 3 on a mesh of two:
# 3 events padded to 4, the queue tree engine
GLOBAL = ["--Nts", "4", "--seed", "1769", "--ThetaM", "0.2", "--saveMode", "3",
          "--event_batch", "3", "--device", "cpu", "--mesh", "2"]
WAIT_S = 300


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _group(argv_of, n=2):
    """n processes in one gloo group on a free port: argv_of(port, p)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT] + os.environ.get("PYTHONPATH", "").split(
                   os.pathsep)))
    return [subprocess.Popen([sys.executable, *argv_of(port, p)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in range(n)]


def _logs(ps):
    """Each process's output once all have ended (rc 0), killing them all if
    one outlasts WAIT_S."""
    logs = []
    try:
        for p in ps:
            out, _ = p.communicate(timeout=WAIT_S)
            logs.append(out)
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    for p, out in zip(ps, logs):
        assert p.returncode == 0, out[-3000:]
    return logs


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every group of this module, started before this process's runs: the
    fan-out pair (--seed 1769 + p, --ftag mh_p), the pair at --mesh 2 over
    the group (dir_tag g<p>) and one process at the same flags without a
    group (one/), and the worker pair (out/)."""
    d = tmp_path_factory.mktemp("mh")
    cli = ["-m", "adiabatic_raytracer_tpu_torch"]
    groups = {
        "fanout": _group(lambda port, p: [
            *cli, *SHARD, "--seed", str(1769 + p), "--dir_tag", str(d), "--ftag", f"mh_{p}",
            "--coordinator", f"127.0.0.1:{port}", "--nprocs", "2", "--procid", str(p)]),
        "mesh": _group(lambda port, p: [
            *cli, *GLOBAL, "--dir_tag", str(d / f"g{p}"), "--coordinator",
            f"127.0.0.1:{port}", "--nprocs", "2", "--procid", str(p)]),
        "one": _group(lambda port, p: [*cli, *GLOBAL, "--dir_tag", str(d / "one")], n=1),
        "worker": _group(lambda port, p: [
            os.path.abspath(__file__), str(port), "2", str(p), str(d / "out")]),
    }
    yield d, groups
    for ps in groups.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


def test_two_processes_match_one_process(procs, tmp_path):
    """Each process's shard is bitwise the shard the same flags give in one
    process without a group; the summed pulse profiles both processes print
    equal the sum of the one-process shards' (all_reduce over gloo); the
    combined npy is byte-identical."""
    d_mh, groups = procs
    d_seq = tmp_path
    for p in range(2):
        run_from_args(SHARD + ["--seed", str(1769 + p), "--dir_tag", str(d_seq), "--ftag",
                               f"mh_{p}"])
    logs = _logs(groups["fanout"])
    shards = {}
    for p in range(2):
        (name,) = [f for f in os.listdir(d_seq / "npy") if f.endswith(f"_mh_{p}.npy")]
        shards[p] = np.load(d_seq / "npy" / name)
        np.testing.assert_array_equal(np.load(d_mh / "npy" / name), shards[p])
    sums = [treduce.pulse_profile_from_rows(shards[0])[i]
            + treduce.pulse_profile_from_rows(shards[1])[i] for i in range(2)]
    for log in logs:
        (line,) = re.findall(r"pulse profile summed over processes: (\{.*\})", log)
        got = json.loads(line)
        assert got["processes"] == 2
        np.testing.assert_array_equal(got["photon"], sums[0].numpy())
        np.testing.assert_array_equal(got["axion"], sums[1].numpy())
    merged = []
    for d in (d_mh, d_seq):
        run_from_args(COMBINE + ["--dir_tag", str(d)])
        (name,) = [f for f in os.listdir(d) if f.endswith(".npy")]
        merged.append((name, (d / name).read_bytes()))
        assert not [f for f in os.listdir(d / "npy") if f.endswith(".npy")]
    assert merged[0] == merged[1]
    assert np.load(d_mh / merged[0][0]).shape[0] == shards[0].shape[0] + shards[1].shape[0]


def _event_lines(path):
    """event_ lines without the per-event wall time (second-last column)."""
    with open(path) as f:
        return [ln.split()[:-2] + ln.split()[-1:] for ln in f]


def _same_text(d_a, d_b, tag=""):
    """The saveMode 3 files of two runs: final_ and every tree_ file
    byte-identical, event_ lines but their wall time."""
    assert (d_a / "event" / f"final_{tag}").read_bytes() == \
        (d_b / "event" / f"final_{tag}").read_bytes()
    assert _event_lines(d_a / "event" / f"event_{tag}") == \
        _event_lines(d_b / "event" / f"event_{tag}")
    trees = sorted(os.listdir(d_b / "tree"))
    assert trees and sorted(os.listdir(d_a / "tree")) == trees
    for name in trees:
        assert (d_a / "tree" / name).read_bytes() == (d_b / "tree" / name).read_bytes()


def test_mesh_over_group_matches_one_process(procs):
    """A mesh over the group, in one test: pytest-xdist's --dist loadfile
    queues the files by their number of tests, and this module keeps the
    place its two tests give it among the suite's longest files.
    (b) two CLI processes at --mesh 2 over the group are one run: process
    0's npy and saveMode 3 files are those of one process's --mesh 2 run at
    the same flags, process 1 writes no file, both print the run's pulse
    profile (that of its rows, not summed over the processes), and the
    rows are the JAX golden rows;
    (a) the counterpart of tests/test_multihost.py::test_two_process_mesh_psum:
    a mesh of two virtual CPU shards over two processes; shard_over_events
    over the 8 values (i+1)^2 runs this process's 4 and returns all 8 on
    each process, and all_reduce_sum of each process's partial sum gives
    the JAX worker's expected 204.0 on both;
    (c) driver.run on a mesh over the group stopped after one batch with a
    checkpoint, then resumed in the same processes: rows (on both
    processes) and text files bitwise the group's uninterrupted run, its
    counts the same, the checkpoint cleared, process 1 writing no file;
    the refusals: a process given another seed than process 0's raises on
    every process before anything runs; a shard that raises on process 1
    raises there and names process 1 on process 0; a mesh of 3 over 2
    processes names the missing device."""
    from test_torch_e2e import _check_golden

    d_mh, groups = procs
    _logs(groups["one"])
    one = d_mh / "one"
    (name,) = os.listdir(one / "npy")
    rows = np.load(one / "npy" / name)
    logs = _logs(groups["mesh"])
    assert (d_mh / "g0" / "npy" / name).read_bytes() == (one / "npy" / name).read_bytes()
    _same_text(d_mh / "g0", one)
    assert not (d_mh / "g1").exists()
    want = treduce.pulse_profile_from_rows(rows)
    for log in logs:
        assert "tree_engine auto -> queue" in log
        (line,) = re.findall(r"pulse profile of the run over the group: (\{.*\})", log)
        got = json.loads(line)
        assert (got["processes"], got["mesh"]) == (2, 2)
        np.testing.assert_array_equal(got["photon"], want[0].numpy())
        np.testing.assert_array_equal(got["axion"], want[1].numpy())
    _check_golden(rows)

    _logs(groups["worker"])
    out = d_mh / "out"
    res = [json.loads((out / f"worker_{p}.json").read_text()) for p in range(2)]
    vals = (np.arange(8, dtype=np.float64) + 1.0) ** 2
    for p in range(2):
        assert (res[p]["process_count"], res[p]["global_devices"]) == (2, 2)
        assert res[p]["shards"] == [[0, "cpu"], [1, "cpu"]]
        assert res[p]["psum_total"] == res[p]["expected"] == 204.0
        assert res[p]["outputs"] == vals.tolist()
        assert res[p]["computed"] == vals[4 * p:4 * p + 4].tolist()

    full = np.load(out / "rows_full_0.npy")
    assert full.shape[0] > 0
    for p in range(2):
        np.testing.assert_array_equal(np.load(out / f"rows_full_{p}.npy"), full)
        np.testing.assert_array_equal(np.load(out / f"rows_resumed_{p}.npy"), full)
        assert res[p]["stopped_events"] == 1
        assert res[p]["resumed_stats"] == res[0]["full_stats"]
    _same_text(out / "resumed_0", out / "full_0", "ck")
    assert not [f for f in os.listdir(out / "resumed_0" / "npy") if f.startswith(".ckpt_")]
    assert not (out / "full_1").exists() and not (out / "resumed_1").exists()

    for p in range(2):
        assert "process 1 was given seed 7" in res[p]["seed_error"]
        assert "process 2's device" in res[p]["mesh3_error"]
    assert res[1]["shard_error"] == "ValueError: shard 1 fails"
    assert res[0]["shard_error"].startswith("ProcessFailed: process 1 failed in its shard")


# ---- the worker: python tests/test_torch_multiprocess.py PORT NPROCS PID OUT ----

def _worker(port, nprocs, pid, out):
    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(f"127.0.0.1:{port}", nprocs, pid, timeout_s=120)
    res = {"process_count": pmesh.process_count()}
    mesh = pmesh.make_mesh(None, "cpu")
    res["global_devices"] = len(mesh)
    res["shards"] = [[s.process, s.device.type] for s in mesh]

    # shard_over_events + all_reduce_sum: tests/multihost_worker.py's psum
    vals = (np.arange(8, dtype=np.float64) + 1.0) ** 2
    computed = []

    def local(v):
        computed.append(v.clone())
        return v * 1.0

    got = pmesh.shard_over_events(mesh, local)(torch.as_tensor(vals))
    mine = torch.cat(computed)
    (tot,) = pmesh.all_reduce_sum(mine.sum())
    res.update(outputs=got.tolist(), computed=mine.tolist(), psum_total=float(tot),
               expected=float(vals.sum()))

    def error_of(fn):
        try:
            fn()
        except Exception as e:          # noqa: BLE001 -- the test reads the message
            return f"{type(e).__name__}: {e}"
        return ""

    def fails_on_1(v):
        if pid == 1:
            raise ValueError("shard 1 fails")
        return v

    res["shard_error"] = error_of(lambda: pmesh.shard_over_events(mesh, fails_on_1)(
        torch.as_tensor(vals)))
    res["mesh3_error"] = error_of(lambda: pmesh.make_mesh(3, "cpu"))

    # driver.run over the group: tests/test_torch_checkpoint.py's run (two
    # events in two batches of one, each padded to two) at saveMode 3
    sc, cfg = Scene(theta_m=0.2), NumericsConfig(interp_points=8, max_crossings=8)
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)

    def run(tag, **kw):
        return driver.run(sc, cfg, tcfg, 3, verbose=False, event_batch=1, device="cpu",
                          file_tag="ck", save_mode=3, mesh_devices=2,
                          dir_tag=os.path.join(out, f"{tag}_{pid}"), **kw)

    res["seed_error"] = error_of(lambda: run("seed", seed=6 + pid))
    counts = lambda st: [st.events, st.finals, st.f_inx, st.sample_attempts, st.tot_nodes,
                         sorted(st.info_hist.items())]
    rows, _, st = run("full", seed=6)
    np.save(os.path.join(out, f"rows_full_{pid}.npy"), rows)
    res["full_stats"] = counts(st)
    res["stopped_events"] = run("resumed", seed=6, checkpoint=True, max_batches=1)[2].events
    rows, _, st = run("resumed", seed=6, checkpoint=True, resume=True)
    np.save(os.path.join(out, f"rows_resumed_{pid}.npy"), rows)
    res["resumed_stats"] = counts(st)
    pmesh.leave_group()
    with open(os.path.join(out, f"worker_{pid}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    os.makedirs(sys.argv[4], exist_ok=True)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
