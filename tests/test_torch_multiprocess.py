"""Two processes of the port's CLI in one torch.distributed group (gloo)
against the same shards run in one process, as tests/test_multihost.py:62-110
holds the JAX CLI under jax.distributed: each shard bitwise, the pulse
profiles summed over the group equal to the one-process sum, the combined
npy byte-identical.  The shards are the golden flags' (tests/test_torch_e2e.py)
with two events instead of three (--Nts 3), at seeds 1769 + p, ~8 s each on
the eager CPU engine; the two processes run while this one computes its
shards."""

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


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Two processes of the port's CLI in one gloo group, one shard each
    (--seed 1769 + p, --ftag mh_p), started before this process's runs."""
    d = tmp_path_factory.mktemp("mh")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT] + os.environ.get("PYTHONPATH", "").split(
                   os.pathsep)))
    ps = [subprocess.Popen(
        [sys.executable, "-m", "adiabatic_raytracer_tpu_torch", *SHARD, "--seed",
         str(1769 + p), "--dir_tag", str(d), "--ftag", f"mh_{p}", "--coordinator",
         f"127.0.0.1:{port}", "--nprocs", "2", "--procid", str(p)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(2)]
    yield d, ps
    for p in ps:
        if p.poll() is None:
            p.kill()


def test_two_processes_match_one_process(procs, tmp_path):
    """Each process's shard is bitwise the shard the same flags give in one
    process without a group; the summed pulse profiles both processes print
    equal the sum of the one-process shards' (all_reduce over gloo); the
    combined npy is byte-identical."""
    d_mh, ps = procs
    d_seq = tmp_path
    for p in range(2):
        run_from_args(SHARD + ["--seed", str(1769 + p), "--dir_tag", str(d_seq), "--ftag",
                               f"mh_{p}"])
    logs = []
    for p in ps:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        logs.append(out)
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


