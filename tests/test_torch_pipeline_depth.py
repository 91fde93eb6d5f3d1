"""Pipeline depth 2 in the port's driver against depth 1 (the JAX driver's
contract, driver.py:585-628 there): the rows, the saveMode 3 text and tree
files and a stopped-and-resumed run are those of depth 1, bit for bit;
--profile_dir writes a trace.  Three runs of two one-event batches, ~9 s
each on the eager CPU engine."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch import driver
from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig

torch.set_num_threads(1)

SC = Scene(theta_m=0.2)
CFG = NumericsConfig(interp_points=8, max_crossings=8)
TCFG = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
# two events in two batches of one (~3 s a batch on the eager CPU engine):
# at depth 2 the second batch is issued before the first is assembled
KW = dict(seed=6, verbose=False, event_batch=1, device="cpu", file_tag="pd")
N_TRAJS = 3


def _run(d, **kw):
    return driver.run(SC, CFG, TCFG, N_TRAJS, dir_tag=str(d), **KW, **kw)


def _read(path):
    with open(path) as f:
        return f.read()


def _event_lines(d):
    """event_ lines without the per-event wall time (second-last column)."""
    with open(os.path.join(d, "event", "event_pd")) as f:
        return [ln.split()[:-2] + ln.split()[-1:] for ln in f]


@pytest.fixture(scope="module")
def depth1(tmp_path_factory):
    """Depth 1 at saveMode 3 (its rows are saveMode 1's: 29 columns, the same
    values)."""
    d = tmp_path_factory.mktemp("depth1")
    return d, _run(d, save_mode=3, pipeline_depth=1)


def test_depth2_rows_and_files_match_depth1(depth1, tmp_path):
    """Depth 2 at saveMode 3: rows bitwise and the same accounting; the
    final_ and tree_ files byte-identical, the event_ lines equal but for
    the wall time."""
    d1, (rows1, _, st1) = depth1
    rows2, _, st2 = _run(tmp_path, save_mode=3, pipeline_depth=2)
    assert rows1.shape[0] >= 2 and rows1.shape[1] == 29
    np.testing.assert_array_equal(rows2, rows1)
    assert (st2.f_inx, st2.sample_attempts, st2.finals, st2.tot_nodes, st2.info_hist) == (
        st1.f_inx, st1.sample_attempts, st1.finals, st1.tot_nodes, st1.info_hist)
    assert _read(tmp_path / "event" / "final_pd") == _read(d1 / "event" / "final_pd")
    assert _event_lines(tmp_path) == _event_lines(d1)
    for e in range(1, N_TRAJS):
        name = f"tree_pd{e}"
        assert _read(tmp_path / "tree" / name) == _read(d1 / "tree" / name)


def test_depth2_savemode1_resume_matches_depth1(depth1, tmp_path):
    """Depth 2 at saveMode 1, stopped after one batch (its checkpoint
    written after that batch assembled) and resumed at depth 2: the rows of
    the uninterrupted depth-1 run, bit for bit."""
    _, (rows1, _, st1) = depth1
    part = _run(tmp_path, save_mode=1, pipeline_depth=2, checkpoint=True, max_batches=1)
    assert part[2].events == 1
    assert len(glob.glob(str(tmp_path / "npy" / ".ckpt_*.json"))) == 1
    rows, _, st = _run(tmp_path, save_mode=1, pipeline_depth=2, checkpoint=True, resume=True)
    np.testing.assert_array_equal(rows, rows1)
    assert (st.f_inx, st.events, st.finals) == (st1.f_inx, st1.events, st1.finals)
    assert not glob.glob(str(tmp_path / "npy" / ".ckpt_*"))


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile_dir through the CLI writes the run's torch.profiler trace
    (a run of no events, --Nts 1: the profiler's cost on the eager CPU
    engine is ~10x; chip_smoke profiles a real run on the card)."""
    from adiabatic_raytracer_tpu_torch.cli import run_from_args

    prof = tmp_path / "prof"
    run_from_args(["--Nts", "1", "--seed", "6", "--ThetaM", "0.2", "--device", "cpu",
                   "--dir_tag", str(tmp_path), "--ftag", "prof", "--profile_dir", str(prof)])
    with open(prof / "trace_prof_p0.json") as f:
        assert "traceEvents" in json.load(f)
