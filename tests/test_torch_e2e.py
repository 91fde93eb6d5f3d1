"""The port's CLI on CPU reproduces the JAX package's pinned golden rows
(tests/test_e2e.py::test_golden_pinned_rows): the threefry stream, sampler,
kinematics, backtrace, forward tree and row assembly end to end."""

import glob
import os

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch.cli import run_from_args

torch.set_num_threads(1)

GOLDEN_ARGS = ["--Nts", "4", "--seed", "1769", "--ThetaM", "0.2", "--saveMode", "1",
               "--event_batch", "3", "--device", "cpu"]
# tests/test_e2e.py pins these weights at rtol 1e-6
GOLDEN_WEIGHTS = [1.37646785e-03, 1.04814701e-02, 8.54149604e-05, 6.64345269e-05,
                  3.15848565e-07, 7.85425213e-04]
# discrete columns of the same JAX run: species, processed-node count, stop code
GOLDEN_SPECIES = [1, 1, 0, 0, 1, 1]
GOLDEN_COUNT = [1, 7, 7, 7, 7, 1]
GOLDEN_INFO = [2, -2, -2, -2, -2, 2]


def _check_golden(rows):
    assert rows.shape == (6, 29)
    np.testing.assert_allclose(rows[:, 8], GOLDEN_WEIGHTS, rtol=1e-6)
    np.testing.assert_array_equal(rows[:, 1], GOLDEN_SPECIES)
    np.testing.assert_array_equal(rows[:, 20], GOLDEN_COUNT)
    np.testing.assert_array_equal(rows[:, 21], GOLDEN_INFO)
    assert np.all(np.isfinite(rows)) and np.all(rows[:, 7] > 0)


def test_golden_pinned_rows(tmp_path):
    rows, path, stats = run_from_args(GOLDEN_ARGS + ["--dir_tag", str(tmp_path),
                                                     "--ftag", "gold"])
    assert os.path.basename(path) in os.listdir(tmp_path / "npy")
    np.testing.assert_array_equal(np.load(path), rows)
    _check_golden(rows)
    assert stats.events == 3 and stats.finals == 6 and stats.f_inx == 17


def test_mega_engine_on_cpu_reproduces_golden(tmp_path):
    """engine=mega on CPU tensors runs K2's plain version (pool + the
    in-kernel probability twin) and the scan-gate census: same rows."""
    rows, _, stats = run_from_args(GOLDEN_ARGS + ["--engine", "mega", "--scan_gate_check",
                                                  "8", "--dir_tag", str(tmp_path),
                                                  "--ftag", "mega"])
    _check_golden(rows)
    assert stats.scan_gate == "ok"


def test_unported_cli_options_raise(tmp_path):
    for extra in (["--saveMode", "2"], ["--tree_engine", "kernel"], ["--tree_window", "128"],
                  ["--pipeline_depth", "2"], ["--mesh", "4"], ["--checkpoint"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_from_args(GOLDEN_ARGS + ["--dir_tag", str(tmp_path)] + extra)
    assert not glob.glob(str(tmp_path / "npy" / "*.npy"))
