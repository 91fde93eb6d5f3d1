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


# The slice at a boundary-layer scene, pinned from the JAX CLI:
#   python -m adiabatic_raytracer_tpu --Nts 4 --seed 1769 --ThetaM 0.2 --saveMode 1 \
#       --event_batch 3 --platform cpu --bndry_lyr 0.5 --maxNodes 6
BNDRY_ARGS = ["--bndry_lyr", "0.5", "--maxNodes", "6"]
BNDRY_WEIGHTS = [5.9290423177e-04, 9.0323405102e-03, 6.1673195411e-05]
BNDRY_SPECIES = [1, 1, 0]
BNDRY_COUNT = [1, 3, 3]
BNDRY_INFO = [2, 2, 2]


def test_bndry_lyr_pinned_rows(tmp_path):
    """--bndry_lyr 0.5 through the port's CLI on CPU (the pool engine; the
    forward tree on the host queue, since the in-kernel probability does not
    cover the boundary layer) reproduces the JAX CLI's rows: weights at rtol
    1e-6, species, node counts and stop codes exact."""
    rows, _, stats = run_from_args(GOLDEN_ARGS + BNDRY_ARGS + ["--dir_tag", str(tmp_path),
                                                               "--ftag", "bndry"])
    assert rows.shape == (3, 29)
    np.testing.assert_allclose(rows[:, 8], BNDRY_WEIGHTS, rtol=1e-6)
    np.testing.assert_array_equal(rows[:, 1], BNDRY_SPECIES)
    np.testing.assert_array_equal(rows[:, 20], BNDRY_COUNT)
    np.testing.assert_array_equal(rows[:, 21], BNDRY_INFO)
    assert np.all(np.isfinite(rows)) and np.all(rows[:, 7] > 0)


def test_mega_engine_on_cpu_reproduces_golden(tmp_path):
    """engine=mega on CPU tensors runs K2's plain version (pool + the
    in-kernel probability twin) and the scan-gate census: same rows."""
    rows, _, stats = run_from_args(GOLDEN_ARGS + ["--engine", "mega", "--tree_engine", "queue",
                                                  "--scan_gate_check", "8", "--dir_tag",
                                                  str(tmp_path), "--ftag", "mega"])
    _check_golden(rows)
    assert stats.scan_gate == "ok"


def test_kernel_tree_engine_matches_host_k1(tmp_path):
    """--tree_engine kernel (K3's plain version on CPU) through the CLI gives
    the rows and counters of driver.run with the host engine at tree_k=1,
    K3's reference.  Two events; rtol 1e-6: the weights multiply crossing
    probabilities, which near-tangent roots move by up to ~1e-7 between the
    pool's autodiff RHS and the kernel's hand adjoint (7e-8 measured)."""
    from adiabatic_raytracer_tpu_torch import config as tcfg
    from adiabatic_raytracer_tpu_torch.driver import run

    two = ["--Nts", "3", "--scan_gate_check", "0", "--dir_tag", str(tmp_path)]
    rows, _, st = run_from_args(GOLDEN_ARGS + two + ["--engine", "mega", "--tree_engine",
                                                     "kernel", "--ftag", "kern"])
    cfg = tcfg.NumericsConfig(atol=1e-6, rtol=1e-7, engine="mega", tree_k=1,
                              scan_gate_check=0)
    rows_h, _, st_h = run(tcfg.Scene(theta_m=0.2), cfg, tcfg.TreeConfig(), 3, seed=1769,
                          save_mode=1, event_batch=3, dir_tag=str(tmp_path), file_tag="host",
                          device="cpu", verbose=False)
    assert rows.shape == rows_h.shape == (5, 29)
    np.testing.assert_array_equal(rows[:, [0, 1, 20, 21]], rows_h[:, [0, 1, 20, 21]])
    np.testing.assert_allclose(rows, rows_h, rtol=1e-6, atol=0)
    assert (st.finals, st.tot_nodes, st.info_hist) == (st_h.finals, st_h.tot_nodes, st_h.info_hist)


def test_refill_engine_through_driver_matches_kernel(tmp_path):
    """tree_refill=1 through driver.run (K4's plain version on CPU, in place
    of K3's, wherever the kernel tree engine runs) writes the rows of the
    one-launch K3 path bit for bit: K4 serves each event as K3 does."""
    from adiabatic_raytracer_tpu_torch import config as tcfg
    from adiabatic_raytracer_tpu_torch.driver import run

    out = {}
    for tag, kw in (("k3", {}), ("k4", dict(tree_refill=1, tree_kernel_chunk=64))):
        cfg = tcfg.NumericsConfig(atol=1e-6, rtol=1e-7, engine="mega", tree_engine="kernel",
                                  scan_gate_check=0, **kw)
        out[tag] = run(tcfg.Scene(theta_m=0.2), cfg, tcfg.TreeConfig(), 3, seed=1769,
                       save_mode=1, event_batch=3, dir_tag=str(tmp_path), file_tag=tag,
                       device="cpu", verbose=False)
    (rows3, _, st3), (rows4, _, st4) = out["k3"], out["k4"]
    assert rows4.shape == (5, 29)
    np.testing.assert_array_equal(rows4, rows3)
    assert (st4.finals, st4.tot_nodes, st4.info_hist) == (st3.finals, st3.tot_nodes,
                                                          st3.info_hist)
    assert st4.tree_iters > st3.tree_iters == 1   # K4 reports thread iterations


def test_unported_cli_options_raise(tmp_path):
    """An option the port does not run raises naming its ROADMAP item; a
    mesh over a process group is ported, and one that cannot form (more
    devices than processes, or no coordinator to join) raises naming why.
    None of them runs anything."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_from_args(GOLDEN_ARGS + ["--dir_tag", str(tmp_path), "--tree_engine", "kernel",
                                     "--bndry_lyr", "1.0"])
    for extra, why in ((["--mesh", "3", "--nprocs", "2"], "process 2's device is missing"),
                       (["--mesh", "2", "--nprocs", "2"], "needs the coordinator")):
        with pytest.raises(ValueError, match=why):
            run_from_args(GOLDEN_ARGS + ["--dir_tag", str(tmp_path)] + extra)
    assert not glob.glob(str(tmp_path / "npy" / "*.npy"))
