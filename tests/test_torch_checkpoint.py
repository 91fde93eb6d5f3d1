"""Checkpoint/resume in the port's driver against the JAX package's contract
(tests/test_checkpoint.py): a run stopped after one batch and resumed writes
the rows, and at saveMode 3 the text, of an uninterrupted run; a checkpoint
written by either package resumes in the other."""

import glob
import os

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu import driver as jdrv
from adiabatic_raytracer_tpu_torch import driver as tdrv
from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

SC = Scene(theta_m=0.2)
CFG = NumericsConfig(interp_points=8, max_crossings=8)
TCFG = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
# two events in two batches of one: the fewest batches a stop can split, each
# batch a full backtrace and tree on the eager CPU engine (~3 s)
KW = dict(seed=6, verbose=False, event_batch=1, device="cpu", file_tag="ck")
N_TRAJS = 3


def _run(d, **kw):
    return tdrv.run(SC, CFG, TCFG, N_TRAJS, dir_tag=str(d), **KW, **kw)


def _event_lines(d):
    """event_ lines without the per-event wall time (second-last column)."""
    with open(os.path.join(d, "event", "event_ck")) as f:
        return [ln.split()[:-2] + ln.split()[-1:] for ln in f]


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """The uninterrupted run at saveMode 3 (its rows are saveMode 1's)."""
    d = tmp_path_factory.mktemp("full")
    return d, _run(d, save_mode=3)


@pytest.mark.parametrize("save_mode", [1, 3])
def test_resume_matches_uninterrupted(full, tmp_path, save_mode):
    d_full, (rows_full, _, st_full) = full
    part = _run(tmp_path, save_mode=save_mode, checkpoint=True, max_batches=1)
    assert part is not None and part[2].events == 1
    assert len(glob.glob(str(tmp_path / "npy" / ".ckpt_*.json"))) == 1
    assert not [p for p in glob.glob(str(tmp_path / "npy" / "*.npy"))
                if not os.path.basename(p).startswith(".")]

    rows, _, st = _run(tmp_path, save_mode=save_mode, checkpoint=True, resume=True)
    np.testing.assert_array_equal(rows, rows_full)
    assert (st.f_inx, st.events, st.finals, st.info_hist) == (
        st_full.f_inx, st_full.events, st_full.finals, st_full.info_hist)
    assert not glob.glob(str(tmp_path / "npy" / ".ckpt_*"))   # cleared at the end
    if save_mode == 3:
        assert _read(tmp_path / "event" / "final_ck") == _read(d_full / "event" / "final_ck")
        assert _event_lines(tmp_path) == _event_lines(d_full)
        for e in range(1, N_TRAJS):
            name = f"tree_ck{e}"
            assert _read(tmp_path / "tree" / name) == _read(d_full / "tree" / name)


def _stats(cls, **kw):
    st = cls(seed=1769, events=5, finals=7, sample_attempts=40, f_inx=17, tot_nodes=12,
             tree_iters=9, dw_warnings=1, t_sample=0.25, t_pipeline=3.5, **kw)
    st.info_hist = {2: 3, -2: 2}
    return st


COUNTERS = ("seed", "events", "finals", "sample_attempts", "f_inx", "tot_nodes",
            "tree_iters", "dw_warnings", "t_sample", "t_pipeline", "info_hist")


def test_checkpoint_moves_between_packages(tmp_path):
    """The JSON state and the partial rows are the JAX package's format: a
    state from JAX's _write_checkpoint resumes through the port's loader
    (the reference's timers the port has set too, none other), and the
    port's through JAX's."""
    out = str(tmp_path / "npy" / "tree_x.npy")
    key = np.array([123456789, 4000000000], np.uint32)
    rows = [np.random.default_rng(3).standard_normal((4, 29))]

    jdrv._write_checkpoint(out, key, 0.3125, 6, 4, _stats(jdrv.RunStats, t_fetch=0.5,
                                                          t_issue=0.1), rows)
    st = tdrv.RunStats()
    k, succ, ev_no, rem, rows_t = tdrv._load_checkpoint(out, st)
    np.testing.assert_array_equal(rng.key_to_jax(k), key)
    assert (succ, ev_no, rem) == (0.3125, 6, 4)
    ref = _stats(tdrv.RunStats)
    assert [getattr(st, n) for n in COUNTERS] == [getattr(ref, n) for n in COUNTERS]
    assert st.t_fetch == 0.5 and st.t_issue == 0.1
    np.testing.assert_array_equal(np.concatenate(rows_t), rows[0])
    tdrv._clear_checkpoint(out)
    assert not os.listdir(tmp_path / "npy")

    tdrv._write_checkpoint(out, rng.key_from_jax(key), 0.3125, 6, 4,
                           _stats(tdrv.RunStats, t_gate=0.75), rows)
    state, rows_j = jdrv._load_checkpoint(out)
    np.testing.assert_array_equal(np.array(state["key"], np.uint32), key)
    assert (state["succ_rate"], state["event_no"], state["remaining"]) == (0.3125, 6, 4)
    st_j = jdrv.RunStats()
    for name, v in state["stats"].items():          # as the JAX driver resumes
        setattr(st_j, name, v)
    st_j.info_hist = {int(n): v for n, v in state["info_hist"].items()}
    ref = _stats(jdrv.RunStats)
    assert [getattr(st_j, n) for n in COUNTERS] == [getattr(ref, n) for n in COUNTERS]
    np.testing.assert_array_equal(np.concatenate(rows_j), rows[0])
