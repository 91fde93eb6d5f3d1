"""CompactedPropagator (ops/streaming.py) against the port's monolithic
propagate, and engine="pool_compact" rows against "pool" with the
backtrace compacting (tests/test_streaming.py holds JAX's the same way;
tests/test_torch_streaming_jax.py holds the port's against JAX's).

The rays are the first 8 of the 64-ray input of tests/test_streaming.py
(same generator and seed; the slowest takes 125 steps), so that the two
eager CPU propagations take ~4 s each instead of ~20; chunk_iters 16 and
min_pool 2 compact them 8 -> 4 -> 2, as chip_smoke.py's phase 21 does on the
card.
"""

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
from adiabatic_raytracer_tpu_torch.ops import streaming
from adiabatic_raytracer_tpu_torch.ops.propagate import propagate
from adiabatic_raytracer_tpu_torch.ops.streaming import CompactedPropagator

torch.set_num_threads(1)

SC = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
           mass_ns=1.0)
CFG = NumericsConfig(interp_points=8)
N = 8

def _rays():
    B = 64
    rng = np.random.default_rng(3)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                  r * np.cos(th)], axis=1)
    v = rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f64 = torch.float64
    args = dict(erg=torch.full((N,), 1.0000005e-5, dtype=f64),
                delta_w=-torch.ones(N, dtype=f64),
                lnt0=torch.full((N,), CFG.ln_t_start, dtype=f64),
                lnt1=torch.full((N,), float(np.log(3e-3)), dtype=f64),
                is_photon=torch.ones(N, dtype=torch.bool),
                max_crossings=torch.ones(N, dtype=torch.int64))
    return torch.as_tensor(x[:N]), torch.as_tensor(v[:N]), args


@pytest.fixture(scope="module")
def results():
    x, v, args = _rays()
    ref = propagate(x, v, SC, CFG, species="photon", **args)
    cp = CompactedPropagator(SC, CFG, species="photon", chunk_iters=16, min_pool=2)
    got = cp.run(x, v, args["erg"], args["delta_w"], args["lnt0"], args["lnt1"],
                 args["is_photon"], args["max_crossings"])
    return ref, got, cp


def test_compacted_matches_propagate(results):
    """n_cross and steps exact, traj and xc within 1e-12: compaction only
    reorders rays, so the outputs are expected bitwise; the bar leaves room
    for libm's vector and scalar paths, which a ray's lane position can
    switch between."""
    ref, got, cp = results
    assert cp.pool_sizes[0] == N and min(cp.pool_sizes) == 2   # it compacted
    np.testing.assert_array_equal(got.n_cross.numpy(), ref.n_cross.numpy())
    np.testing.assert_array_equal(got.steps.numpy(), ref.steps.numpy())
    np.testing.assert_allclose(got.traj.numpy(), ref.traj.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.xc.numpy(), ref.xc.numpy(), rtol=1e-12, atol=1e-12)


class _SmallChunks(CompactedPropagator):
    """The driver's CompactedPropagator at chunk_iters 16 and min_pool 1, so
    that a two-event backtrace compacts; each run's pool sizes recorded."""

    sizes = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **{**kw, "chunk_iters": 16, "min_pool": 1})

    def run(self, *a, **kw):
        out = super().run(*a, **kw)
        _SmallChunks.sizes.append(list(self.pool_sizes))
        return out


def test_pool_compact_rows_match_pool(tmp_path, monkeypatch):
    """engine='pool_compact' (the backtrace through CompactedPropagator)
    against engine='pool' through driver.run, at tests/test_streaming.py's
    configuration and bars: species and stop codes exact, the rest within
    rtol 1e-3.  At the driver's defaults (chunk_iters 256, min_pool 128, as
    in JAX) a backtrace of a few events never compacts, so the backtrace's
    propagator runs at chunk_iters 16 and min_pool 1 here, and its pool
    must shrink from 2 to 1."""
    from adiabatic_raytracer_tpu_torch.driver import run

    monkeypatch.setattr(streaming, "CompactedPropagator", _SmallChunks)
    _SmallChunks.sizes = []
    tcfg = TreeConfig(num_cutoff=3, mc_nodes=2, max_nodes=8)
    rows = {}
    for eng in ("pool", "pool_compact"):
        cfg = NumericsConfig(interp_points=8, max_crossings=8, engine=eng)
        rows[eng] = run(Scene(theta_m=0.2), cfg, tcfg, 3, seed=911, save_mode=1,
                        verbose=False, dir_tag=str(tmp_path / eng), event_batch=2,
                        device="cpu")[0]
    a, b = rows["pool"], rows["pool_compact"]
    (sizes,) = _SmallChunks.sizes
    assert sizes[0] == 2 and sizes[-1] == 1, sizes      # the backtrace compacted
    assert a.shape == b.shape and a.shape[0] >= 1
    np.testing.assert_array_equal(a[:, 1], b[:, 1])
    np.testing.assert_array_equal(a[:, 21], b[:, 21])
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-12)
