"""The port's mesh and histogram reductions against the JAX package's
contracts (tests/test_sharding.py): weighted_histogram and
pulse_profile_from_pools against JAX's on the same numpy inputs; driver.run
on a mesh of two virtual CPU shards against one, at the golden flags
(tests/test_torch_e2e.py, ~10 s a run on the eager CPU engine);
event_pipeline_sharded on one and two virtual CPU shards.  Two processes in
a group: tests/test_torch_multiprocess.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu.parallel import reduce as jreduce
from adiabatic_raytracer_tpu_torch.cli import run_from_args
from adiabatic_raytracer_tpu_torch.parallel import reduce as treduce
from test_torch_e2e import _check_golden

torch.set_num_threads(1)

# the golden flags (tests/test_torch_e2e.py) but the seed
SHARD = ["--Nts", "4", "--ThetaM", "0.2", "--saveMode", "1", "--event_batch", "3",
         "--device", "cpu"]


def _pools(rng, E=5, P=7):
    fmom = rng.standard_normal((E, P, 3))
    fmom[0, 0, :2] = 0.0                       # phi = 0 exactly
    return dict(is_final=rng.random((E, P)) < 0.6, status=rng.integers(0, 3, (E, P)),
                fmom=fmom, weight=rng.random((E, P)), is_photon=rng.random((E, P)) < 0.5)


class _Pools:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("lo,hi,nbins", [(-np.pi, np.pi, 50), (-1.0, 0.5, 7)])
def test_weighted_histogram_matches_jax(lo, hi, nbins):
    """Values below lo, at hi and above it fall in no bin, as in JAX's."""
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-4.0, 4.0, 200), [lo, hi, hi + 1.0, lo - 1.0]])
    w = rng.random(x.shape[0])
    got = treduce.weighted_histogram(torch.as_tensor(x), torch.as_tensor(w), nbins, lo, hi)
    want = jreduce.weighted_histogram(jnp.asarray(x), jnp.asarray(w), nbins, lo, hi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)


def test_pulse_profile_from_pools_matches_jax():
    rng = np.random.default_rng(5)
    p = _pools(rng)
    sbw, sln = rng.random(5), rng.random(5) * 100.0
    got = treduce.pulse_profile_from_pools(
        _Pools(**{k: torch.as_tensor(v) for k, v in p.items()}), torch.as_tensor(sbw),
        torch.as_tensor(sln), nbins=16)
    want = jreduce.pulse_profile_from_pools(
        _Pools(**{k: jnp.asarray(v) for k, v in p.items()}), jnp.asarray(sbw),
        jnp.asarray(sln), nbins=16)
    for g, w in zip(got, want):
        assert float(g.sum()) > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """The golden flags through --mesh 1: the rows of no mesh."""
    d = tmp_path_factory.mktemp("mesh1")
    return run_from_args(SHARD + ["--seed", "1769", "--mesh", "1", "--dir_tag", str(d),
                                  "--ftag", "mesh1"])[0]


def test_mesh1_rows_are_golden(mesh1):
    """mesh_devices=1 at the golden flags writes the JAX golden rows."""
    _check_golden(mesh1)


def test_mesh2_matches_mesh1(mesh1, tmp_path):
    """Two virtual CPU shards (3 events padded to 4, the padding's rows
    dropped) against no mesh, as tests/test_sharding.py:27-51 holds JAX's:
    event, species, node count, stop code and c_bck bitwise, the rest
    within 1e-9."""
    rows1 = mesh1
    rows2, _, st = run_from_args(SHARD + ["--seed", "1769", "--mesh", "2", "--dir_tag",
                                          str(tmp_path), "--ftag", "mesh2"])
    assert st.events == 3 and rows2.shape == rows1.shape
    for col in (0, 1, 20, 21, 27):
        np.testing.assert_array_equal(rows2[:, col], rows1[:, col])
    np.testing.assert_allclose(rows2, rows1, rtol=1e-9, atol=1e-300)



def test_event_pipeline_sharded_mesh_invariant():
    """event_pipeline_sharded (kinematics, backtrace, forward tree and the
    pulse-profile histograms per shard, summed over the shards and the
    process group) on one shard and on two virtual CPU shards, as
    tests/test_sharding.py:54-80 holds JAX's at 1 and 8 devices on 8
    events (two events here, each pipeline ~5 s on the eager CPU engine):
    sln_base, samp_back_weight and the photon histogram agree."""
    import __graft_entry__ as ge
    from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig
    from adiabatic_raytracer_tpu_torch.parallel.mesh import (
        event_pipeline_sharded, make_mesh, shard_inputs)

    sc = Scene(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
               mass_ns=1.0)
    cfg = NumericsConfig(interp_points=4, max_crossings=4, max_steps=2000, bisect_iters=30)
    tcfg = TreeConfig(num_cutoff=1, mc_nodes=1, max_nodes=2)
    x, v, erg = ge._synthetic_events(2, seed=3)
    outs = []
    for nd in (1, 2):
        mesh = make_mesh(nd, "cpu")
        fn = event_pipeline_sharded(mesh, sc, cfg, tcfg, maxR=25.0, lnt_end=float(np.log(1e-3)),
                                    nbins=16)
        r = fn(*shard_inputs(mesh, np.arange(2), x, v, erg))
        outs.append((r.sln_base.numpy(), r.bt.samp_back_weight.numpy(), r.hists[0].numpy()))
    assert outs[0][2].sum() > 0
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-12)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-10)
    np.testing.assert_allclose(outs[1][2], outs[0][2], rtol=1e-10)
