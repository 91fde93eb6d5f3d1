"""The port's CompactedPropagator against the JAX package's on the same
rays and settings, within tests/test_streaming.py's bars.  The rays are the
first 8 of that test's 64-ray input (the slowest takes 125 steps);
chunk_iters 16 and min_pool 4 compact both pools 8 -> 4.  JAX's side
compiles one program per pool size (~35 s on one CPU core for the two;
a third, at min_pool 2, would add ~18 s)."""

import jax.numpy as jnp
import numpy as np
import torch

from adiabatic_raytracer_tpu.config import NumericsConfig as JNumericsConfig
from adiabatic_raytracer_tpu.config import Scene as JScene
from adiabatic_raytracer_tpu.ops.streaming import CompactedPropagator as JCompactedPropagator
from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene
from adiabatic_raytracer_tpu_torch.ops.streaming import CompactedPropagator
from test_torch_streaming import N, _rays

torch.set_num_threads(1)

SCENE = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
             mass_ns=1.0)


def test_compacted_matches_jax_compacted():
    """n_cross exact, mean step-count difference under 5% of the mean, traj
    rtol/atol 1e-4, xc rtol 1e-4 and atol 1e-6 (tests/test_streaming.py's
    bars for JAX's compacted against its monolithic propagate)."""
    x, v, args = _rays()
    order = ("erg", "delta_w", "lnt0", "lnt1", "is_photon", "max_crossings")
    cp = CompactedPropagator(Scene(**SCENE), NumericsConfig(interp_points=8), species="photon", chunk_iters=16, min_pool=4)
    got = cp.run(x, v, *(args[k] for k in order))
    assert cp.pool_sizes[0] == N and min(cp.pool_sizes) == 4

    jcp = JCompactedPropagator(JScene(**SCENE), JNumericsConfig(interp_points=8),
                               species="photon", chunk_iters=16, min_pool=4)
    jargs = {k: jnp.asarray(args[k].numpy()) for k in order}
    jargs["max_crossings"] = jargs["max_crossings"].astype(jnp.int32)
    want = jcp.run(jnp.asarray(x.numpy()), jnp.asarray(v.numpy()), *(jargs[k] for k in order))

    np.testing.assert_array_equal(got.n_cross.numpy(), np.asarray(want.n_cross))
    steps, jsteps = got.steps.numpy(), np.asarray(want.steps)
    assert np.mean(np.abs(steps - jsteps)) < 0.05 * np.mean(jsteps)
    np.testing.assert_allclose(got.traj.numpy(), np.asarray(want.traj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.xc.numpy(), np.asarray(want.xc), rtol=1e-4, atol=1e-6)
