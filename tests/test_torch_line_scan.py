"""K1's plain version and the port's sampler against the JAX sampler.

The JAX side runs its plain XLA path (the Pallas kernel body _condition_block
is plain jnp); the CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py).  At a boundary-layer scene the comparison is
with the JAX XLA condition (sampler._line_condition) only: the Pallas body
has no boundary-layer term, while the port's K1 has it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.ops import pallas_kernels as jpk
from adiabatic_raytracer_tpu.ops import sampler as jsamp
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, theta_m=0.4, omega_pul=1.0, b0=1e14, r_ns=10.0, mass_ns=1.0)


def lines(B=8, N=512, seed=0):
    rng_ = np.random.default_rng(seed)
    vvec = rng_.normal(size=(B, 3))
    vvec /= np.linalg.norm(vvec, axis=1, keepdims=True)
    x0 = rng_.normal(size=(B, 3)) * 5.0 - vvec * 27.0
    vloc = rng_.normal(size=(B, 3))
    vloc /= np.linalg.norm(vloc, axis=1, keepdims=True)
    erg = np.full(B, 1.0000005e-5)
    return x0, vvec, vloc, erg, np.linspace(0.0, 55.0, N)


def jax_block(x0, vvec, vloc, erg, s, sc, dtype):
    c = lambda a: jnp.asarray(a, dtype)
    p = lambda i: c(x0[:, i])[:, None] + c(s)[None, :] * c(vvec[:, i])[:, None]
    col = lambda a, i: c(a[:, i])[:, None]
    return np.asarray(jpk._condition_block(
        p(0), p(1), p(2), col(vloc, 0), col(vloc, 1), col(vloc, 2), c(erg)[:, None],
        np.cos(sc.theta_m), np.sin(sc.theta_m), sc.omega_pul, sc.b0, sc.r_ns,
        sc.mass_ns, sc.mass_a, False), np.float64)


def test_plain_condition_matches_jax_block_f64():
    """sampler._line_condition on the [B, N] grid (K1's plain version, here in
    f64) against the Pallas kernel body evaluated as jnp in f64."""
    sc = tcfg.Scene(**KW)
    x0, vvec, vloc, erg, s = lines()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    p = T(x0)[:, None, :] + T(s)[None, :, None] * T(vvec)[:, None, :]
    got = sampler._line_condition(p, T(vloc)[:, None, :], T(erg)[:, None], sc,
                                  sc.mass_ns).numpy()
    want = jax_block(x0, vvec, vloc, erg, s, jcfg.Scene(**KW), jnp.float64)
    # f64 both; the kernel body takes the azimuthal trig from Cartesian ratios
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_line_scan_cpu_wrapper_is_f32_plain():
    """On CPU tensors the K1 wrapper runs its plain version in f32: agreement
    with the f32 kernel body to f32 rounding (the JAX kernel test's bar)."""
    sc = tcfg.Scene(**KW)
    x0, vvec, vloc, erg, s = lines()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = line_scan.line_scan(T(x0), T(vvec), T(vloc), T(erg), T(s), sc, sc.mass_ns)
    assert got.dtype == torch.float32 and got.shape == (8, 512)
    want = jax_block(x0, vvec, vloc, erg, s, jcfg.Scene(**KW), jnp.float64)
    got = got.numpy().astype(np.float64)
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert np.max(rel) < 1e-4, np.max(rel)
    mask = np.abs(want) > 1e-3
    np.testing.assert_array_equal(np.sign(got[mask]), np.sign(want[mask]))


def test_plain_condition_matches_jax_xla_bndry_f64():
    """K1's plain condition (sampler._line_condition, which line_scan_plain
    evaluates in f32) at a boundary-layer scene against the JAX XLA
    condition, both in f64, rtol 1e-10; the term is live on these lines."""
    sc = tcfg.Scene(**KW, bndry_lyr=0.5)
    jsc = jcfg.Scene(**KW, bndry_lyr=0.5)
    x0, vvec, vloc, erg, s = lines()
    p = x0[:, None, :] + s[None, :, None] * vvec[:, None, :]
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = sampler._line_condition(T(p), T(vloc)[:, None, :], T(erg)[:, None], sc,
                                  sc.mass_ns).numpy()
    cond = jax.vmap(jax.vmap(lambda pp, vl, e: jsamp._line_condition(
        pp, vl, e, jsc, jsc.mass_ns, True), (0, None, None)), (0, 0, 0))
    want = np.asarray(cond(jnp.asarray(p), jnp.asarray(vloc), jnp.asarray(erg)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    base = sampler._line_condition(T(p), T(vloc)[:, None, :], T(erg)[:, None],
                                   tcfg.Scene(**KW), sc.mass_ns).numpy()
    assert np.mean(np.abs(got - base) > 1e-3 * (1.0 + np.abs(got))) > 0.05
    # the CPU wrapper: the same condition in f32, to f32 rounding
    got32 = line_scan.line_scan(T(x0), T(vvec), T(vloc), T(erg), T(s), sc, sc.mass_ns)
    rel = np.abs(got32.numpy().astype(np.float64) - want) / (1.0 + np.abs(want))
    assert np.max(rel) < 1e-4, np.max(rel)


def check_sample_batch(compute_dtype, engine, **scene):
    jsc = jcfg.Scene(**dict(KW, theta_m=0.2, **scene))
    tsc = tcfg.Scene(**dict(KW, theta_m=0.2, **scene))
    kw = dict(n_grid=768, n_max=6, compute_dtype=compute_dtype)
    ref = jsamp.sample_batch(jax.random.PRNGKey(42), 32, 25.0, jsc, jsc.mass_ns,
                             line_engine="xla", **kw)
    got = sampler.sample_batch(rng.PRNGKey(42), 32, 25.0, tsc, tsc.mass_ns,
                               line_engine=engine, **kw)
    ok = np.asarray(ref.success)
    assert ok.sum() >= 4
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
    np.testing.assert_array_equal(got.v_ifty.numpy(), np.asarray(ref.v_ifty))
    np.testing.assert_array_equal(got.erg_inf.numpy(), np.asarray(ref.erg_inf))
    atol = 1e-9 if compute_dtype == "state" else 2e-3
    np.testing.assert_allclose(got.xpos.numpy()[ok], np.asarray(ref.xpos)[ok], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got.v_loc.numpy()[ok], np.asarray(ref.v_loc)[ok],
                               rtol=1e-6 if compute_dtype == "f32" else 1e-12)
    return got


@pytest.mark.parametrize("compute_dtype,engine", [("state", "plain"), ("f32", "kernel")])
def test_sample_batch_matches_jax(compute_dtype, engine):
    """Same key, same events: the draw stream is bit-identical, successes and
    crossing counts agree, roots within 2e-3 km (tests/test_pallas.py:79-80)."""
    check_sample_batch(compute_dtype, engine)


@pytest.mark.parametrize("compute_dtype,engine", [("state", "plain"), ("f32", "kernel")])
def test_sample_batch_bndry_matches_jax(compute_dtype, engine):
    """test_sample_batch_matches_jax at bndry_lyr 0.5, against the JAX XLA
    line engine (never the Pallas kernel, which drops the term): the
    boundary layer changes the sampled surface."""
    got = check_sample_batch(compute_dtype, engine, bndry_lyr=0.5)
    base = sampler.sample_batch(rng.PRNGKey(42), 32, 25.0, tcfg.Scene(**dict(KW, theta_m=0.2)),
                                1.0, n_grid=768, n_max=6, compute_dtype=compute_dtype,
                                line_engine=engine)
    assert not torch.equal(got.weight, base.weight)
