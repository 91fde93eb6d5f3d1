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


# The fused K1 kernel's algorithm (line_scan.line_roots_warp: the scan in
# rounds of 32 points with a carry, flips ranked in ballot order, a
# bisection per slot) against the sampler's torch route (sampler._roots: the
# top_k compaction and the batched bisection), bit for bit: flip counts,
# ok, and the intervals and roots of every slot that holds a root.

def sampler_lines(B, dtype, **scene):
    """B sampling lines of the production default scene (with `scene`'s
    fields changed) as the sampler draws them, and its grid."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius

    sc = tcfg.Scene(mass_a=1e-5, theta_m=0.2, b0=1e14, **scene)
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    geo = sampler._draw(rng.split(rng.PRNGKey(20261017), B), maxR, sc, 220.0, True, dtype)
    s_grid = torch.linspace(0.0, 2.2 * maxR, sampler.default_n_grid(maxR),
                            dtype=torch.float64).to(dtype)
    return sc, (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf), s_grid


def synthetic_grid(N=200):
    """Condition grids whose sign changes test the compaction's edges, f32:
    none, exact zeros, a NaN, more than 16, the last interval, across round
    boundaries (carry) and the first interval, and seeded random signs."""
    g = np.ones((8, N), np.float32)
    g[1, 10:13] = [1.0, 0.0, -1.0]            # through a zero: no flip
    g[1, 13:] = -1.0
    g[1, 150:] = 2.0                           # one flip at 149
    g[2, 20:23] = [1.0, np.nan, -1.0]          # through a NaN: no flip
    g[2, 23:] = -1.0
    g[2, 60:] = 0.5                            # one flip at 59
    g[3, 5:45] = np.where(np.arange(40) % 2, -1.0, 1.0)   # 40 flips
    g[4, N - 1] = -3.0                         # the last interval only
    g[5, 32:] = -1.0                           # 31|32, 63|64 and 95|96
    g[5, 64:] = 1.0
    g[5, 96:] = -1.0
    g[6, 1:] = -1.0                            # the first interval
    r = np.random.default_rng(5).normal(size=N).astype(np.float32)
    r[::17] = 0.0
    g[7] = r                                   # dozens of flips, zeros among them
    return torch.from_numpy(g)


def check_warp_model(g32, lines, s_grid, sc):
    """line_roots_warp on g32 against sampler._roots on g32 in the lines'
    dtype, bit for bit on every slot that holds a root."""
    x0 = lines[0]
    s_w, ok_w, n_w, idx_w = line_scan.line_roots_warp(*lines, g32, s_grid, sc, sc.mass_ns)
    s_r, ok_r, n_r = sampler._roots(*lines, g32.to(x0.dtype), s_grid, sc, sc.mass_ns)
    idx_r, g_lo_r, _ = sampler._flip_slots(g32)
    has = torch.arange(sampler.MAX_LINE_CROSSINGS)[None, :] < n_r[:, None].long()
    assert n_w.dtype == n_r.dtype == torch.int32 and torch.equal(n_w, n_r)
    assert torch.equal(idx_w >= 0, has) and torch.equal(idx_w[has], idx_r[has])
    assert torch.equal(ok_w, ok_r)
    assert s_w.dtype == x0.dtype and torch.equal(s_w[has], s_r[has])
    assert bool((s_w[~has] == 0).all())
    return n_r, ok_r


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene", [{}, {"bndry_lyr": 0.5}], ids=["production", "bndry"])
def test_line_roots_warp_matches_roots(scene, dtype):
    """On 48 sampling lines of the production and the boundary-layer scene
    (the f32 grid of line_scan_plain, the bisection in the compute dtype)."""
    sc, lines, s_grid = sampler_lines(48, dtype, **scene)
    g32 = line_scan.line_scan_plain(*lines, s_grid, sc, sc.mass_ns)
    n, ok = check_warp_model(g32, lines, s_grid, sc)
    assert int((n >= 2).sum()) >= 3 and int(ok.sum()) >= 10
    # the CPU wrapper is the plain version: the f32 grid, then _roots, with
    # s_star 0 past the flip count as the kernel writes it
    s_g, ok_g, n_g = line_scan.line_roots(*lines, s_grid, sc, sc.mass_ns)
    s_r, ok_r, n_r = sampler._roots(*lines, g32.to(dtype), s_grid, sc, sc.mass_ns)
    has = torch.arange(sampler.MAX_LINE_CROSSINGS)[None, :] < n_r[:, None]
    assert torch.equal(n_g, n_r) and torch.equal(ok_g, ok_r)
    assert torch.equal(s_g, torch.where(has, s_r, torch.zeros_like(s_r)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_line_roots_warp_synthetic_grids(dtype):
    """On synthetic grids (synthetic_grid) along real lines: the compaction's
    edge cases, and the bisection and filter of the slots they give."""
    g32 = synthetic_grid()
    x0, vvec, vloc, erg, _ = lines(B=8, N=g32.shape[1], seed=3)
    T = lambda a: torch.as_tensor(a, dtype=dtype)
    sc = tcfg.Scene(**KW)
    s_grid = T(np.linspace(0.0, 55.0, g32.shape[1]))
    n, _ = check_warp_model(g32, (T(x0), T(vvec), T(vloc), T(erg)), s_grid, sc)
    assert n.tolist() == [0, 1, 1, 40, 1, 3, 1, int(n[7])] and int(n[7]) > 16


def line_sin_theta_f32(p):
    """A torch replica, in f32, of K1's `line_sin_theta<float>`
    (csrc/physics.cuh): sin(theta) from the cylindrical radius where
    1 - cos^2(theta) < 1e-4, else from cos(theta) as the plain version."""
    p = p.to(torch.float32)
    rr = torch.sqrt((p * p).sum(dim=-1))
    cz = p[..., 2] / rr
    s2 = 1.0 - cz * cz
    pole = torch.clamp(torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) / rr, min=1e-15)
    return torch.where(s2 < 1e-4, pole, torch.sqrt(torch.clamp(s2, min=1e-30))), s2


def test_line_sin_theta_f32_pole_form():
    """K1's f32 sin(theta) within 0.6 degrees of either pole, where the f32
    form of the plain version, sqrt(1 - cz^2), keeps few digits (the pole
    form takes over at 1 - cz^2 < 1e-4, 0.573 degrees): the
    replica's relative error against f64 stays at f32 rounding, the old
    form's does not (the witness that these points need the pole form);
    away from the poles the replica is the old form bitwise."""
    rng_ = np.random.default_rng(5)
    n = 4096
    r = rng_.uniform(9.0, 12.0, n)
    th = rng_.uniform(1e-4, np.deg2rad(0.57), n)
    th = np.where(rng_.random(n) < 0.5, th, np.pi - th)
    ph = rng_.uniform(0.0, 2.0 * np.pi, n)
    p = torch.tensor(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                               r * np.cos(th)], axis=1))
    p32 = p.to(torch.float32).double()   # the f32 point, exactly, in f64
    exact = torch.sqrt(p32[:, 0] ** 2 + p32[:, 1] ** 2) / p32.norm(dim=1)
    st, s2 = line_sin_theta_f32(p)
    assert bool((s2 < 1e-4).all())
    rel = ((st.double() - exact).abs() / exact).max().item()
    old = torch.sqrt(torch.clamp(s2, min=1e-30)).double()
    rel_old = ((old - exact).abs() / exact).max().item()
    assert rel < 1e-6 and rel_old > 1e-3, (rel, rel_old)
    th_far = rng_.uniform(np.deg2rad(0.6), np.pi - np.deg2rad(0.6), n)
    q = torch.tensor(np.stack([r * np.sin(th_far) * np.cos(ph), r * np.sin(th_far) * np.sin(ph),
                               r * np.cos(th_far)], axis=1))
    st_far, s2_far = line_sin_theta_f32(q)
    far = s2_far >= 1e-4
    assert int(far.sum()) > n // 2
    assert torch.equal(st_far[far], torch.sqrt(s2_far[far]))
