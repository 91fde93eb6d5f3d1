"""The geometry diagnostics (ops/geometry.py) and the radiative extras
(ops/radiative.py) against the JAX package in f64, within 1e-10 relative,
on the inputs of tests/test_geometry_diag.py and tests/test_radiative.py,
single points and a small batch through torch.func.vmap (the JAX side
jitted: its eager grads cost seconds a call on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.models import magnetosphere as jmag
from adiabatic_raytracer_tpu.ops import dispersion as jdisp
from adiabatic_raytracer_tpu.ops import geometry as jgeo
from adiabatic_raytracer_tpu.ops import radiative as jrad
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.models import magnetosphere as tmag
from adiabatic_raytracer_tpu_torch.ops import dispersion as tdisp
from adiabatic_raytracer_tpu_torch.ops import geometry as tgeo
from adiabatic_raytracer_tpu_torch.ops import radiative as trad

torch.set_num_threads(1)

RTOL = 1e-10
SCENE = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.3, omega_pul=1.0, b0=1e14, r_ns=10.0,
             mass_ns=1.0)
JSC, TSC = jcfg.Scene(**SCENE), tcfg.Scene(**SCENE)
X = np.array([18.0, 6.0, 9.0])
K = np.array([-0.7, 0.2, -0.4])
T = torch.as_tensor


def _points(n=6, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x *= rng.uniform(12.0, 40.0, (n, 1)) / np.linalg.norm(x, axis=1, keepdims=True)
    return x, rng.normal(size=(n, 3))


# (name, JAX call, port call) of a single point (x, k) at t = 0.25
DIAGS = [
    ("surf_norm", lambda x, k: jgeo.surf_norm(x, k, 0.25, JSC, JSC.mass_ns),
     lambda x, k: tgeo.surf_norm(x, k, 0.25, TSC, TSC.mass_ns)),
    ("surf_norm_vec", lambda x, k: jgeo.surf_norm(x, k, 0.25, JSC, JSC.mass_ns,
                                                  return_vec=True)[1],
     lambda x, k: tgeo.surf_norm(x, k, 0.25, TSC, TSC.mass_ns, return_vec=True)[1]),
    ("angle_vg_snorm", lambda x, k: jgeo.angle_vg_snorm(x, k, 0.25, JSC, JSC.mass_ns),
     lambda x, k: tgeo.angle_vg_snorm(x, k, 0.25, TSC, TSC.mass_ns)),
    ("theta_b_cart", lambda x, k: jgeo.theta_b_cart(x, k, 0.25, JSC),
     lambda x, k: tgeo.theta_b_cart(x, k, 0.25, TSC)),
    ("dtheta_dr_proj", lambda x, k: jgeo.dtheta_dr_proj(x, k, 0.25, JSC),
     lambda x, k: tgeo.dtheta_dr_proj(x, k, 0.25, TSC)),
    ("dwdr_abs_proj", lambda x, k: jgeo.dwdr_abs_proj(x, k, 0.25, JSC),
     lambda x, k: tgeo.dwdr_abs_proj(x, k, 0.25, TSC)),
    ("d2wdr2_abs_vec", lambda x, k: jgeo.d2wdr2_abs_vec(x, k, 0.25, JSC),
     lambda x, k: tgeo.d2wdr2_abs_vec(x, k, 0.25, TSC)),
]


@pytest.mark.parametrize("name,jfn,tfn", DIAGS, ids=[d[0] for d in DIAGS])
def test_geometry_diagnostic_matches_jax(name, jfn, tfn):
    """At the point of tests/test_geometry_diag.py, then vmapped over six
    points against jax.vmap."""
    want = np.asarray(jax.jit(jfn)(jnp.asarray(X), jnp.asarray(K)))
    got = tfn(T(X), T(K)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    xs, ks = _points()
    want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(xs), jnp.asarray(ks)))
    got = torch.func.vmap(tfn)(T(xs), T(ks)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_get_crossings_matches_jax():
    """tests/test_radiative.py's series (4 crossings in 8 slots) and a
    keep_all=False, 2-slot case of it."""
    x = np.linspace(0, 4 * np.pi, 200)
    a = np.sin(x + 0.1)
    for kw in (dict(), dict(max_crossings=2, keep_all=False)):
        cj = jrad.get_crossings(jnp.asarray(a), **kw)
        ct = trad.get_crossings(T(a), **kw)
        for f in ("i1", "i2", "mask"):
            np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)))
        np.testing.assert_allclose(ct.weight.numpy(), np.asarray(cj.weight), rtol=RTOL)
        np.testing.assert_allclose(trad.apply_crossings(ct, T(x)).numpy(),
                                   np.asarray(jrad.apply_crossings(cj, jnp.asarray(x))),
                                   rtol=RTOL)
    assert int(trad.get_crossings(T(a)).mask.sum()) == 4


def _trajs():
    """tests/test_radiative.py's radially outgoing trajectory (to 5000 km:
    omega_c stays above mass_a, tau 0), and one to 2e5 km, through the
    cyclotron resonance."""
    NS = 64
    x = np.zeros((2, NS, 3))
    for i, r_max in enumerate((5000.0, 2e5)):
        rr = np.linspace(11, r_max, NS)
        x[i, :, 0], x[i, :, 2] = rr * 0.6, rr * 0.8
    k = np.broadcast_to(np.array([0.6, 0.0, 0.8]) * 1e-5, (2, NS, 3)).copy()
    return x, k, np.linspace(0, 1e-2, NS), np.array([0.0, 0.5])


def test_tau_cyc_matches_jax():
    x, k, tarr, t0 = _trajs()
    want = np.asarray(jax.jit(lambda *a: jrad.tau_cyc(*a, JSC))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(tarr), jnp.asarray(t0)))
    got = trad.tau_cyc(T(x), T(k), T(tarr), T(t0), TSC).numpy()
    assert got[0] == 0 and got[1] > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_dwdt_vec_and_dist_diff_match_jax():
    """dwdt_vec with the photon frequency (omega_function at the covariant
    celerity; its time dependence is the star's rotation); dist_diff as
    tests/test_radiative.py checks it."""
    x, k, tarr, t0 = _trajs()
    x = x[:, :16]
    k = k[:, :16]
    tarr = tarr[:16]
    jom = lambda xx, kk, t, sc: jdisp.omega_function(
        jgeo.cart_to_sph(xx), jgeo.celerity_from_cart(xx, kk, sc.mass_ns), t, sc, sc.mass_ns)
    tom = lambda xx, kk, t, sc: tdisp.omega_function(
        tgeo.cart_to_sph(xx), tgeo.celerity_from_cart(xx, kk, sc.mass_ns), t, sc, sc.mass_ns)
    want = np.asarray(jax.jit(lambda *a: jrad.dwdt_vec(*a, JSC, jom))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(tarr), jnp.asarray(t0)))
    got = trad.dwdt_vec(T(x), T(k), T(tarr), T(t0), TSC, tom).numpy()
    assert np.all(got != 0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(trad.dist_diff(T(x)).numpy(),
                               np.asarray(jrad.dist_diff(jnp.asarray(x))), rtol=RTOL, atol=0)


def test_cyclotron_freq_matches_jax():
    xs, _ = _points()
    np.testing.assert_allclose(
        tmag.cyclotron_freq_cart(T(xs), 0.25, 0.3, 1.0, 1e14, 10.0).numpy(),
        np.asarray(jmag.cyclotron_freq_cart(jnp.asarray(xs), 0.25, 0.3, 1.0, 1e14, 10.0)),
        rtol=RTOL, atol=0)
