"""Port physics (metric, fields, geometry, dispersion, conversion) against the
JAX f64 functions on the point sets of test_metric.py, test_fields.py and
test_conversion.py plus a seeded random set.  Tolerance rtol 1e-10 with an
absolute floor of 1e-10 x the largest |value| of each output (libm rounding
is the only slack; the floor covers outputs that cancel to ~0)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.models import magnetosphere as jmag
from adiabatic_raytracer_tpu.models import metric as jmet
from adiabatic_raytracer_tpu.ops import conversion as jconv
from adiabatic_raytracer_tpu.ops import dispersion as jdisp
from adiabatic_raytracer_tpu.ops import geometry as jgeo
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.models import magnetosphere as tmag
from adiabatic_raytracer_tpu_torch.models import metric as tmet
from adiabatic_raytracer_tpu_torch.ops import conversion as tconv
from adiabatic_raytracer_tpu_torch.ops import dispersion as tdisp
from adiabatic_raytracer_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.3, omega_pul=1.0, b0=1e14, r_ns=10.0,
          mass_ns=1.0)


def scenes(**over):
    kw = dict(KW, **over)
    return jcfg.Scene(**kw), tcfg.Scene(**kw)


def close(got, want, rtol=1e-10):
    got = [np.asarray(g.detach().numpy() if torch.is_tensor(g) else g, np.float64)
           for g in (got if isinstance(got, (tuple, list)) else [got])]
    want = [np.asarray(w, np.float64) for w in (want if isinstance(want, (tuple, list)) else [want])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale)


def sph_points():
    fixed = np.array([[25.0, 0.7, 1.3], [5.0, 1.0, 0.5], [10.0 - 1e-9, 1.0, 0.5],
                      [10.0 + 1e-9, 1.0, 0.5], [30.0, 0.9, 0.3], [22.0, 1.2, -0.7],
                      [15.0, 0.8, 1.1], [40.0, 0.8, 1.1], [25.0, 1.0, 0.9]])
    rng = np.random.default_rng(0)
    rnd = np.stack([rng.uniform(3.0, 60.0, 48), np.arccos(rng.uniform(-0.95, 0.95, 48)),
                    rng.uniform(-np.pi, np.pi, 48)], axis=1)
    return np.concatenate([fixed, rnd])


def cart_points(n=24, seed=1):
    rng = np.random.default_rng(seed)
    s = sph_points()[9:9 + n]
    s[:, 0] = rng.uniform(11.0, 40.0, n)
    x = np.stack([s[:, 0] * np.sin(s[:, 1]) * np.cos(s[:, 2]),
                  s[:, 0] * np.sin(s[:, 1]) * np.sin(s[:, 2]), s[:, 0] * np.cos(s[:, 1])], 1)
    x[0] = [12.0, 4.0, 18.0]
    k = rng.normal(size=(n, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    k[0] = [0.2, -0.3, 0.93]
    return x, k


T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
J = lambda a: jnp.asarray(np.asarray(a), dtype=jnp.float64)


@pytest.mark.parametrize("mass", [1.0, 0.0, 1.5])
def test_metric_and_christoffel(mass):
    x = sph_points()
    close(tmet.metric_inverse(T(x), mass), jmet.metric_inverse(J(x), mass))
    close(tmet.christoffel(T(x), mass), jmet.christoffel(J(x), mass))


@pytest.mark.parametrize("t", [0.0, 0.37])
def test_fields(t):
    x = sph_points()
    js, ts = scenes()
    args = (t, js.theta_m, js.omega_pul, js.b0, js.r_ns)
    close(tmag.dipole_sph(T(x), *args), jmag.dipole_sph(J(x), *args))
    for zero_in in (True, False):
        for bl in (-1.0, 0.6):
            close(tmag.omega_p_sph(T(x), *args, mass_a=1e-5, bndry_lyr=bl, zero_in=zero_in),
                  jmag.omega_p_sph(J(x), *args, mass_a=1e-5, bndry_lyr=bl, zero_in=zero_in))
    xc, _ = cart_points()
    close(tmag.omega_p_cart(T(xc), *args), jmag.omega_p_cart(J(xc), *args))
    close(tmag.b_cart(T(xc), *args), jmag.b_cart(J(xc), *args))
    close(tmag.b_sph_lower(T(x), *args, 1.0), jmag.b_sph_lower(J(x), *args, 1.0))
    for c in range(4):
        close(tmag.b_sph_component(T(x), *args, 1.0, c),
              jmag.b_sph_component(J(x), *args, 1.0, c))
    for tm in (0.2, 2.0):
        close(tmag.conversion_surface_radius(1e-5, tm, 1.0, 1e14, 10.0),
              jmag.conversion_surface_radius(1e-5, tm, 1.0, 1e14, 10.0))


def test_geometry():
    xc, k = cart_points()
    xs = sph_points()
    close(tgeo.cart_to_sph(T(xc)), jgeo.cart_to_sph(J(xc)))
    close(tgeo.sph_to_cart(T(xs)), jgeo.sph_to_cart(J(xs)))
    close(tgeo.cart_vel_to_sph(T(xc), T(k)), jgeo.cart_vel_to_sph(J(xc), J(k)))
    for m in (1.0, 0.0):
        w_t = tgeo.celerity_from_cart(T(xc), T(k), m)
        close(w_t, jgeo.celerity_from_cart(J(xc), J(k), m))
        s = tgeo.cart_to_sph(T(xc))
        close(tgeo.celerity_to_cart_vel(s, w_t, m),
              jgeo.celerity_to_cart_vel(J(s.numpy()), J(w_t.numpy()), m))
        close(tgeo.spatial_norm(s, w_t, m), jgeo.spatial_norm(J(s.numpy()), J(w_t.numpy()), m))


@pytest.mark.parametrize("mode", ["melrose", "iso", "full"])
def test_dispersion(mode):
    over = {"melrose": {}, "iso": {"isotropic": True}, "full": {"melrose": False}}[mode]
    js, ts = scenes(**over)
    xc, kd = cart_points()
    xs = tgeo.cart_to_sph(T(xc)).numpy()
    erg = 1.0000005e-5
    kk = tgeo.celerity_from_cart(T(xc), T(kd), 1.0).numpy() * 1e-5
    close(tdisp.k_par(T(xs), T(kk), 0.2, ts, 1.0), jdisp.k_par(J(xs), J(kk), 0.2, js, 1.0))
    close(tdisp.ctheta_b_sphere(T(xs), T(kk), 0.2, ts, 1.0),
          jdisp.ctheta_b_sphere(J(xs), J(kk), 0.2, js, 1.0))
    close(tdisp.hamiltonian_photon(T(xs), T(kk), 0.2, erg, ts, 1.0),
          jdisp.hamiltonian_photon(J(xs), J(kk), 0.2, erg, js, 1.0))
    close(tdisp.hamiltonian_axion(T(xs), T(kk), erg, 1.0),
          jdisp.hamiltonian_axion(J(xs), J(kk), erg, 1.0))
    if mode != "full":
        close(tdisp.omega_function(T(xs), T(kk), 0.2, ts, 1.0),
              jdisp.omega_function(J(xs), J(kk), 0.2, js, 1.0))
    for ph, fix in ((True, True), (True, False), (False, False)):
        close(tdisp.k_norm_cart(T(xc), T(kd), 0.0, erg, ts, 1.0, is_photon=ph, ax_fix=fix),
              jdisp.k_norm_cart(J(xc), J(kd), 0.0, erg, js, 1.0, is_photon=ph, ax_fix=fix))
    close(tdisp.k_sphere(T(xc), T(kd), 1.0, flat=True),
          jdisp.k_sphere(J(xc), J(kd), 1.0, flat=True))


def _batched(jfn, tfn, *arrays):
    want = jax.jit(jax.vmap(jfn))(*[J(a) for a in arrays])
    got = torch.func.vmap(tfn)(*[T(a) for a in arrays])
    close(got, want)


@pytest.mark.parametrize("iso", [False, True])
def test_conversion(iso):
    js, ts = scenes(isotropic=iso)
    xc, kd = cart_points(12, seed=3)
    erg = 1.0000005e-5
    k_on = tdisp.k_norm_cart(T(xc), T(kd), 0.0, erg, ts, 1.0, is_photon=True,
                             ax_fix=True).numpy()
    ksph = tdisp.k_sphere(T(xc), T(k_on), 1.0).numpy()
    xs = tgeo.cart_to_sph(T(xc)).numpy()
    w = np.full(len(xc), erg / np.sqrt(1 - 2 * 1.32712e11 / 2.99792e5**2 / xs[:, 0]))
    _batched(lambda x, k: jconv.k_gamma(x, k, 0.0, erg, js, 1.0),
             lambda x, k: tconv.k_gamma(x, k, 0.0, erg, ts, 1.0), xs, ksph)
    _batched(lambda x, k, e: jconv.dwp_ds(x, k, 0.0, e, js, 1.0),
             lambda x, k, e: tconv.dwp_ds(x, k, 0.0, e, ts, 1.0), xc, ksph, w)
    _batched(lambda x, k, e: jconv.conversion_prob(x, k, 0.0, e, js, 1.0),
             lambda x, k, e: tconv.conversion_prob(x, k, 0.0, e, ts, 1.0), xs, ksph, w)
    _batched(lambda x, k: jconv.get_prob_nonad(x, k, erg, js),
             lambda x, k: tconv.get_prob_nonad(x, k, erg, ts), xc, k_on)
    _batched(lambda x: jconv.g_det(x, 0.0, js, 1.0), lambda x: tconv.g_det(x, 0.0, ts, 1.0), xs)
    v = np.tile([[0.5, -0.3, 0.45]], (len(xc), 1)) * (1 + 0.1 * kd)
    _batched(lambda x, vv: jconv.jacobian_fv(x, vv), lambda x, vv: tconv.jacobian_fv(x, vv),
             xc, v)
    for c in range(3):
        _batched(lambda th, ph, r, vv: jconv.v_infinity(th, ph, r, vv, v_comp=c),
                 lambda th, ph, r, vv: tconv.v_infinity(th, ph, r, vv, v_comp=c),
                 xs[:, 1], xs[:, 2], xs[:, 0], v)
