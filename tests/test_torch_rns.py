"""The port below r_NS = 10 km against the JAX package's CPU path.

The pool engine (JAX's and the port's) takes the metric's interior branch
below 10 km whatever the scene's r_NS (metric_inverse's default), so at r_NS
< 10 km photons meet it between r_NS and 10 km; K2, K3 and K4 follow the
pool there (megakernel.METRIC_R_NS).  Two scenes at r_NS 9 km: A (MassA
1e-5, the conversion surface far outside 10 km but for the null cone of
B_z) and B (MassA 3e-5, the surface at 9-11 km).  Every test asserts that
some state or crossing it checks lay below 10 km."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.ops import conversion as jconv
from adiabatic_raytracer_tpu.ops import propagate as jprop
from adiabatic_raytracer_tpu.ops import sampler as jsamp
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
from adiabatic_raytracer_tpu_torch.ops import sampler
from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
from adiabatic_raytracer_tpu_torch.ops.geometry import celerity_to_cart_vel, sph_to_cart
from adiabatic_raytracer_tpu_torch.ops.integrator import integrate_pool
from adiabatic_raytracer_tpu_torch.ops.propagate import (
    condition_fn,
    finalize_propagate,
    launch_state,
    make_rhs,
)
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

F64 = torch.float64
R_M = mk.METRIC_R_NS
KW = dict(ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, mass_ns=1.0, r_ns=9.0)
SCENE_A = dict(KW, mass_a=1e-5)
SCENE_B = dict(KW, mass_a=3e-5)
# the four dispersion variants K2 instantiates (art::Disp)
DISPERSIONS = ({}, dict(bndry_lyr=0.5), dict(isotropic=True),
               dict(isotropic=True, bndry_lyr=0.5))
T = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
J = lambda a: jnp.asarray(np.asarray(a))


def close_cols(got, want, rtol):
    """got ~ want to rtol of each column's largest |value|."""
    scale = np.abs(want).max(axis=0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=rtol)


def zone_states(r_ns, B=32, seed=0, mass_a=1e-5):
    """[B] launch states at r in [1.02 r_NS, 10 km), lnt, erg, is_photon."""
    g = np.random.default_rng(seed)
    r = g.uniform(1.02 * r_ns, R_M, B)
    th = np.arccos(g.uniform(-0.9, 0.9, B))
    ph = g.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    erg = np.full(B, mass_a * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    sc = tcfg.Scene(**dict(KW, r_ns=r_ns, mass_a=mass_a))
    u = launch_state(T(x), T(g.normal(size=(B, 3))), sc, T(erg), -torch.ones(B, dtype=F64))
    return u, T(g.uniform(-10.0, 0.0, B)), T(erg), g.uniform(size=B) > 0.5


@pytest.mark.parametrize("r_ns", [8.0, 9.0])
def test_pool_rhs_matches_jax_rhs(r_ns):
    """The port pool's autograd RHS against JAX's make_rhs (jax.grad), both
    f64, species mixed, at the Melrose scene and at the isotropic one with
    the boundary layer, on states inside 10 km: rtol 1e-12 of each
    component's largest value (libm rounding)."""
    u, lnt, erg, is_ph = zone_states(r_ns)
    assert bool((u[:, 0] < R_M).all()) and is_ph.any() and (~is_ph).any()
    for disp in (DISPERSIONS[0], DISPERSIONS[3]):
        kw = dict(KW, r_ns=r_ns, mass_a=1e-5, **disp)
        sc = tcfg.Scene(**kw)
        got = make_rhs(sc, sc.mass_ns_eff, 0.0, "mixed")(
            u, lnt, {"erg": erg, "is_photon": torch.as_tensor(is_ph)})
        jsc = jcfg.Scene(**kw)
        jrhs = jprop.make_rhs(jsc, jsc.mass_ns, 0.0, "mixed")
        want = np.asarray(jax.jit(jax.vmap(lambda uu, ll, ee, pp: jrhs(
            uu, ll, {"erg": ee, "is_photon": pp})))(J(u), J(lnt), J(erg), J(is_ph)))
        close_cols(got.numpy(), want, 1e-12)


@pytest.fixture(scope="module")
def sampled_b():
    """The port's sampler (K1's plain version and its root finder, f64) and
    the JAX sampler (XLA line engine) on one key at scene B."""
    sc = tcfg.Scene(**SCENE_B)
    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns))
    kw = dict(n_grid=sampler.default_n_grid(maxR, scan_per_step=8), n_max=6)
    jsc = jcfg.Scene(**SCENE_B)
    ref = jsamp.sample_batch(jax.random.PRNGKey(7), 256, maxR, jsc, jsc.mass_ns,
                             line_engine="xla", **kw)
    got = sampler.sample_batch(rng.PRNGKey(7), 256, maxR, sc, sc.mass_ns, line_engine="plain",
                               **kw)
    return got, ref


def test_sampler_matches_jax_at_scene_b(sampled_b):
    """K1 needs no change below 10 km: its condition already takes the metric
    at 10 km and the launch lapse at the scene's r_NS, as the JAX sampler
    does.  Successes, weights and draws exact, roots to 1e-9 km
    (test_torch_line_scan's bars); some sampled roots lie below 10 km."""
    got, ref = sampled_b
    ok = np.asarray(ref.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(ref.weight))
    np.testing.assert_allclose(got.xpos.numpy()[ok], np.asarray(ref.xpos)[ok], rtol=0, atol=1e-9)
    assert (np.linalg.norm(got.xpos.numpy()[ok], axis=1) < R_M).sum() >= 4


@pytest.mark.parametrize("scene", ["sampled", "r_ns_8"])
def test_prob_nd_matches_jax_get_prob_nonad(scene, sampled_b):
    """The in-kernel probability's twin against JAX's get_prob_nonad (through
    conversion_prob, on the Cartesian position and momentum of each state,
    full mass) at crossing states between 1.01 r_NS and 10 km: the roots K1's
    plain version samples there at scene B (axion shell, the sampled local
    velocity), and random states at r_NS 8 km.  rtol 1e-10."""
    if scene == "sampled":
        got, _ = sampled_b
        sc = tcfg.Scene(**SCENE_B)
        r = torch.linalg.vector_norm(got.xpos, dim=1)
        ok = got.success & (r > 1.01 * sc.r_ns) & (r < R_M)
        erg = got.erg_inf[ok]
        u = launch_state(got.xpos[ok], got.v_loc[ok], sc, erg, -torch.ones_like(erg))
    else:
        sc = tcfg.Scene(**dict(KW, r_ns=8.0, mass_a=3e-5))
        u, _, erg, _ = zone_states(8.0, seed=2, mass_a=3e-5)
    r = u[:, 0]
    assert r.numel() >= 2 and bool(((r > 1.01 * sc.r_ns) & (r < R_M)).all())
    P = mk.mega_params(sc, tcfg.NumericsConfig(), with_prob=True)
    p = mk._prob_nd(P, tuple(u[:, i] for i in range(7)), erg).numpy()
    pos = sph_to_cart(u[:, :3])
    kc = celerity_to_cart_vel(u[:, :3], u[:, 3:6] * erg[:, None], sc.mass_ns)
    js = jcfg.Scene(**{k: getattr(sc, k) for k in ("mass_a", "ax_g", "theta_m", "omega_pul",
                                                   "b0", "mass_ns", "r_ns")})
    pn = jax.jit(jax.vmap(lambda x, k, e: jconv.get_prob_nonad(x, k, e, js)))(
        J(pos), J(kc), J(u[:, 6].abs()))
    want = np.clip(1.0 - np.exp(-np.asarray(pn)), 0.0, 1.0)
    assert (want > 1e-4).all()
    np.testing.assert_allclose(p, want, rtol=1e-10)


def k3_plain_photons(sc, cfg, u0, lnt0, lnt1, erg, x0):
    """Photons through K3's plain step (treekernel._step, one crossing slot,
    K2's twins) until each ray's segment ends: (final u, steps, crossed,
    root state, least r on the accepted steps)."""
    P = tk.kernel_params(sc, cfg)
    B = u0.shape[0]
    ph = torch.ones(B, dtype=F64)
    f0 = tk._f(P, u0, lnt0, erg, ph)
    S = dict(u=u0.clone(), f0=f0, is_ph=ph, lnt=lnt0.clone(), g0=tk._g(P, u0, lnt0),
             dt=tk._initial_dt(P, u0, f0, lnt1 - lnt0), errold=torch.full((B,), 1e-4, dtype=F64),
             steps=torch.zeros(B, dtype=F64), nfine=torch.zeros(B, dtype=F64),
             nbisect=torch.zeros(B, dtype=F64), lnt_ck=lnt0.clone())
    run = torch.ones(B, dtype=torch.bool)
    crossed = torch.zeros(B, dtype=torch.bool)
    u_root = torch.zeros_like(u0)
    r_min = u0[:, 0].clone()
    while bool(run.any()):
        seg_end, cr, ur, _ = tk._step(P, S, run, lnt1, erg, x0)
        crossed |= cr
        u_root[cr] = ur[cr]
        r_min = torch.minimum(r_min, S["u"][:, 0])
        run &= ~seg_end
    return S["u"], S["steps"], crossed, u_root, r_min


def test_photons_into_the_zone_match_jax_pool():
    """16 photons launched inward from 12 km at scene A (one crossing slot,
    dense event scan, 200-step cap) through the port pool and K3's plain
    step, against the JAX pool's propagate: crossing counts, step counts and
    star hits exact; the port pool's save grid and crossings against JAX at
    test_pool_propagate_matches_jax_pool's bar (rtol 1e-8), K3's final
    states and roots against the port pool's at the same bar, on every ray
    that ended by itself.  Rays fall through 9.09-10 km onto the star and
    cross the DP5 steps that straddle the metric's kink at 10 km."""
    B = 16
    g = np.random.default_rng(11)
    th = np.arccos(g.uniform(-0.9, 0.9, B))
    ph = g.uniform(-np.pi, np.pi, B)
    x = 12.0 * np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], 1)
    v = -x / 12.0 + 0.4 * g.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(B, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    lnt1 = float(np.log(1e-3))
    kw = dict(interp_points=8, interp_coarse=0, max_steps=200)
    jcf = jcfg.NumericsConfig(**kw)
    ref = jax.jit(lambda x, v, erg: jprop.propagate(
        x, v, jcfg.Scene(**SCENE_A), jcf, erg=erg, delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, -30.0), lnt1=jnp.full(B, lnt1), is_photon=jnp.ones(B, bool),
        max_crossings=jnp.ones(B, jnp.int32), species="photon"))(J(x), J(v), J(erg))

    sc, cfg = tcfg.Scene(**SCENE_A), tcfg.NumericsConfig(**kw)
    u0 = launch_state(T(x), T(v), sc, T(erg), -torch.ones(B, dtype=F64))
    lnt0, l1 = torch.full((B,), -30.0, dtype=F64), torch.full((B,), lnt1, dtype=F64)
    save_lnt = lnt0[:, None] + (l1 - lnt0)[:, None] * torch.linspace(0, 1, cfg.n_save,
                                                                     dtype=F64)[None, :]
    is_ph = torch.ones(B, dtype=torch.bool)
    res = integrate_pool(make_rhs(sc, sc.mass_ns, 0.0, "photon"), condition_fn(sc, sc.mass_ns),
                         u0, lnt0, l1, {"erg": T(erg), "is_photon": is_ph}, cfg,
                         save_lnt=save_lnt, kill_at_surface=is_ph, r_ns=sc.r_ns, x0_cart=T(x),
                         max_crossings=torch.ones(B, dtype=torch.int64))
    got = finalize_propagate(res, T(erg), sc, sc.mass_ns, save_lnt)
    k3_u, k3_steps, k3_crossed, k3_root, r_min = k3_plain_photons(sc, cfg, u0, lnt0, l1,
                                                                  T(erg), T(x))

    nc = np.asarray(ref.n_cross)
    np.testing.assert_array_equal(got.n_cross.numpy(), nc)
    np.testing.assert_array_equal(k3_crossed.numpy(), nc > 0)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(k3_steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(got.ns_hit.numpy(), np.asarray(ref.ns_hit))
    ok = ~np.asarray(ref.maxed)
    # the witness: rays below 10 km that ended by themselves, some on the star
    zone = r_min.numpy() < R_M
    assert (zone & ok).sum() >= 2 and np.asarray(ref.ns_hit).sum() >= 1 and nc.sum() >= 4
    traj = np.asarray(ref.traj)
    np.testing.assert_allclose(got.traj.numpy()[ok], traj[ok], rtol=1e-8,
                               atol=1e-8 * np.abs(traj).max())
    np.testing.assert_allclose(got.mom.numpy()[ok], np.asarray(ref.mom)[ok], rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(ref.mom)).max())
    both = nc >= 1
    np.testing.assert_allclose(got.xc.numpy()[both, 0], np.asarray(ref.xc)[both, 0], rtol=1e-8)
    close_cols(k3_u.numpy()[ok], res.u.numpy()[ok], 1e-8)
    close_cols(k3_root.numpy()[both], res.cross_u[:, 0].numpy()[both], 1e-8)


@pytest.fixture(scope="module")
def tree_runs(tmp_path_factory):
    """Scene B through the CLI on the kernel path (--engine mega
    --tree_engine kernel: K3's plain version here) and driver.run with the
    host engine at tree_k=1, K3's reference; two events (four rows)."""
    from adiabatic_raytracer_tpu_torch.cli import run_from_args
    from adiabatic_raytracer_tpu_torch.driver import run

    d = str(tmp_path_factory.mktemp("rns"))
    rows, _, st = run_from_args([
        "--Nts", "3", "--seed", "1769", "--ThetaM", "0.2", "--saveMode", "1", "--event_batch",
        "3", "--device", "cpu", "--rNS", "9", "--MassA", "3e-5", "--engine", "mega",
        "--tree_engine", "kernel", "--scan_gate_check", "0", "--dir_tag", d, "--ftag", "kern"])
    cfg = tcfg.NumericsConfig(atol=1e-6, rtol=1e-7, engine="mega", tree_k=1, scan_gate_check=0)
    host = run(tcfg.Scene(theta_m=0.2, r_ns=9.0, mass_a=3e-5), cfg, tcfg.TreeConfig(), 3,
               seed=1769, save_mode=1, event_batch=3, dir_tag=d, file_tag="host",
               device="cpu", verbose=False)
    return (rows, st), host[::2]


def test_kernel_tree_engine_matches_host_k1_at_scene_b(tree_runs):
    """test_torch_e2e's test_kernel_tree_engine_matches_host_k1 at scene B:
    rows and counters of the kernel tree engine as the host engine's (event,
    species, node count and stop code exact, rows to rtol 1e-6).  Every
    event converts below 10 km (row columns 9-11: the sampled conversion
    point), so its photons start in the metric's interior branch."""
    (rows, st), (rows_h, st_h) = tree_runs
    assert rows.shape == rows_h.shape and rows.shape[0] >= 3
    np.testing.assert_array_equal(rows[:, [0, 1, 20, 21]], rows_h[:, [0, 1, 20, 21]])
    np.testing.assert_allclose(rows, rows_h, rtol=1e-6, atol=0)
    assert (st.finals, st.tot_nodes, st.info_hist) == (st_h.finals, st_h.tot_nodes, st_h.info_hist)
    assert (np.linalg.norm(rows[:, 9:12], axis=1) < R_M).all()
