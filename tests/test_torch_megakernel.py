"""K2's torch twins against the JAX megakernel's jnp device functions, the
port's pool engine against the JAX pool, and integrate_mega_plain's output
contract.  The kernel itself runs only on the card (tests/test_torch_cuda.py).

The JAX device functions evaluate sin/cos/exp through Cody-Waite
polynomials fitted for f32 (~1e-11 and ~1e-9 relative in f64); the twin
comparison swaps those for exact jnp.sin/cos/exp, so the remaining slack
(rtol 1e-10) is libm rounding.  The boundary-layer and isotropic scenes
(the kernels' other dispersion variants) are held to the same bars."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.ops import megakernel as jmk
from adiabatic_raytracer_tpu.ops import propagate as jprop
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
from adiabatic_raytracer_tpu_torch.ops import tree
from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state, make_rhs, propagate

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
          mass_ns=1.0)
F64 = torch.float64


# the scenes of the kernels' dispersion variants other than the default
VARIANTS = {"bndry": dict(bndry_lyr=0.5), "iso": dict(isotropic=True)}


@pytest.fixture
def exact_jax_trig(monkeypatch):
    monkeypatch.setattr(jmk, "_sincos", lambda x: (jnp.sin(x), jnp.cos(x)))
    monkeypatch.setattr(jmk, "_exp32", jnp.exp)
    # _bndry_t binds the Cody-Waite exp as a default argument
    monkeypatch.setattr(jmk._bndry_t, "__defaults__", (jnp.exp,))


def states(B=64, seed=0, r_lo=11.0, r_hi=45.0, b0=1e14):
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_lo, r_hi, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    k = rng.normal(size=(B, 3))
    erg = np.full(B, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    sc = tcfg.Scene(**dict(KW, b0=b0))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    u = launch_state(T(x), T(k), sc, T(erg), -torch.ones(B, dtype=F64))
    lnt = T(rng.uniform(-10.0, 0.0, B))
    is_ph = T((rng.uniform(size=B) > 0.5).astype(np.float64))
    return u, lnt, T(erg), is_ph


def jax_consts(species, **scene):
    C = jmk.SceneConsts(jcfg.Scene(**KW, **scene), jcfg.NumericsConfig(rhs_mode="hand"))
    C.species = species
    return C


def close(got, want, rtol=1e-10):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=rtol,
                                   atol=rtol * np.abs(w).max())


def test_device_function_twins_match_jax(exact_jax_trig):
    u, lnt, erg, is_ph = states()
    ut = tuple(u[:, i] for i in range(7))
    uj = tuple(jnp.asarray(c.numpy()) for c in ut)
    lj, ej = jnp.asarray(lnt.numpy()), jnp.asarray(erg.numpy())
    P = mk.mega_params(tcfg.Scene(**KW), tcfg.NumericsConfig(), species="photon",
                       with_prob=True)
    C = jax_consts("photon")
    s, c = torch.sin(ut[1]), torch.cos(ut[1])
    close(mk._metric(P, ut[0], s), jmk._metric(C, uj[0], jnp.sin(uj[1])))
    t = torch.exp(lnt)
    close(mk._dipole_unit(P, ut[0], c, s, torch.cos(ut[2]), torch.sin(ut[2]), t),
          jmk._dipole_unit(C, uj[0], jnp.cos(uj[1]), jnp.sin(uj[1]), jnp.cos(uj[2]),
                           jnp.sin(uj[2]), jnp.exp(lj), sincos=lambda x: (jnp.sin(x), jnp.cos(x))))
    close([mk._condition(P, ut, lnt)], [jmk._condition(C, uj, lj)])
    close([mk._prob_nd(P, ut, erg)], [jmk._prob_nd(C, uj, ej)], rtol=1e-9)
    close(mk._hermite(ut, ut[::-1], ut, ut, 0.3, 0.7), jmk._hermite(uj, uj[::-1], uj, uj, 0.3, 0.7))
    for species in ("photon", "axion", "mixed"):
        P = mk.mega_params(tcfg.Scene(**KW), tcfg.NumericsConfig(), species=species)
        C = jax_consts(species)
        ph = is_ph if species == "mixed" else torch.full_like(is_ph, species == "photon")
        close(mk._rhs(P, ut, lnt, erg, ph),
              jmk._rhs(C, uj, lj, ej, jnp.asarray(ph.numpy())))


@pytest.mark.parametrize("variant", ["bndry", "iso"])
def test_variant_twins_match_jax(exact_jax_trig, variant):
    """_condition, _rhs (hand adjoint) and _bndry_t at a boundary-layer and
    at an isotropic scene against the JAX functions, photon, axion and
    mixed, at rtol 1e-10; states straddle the boundary-layer shell (~12.5
    km, decay length ~2.5 km).  The variant's terms are live: the condition
    and the photon's de7 differ from the default scene's."""
    scene = VARIANTS[variant]
    u, lnt, erg, is_ph = states(r_lo=10.2, r_hi=30.0, seed=4)
    ut = tuple(u[:, i] for i in range(7))
    uj = tuple(jnp.asarray(c.numpy()) for c in ut)
    lj, ej = jnp.asarray(lnt.numpy()), jnp.asarray(erg.numpy())
    sc = tcfg.Scene(**KW, **scene)
    P = mk.mega_params(sc, tcfg.NumericsConfig())
    P0 = mk.mega_params(tcfg.Scene(**KW), tcfg.NumericsConfig())
    C = jax_consts("photon", **scene)
    assert (P.bndry_lyr > 0, P.isotropic) == (variant == "bndry", int(variant == "iso"))
    g = mk._condition(P, ut, lnt)
    close([g], [jmk._condition(C, uj, lj)])
    assert (torch.abs(g - mk._condition(P0, ut, lnt)) > 1e-3 * torch.abs(g)).double().mean() > 0.2
    if variant == "bndry":
        bt = mk._bndry_t(P, ut[0])
        close([bt], [jmk._bndry_t(C, uj[0])])
        assert bool((bt > 0).all())
    for species in ("photon", "axion", "mixed"):
        P = mk.mega_params(sc, tcfg.NumericsConfig(), species=species)
        C = jax_consts(species, **scene)
        ph = is_ph if species == "mixed" else torch.full_like(is_ph, species == "photon")
        got = mk._rhs(P, ut, lnt, erg, ph)
        close(got, jmk._rhs(C, uj, lj, ej, jnp.asarray(ph.numpy())))
        if species != "axion":
            base = mk._rhs(mk.mega_params(tcfg.Scene(**KW), tcfg.NumericsConfig(),
                                          species=species), ut, lnt, erg, ph)
            d = torch.abs(got[6] - base[6]) / torch.abs(got[6]).clamp(min=1e-300)
            assert d[ph > 0.5].median().item() > 1e-3


@pytest.mark.parametrize("variant", ["bndry", "iso"])
def test_variant_scene_carried_across(variant):
    """A JAX Scene of the variant through config.from_jax_dict gives the
    MegaParams K1 and K2 receive: the boundary layer's scalars and the
    isotropic flag equal SceneConsts' (rtol 1e-15)."""
    js = jcfg.Scene(**KW, **VARIANTS[variant])
    sc, cfg, _ = tcfg.from_jax_dict({"scene": {k: np.asarray(v) for k, v in
                                               dataclasses.asdict(js).items()}})
    P = mk.mega_params(sc, cfg)
    C = jmk.SceneConsts(js, jcfg.NumericsConfig())
    for name in ("bndry_lyr", "bndry_pole_t", "bndry_rmax", "wp2_scale"):
        np.testing.assert_allclose(getattr(P, name), getattr(C, name), rtol=1e-15)
    assert P.isotropic == int(C.isotropic) == int(variant == "iso")
    assert (P.bndry_lyr > 0) == bool(C.has_bndry)


# the states tests/test_megakernel.py draws for the JAX hand adjoint against
# the pool (test_bndry_lyr_rhs_matches_pool_f64, around the boundary-layer
# shell; test_rhs_hand_adjoint_matches_pool_f64, interior axions included)
def jax_test_states(which):
    rng = np.random.default_rng(3)
    N = 256
    if which == "shell":
        pole_t = np.sqrt(mk._wp2_scale(tcfg.Scene(**KW)))
        rmax = 10.0 * pole_t ** (2.0 / 3.0)
        center = rmax * 0.5
        r = rng.uniform(max(11.5, center - 0.3 * rmax), center + 0.3 * rmax, N)
    else:
        r = rng.uniform(6.0, 40.0, N)
    th = rng.uniform(0.1, np.pi - 0.1, N)
    ph = rng.uniform(-np.pi, np.pi, N)
    w = rng.normal(size=(3, N))
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    erg = np.full(N, 1e-5)
    lnt = np.log(rng.uniform(1e-6, 0.5, N))
    is_ph = np.arange(N) % 2 == 0
    if which != "shell":
        is_ph &= r > 11.5
    T = lambda a: torch.as_tensor(a, dtype=F64)
    return (T(np.stack([r, th, ph, w[0], w[1], w[2], -erg], 1)), T(lnt), T(erg),
            T(is_ph.astype(np.float64)))


# the four dispersion variants K2 instantiates (art::Disp)
DISPERSIONS = ({}, VARIANTS["bndry"], VARIANTS["iso"], dict(isotropic=True, bndry_lyr=0.5))


@pytest.mark.parametrize("scene", ["default", "bndry", "iso", "rns"])
@pytest.mark.parametrize("species", ["photon", "axion", "mixed"])
def test_hand_rhs_matches_pool_rhs(species, scene):
    """The twin RHS (hand adjoint, what the kernel runs) against the pool's
    autograd RHS, including axion states inside the star, where the TPU
    kernel's r-clamped lapse factor differed from the pool; at the
    boundary-layer and isotropic scenes also on the JAX tests' states.  The
    rns scene takes r_NS 8 and 9 km under the four dispersion variants, on
    states between 1.02 r_NS and 10 km, where the photon side meets the
    metric's interior branch (mk.METRIC_R_NS)."""
    cases = [(tcfg.Scene(**KW, **VARIANTS.get(scene, {})),
              [states(r_lo=4.0, r_hi=45.0, seed=1)])]
    if scene in VARIANTS:
        cases[0][1].extend([jax_test_states("shell"), jax_test_states("wide")])
    if scene == "rns":
        cases = [(tcfg.Scene(**dict(KW, r_ns=r_ns), **disp),
                  [states(r_lo=1.02 * r_ns, r_hi=mk.METRIC_R_NS, seed=1)])
                 for r_ns in (8.0, 9.0) for disp in DISPERSIONS]
    for sc, draws in cases:
        for u, lnt, erg, is_ph in draws:
            if scene == "rns":   # every state inside the zone, photons unfrozen
                assert bool((u[:, 0] < mk.METRIC_R_NS).all() and (u[:, 0] > 1.01 * sc.r_ns).all())
            ph = is_ph > 0.5 if species == "mixed" else torch.full(is_ph.shape,
                                                                   species == "photon")
            want = make_rhs(sc, sc.mass_ns_eff, 0.0, species)(u, lnt, {"erg": erg,
                                                                       "is_photon": ph})
            P = mk.mega_params(sc, tcfg.NumericsConfig(), species=species)
            got = torch.stack(mk._rhs(P, tuple(u[:, i] for i in range(7)), lnt, erg,
                                      ph.double()), 1)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                       atol=1e-12 * want.abs().max().item())


def test_bndry_pool_backtrace_matches_jax_pool():
    """The port's pool against the JAX pool on the backtrace of
    tests/test_megakernel.py::test_bndry_lyr_backtrace_matches_pool (16 axion
    rays inbound through the boundary-layer shell, seed 8, bndry_lyr 0.5,
    B = -1e14, 8 crossing slots): identical crossing counts, crossing radii
    to 1e-8 relative; the topology differs from the scene without the
    boundary layer."""
    mk_sc = dict(KW, b0=-1e14)
    B = 16
    rng = np.random.default_rng(8)
    r = rng.uniform(16.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    v = -x / np.linalg.norm(x, axis=1, keepdims=True) + 0.3 * rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(B, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    kw = dict(interp_points=8, max_steps=3000, max_crossings=8)
    lnt1 = float(np.log(1e-2))
    jcf = jcfg.NumericsConfig(**kw)
    ref = jax.jit(lambda x, v, erg: jprop.propagate(
        x, v, jcfg.Scene(**mk_sc, bndry_lyr=0.5), jcf, erg=erg, delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, jcf.ln_t_start), lnt1=jnp.full(B, lnt1), is_photon=jnp.zeros(B, bool),
        species="axion", max_crossings=jnp.full(B, 8, jnp.int32)))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(erg))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    tcf = tcfg.NumericsConfig(**kw)
    args = dict(erg=T(erg), delta_w=-torch.ones(B, dtype=F64),
                lnt0=torch.full((B,), tcf.ln_t_start, dtype=F64),
                lnt1=torch.full((B,), lnt1, dtype=F64),
                is_photon=torch.zeros(B, dtype=torch.bool), species="axion",
                max_crossings=torch.full((B,), 8, dtype=torch.int64))
    got = propagate(T(x), T(v), tcfg.Scene(**mk_sc, bndry_lyr=0.5), tcf, **args)
    got0 = propagate(T(x), T(v), tcfg.Scene(**mk_sc), tcf, **args)
    nc = np.asarray(ref.n_cross)
    np.testing.assert_array_equal(got.n_cross.numpy(), nc)
    assert nc.max() >= 1 and nc.sum() != int(got0.n_cross.sum())
    used = np.arange(8)[None, :] < nc[:, None]
    rg = np.linalg.norm(got.xc.numpy(), axis=-1)[used]
    rr = np.linalg.norm(np.asarray(ref.xc), axis=-1)[used]
    np.testing.assert_allclose(rg, rr, rtol=1e-8)


def test_pool_propagate_matches_jax_pool():
    """Port pool vs JAX pool (f64), B=128 photons (tests/test_megakernel.py's
    setup, 64 rays, 500-step cap): identical crossing topology and step
    counts, endpoints rtol 1e-8 on every ray that ended by itself.  The RHS
    agrees to ~1e-15 per evaluation (test_hand_rhs_matches_pool_rhs); over a
    few hundred adaptive steps the libm rounding of the two frameworks grows
    to ~2e-9 relative, hence 1e-8.  A step-capped ray grinds at dt_min in a
    chaotic regime where rounding grows without bound, so it is not compared."""
    B = 64
    rng = np.random.default_rng(0)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1)
    v = rng.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    erg = np.full(B, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    lnt1 = float(np.log(1e-3))
    kw = dict(interp_points=8, max_steps=500)
    ref = jax.jit(lambda x, v, erg: jprop.propagate(
        x, v, jcfg.Scene(**KW), jcfg.NumericsConfig(**kw), erg=erg, delta_w=-jnp.ones(B),
        lnt0=jnp.full(B, -30.0), lnt1=jnp.full(B, lnt1), is_photon=jnp.ones(B, bool),
        max_crossings=jnp.ones(B, jnp.int32), species="photon"))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(erg))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    got = propagate(T(x), T(v), tcfg.Scene(**KW), tcfg.NumericsConfig(**kw), erg=T(erg),
                    delta_w=-torch.ones(B, dtype=F64), lnt0=torch.full((B,), -30.0, dtype=F64),
                    lnt1=torch.full((B,), lnt1, dtype=F64),
                    is_photon=torch.ones(B, dtype=torch.bool),
                    max_crossings=torch.ones(B, dtype=torch.int64), species="photon")
    np.testing.assert_array_equal(got.n_cross.numpy(), np.asarray(ref.n_cross))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(ref.steps))
    np.testing.assert_array_equal(got.ns_hit.numpy(), np.asarray(ref.ns_hit))
    ok = ~np.asarray(ref.maxed)
    assert ok.sum() >= B // 2
    np.testing.assert_allclose(got.traj.numpy()[ok], np.asarray(ref.traj)[ok], rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(ref.traj)).max())
    np.testing.assert_allclose(got.mom.numpy()[ok], np.asarray(ref.mom)[ok], rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(ref.mom)).max())
    both = np.asarray(ref.n_cross) >= 1
    assert both.sum() > 4
    np.testing.assert_allclose(got.xc.numpy()[both, 0], np.asarray(ref.xc)[both, 0], rtol=1e-8)


def backtrace_inputs(B=8, seed=5):
    sc = tcfg.Scene(**KW)
    rng = np.random.default_rng(seed)
    r = rng.uniform(15.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = torch.as_tensor(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                                  r * np.cos(th)], 1), dtype=F64)
    k = torch.as_tensor(rng.normal(size=(B, 3)), dtype=F64)
    erg = torch.full((B,), 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2), dtype=F64)
    sc_b = tree._negate_b(sc)
    u0 = launch_state(x, k, sc_b, erg, -torch.ones(B, dtype=F64))
    return sc_b, x, k, erg, u0


def test_integrate_mega_plain_contract():
    sc_b, x, k, erg, u0 = backtrace_inputs()
    B = x.shape[0]
    cfg = tcfg.NumericsConfig(interp_points=16, max_steps=4000)
    lnt0 = torch.full((B,), -30.0, dtype=F64)
    lnt1 = torch.zeros(B, dtype=F64)
    kw = dict(max_crossings=16, is_photon=torch.zeros(B, dtype=torch.bool), species="axion",
              with_prob=True)
    out = mk.integrate_mega_plain(u0, lnt0, lnt1, erg, x, sc_b, cfg, **kw)
    assert len(out) == 12
    uf, lntf, steps, code, nc, cru, crlnt, save_mid, pcx, chain, isph, nfine = out
    assert all(t.dtype == F64 for t in out)
    assert uf.shape == (B, 7) and cru.shape == (B, 16, 7) and pcx.shape == (B, 16)
    assert set(code.tolist()) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    assert (nc >= 1).sum() >= 2
    used = torch.arange(16)[None, :] < nc[:, None]
    assert bool((pcx[used] > 0).all() and (pcx[used] <= 1).all())
    assert bool((pcx[~used] == 0).all() and (cru[~used] == 0).all())
    mid_spanned = 0.5 * (lnt0 + lnt1) <= lntf
    assert bool((save_mid[~mid_spanned] == 0).all() and (save_mid[mid_spanned, 0] > 0).all())
    assert bool((chain == 0).all() and (isph == 0).all())
    # the wrapper runs the plain version on CPU tensors
    again = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc_b, cfg, **kw)
    for a, b in zip(out, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # in-kernel probability twin == the host chain (get_prob_nonad) at the
    # same crossings
    res = mk.propagate_mega(x, -k, sc_b, cfg, erg=erg, delta_w=-torch.ones(B, dtype=F64),
                            lnt0=lnt0, lnt1=lnt1, is_photon=torch.zeros(B, dtype=torch.bool),
                            max_crossings=16, species="axion", with_prob=True)
    ei, si = (torch.arange(16)[None, :] < res.n_cross[:, None]).nonzero(as_tuple=True)
    host = tree._prob_batch(res.xc[ei, si], res.kc[ei, si], erg[ei] * res.dwc[ei, si].abs(),
                            sc_b)[0]
    np.testing.assert_allclose(res.pcx[ei, si].numpy(), host.numpy(), rtol=1e-9)


def test_kernel_scene_checks():
    """K2 takes the boundary-layer and isotropic scenes and r_NS < 10 km; it
    still refuses the non-Melrose anisotropic dispersion.  K3 and K4 (built
    for the Melrose variant, with the in-kernel probability) take r_NS < 10
    km and refuse every scene without the in-kernel probability, naming the
    ROADMAP item, on CPU tensors (their plain versions) as on the card."""
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk

    cfg = tcfg.NumericsConfig()
    for scene in VARIANTS.values():
        mk.check_supported(tcfg.Scene(**KW, **scene), cfg, 16)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tk.check_tree_scene(tcfg.Scene(**KW, **scene), cfg)
    tk.check_tree_scene(tcfg.Scene(**KW), cfg)
    mk.check_supported(tcfg.Scene(**dict(KW, r_ns=8.0)), cfg, 1)
    tk.check_tree_scene(tcfg.Scene(**dict(KW, r_ns=8.0)), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk.check_supported(tcfg.Scene(**dict(KW, melrose=False)), cfg, 1)
    # the CPU dispatch checks the scene before the plain version runs
    z = lambda *shape: torch.zeros(shape, dtype=F64)
    blocks = (z(2, tk.ROWS), z(2, 32), z(2, 8), z(2, tk.ROWS))
    bndry = tcfg.Scene(**KW, **VARIANTS["bndry"])
    tc = tcfg.TreeConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.tree_kernel_launch(*blocks, bndry, cfg, tc, nf=1, qd=1, it_cap=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.tree_refill_launch(*blocks, bndry, cfg, tc, nf=1, qd=1, epart=2, refill_k=1,
                              it_cap=1)
