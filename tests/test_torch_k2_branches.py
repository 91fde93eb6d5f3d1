"""K2's last branches against the JAX package (ops/megakernel.py of both):
the canonical condition, the vjp RHS, the native gate's f32 trig, the
chunked relaunch (`backtrace_chunk`) and the MEGA_* environment overrides;
and torch's f32 sin/cos/exp against the JAX package's utils/precise.py.

The kernels themselves run only on the card (chip_smoke.py phase 26); here
the twins and the plain versions run.  The JAX device functions take the
exact jnp sin/cos/exp (test_torch_megakernel.exact_jax_trig's pattern) under
x64, so the slack is libm rounding."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu.ops import megakernel as jmk
from adiabatic_raytracer_tpu.utils import precise as jprecise
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch import driver
from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state
from test_torch_megakernel import F64, KW, close, exact_jax_trig  # noqa: F401  (a fixture)

torch.set_num_threads(1)

# the scenes of JAX's test_condition_fast_matches_canonical
SCENES = {"aniso": {}, "iso": dict(isotropic=True, melrose=False), "bndry": dict(bndry_lyr=0.5)}


def jax_consts(species, cfg=None, **scene):
    C = jmk.SceneConsts(jcfg.Scene(**KW, **scene), cfg or jcfg.NumericsConfig())
    C.species = species
    return C


def to_jax(*ts):
    return tuple(jnp.asarray(t.numpy()) for t in ts)


def canonical_states(name, N=512):
    """JAX's test_condition_fast_matches_canonical states (seed 11; theta
    beyond pi for half of them; |e7| >= mass_a), in f64."""
    rng = np.random.default_rng(11 + list(SCENES).index(name))
    P = mk.mega_params(tcfg.Scene(**KW, **SCENES[name]), tcfg.NumericsConfig())
    r = rng.uniform(11.0, 4.0 * P.bndry_rmax, N)
    th = np.concatenate([rng.uniform(0.1, np.pi - 0.1, N // 2),
                         rng.uniform(np.pi + 0.1, 2 * np.pi - 0.1, N - N // 2)])
    ph = rng.uniform(-np.pi, np.pi, N)
    w = rng.normal(size=(3, N))
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    e7 = -np.full(N, 1e-5) * rng.uniform(1.0, 1.2, N)
    lnt = np.log(rng.uniform(1e-6, 0.5, N))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    return tuple(T(v) for v in (r, th, ph, w[0], w[1], w[2], e7)), T(lnt)


@pytest.mark.parametrize("name", list(SCENES))
def test_condition_canonical_matches_jax_and_fast(exact_jax_trig, name):
    """_condition_canonical (cond_mode "canonical", the twin of
    art::condition_canonical) against JAX's _condition_canonical at rtol
    1e-12, and against the port's fast _condition to rounding away from its
    roots (the reference's oracle test, held in f64); P.modes picks it in
    _condition."""
    u, lnt = canonical_states(name)
    sc = tcfg.Scene(**KW, **SCENES[name])
    P = mk.mega_params(sc, tcfg.NumericsConfig(cond_mode="canonical"))
    assert P.modes.cond == "canonical"
    g_can = mk._condition_canonical(P, u, lnt)
    assert torch.equal(mk._condition(P, u, lnt, gate=True), g_can)
    C = jax_consts("mixed", **SCENES[name])
    close([g_can], [jmk._condition_canonical(C, to_jax(*u), jnp.asarray(lnt.numpy()))], 1e-12)
    g_fast = mk._condition(mk.mega_params(sc, tcfg.NumericsConfig()), u, lnt)
    d = torch.abs(g_fast - g_can)
    assert d.max().item() < 1e-13
    far = torch.abs(g_can) > 1e-2
    assert far.double().mean() > 0.5
    assert (d[far] / torch.abs(g_can[far])).max().item() < 1e-12


def rhs_states(r_lo, r_hi, N=256, seed=5):
    """States around the star (axions inside it where r_lo < r_NS), half
    photons; theta in (0, pi)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_lo, r_hi, N)
    th = rng.uniform(0.1, np.pi - 0.1, N)
    ph = rng.uniform(-np.pi, np.pi, N)
    w = rng.normal(size=(3, N))
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    erg = np.full(N, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2))
    lnt = np.log(rng.uniform(1e-6, 0.5, N))
    is_ph = (np.arange(N) % 2 == 0).astype(np.float64)
    T = lambda a: torch.as_tensor(a, dtype=F64)
    u = tuple(T(v) for v in (r, th, ph, w[0], w[1], w[2], -erg * rng.uniform(1.0, 1.1, N)))
    return u, T(lnt), T(erg), T(is_ph)


@pytest.mark.parametrize("scene", ["aniso", "bndry", "iso", "rns"])
def test_vjp_rhs_matches_jax_and_hand(exact_jax_trig, scene):
    """_rhs at rhs_mode "vjp" (_grad_h_vjp: torch.func.grad of
    _hamiltonian_nd, the twin of art::grad_h_vjp) against JAX's _rhs at
    rhs_mode "vjp" at r >= 10 km (rtol 1e-10; species mixed, half photons,
    so both Hamiltonians), and against the port's hand adjoint at rtol 1e-12
    at every r (photon, axion, mixed), axions inside the star and the
    metric's interior branch (r_NS 9 km) included."""
    extra = {"aniso": {}, "bndry": dict(bndry_lyr=0.5), "iso": dict(isotropic=True),
             "rns": dict(r_ns=9.0)}[scene]
    sc = tcfg.Scene(**dict(KW, **extra))
    for species in ("photon", "axion", "mixed"):
        P = mk.mega_params(sc, tcfg.NumericsConfig(rhs_mode="vjp"), species=species)
        Ph = mk.mega_params(sc, tcfg.NumericsConfig(), species=species)
        u, lnt, erg, is_ph = rhs_states(5.0, 40.0)
        ph = is_ph if species == "mixed" else torch.full_like(is_ph, species == "photon")
        close(mk._rhs(P, u, lnt, erg, ph), mk._rhs(Ph, u, lnt, erg, ph), 1e-12)
        if scene == "rns" or species != "mixed":
            continue
        u, lnt, erg, is_ph = rhs_states(10.0, 40.0, seed=6)
        ph = is_ph if species == "mixed" else torch.full_like(is_ph, species == "photon")
        C = jax_consts(species, jcfg.NumericsConfig(rhs_mode="vjp"), **extra)
        assert C.rhs_mode == "vjp"
        close(mk._rhs(P, u, lnt, erg, ph),
              jmk._rhs(C, to_jax(*u), *to_jax(lnt, erg), jnp.asarray(ph.numpy())), 1e-10)


def test_native_gate_trig_matches_jax():
    """The native gate's sin/cos/exp (f32 on the f32-cast argument, the twin
    of the card's __sincosf / __expf) against JAX's _sincos_gate and
    _exp32_gate within 1e-3 over test_gate_precision_transcendentals'
    ranges; and _condition's gate samples use it only at gate_trig
    "native"."""
    x = np.linspace(-60.0, 60.0, 20001)
    xt = torch.as_tensor(x, dtype=F64)
    js, jc = jmk._sincos_gate(jnp.asarray(x, jnp.float32))
    for f, want in ((torch.sin, js), (torch.cos, jc)):
        assert np.abs(mk._f32(f)(xt).numpy() - np.asarray(want, np.float64)).max() < 1e-3
    y = np.linspace(-30.0, 3.0, 20001)
    ej = np.asarray(jmk._exp32_gate(jnp.asarray(y, jnp.float32)), np.float64)
    et = mk._f32(torch.exp)(torch.as_tensor(y, dtype=F64)).numpy()
    assert (np.abs(et - ej) / np.exp(y)).max() < 1e-3
    u, lnt = canonical_states("bndry", N=64)
    sc = tcfg.Scene(**KW, bndry_lyr=0.5)
    Pn = mk.mega_params(sc, tcfg.NumericsConfig(gate_trig="native"))
    Pp = mk.mega_params(sc, tcfg.NumericsConfig())
    assert torch.equal(mk._condition(Pn, u, lnt), mk._condition(Pp, u, lnt))
    assert torch.equal(mk._condition(Pp, u, lnt, gate=True), mk._condition(Pp, u, lnt))
    d = torch.abs(mk._condition(Pn, u, lnt, gate=True) - mk._condition(Pp, u, lnt))
    assert 0 < d.max().item() < 1e-3


def test_chunked_plain_matches_single_launch(monkeypatch):
    """integrate_mega_chunked over the plain version (the pool with its
    state carried, integrate_mega_plain's resumable contract) against one
    plain run, bitwise on all 12 outputs: JAX's test_chunked_matches_single
    _launch's chunk 75, shrink 2, floor 128 and lane done at entry, on an
    axion backtrace batch (16 slots).  The pyramid shrinks (256 -> 128) and
    a ray records crossings in two launches."""
    sc = tcfg.Scene(**KW)
    cfg = tcfg.NumericsConfig(interp_points=8, max_steps=3000, bisect_iters=24)
    B = 256
    rng = np.random.default_rng(3)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    T = lambda a: torch.as_tensor(a, dtype=F64)
    x = T(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1))
    v = rng.normal(size=(B, 3))
    v = T(v / np.linalg.norm(v, axis=1, keepdims=True))
    erg = T(np.full(B, 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2)))
    u0 = launch_state(x, v, sc, erg, -torch.ones(B, dtype=F64))
    lnt0 = torch.full((B,), float(np.log(1e-7)), dtype=F64)
    lnt1 = torch.full((B,), float(np.log(1e-3)), dtype=F64)
    lnt1[0] = lnt0[0] - 1.0
    kw = dict(max_crossings=16, species="axion", is_photon=torch.zeros(B, dtype=torch.bool))
    single = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc, cfg, **kw)

    launches, real = [], mk.integrate_mega

    def spy(*args, **k):
        out = real(*args, **k)
        res_in = k["resume"]
        n_in = torch.zeros_like(out[4]) if res_in is None else res_in["n_cross"]
        live = out[-1]["done"] < 0.5
        launches.append((args[0].shape[0], bool(((n_in > 0) & (out[4] > n_in)).any()),
                         int(live.sum())))
        return out

    monkeypatch.setattr(mk, "integrate_mega", spy)
    reads = mk.CHUNKED_READS["alive"]
    chunked = mk.integrate_mega_chunked(u0, lnt0, lnt1, erg, x, sc, cfg, chunk_iters=75,
                                        stage_shrink=2, stage_floor=128, **kw)
    for i, (a, b) in enumerate(zip(single, chunked)):
        assert torch.equal(a, b), i
    assert single[3][0] == 0 and torch.equal(chunked[0][0], u0[0]) and single[2][0] == 0
    assert [n for n, _, _ in launches][:1] == [256] and launches[-1][0] == 128
    assert any(across for _, across, _ in launches[1:])
    assert mk.CHUNKED_READS["alive"] - reads == len(launches) + 1
    assert int(single[4].sum()) > 200 and int((single[2] > 75).sum()) > 20


def test_resume_starts_dt0_rays_fresh():
    """The resumable contract per ray, as the kernel's run_ray<..., Resume>
    reads its rows: in one resume dict, rays with dt > 0 continue from their
    rows and rays with dt 0 start fresh from u0 and lnt0.  After a launch
    capped at 10 steps, half the rays get their rows and endpoints, the
    other half dt 0, done 0 and their launch state, but ray 0 is marked
    done: every other ray ends where one uncapped launch ends it (endpoint,
    log time, steps, code and crossing count bitwise), the fresh rays record
    all their crossings, and ray 0 is skipped (outputs zero, rows echoed)."""
    sc = tcfg.Scene(**KW)
    cfg = tcfg.NumericsConfig(interp_points=8, max_steps=3000)
    B = 8
    rng = np.random.default_rng(5)
    r = rng.uniform(14.0, 24.0, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    T = lambda a: torch.as_tensor(a, dtype=F64)
    x = T(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)], 1))
    v = rng.normal(size=(B, 3))
    v = T(v / np.linalg.norm(v, axis=1, keepdims=True))
    erg = T(np.full(B, 1.0000003e-5))
    u0 = launch_state(x, v, sc, erg, -torch.ones(B, dtype=F64))
    lnt0 = torch.full((B,), float(np.log(1e-7)), dtype=F64)
    lnt1 = torch.full((B,), float(np.log(1e-4)), dtype=F64)
    kw = dict(max_crossings=8, species="axion", is_photon=torch.zeros(B, dtype=torch.bool))
    single = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc, cfg, **kw)
    first = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc, cfg, it_cap=10, return_resume=True,
                              **kw)
    res = {k: v.clone() for k, v in first[-1].items()}
    fresh = torch.arange(B) % 2 == 1
    res["dt"][fresh] = 0.0
    res["done"][fresh] = 0.0
    assert not bool((res["done"] > 0.5).any())   # every ray continues or restarts
    res["done"][0] = 1.0
    run = torch.arange(B) > 0
    u_in = torch.where(fresh[:, None], u0, first[0])
    lnt_in = torch.where(fresh, lnt0, first[1])
    *out, res_out = mk.integrate_mega(u_in, lnt_in, lnt1, erg, x, sc, cfg, resume=res,
                                      return_resume=True, **kw)
    for i in range(5):
        assert torch.equal(out[i][run], single[i][run]), i
    for i in (5, 6):
        assert torch.equal(out[i][fresh], single[i][fresh]), i
    for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 11):
        assert not bool(out[i][0].any()), i
    for key, v in res_out.items():
        assert torch.equal(v[0], res[key][0]), key
    assert int(single[4][fresh].sum()) > 0 and bool((single[2] > 10).all())


def test_driver_backtrace_chunk_bitwise(tmp_path):
    """driver.run at engine mega with backtrace_chunk=64 (the backtrace
    through integrate_mega_chunked) against backtrace_chunk=0: the rows
    bitwise, on two events (rtol 1e-5 and a two-node tree keep the eager
    CPU runs short)."""
    sc = tcfg.Scene(theta_m=0.2)
    tc = tcfg.TreeConfig(num_cutoff=1, mc_nodes=1, max_nodes=2)
    reads = mk.CHUNKED_READS["alive"]
    rows = []
    for chunk in (0, 64):
        cfg = tcfg.NumericsConfig(engine="mega", interp_points=8, max_crossings=8, rtol=1e-5,
                                  scan_gate_check=0, backtrace_chunk=chunk)
        out = driver.run(sc, cfg, tc, 3, seed=6, verbose=False, event_batch=2, device="cpu",
                         dir_tag=str(tmp_path / f"c{chunk}"))
        rows.append(out[0])
    assert rows[0].shape[0] >= 2
    np.testing.assert_array_equal(rows[1], rows[0])
    assert mk.CHUNKED_READS["alive"] - reads >= 3   # relaunched at least twice


def test_mega_env_overrides_reach_mega_params(monkeypatch):
    """MEGA_COND / MEGA_GATE_TRIG / MEGA_RHS override cfg's modes and
    MEGA_PROFILE sets the step profile, read where mega_params builds K2's
    parameters (as the reference's SceneConsts reads them); each picks the
    library's variant; unknown values raise.  A profile runs the plain
    version without the event scan (the pool with detect_events=False) and
    refuses the in-kernel probability."""
    sc = tcfg.Scene(**KW)
    cfg = tcfg.NumericsConfig(interp_points=8)
    assert mk.mega_params(sc, cfg).modes == mk.Modes()
    assert mk.variant_of(mk.mega_params(sc, cfg)).is_default()
    for var, field, value in (("MEGA_COND", "cond", "canonical"),
                              ("MEGA_GATE_TRIG", "gate", "native"),
                              ("MEGA_RHS", "rhs", "vjp"), ("MEGA_PROFILE", "profile", "scan")):
        with monkeypatch.context() as m:
            m.setenv(var, value)
            P = mk.mega_params(sc, cfg)
            assert getattr(P.modes, field) == value
            assert mk.variant_of(P).tag() == value
            assert mk.variant_of(P, resume=True).tag() == value + "+resume"
            driver.check_ported(cfg)
            m.setenv(var, "bogus")
            with pytest.raises(ValueError, match=field):
                mk.mega_params(sc, cfg)
    P = mk.mega_params(sc, dataclasses.replace(cfg, cond_mode="canonical", rhs_mode="vjp"))
    assert mk.variant_of(P).tag() == "canonical+vjp"

    B = 4
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(12.0, 20.0, (B, 3)), dtype=F64)
    k = torch.as_tensor(rng.normal(size=(B, 3)), dtype=F64)
    erg = torch.full((B,), 1.0000003e-5, dtype=F64)
    u0 = launch_state(x, k, sc, erg, -torch.ones(B, dtype=F64))
    lnt0 = torch.full((B,), float(np.log(1e-6)), dtype=F64)
    lnt1 = torch.full((B,), float(np.log(3e-6)), dtype=F64)
    monkeypatch.setenv("MEGA_PROFILE", "coarse")
    out = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc, cfg)
    res = mk.pool_run(u0, lnt0, lnt1, erg, x, sc, cfg, max_crossings=1,
                      is_photon=torch.ones(B, dtype=torch.bool), species="photon",
                      detect_events=False)
    assert torch.equal(out[0], res.u) and torch.equal(out[2], res.steps.to(F64))
    assert int(out[4].sum()) == 0
    with pytest.raises(ValueError, match="bench-only"):
        mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc, cfg, with_prob=True)


def test_precise_trig_is_torch_f32_libm():
    """The JAX package's utils/precise.py (f32 sin/cos/exp to 1-2 ulp where
    the TPU's are not) has no port module: torch's f32 sin, cos and exp,
    which the port's f32 physics calls on the CPU and the card, agree with
    its sin_p / cos_p / exp_p to 2 ulp over the live ranges (angles within
    +-2 pi, omega t, the boundary layer's and the log-time exponents)."""
    x = np.linspace(-2 * np.pi, 2 * np.pi, 40001).astype(np.float32)
    y = np.linspace(-60.0, 3.0, 40001).astype(np.float32)
    for fj, ft, arg in ((jprecise.sin_p, torch.sin, x), (jprecise.cos_p, torch.cos, x),
                        (jprecise.exp_p, torch.exp, y)):
        want = np.asarray(fj(jnp.asarray(arg)), np.float32)
        got = ft(torch.from_numpy(arg)).numpy()
        assert want.dtype == got.dtype == np.float32
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)).astype(np.float32))
        # near sin's and cos's zeros the absolute error of either is ~1 ulp of 1
        scale = np.maximum(ulp, np.spacing(np.float32(1.0)) * (ft is not torch.exp))
        assert (np.abs(got.astype(np.float64) - want) / scale).max() <= 2.0
