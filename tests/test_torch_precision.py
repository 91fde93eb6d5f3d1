"""The precision path of the port: compute_dtype="f32" (the physics in f32
under an f64 state) and --precision f32 (every tensor in f32), against the
JAX package's f32 modes and against the port's own f64.

The bars are tests/test_precision.py's: the same crossing topology, and
endpoint relative error median < 5e-5 and max < 1e-3.  The JAX side runs in
process with x64 on, where its compute_dtype="f32" mode runs; only its CLI at
--precision f32 (x64 off, which one process cannot switch to, and a ~65 s
compile) is pinned, with the command that produced it."""

import dataclasses
import glob

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adiabatic_raytracer_tpu import config as jcfg
from adiabatic_raytracer_tpu import driver as jdriver
from adiabatic_raytracer_tpu.ops import propagate as jprop
from adiabatic_raytracer_tpu.ops import tree as jtree
from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch import driver
from adiabatic_raytracer_tpu_torch.cli import run_from_args
from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
from adiabatic_raytracer_tpu_torch.ops import propagate as tprop
from adiabatic_raytracer_tpu_torch.ops import sampler, tree
from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
from adiabatic_raytracer_tpu_torch.ops.megakernel import integrate_mega_plain
from adiabatic_raytracer_tpu_torch.utils import rng

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0, mass_ns=1.0)
SC = tcfg.Scene(**KW)
F32, F64 = torch.float32, torch.float64


def precision_rays():
    """tests/test_precision.py's 8 outward rays: (x [8, 3], v [8, 3], erg [8])."""
    B = 8
    r_ = np.random.default_rng(5)
    r = r_.uniform(14.0, 24.0, B)
    th = np.arccos(r_.uniform(-0.9, 0.9, B))
    ph = r_.uniform(-np.pi, np.pi, B)
    x = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph), r * np.cos(th)],
                 axis=1)
    v = x / np.linalg.norm(x, axis=1, keepdims=True) + 0.2 * r_.normal(size=(B, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return x, v, np.full(B, 1.0000005e-5)


def assert_endpoint_bars(got, ref):
    """tests/test_precision.py's bars on [B, 3] endpoints."""
    rel = np.linalg.norm(got - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.median(rel) < 5e-5, rel
    assert np.max(rel) < 1e-3, rel


# --- make_rhs -------------------------------------------------------------

@pytest.mark.parametrize("species", ["photon", "axion", "mixed"])
def test_make_rhs_f32_matches_jax(species, monkeypatch):
    """make_rhs(compute_dtype="f32") on launch states of the 8 rays at four
    log-times, against JAX's make_rhs(compute_dtype="f32") and against the
    port's f64: per component within 1e-5 of the component's largest |value|
    (f32 rounding is ~6e-8; the gradients through the ~1e13 B field amplify
    it to ~1e-6, measured).  The result is f64, the state's dtype, and the
    derivatives are forward-mode: torch.autograd.grad (reverse mode) is
    never called."""
    x, v, erg = (torch.tensor(a) for a in precision_rays())
    u0 = tprop.launch_state(x, v, SC, erg, -torch.ones(8, dtype=F64))
    u = u0.repeat(4, 1)
    lnt = torch.tensor([-30.0, -12.0, -8.0, -6.0], dtype=F64).repeat_interleave(8)
    e = erg.repeat(4)
    is_ph = torch.arange(32) % 2 == 0
    ra = {"erg": e, "is_photon": is_ph}
    want64 = tprop.make_rhs(SC, 1.0, 0.0, species)(u, lnt, ra).numpy()

    def no_reverse(*a, **k):
        raise AssertionError("reverse-mode derivative in the f32 RHS")

    monkeypatch.setattr(torch.autograd, "grad", no_reverse)
    got = tprop.make_rhs(SC, 1.0, 0.0, species, "f32")(u, lnt, ra)
    monkeypatch.undo()
    assert got.dtype == F64
    got = got.numpy()

    jrhs = jprop.make_rhs(jcfg.Scene(**KW), 1.0, 0.0, species, compute_dtype="f32")
    ref = np.asarray(jax.jit(jax.vmap(lambda uu, ll, ee, pp: jrhs(uu, ll, {"erg": ee,
                                                                          "is_photon": pp})))(
        jnp.asarray(u.numpy()), jnp.asarray(lnt.numpy()), jnp.asarray(e.numpy()),
        jnp.asarray(is_ph.numpy())))
    assert ref.dtype == np.float64
    scale = np.maximum(np.abs(want64).max(axis=0), 1e-300)
    for name, other in (("JAX f32", ref), ("port f64", want64)):
        err = np.abs(got - other) / scale
        assert err.max() < 1e-5, (name, err.max(axis=0))


# --- propagate ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_f32_endpoints():
    """JAX's propagate at compute_dtype="f32" on the 8 rays (tests/
    test_precision.py's _run("f32") under one jax.jit): endpoints [8, 3] and
    crossing counts."""
    x, v, erg = precision_rays()
    cfg = jcfg.NumericsConfig(interp_points=8, compute_dtype="f32")

    def run(x, v, erg):
        res = jprop.propagate(x, v, jcfg.Scene(**KW), cfg, erg=erg, delta_w=-jnp.ones(8),
                              lnt0=jnp.full(8, cfg.ln_t_start),
                              lnt1=jnp.full(8, float(np.log(3e-3))),
                              is_photon=jnp.ones(8, bool), max_crossings=jnp.ones(8, jnp.int32),
                              species="photon")
        return res.traj[:, -1, :], res.n_cross

    end, nc = jax.jit(run)(jnp.asarray(x), jnp.asarray(v), jnp.asarray(erg))
    assert end.dtype == jnp.float64
    return np.asarray(end), np.asarray(nc)


def propagate_rays(compute_dtype, dtype):
    x, v, erg = precision_rays()
    cfg = tcfg.NumericsConfig(interp_points=8, compute_dtype=compute_dtype)
    t = lambda a: torch.tensor(a, dtype=dtype)
    res = tprop.propagate(t(x), t(v), SC, cfg, erg=t(erg), delta_w=-torch.ones(8, dtype=dtype),
                          lnt0=torch.full((8,), cfg.ln_t_start, dtype=dtype),
                          lnt1=torch.full((8,), float(np.log(3e-3)), dtype=dtype),
                          is_photon=torch.ones(8, dtype=torch.bool),
                          max_crossings=torch.ones(8, dtype=torch.int64), species="photon")
    assert res.traj.dtype == dtype
    return res.traj[:, -1, :].double().numpy(), res.n_cross.numpy()


@pytest.fixture(scope="module")
def endpoints_f64():
    return propagate_rays("state", F64)


@pytest.mark.parametrize("compute_dtype,dtype", [("f32", F64), ("state", F32)],
                         ids=["compute_f32", "precision_f32"])
def test_propagate_f32_matches_f64_and_jax(compute_dtype, dtype, endpoints_f64,
                                           jax_f32_endpoints):
    """propagate at compute_dtype="f32" (f64 state) and at an f32 state
    (--precision f32: every tensor f32), both with the forward-mode f32 RHS,
    against the port's f64 and against JAX's compute_dtype="f32" propagate
    run here, at tests/test_precision.py's bars."""
    end, nc = propagate_rays(compute_dtype, dtype)
    end64, nc64 = endpoints_f64
    jend, jnc = jax_f32_endpoints
    np.testing.assert_array_equal(nc, nc64)
    np.testing.assert_array_equal(nc, jnc)
    assert_endpoint_bars(end, end64)
    assert_endpoint_bars(end, jend)


# --- _prob_batch and _event_kinematics ------------------------------------

@pytest.fixture(scope="module")
def surface_events():
    """64 conversion-surface points of the production scene (f64 sampler;
    the events are f32-representable so both dtypes see the same inputs)."""
    maxR = float(conversion_surface_radius(SC.mass_a, SC.theta_m, SC.omega_pul, SC.b0,
                                           SC.r_ns))
    n_grid = sampler.default_n_grid(maxR, scan_per_step=8)
    xs, vs, es = [], [], []
    key = rng.PRNGKey(2)
    while sum(a.shape[0] for a in xs) < 64:
        key, sub = rng.split(key).unbind(0)
        r = sampler.sample_batch(sub, 256, maxR, SC, SC.mass_ns, n_grid=n_grid)
        ok = r.success.nonzero().squeeze(1)
        xs.append(r.xpos[ok]), vs.append(r.v_loc[ok]), es.append(r.erg_inf[ok])
    f = lambda a: torch.cat(a)[:64].float().double()
    return f(xs), f(vs), f(es), maxR


def test_prob_batch_f32_matches_jax(surface_events):
    """_prob_batch(compute_dtype="f32") at 64 conversion-surface points
    against JAX's _prob_batch(compute_dtype="f32") and the port's f64:
    P and P_nonAD in f64 (the state's dtype), relative error < 1e-4 (f32
    rounding through the B-field gradient, ~1e-6 measured).  The f32 state
    (--precision f32) returns f32 at the same bar."""
    x, v, e, _ = surface_events
    k = k_norm_cart(x, v, 0.0, e, SC, SC.mass_ns, is_photon=True, ax_fix=True)
    p64, n64 = tree._prob_batch(x, k, e, SC)
    p32, n32 = tree._prob_batch(x, k, e, SC, "f32")
    ps, ns = tree._prob_batch(x.float(), k.float(), e.float(), SC)
    assert p32.dtype == F64 and ps.dtype == F32 and ns.dtype == F32
    jp, jn = jax.jit(lambda a, b, c: jtree._prob_batch(a, b, c, jcfg.Scene(**KW), "f32"))(
        jnp.asarray(x.numpy()), jnp.asarray(k.numpy()), jnp.asarray(e.numpy()))
    assert bool((n64 > 0).all())
    for a, b in ((p32, np.asarray(jp)), (n32, np.asarray(jn)), (p32, p64.numpy()),
                 (n32, n64.numpy()), (ps, p64.numpy()), (ns, n64.numpy())):
        np.testing.assert_allclose(a.double().numpy(), b, rtol=1e-4, atol=0)


def test_event_kinematics_f32_matches_jax(surface_events):
    """_event_kinematics(compute_dtype="f32") on the same 64 events against
    JAX's and the port's f64 (the bars of tests/test_precision.py's
    kinematics test: sln_base rtol 2e-5, cos_w rtol 1e-4 atol 1e-7; k_init
    rtol 1e-5), in the state's dtype, and the device value in f32 range: the
    ~1e39-1e42 weight exists only as host f64 (sln_base * sln_scale).
    jac_v, which neither pipeline reads, is a determinant that cancels
    catastrophically in f32 (JAX's is off by up to 99% on these events):
    only its dtype is checked."""
    x, v, e, maxR = surface_events
    got = driver._event_kinematics(x, v, e, SC, "f32")
    assert all(a.dtype == F64 for a in got)
    ref = jax.jit(lambda a, b, c: jdriver._event_kinematics(
        a, b, c, maxR, jcfg.Scene(**KW), jcfg.TreeConfig(), "f32"))(
        jnp.asarray(x.numpy()), jnp.asarray(v.numpy()), jnp.asarray(e.numpy()))
    own = driver._event_kinematics(x, v, e, SC)
    for g, j, o, (rtol, atol) in zip(got[:3], ref, own, ((1e-5, 0), (2e-5, 0), (1e-4, 1e-7))):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=rtol, atol=atol)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=rtol, atol=atol)
    s32 = driver._event_kinematics(x.float(), v.float(), e.float(), SC)[1]
    assert s32.dtype == F32 and bool(torch.isfinite(s32).all())
    full = s32.double().numpy() * driver.sln_scale(SC, maxR, tcfg.TreeConfig())
    assert np.all(np.isfinite(full)) and full.max() > 1e38


# an event K1 sampled on the card at MassA 1e-5, B0 1e13, --bndry_lyr 0.5
# (seed 1769, the CLI's card defaults): 1.6e-3 km off the rotation axis at
# r 11.49 km, where z / r rounds past 1 in f32
POLE_EVENT = ([-0.0005605220794677734, -0.0014638900756835938, 11.485711097717285],
              [-0.2893073558807373, -0.40061208605766296, 0.1137344241142273],
              1.0000002475862857e-05)


def test_event_kinematics_f32_near_the_rotation_axis():
    """Within ~3e-4 rad of the rotation axis the reference's f32 theta,
    arccos(z / r), is 0 or NaN: at POLE_EVENT JAX's f32 kinematics give
    NaN, and the card's CLI wrote a NaN row.  The port takes theta and
    sin(theta) from the cylindrical radius there in f32 (geometry.
    polar_angle, sin_polar, ROADMAP Queue 3): finite, k_init within 1e-4 of
    the f64 kinematics (the celerity's theta component cancels near the
    axis), sln_base and cos_w within 2e-5; the f64 kinematics are JAX's.
    Outside the zone, and in f64, theta is bit for bit the reference's
    form."""
    from adiabatic_raytracer_tpu_torch.ops import geometry

    sc_j = jcfg.Scene(mass_a=1e-5, theta_m=0.2, b0=1e13, bndry_lyr=0.5)
    sc = tcfg.Scene(mass_a=1e-5, theta_m=0.2, b0=1e13, bndry_lyr=0.5)
    x, v, e = (np.asarray([a], dtype=np.float64) for a in POLE_EVENT)
    jax_f32 = jdriver._event_kinematics(jnp.asarray(x), jnp.asarray(v), jnp.asarray(e), 11.68,
                                        sc_j, jcfg.TreeConfig(), "f32")
    assert not np.isfinite(np.asarray(jax_f32[0])).any()
    jax_f64 = jdriver._event_kinematics(jnp.asarray(x), jnp.asarray(v), jnp.asarray(e), 11.68,
                                        sc_j, jcfg.TreeConfig(), "state")
    t = lambda a: torch.as_tensor(a)
    got = driver._event_kinematics(t(x), t(v), t(e), sc, "f32")
    own = driver._event_kinematics(t(x), t(v), t(e), sc, "state")
    for o, j in zip(own[:3], jax_f64[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=1e-12)
    for g, o, rtol in zip(got[:3], own[:3], (1e-4, 2e-5, 2e-5)):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=rtol)
    # theta itself: the pole zone's f32 form against f64, and bitwise the
    # reference's form outside it and in f64
    pts = torch.tensor([POLE_EVENT[0], [3.0, -4.0, 10.0]], dtype=F64)
    r64 = torch.linalg.norm(pts, dim=1)
    p32 = pts.float()
    r32 = torch.sqrt(torch.sum(p32 * p32, dim=-1))
    th32 = geometry.polar_angle(p32, r32)
    assert torch.isnan(torch.arccos(p32[0, 2] / r32[0])) or torch.arccos(p32[0, 2] / r32[0]) == 0
    np.testing.assert_allclose(th32[0].item(), torch.arccos(pts[0, 2] / r64[0]).item(), rtol=1e-6)
    assert th32[1] == torch.arccos(p32[1, 2] / r32[1])
    assert torch.equal(geometry.polar_angle(pts, r64), torch.arccos(pts[:, 2] / r64))


# --- K2's and K3's plain versions under an f32 state -----------------------

def test_integrate_mega_plain_f32_boundary(surface_events):
    """K2's plain version under an f32 state (--precision f32): the inputs go
    up to f64 and every output comes back in f32, the f32 rounding of the
    f64 call's on the same (f32-representable) inputs: topology and values
    identical.  Axion backtraces of 4 events, 16 crossing slots, in-kernel
    probability."""
    x, v, e, _ = surface_events
    x, v, e = x[:4], v[:4], e[:4]
    k = k_norm_cart(x, v, 0.0, e, SC, SC.mass_ns, is_photon=True, ax_fix=True)
    sc_b = dataclasses.replace(SC, b0=-SC.b0)
    u0 = tprop.launch_state(x, -k, sc_b, e, -torch.ones(4, dtype=F64)).float()
    cfg = tcfg.NumericsConfig(interp_points=8, max_steps=4000)
    args = lambda d: (u0.to(d), torch.full((4,), -30.0, dtype=d), torch.zeros(4, dtype=d),
                      e.to(d), x.to(d))
    kw = dict(max_crossings=16, is_photon=torch.zeros(4, dtype=torch.bool), species="axion",
              with_prob=True)
    o64 = integrate_mega_plain(*args(F64), sc_b, cfg, **kw)
    o32 = integrate_mega_plain(*args(F32), sc_b, cfg, **kw)
    assert int(o64[4].sum()) > 0    # crossings were recorded
    for a, b in zip(o32, o64):
        if a is not None:
            assert a.dtype == F32
            torch.testing.assert_close(a, b.float(), rtol=0, atol=0)


def test_tree_kernel_plain_f32_state():
    """K3's tree engine (forward_tree_kernel on its plain version) under an
    f32 state against the same f32-representable events at f64: the pools
    and counters come back in f32, the counters (the tree's topology) are
    identical and the finals' weights within f32 bars (1e-4).  The scene and
    cutoffs of tests/test_torch_treekernel.py."""
    sc = tcfg.Scene(**dict(KW, theta_m=0.4))
    cfg = tcfg.NumericsConfig(engine="mega", tree_engine="kernel", interp_points=8,
                              max_crossings=8, max_steps=2000, in_kernel_prob=1, tree_k=1)
    tc = tcfg.TreeConfig(num_cutoff=4, mc_nodes=1, max_nodes=10)
    maxR = float(conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns))
    r = sampler.sample_batch(rng.PRNGKey(2), 16, maxR, sc, sc.mass_ns,
                             n_grid=sampler.default_n_grid(maxR, scan_per_step=8),
                             state_dtype=F32)
    assert r.xpos.dtype == F32
    ok = r.success.nonzero().squeeze(1)[:3]
    x, v, e = r.xpos[ok], r.v_loc[ok], r.erg_inf[ok]
    k = k_norm_cart(x, v, 0.0, e, sc, sc.mass_ns, is_photon=True, ax_fix=True)
    out = {d: tree.forward_tree(rng.PRNGKey(11), x.to(d), k.to(d), e.to(d), sc, cfg, tc,
                                lnt_end=0.0) for d in (F32, F64)}
    a, b = out[F32], out[F64]
    assert a.pools.weight.dtype == F32 and a.tot_prob.dtype == F32
    for name in ("count", "count_main", "info", "n_alloc", "dw_anomalies"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    fa = a.pools.is_final & (a.pools.status == 2)
    assert torch.equal(fa, b.pools.is_final & (b.pools.status == 2)) and bool(fa.any())
    torch.testing.assert_close(a.pools.weight[fa].double(), b.pools.weight[fa], rtol=1e-4,
                               atol=0)


# --- --precision f32 through the CLI ---------------------------------------

# The JAX CLI's rows (saveMode 1, 29 columns) of
#   JAX_PLATFORMS=cpu python -m adiabatic_raytracer_tpu --platform cpu \
#     --precision f32 --computeDtype f32 --Nts 3 --seed 3 --ThetaM 0.2 \
#     --numCutoff 1 --MCNodes 1 --maxNodes 4 --saveMode 1 --dir_tag D
# (x64 off: every array f32).  --computeDtype f32 selects JAX's forward-mode
# f32 derivatives: with the CPU default (compute "state") JAX differentiates
# the f32 Hamiltonian in reverse mode, which on XLA's CPU loses up to 5.4% of
# dH/dx (measured against f64 at the launch state of event 1), and its rows
# then move by up to 39% (theta_f of event 2).  The port differentiates
# every f32 evaluation in forward mode, at --precision f32 alone too, and
# lands on these rows.
JAX_F32_ROWS = np.array([
    [1.0, 1.0, 2.8680489208258333e+00, -9.8686046439664443e-01, 2.8680277113404014e+00,
     -9.8679468086189837e-01, 2.9975341277282080e+05, 2.5273262818025235e+40,
     1.0498572821653340e-03, 1.2966171264648438e+01, -5.9449062347412109e+00,
     -7.4903945922851562e+00, -1.0000023430103393e+00, 1.0498572821653340e-03, 0.0, 1.0,
     6.2861515992551631e-09, -3.9871488866083382e-07, 3.8485623008455150e-06,
     9.5828545093536377e-01, 3.0, -2.0, 9.9901777505874634e-01, 9.8222494125366211e-04,
     -1.0, 1.0508894920349121e-03, 2.9975341277282080e+05, 1.0, 1.0508894920349121e-03],
    [1.0, 0.0, 2.5850517457476521e+00, -3.0651017187755567e+00, 2.6134906208239772e+00,
     -3.0363225855843257e+00, 8.4098547289672588e+03, 2.5273262818025235e+40,
     1.0322098695780824e-06, 1.2966171264648438e+01, -5.9449062347412109e+00,
     -7.4903945922851562e+00, -1.0000018882629884e+00, 1.0322098695780824e-06, 0.0, 1.0,
     6.2861515992551631e-09, -3.9871488866083382e-07, 3.8485623008455150e-06,
     9.5828545093536377e-01, 3.0, -2.0, 9.8222494125366211e-04, 9.8222494125366211e-04,
     9.8222494125366211e-04, 1.0508894920349121e-03, 8.4098547289672588e+03, 1.0,
     1.0508894920349121e-03],
    [2.0, 1.0, 8.4681872508529765e-01, -1.0568065345840290e+00, 8.4681408333696462e-01,
     -1.0567753487807416e+00, 2.9975444511877361e+05, 1.2149199187165954e+40,
     5.2365284723276950e-03, 1.0719730377197266e+01, 1.3763456046581268e-01,
     7.6670799255371094e+00, -1.0000001602230675e+00, 5.2365284723276950e-03, 0.0, 1.0,
     -1.0151078413400683e-06, -3.7776753742946312e-06, 1.4439336837313022e-06,
     4.1562351584434509e-01, 3.0, -3.0, 9.9476337432861328e-01, 5.2366256713867188e-03,
     -1.0, 5.2640945650637150e-03, 2.9975444511877361e+05, 1.0, 5.2886605262756348e-03]])
# event, species, count, info, c_bck: exact
EXACT_COLS = [0, 1, 20, 21, 27]


def test_cli_precision_f32_matches_jax_cli_rows(tmp_path):
    """--precision f32 --device cpu through the port's CLI (pool engine,
    queue tree, every tensor f32) against JAX_F32_ROWS: event, species,
    count, info and c_bck exact; the other columns (f64 rows holding f32
    values) within tests/test_precision.py's bars, median 5e-5 and max
    1e-3 relative; zeros exact."""
    out = run_from_args(["--device", "cpu", "--precision", "f32", "--Nts", "3", "--seed", "3",
                         "--ThetaM", "0.2", "--numCutoff", "1", "--MCNodes", "1",
                         "--maxNodes", "4", "--saveMode", "1", "--dir_tag", str(tmp_path)])
    rows = np.load(glob.glob(str(tmp_path / "npy" / "*.npy"))[0])
    assert rows.dtype == np.float64 and rows.shape == JAX_F32_ROWS.shape
    np.testing.assert_array_equal(rows, out[0])
    np.testing.assert_array_equal(rows[:, EXACT_COLS], JAX_F32_ROWS[:, EXACT_COLS])
    fl = [c for c in range(rows.shape[1]) if c not in EXACT_COLS]
    got, ref = rows[:, fl], JAX_F32_ROWS[:, fl]
    np.testing.assert_array_equal(got[ref == 0], 0.0)
    rel = np.abs(got[ref != 0] - ref[ref != 0]) / np.abs(ref[ref != 0])
    assert np.median(rel) < 5e-5 and rel.max() < 1e-3, (np.median(rel), rel.max())
