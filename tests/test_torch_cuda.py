"""K1-K4 and P1 on the card against their plain versions.  Every test needs a
CUDA device (the kernels have no CPU mode) and skips without one.  The file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from adiabatic_raytracer_tpu_torch import config as tcfg
from adiabatic_raytracer_tpu_torch.ops import line_scan
from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state
from adiabatic_raytracer_tpu_torch.ops.tree import _negate_b

torch.set_num_threads(1)

KW = dict(mass_a=1e-5, ax_g=1e-12, theta_m=0.2, omega_pul=1.0, b0=1e14, r_ns=10.0,
          mass_ns=1.0)
F64 = torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def rays(B, seed, r_lo=15.0, r_hi=24.0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(r_lo, r_hi, B)
    th = np.arccos(rng.uniform(-0.9, 0.9, B))
    ph = rng.uniform(-np.pi, np.pi, B)
    x = torch.as_tensor(np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                                  r * np.cos(th)], 1), dtype=F64)
    k = torch.as_tensor(rng.normal(size=(B, 3)), dtype=F64)
    erg = torch.full((B,), 1e-5 * (1 + 0.5 * (220 / 2.99792e5) ** 2), dtype=F64)
    return x, k, erg


@pytest.mark.cuda
def test_line_scan_kernel_matches_plain(dev):
    sc = tcfg.Scene(**KW)
    rng = np.random.default_rng(1)
    B, N = 256, 2221
    vvec = rng.normal(size=(B, 3))
    vvec /= np.linalg.norm(vvec, axis=1, keepdims=True)
    vloc = rng.normal(size=(B, 3))
    vloc /= np.linalg.norm(vloc, axis=1, keepdims=True)
    T = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
    args = (T(rng.normal(size=(B, 3)) * 5.0 - vvec * 27.0), T(vvec), T(vloc),
            T(np.full(B, 1.0000005e-5)), T(np.linspace(0.0, 55.0, N)), sc, sc.mass_ns)
    got = line_scan.line_scan(*args)
    torch.cuda.synchronize()
    want = line_scan.line_scan_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    # both f32; they differ only where the f32 evaluation is ill-conditioned
    rel = torch.abs(got - want) / (1.0 + torch.abs(want))
    assert torch.quantile(rel.flatten(), 0.999).item() < 1e-5
    away = torch.abs(want) > 1e-3
    assert bool((torch.sign(got) == torch.sign(want))[away].all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scene", [{}, {"bndry_lyr": 0.5}], ids=["production", "bndry"])
def test_line_roots_kernel_matches_grid_route(dev, scene, dtype):
    """K1's fused kernel on 4096 sampling lines against the torch route on
    the grid kernel's output (sampler._flip_slots, _roots): flip counts and
    the first 16 intervals identical (one device function scans both), ok
    identical on all but 1 in 1000 lines, s* on the roots of the others
    within the root bar of the compute dtype: 2e-3 km in f32, 1e-8 km in
    f64, where both bisect the same interval in f64 (chip_smoke.py phase 3's
    bars)."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc = tcfg.Scene(**KW, **scene)
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    B = 4096
    geo = sampler._draw(rng.split(rng.PRNGKey(11, device=dev), B), maxR, sc, 220.0, True, dtype)
    s_grid = torch.linspace(0.0, 2.2 * maxR, sampler.default_n_grid(maxR), dtype=F64,
                            device=dev).to(dtype)
    args = (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf, s_grid, sc, sc.mass_ns)
    s_k, ok_k, n_k, idx_k = line_scan.line_roots_slots(*args)
    g = line_scan.line_scan(*args)
    idx_t, _, n_t = sampler._flip_slots(g)
    has = torch.arange(sampler.MAX_LINE_CROSSINGS, device=dev)[None, :] < n_t[:, None]
    assert s_k.dtype == dtype and torch.equal(n_k, n_t)
    assert torch.equal(torch.where(has, idx_k.long(), -1), torch.where(has, idx_t, -1))
    s_p, ok_p, _ = sampler._roots(*args[:4], g.to(dtype), s_grid, sc, sc.mass_ns)
    ok_diff = (ok_k != ok_p).any(dim=1)
    assert int(ok_diff.sum()) <= B // 1000 and int(ok_k.sum()) > B // 4
    bar = 1e-8 if dtype == torch.float64 else 2e-3
    assert (s_k - s_p).abs()[has & ~ok_diff[:, None]].max().item() <= bar


@pytest.mark.cuda
def test_megakernel_matches_plain(dev):
    """Dense scan (interp_coarse=0): the kernel and the pool engine run one
    algorithm, so crossing counts agree and endpoints agree to rounding."""
    x, k, erg = rays(256, seed=9)
    sc_b = _negate_b(tcfg.Scene(**KW))
    B = x.shape[0]
    u0 = launch_state(x, -k, sc_b, erg, -torch.ones(B, dtype=F64))
    d = lambda t: t.to(dev)
    args = (d(u0), d(torch.full((B,), -30.0, dtype=F64)), d(torch.zeros(B, dtype=F64)),
            d(erg), d(x), sc_b, tcfg.NumericsConfig(interp_coarse=0))
    kw = dict(max_crossings=16, is_photon=d(torch.zeros(B, dtype=torch.bool)),
              species="axion", with_prob=True)
    got = mk.integrate_mega(*args, **kw)
    torch.cuda.synchronize()
    want = mk.integrate_mega_plain(*args, **kw)
    assert (got[4] == want[4]).double().mean().item() >= 0.99
    end = (got[3] == 1) & (want[3] == 1)
    rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-300)).amax(dim=1)[end]
    assert rel.median().item() < 1e-8


@pytest.mark.cuda
def test_megakernel_chunked_is_one_launch(dev):
    """K2's resumable instantiation through integrate_mega_chunked (chunk 64,
    stages 256 -> 128) against one launch of mega_kernel: all 12 outputs
    bitwise (the controller, f0, g0 and the stall reference are carried)."""
    x, k, erg = rays(256, seed=9)
    sc_b = _negate_b(tcfg.Scene(**KW))
    B = x.shape[0]
    u0 = launch_state(x, -k, sc_b, erg, -torch.ones(B, dtype=F64))
    d = lambda t: t.to(dev)
    args = (d(u0), d(torch.full((B,), -30.0, dtype=F64)), d(torch.zeros(B, dtype=F64)),
            d(erg), d(x), sc_b, tcfg.NumericsConfig())
    kw = dict(max_crossings=16, is_photon=d(torch.zeros(B, dtype=torch.bool)),
              species="axion", with_prob=True)
    one = mk.integrate_mega(*args, **kw)
    chunked = mk.integrate_mega_chunked(*args, chunk_iters=64, stage_shrink=2, stage_floor=128,
                                        **kw)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_megakernel_resume_starts_dt0_rays_fresh(dev):
    """K2's resumable instantiation on one resume dict that mixes rays with
    dt > 0 (continued from their rows) and rays with dt 0 (fresh from u0
    and lnt0), as test_torch_k2_branches holds its plain version: after a
    launch capped at 10 steps, every ray still running ends where one
    launch of mega_kernel ends it (endpoint, log time, steps, code and
    crossing count bitwise), the fresh rays record all their crossings, and
    a ray done in the dict is skipped (outputs zero, rows echoed)."""
    x, k, erg = rays(256, seed=9)
    sc_b = _negate_b(tcfg.Scene(**KW))
    B = x.shape[0]
    u0 = launch_state(x, -k, sc_b, erg, -torch.ones(B, dtype=F64)).to(dev)
    lnt0 = torch.full((B,), -30.0, dtype=F64, device=dev)
    lnt1, erg, x = (t.to(dev) for t in (torch.zeros(B, dtype=F64), erg, x))
    cfg = tcfg.NumericsConfig()
    kw = dict(max_crossings=16, is_photon=torch.zeros(B, dtype=torch.bool, device=dev),
              species="axion", with_prob=True)
    one = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc_b, cfg, **kw)
    first = mk.integrate_mega(u0, lnt0, lnt1, erg, x, sc_b, cfg, it_cap=10,
                              return_resume=True, **kw)
    res = {key: v.clone() for key, v in first[-1].items()}
    fresh = torch.arange(B, device=dev) % 2 == 1
    res["dt"][fresh] = 0.0
    res["done"][fresh] = 0.0
    res["done"][0] = 1.0
    live = res["done"] < 0.5
    u_in = torch.where(fresh[:, None], u0, first[0])
    lnt_in = torch.where(fresh, lnt0, first[1])
    *out, res_out = mk.integrate_mega(u_in, lnt_in, lnt1, erg, x, sc_b, cfg, resume=res,
                                      return_resume=True, **kw)
    for i in range(5):
        assert torch.equal(out[i][live], one[i][live]), i
    for i in (5, 6, 8):
        assert torch.equal(out[i][fresh], one[i][fresh]), i
    for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 11):
        assert not bool(out[i][0].any()), i
    for key, v in res_out.items():
        assert torch.equal(v[0], res[key][0]), key
    assert int(live.sum()) > B // 2 and int(one[4][fresh].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [dict(cond_mode="canonical"), dict(gate_trig="native"),
                                  dict(rhs_mode="vjp")], ids=lambda m: list(m.values())[0])
def test_megakernel_mode_matches_plain(dev, mode):
    """K2 from the mode's variant library against integrate_mega_plain (the
    pool, whatever the mode) at test_megakernel_matches_plain's bars."""
    x, k, erg = rays(256, seed=9)
    sc_b = _negate_b(tcfg.Scene(**KW))
    B = x.shape[0]
    u0 = launch_state(x, -k, sc_b, erg, -torch.ones(B, dtype=F64))
    d = lambda t: t.to(dev)
    args = (d(u0), d(torch.full((B,), -30.0, dtype=F64)), d(torch.zeros(B, dtype=F64)),
            d(erg), d(x), sc_b, tcfg.NumericsConfig(**mode))
    kw = dict(max_crossings=16, is_photon=d(torch.zeros(B, dtype=torch.bool)),
              species="axion", with_prob=True)
    got = mk.integrate_mega(*args, **kw)
    torch.cuda.synchronize()
    want = mk.integrate_mega_plain(*args, **kw)
    assert (got[4] == want[4]).double().mean().item() >= 0.99
    end = (got[3] == 1) & (want[3] == 1)
    rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-300)).amax(dim=1)[end]
    assert rel.median().item() < 1e-8


def surface_rays(dev, n, seed, **scene):
    """n conversion-surface events of the production scene, or of it with
    `scene`'s fields changed (sampled with K1; repeated in turn where the
    draw has fewer): x, photon k, erg, on dev."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc = tcfg.Scene(**KW, **scene)
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    r = sampler.sample_batch(rng.PRNGKey(seed, device=dev), 4096, maxR, sc, sc.mass_ns,
                             n_grid=sampler.default_n_grid(maxR), compute_dtype="f32",
                             line_engine="kernel")
    ok = r.success.nonzero().squeeze(1)
    ok = ok[torch.arange(n, device=dev) % ok.shape[0]]
    x, v, e = r.xpos[ok].double(), r.v_loc[ok].double(), r.erg_inf[ok].double()
    return x, k_norm_cart(x, v, 0.0, e, sc, sc.mass_ns, is_photon=True, ax_fix=True), e


@pytest.mark.cuda
@pytest.mark.parametrize("species", ["photon", "axion", "mixed"])
@pytest.mark.parametrize("size", ["1", "33", "over_resident"])
def test_megakernel_warp_queue_matches_plain(dev, size, species):
    """K2 (one warp per ray, rays pulled from a queue by min(B, resident
    warps) warps) against integrate_mega_plain at chip_smoke.py phase 5's
    bars: crossing counts identical on >= 99% of the rays (every ray at
    B = 1 and 33), endpoint median relative error < 1e-8 on the rays that
    reached the end, with the dense scan, and counts on >= 99% with the
    gate.  Axion: the backtrace (B flipped, 16 slots); photon: forward from
    the conversion point, one slot, as the queue path's tree nodes; mixed:
    both species in one launch."""
    resident = mk.resident_warps(mk.mega_params(tcfg.Scene(**KW), tcfg.NumericsConfig()), dev)
    B = {"1": 1, "33": 33}.get(size) or resident + 37
    x, k, e = surface_rays(dev, B, seed=31)
    sc = tcfg.Scene(**KW)
    if species == "axion":
        sc = _negate_b(sc)
        k = -k
        is_ph = torch.zeros(B, dtype=torch.bool, device=dev)
    else:
        gen = np.random.default_rng(B)
        mask = np.ones(B, bool) if species == "photon" else gen.random(B) < 0.5
        is_ph = torch.as_tensor(mask, device=dev)
    u0 = launch_state(x, k, sc, e, -torch.ones(B, dtype=F64, device=dev))
    lnt0 = torch.full((B,), -30.0, dtype=F64, device=dev)
    lnt1 = torch.zeros(B, dtype=F64, device=dev)
    kw = dict(max_crossings=16 if species == "axion" else 1, is_photon=is_ph,
              species=species, with_prob=True)
    gated = tcfg.NumericsConfig()
    dense = tcfg.NumericsConfig(interp_coarse=0)
    got = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, dense, **kw)
    got_g = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, gated, **kw)
    torch.cuda.synchronize()
    want = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, sc, gated, **kw)
    same = (got[4] == want[4]).double().mean().item()
    assert same >= (1.0 if B <= 33 else 0.99), same
    assert (got_g[4] == want[4]).double().mean().item() >= (1.0 if B <= 33 else 0.99)
    end = (got[3] == 1) & (want[3] == 1)
    if bool(end.any()):
        rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-300)).amax(dim=1)[end]
        assert rel.median().item() < 1e-8
    assert bool(torch.isfinite(got[0]).all()) and bool((got[2] > 0).all())


@pytest.mark.cuda
def test_megakernel_chain_matches_plain(dev):
    """K2's chain instantiation (mc_chain) against its plain version, the
    pool engine segment by segment, on 64 conversion-surface rays, photon and
    axion mixed, dense scan: rays at cap 8 run the in-kernel MC chain on
    random uniforms, ray 0 at cap 0 the multi-crossing semantics, ray 1 at
    cap 1 stops at its first crossing.  Restarts, codes, crossing counts
    and final species identical on >= 95% of the rays (every one of the
    first two), chains restarted, and the endpoints' median relative error
    < 1e-8 on the agreeing rays."""
    B, S = 64, 8
    x, k, e = surface_rays(dev, B, seed=37)
    sc = tcfg.Scene(**KW)
    gen = np.random.default_rng(5)
    is_ph = torch.as_tensor(gen.random(B) < 0.5, device=dev)
    cap = torch.full((B,), float(S), dtype=F64, device=dev)
    cap[0], cap[1] = 0.0, 1.0
    u0 = launch_state(x, k, sc, e, -torch.ones(B, dtype=F64, device=dev))
    lnt0 = torch.full((B,), -30.0, dtype=F64, device=dev)
    lnt1 = torch.zeros(B, dtype=F64, device=dev)
    kw = dict(max_crossings=S, is_photon=is_ph, species="mixed", with_prob=True, chain_cap=cap,
              uniforms=torch.as_tensor(gen.random((B, S)), device=dev))
    cfg = tcfg.NumericsConfig(interp_coarse=0)
    got = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, cfg, **kw)
    torch.cuda.synchronize()
    want = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, sc, cfg, **kw)
    same = (got[9] == want[9]) & (got[3] == want[3]) & (got[4] == want[4]) & (got[10] == want[10])
    assert same.double().mean().item() >= 0.95 and bool(same[:2].all())
    assert int(got[9].sum()) > 0 and int(got[9][:2].sum()) == 0
    rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-300)).amax(dim=1)[same]
    assert rel.median().item() < 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("species", ["photon", "axion", "mixed"])
def test_probe_matches_twins(dev, species):
    x, k, erg = rays(256, seed=4, r_lo=11.0, r_hi=45.0)
    sc = tcfg.Scene(**KW)
    B = x.shape[0]
    u = launch_state(x, k, sc, erg, -torch.ones(B, dtype=F64))
    gen = torch.Generator().manual_seed(0)
    lnt = torch.rand(B, generator=gen, dtype=F64) * 10.0 - 10.0
    is_ph = (torch.rand(B, generator=gen, dtype=F64) > 0.5).to(F64)
    P = mk.mega_params(sc, tcfg.NumericsConfig(), species=species, with_prob=True)
    whichs = mk.PROBE_FUNCS[:-1] if species == "photon" else ("rhs",)
    for which in whichs:
        got = mk.probe(P, which, u.to(dev), lnt.to(dev), erg.to(dev), is_ph.to(dev), 1e14)
        want = mk.probe_plain(P, which, u, lnt, erg, is_ph, 1e14)
        scale = want.abs().amax(dim=0, keepdim=True).clamp(min=1e-300)  # zero columns
        assert ((got.cpu() - want).abs() / (want.abs() + scale)).max().item() < 1e-12, which


VARIANTS = {"bndry": dict(bndry_lyr=0.5), "iso": dict(isotropic=True)}


@pytest.mark.cuda
def test_line_scan_kernel_bndry_matches_plain(dev):
    """K1 at bndry_lyr 0.5 against its plain version, at the bars of
    test_line_scan_kernel_matches_plain; the term changes the output."""
    sc = tcfg.Scene(**KW, bndry_lyr=0.5)
    rng = np.random.default_rng(1)
    B, N = 256, 2221
    vvec = rng.normal(size=(B, 3))
    vvec /= np.linalg.norm(vvec, axis=1, keepdims=True)
    vloc = rng.normal(size=(B, 3))
    vloc /= np.linalg.norm(vloc, axis=1, keepdims=True)
    T = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
    args = (T(rng.normal(size=(B, 3)) * 5.0 - vvec * 27.0), T(vvec), T(vloc),
            T(np.full(B, 1.0000005e-5)), T(np.linspace(0.0, 55.0, N)))
    got = line_scan.line_scan(*args, sc, sc.mass_ns)
    torch.cuda.synchronize()
    want = line_scan.line_scan_plain(*args, sc, sc.mass_ns)
    rel = torch.abs(got - want) / (1.0 + torch.abs(want))
    assert torch.quantile(rel.flatten(), 0.999).item() < 1e-5
    away = torch.abs(want) > 1e-3
    assert bool((torch.sign(got) == torch.sign(want))[away].all())
    base = line_scan.line_scan(*args, tcfg.Scene(**KW), sc.mass_ns)
    assert (torch.abs(got - base) > 1e-3 * (1.0 + torch.abs(got))).double().mean().item() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bndry", "iso"])
@pytest.mark.parametrize("launch", ["backtrace", "mixed"])
def test_megakernel_variant_matches_plain(dev, variant, launch):
    """K2's boundary-layer and isotropic instantiations against
    integrate_mega_plain on 256 conversion-surface rays of the scene, at
    chip_smoke.py phase 5's bars, dense and with the gate the main path runs
    there (the scan-gate census's choice: at bndry_lyr 0.5 the default gate
    misses close crossing pairs at the boundary-layer shell): the backtrace
    (axion, B flipped, 16 slots) and a queue-path tree iteration (photon and
    axion mixed, one slot; photons are where the boundary layer enters the
    RHS)."""
    from adiabatic_raytracer_tpu_torch import driver
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius

    B = 256
    scene = VARIANTS[variant]
    x, k, e = surface_rays(dev, B, seed=41, **scene)
    sc = tcfg.Scene(**KW, **scene)
    if launch == "backtrace":
        sc, k = _negate_b(sc), -k
        is_ph = torch.zeros(B, dtype=torch.bool, device=dev)
        kw = dict(max_crossings=16, species="axion")
    else:
        is_ph = torch.as_tensor(np.random.default_rng(B).random(B) < 0.5, device=dev)
        kw = dict(max_crossings=1, species="mixed")
    u0 = launch_state(x, k, sc, e, -torch.ones(B, dtype=F64, device=dev))
    lnt0 = torch.full((B,), -30.0, dtype=F64, device=dev)
    lnt1 = torch.zeros(B, dtype=F64, device=dev)
    kw.update(is_photon=is_ph, with_prob=True)
    want = mk.integrate_mega_plain(u0, lnt0, lnt1, e, x, sc, tcfg.NumericsConfig(), **kw)
    sc0 = tcfg.Scene(**KW, **scene)
    maxR = conversion_surface_radius(sc0.mass_a, sc0.theta_m, sc0.omega_pul, sc0.b0, sc0.r_ns)
    stats = driver.RunStats()
    gated = driver._apply_scan_gate_guard(sc0, tcfg.NumericsConfig(engine="mega"), maxR, 0.0,
                                          stats, dev)
    assert stats.scan_gate in ("ok", "widened", "fallback_plain")
    for cfg in (tcfg.NumericsConfig(interp_coarse=0), gated):
        got = mk.integrate_mega(u0, lnt0, lnt1, e, x, sc, cfg, **kw)
        assert (got[4] == want[4]).double().mean().item() >= 0.99
        end = (got[3] == 1) & (want[3] == 1)
        assert int(end.sum()) > B // 4
        rel = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-300)).amax(dim=1)[end]
        assert rel.median().item() < 1e-8
        assert bool((got[8] == 0).all())   # no in-kernel probability at these scenes


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bndry", "iso"])
@pytest.mark.parametrize("species", ["photon", "axion", "mixed"])
def test_probe_variant_matches_twins(dev, variant, species):
    """The condition and the RHS of K2's boundary-layer and isotropic
    instantiations against their torch twins, rtol 1e-12, on states around
    the boundary-layer shell."""
    x, k, erg = rays(256, seed=5, r_lo=10.2, r_hi=30.0)
    sc = tcfg.Scene(**KW, **VARIANTS[variant])
    B = x.shape[0]
    u = launch_state(x, k, sc, erg, -torch.ones(B, dtype=F64))
    gen = torch.Generator().manual_seed(1)
    lnt = torch.rand(B, generator=gen, dtype=F64) * 10.0 - 10.0
    is_ph = (torch.rand(B, generator=gen, dtype=F64) > 0.5).to(F64)
    P = mk.mega_params(sc, tcfg.NumericsConfig(), species=species)
    for which in ("condition", "rhs"):
        got = mk.probe(P, which, u.to(dev), lnt.to(dev), erg.to(dev), is_ph.to(dev), 1e14)
        want = mk.probe_plain(P, which, u, lnt, erg, is_ph, 1e14)
        scale = want.abs().amax(dim=0, keepdim=True).clamp(min=1e-300)
        assert ((got.cpu() - want).abs() / (want.abs() + scale)).max().item() < 1e-12, which


def tree_blocks(dev, n, seed):
    """K3/K4 input blocks of n production events (default cutoffs)."""
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius
    from adiabatic_raytracer_tpu_torch.ops import sampler
    from adiabatic_raytracer_tpu_torch.ops.dispersion import k_norm_cart
    from adiabatic_raytracer_tpu_torch.utils import rng

    sc = tcfg.Scene(**KW)
    cfg = tcfg.NumericsConfig(engine="mega", tree_engine="kernel")
    tc = tcfg.TreeConfig()
    maxR = conversion_surface_radius(sc.mass_a, sc.theta_m, sc.omega_pul, sc.b0, sc.r_ns)
    r = sampler.sample_batch(rng.PRNGKey(seed, device=dev), 4096, maxR, sc, sc.mass_ns,
                             n_grid=sampler.default_n_grid(maxR), compute_dtype="f32",
                             line_engine="kernel")
    ok = r.success.nonzero().squeeze(1)[:n]
    E = ok.shape[0]
    x, v, e = r.xpos[ok].double(), r.v_loc[ok].double(), r.erg_inf[ok].double()
    k = k_norm_cart(x, v, 0.0, e, sc, sc.mass_ns, is_photon=True, ax_fix=True)
    keys = rng.fold_in(rng.PRNGKey(9, device=dev), torch.arange(E, device=dev))
    return sc, cfg, tc, tk.tree_inputs(keys, x, k, e, sc, cfg, tc, lnt_end=0.0)


def assert_trees_agree(a_k, f_k, a_p, f_p, nf, min_same):
    """Counters identical (and the tree done) on >= min_same of the events,
    and on those the steps, accepted steps, dense passes and recorded
    crossings on >= 99%; their finals' records, each column relative to its
    size (angles to max(|value|, 1 rad), momentum components to the record's
    |w|), to median relative error 1e-8, p99 1e-6 and worst 1e-5
    (chip_smoke.py phase 6's bars, which say why)."""
    E = a_k.shape[0]
    rows = [tk.A_COUNT, tk.A_CMAIN, tk.A_INFO, tk.A_NALLOC, tk.A_ANOM]
    same = (a_k[:, rows] == a_p[:, rows]).all(dim=1) & (a_k[:, tk.A_DONE] == 1)
    assert same.double().mean().item() >= min_same
    fk = f_k.reshape(E, nf, tk.ROWS)
    fp = f_p.reshape(E, nf, tk.ROWS)
    slots = same[:, None] & (fk[..., tk.F_VALID] > 0.5)
    assert bool((fp[..., tk.F_VALID] > 0.5)[slots].all())
    assert torch.equal(fk[slots][:, tk.F_ORD], fp[slots][:, tk.F_ORD])
    work = [tk.A_STEPTOT, tk.A_STEPS_PH, tk.A_NACC, tk.A_NFINE, tk.A_NCROSS]
    assert (a_k[:, work] == a_p[:, work]).all(dim=1)[same].double().mean().item() >= 0.99
    cols = [tk.F_W, tk.F_PROB, tk.F_PCONV, tk.F_PCONV0, tk.F_TB] + list(range(tk.F_U0, 16))
    a, b = fk[slots][:, cols], fp[slots][:, cols]
    scale = b.abs()
    scale[:, 6:8] = scale[:, 6:8].clamp(min=1.0)
    scale[:, 8:11] = b[:, 8:11].norm(dim=1, keepdim=True)
    rel = ((a - b).abs() / scale.clamp(min=1e-300)).amax(dim=1)
    assert rel.median().item() < 1e-8
    assert torch.quantile(rel, 0.99).item() < 1e-6 and rel.max().item() < 1e-5


@pytest.mark.cuda
def test_treekernel_matches_plain(dev):
    """K3 (one warp per event) and tree_kernel_launch_plain on the same
    blocks (128 production events, default cutoffs, one launch), at
    assert_trees_agree's bars with counters identical on >= 99% of events."""
    sc, cfg, tc, blocks = tree_blocks(dev, 128, seed=5)
    E = blocks[0].shape[0]
    kw = dict(nf=tc.num_cutoff, qd=tc.mc_nodes + 2, it_cap=10**8)
    _, a_k, _, f_k = tk.tree_kernel_launch(*blocks, sc, cfg, tc, **kw)
    torch.cuda.synchronize()
    _, a_p, _, f_p = tk.tree_kernel_launch_plain(*blocks, sc, cfg, tc, **kw)
    assert E >= 100
    assert_trees_agree(a_k, f_k, a_p, f_p, tc.num_cutoff, 0.99)


@pytest.mark.cuda
def test_treerefill_matches_plain(dev):
    """K4 and tree_refill_launch_plain on 8 production events in one
    partition, the kernel with 2 warps (so the queue hands each warp events
    in turn), the plain version with 2 lanes, refill period 4: the same
    trees as assert_trees_agree holds them, counters on all but one event at
    most; every event finished, each at a warp iteration count no smaller
    than its own steps, and some started after another ended."""
    sc, cfg, tc, blocks = tree_blocks(dev, 8, seed=6)
    E = blocks[0].shape[0]
    kw = dict(nf=tc.num_cutoff, qd=tc.mc_nodes + 2, epart=8, refill_k=4, it_cap=10**8)
    _, a_k, _, f_k = tk.tree_refill_launch(*blocks, sc, cfg, tc, warps=2, **kw)
    torch.cuda.synchronize()
    _, a_p, _, f_p = tk.tree_refill_launch_plain(*blocks, sc, cfg, tc, lanes=2, **kw)
    assert E == 8 and torch.all(a_k[:, tk.A_DONE] == 1) and torch.all(a_p[:, tk.A_DONE] == 1)
    assert torch.all(a_k[:, tk.A_ITERS] >= a_k[:, tk.A_STEPTOT])
    assert int((a_k[:, tk.A_ITERS] > a_k[:, tk.A_STEPTOT]).sum()) >= 2
    assert_trees_agree(a_k, f_k, a_p, f_p, tc.num_cutoff, 7 / 8)


@pytest.mark.cuda
def test_treerefill_equals_treekernel(dev):
    """K4 (2 warps per partition of 16, and its default warps in one
    partition) and K3 in one launch run the same warp code per event: every
    aux row but the iteration count, and every finals slot, bit for bit."""
    sc, cfg, tc, blocks = tree_blocks(dev, 64, seed=7)
    kw = dict(nf=tc.num_cutoff, qd=tc.mc_nodes + 2)
    _, a3, _, f3 = tk.tree_kernel_launch(*blocks, sc, cfg, tc, it_cap=10**8, **kw)
    keep = [r for r in range(tk.AUX_ROWS) if r != tk.A_ITERS]
    for epart, warps in ((16, 2), (64, None)):
        _, a4, _, f4 = tk.tree_refill_launch(*blocks, sc, cfg, tc, epart=epart, refill_k=8,
                                             it_cap=10**8, warps=warps, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a4[:, keep], a3[:, keep]) and torch.equal(f4, f3), (epart, warps)


@pytest.mark.cuda
def test_refill_probe_matches_plain(dev):
    """P1 against its plain version: at the probe's shapes, and on two
    partitions served by 100 threads each, and with the loop cut at 8
    iterations.  Ids, steps and the zero rows equal; the flush iteration,
    which depends on which thread took the event when, at a refill boundary
    or the loop's end (checks).  The loop's end (a partition's largest flush
    iteration) is the makespan of the order the atomics gave, so it is held
    to what every order gives: at least the largest quota (its thread worked
    it from a refill boundary >= 0) and the partition's total quota over its
    threads, both capped at n_it, and at most n_it."""
    from adiabatic_raytracer_tpu_torch.ops import refill_probe as rp

    two = torch.cat([rp.probe_table(0), rp.probe_table(1)])
    for tbl, kw in ((rp.probe_table(), {}), (two, dict(lanes=100)), (two, dict(n_it=8))):
        got = rp.refill_probe(tbl.to(dev), **kw)
        torch.cuda.synchronize()
        want = rp.refill_probe_plain(tbl, **kw)
        assert torch.equal(got[:, :-1].cpu(), want[:, :-1])
        lanes, n_it = kw.get("lanes", rp.L), kw.get("n_it", rp.N_IT)
        quota = tbl[:, 0]
        low = torch.maximum(quota.amax(dim=1), torch.ceil(quota.sum(dim=1) / lanes)).clamp(max=n_it)
        end = got[:, -1].amax(dim=1).cpu()
        assert bool(((end >= low) & (end <= n_it)).all()), (kw, end, low)
        if "n_it" in kw:   # half the events never taken; the others flushed at 4 or 8
            at = got[:, -1].cpu()[got[:, 0].cpu() > 0]
            assert at.numel() == 2 * 256 and bool(torch.all((at == 4) | (at == 8)))
        else:
            assert all(ok for ok, _ in rp.checks(tbl, got).values())
