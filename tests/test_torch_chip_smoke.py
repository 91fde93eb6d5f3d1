"""chip_smoke.py's helpers that run without a card: ptxas parsing, the
refusal to run on a machine without one, 27e's spectrum comparison, and
phase 28's shell and pinned-root helpers."""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LOG = """== megakernel.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112probe_kernelEiPKdS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112probe_kernelEiPKdS1_
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Function properties for _ZN3art7prob_ndERKNS_10MegaParamsEPKdd
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_111mega_kernelILi0EEEvPKdS2_iiPiN3art10MegaParamsEPdS6_S6_S6_S6_S6_S6_
    496 bytes stack frame, 128 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 496 bytes cumulative stack size
ptxas info    : Function properties for _ZN12_GLOBAL__N_111mega_kernelILi3EEEvPKdS2_iiPiN3art10MegaParamsEPdS6_S6_S6_S6_S6_S6_
    464 bytes stack frame, 80 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 464 bytes cumulative stack size
== line_scan.cu
ptxas info    : Function properties for _ZN45_GLOBAL__N__04f3c17b_12_line_scan_cu_bb73f25f17line_roots_kernelIdEEvPKfS2_PKT_S5_iiiN3art10LineSceneTIfEENS7_IS3_EEPS3_PhPiSC_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 0 barriers, 1024 bytes smem
ptxas info    : Function properties for _ZN45_GLOBAL__N__04f3c17b_12_line_scan_cu_bb73f25f17line_roots_kernelIfEEvPKfS2_PKT_S5_iiiN3art10LineSceneTIfEENS7_IS3_EEPS3_PhPiSC_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 55 registers, used 0 barriers, 1024 bytes smem
== refill_probe.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_119refill_probe_kernelEPKfPfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, used 1 barriers
== treerefill.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_118tree_refill_kernelEPdS1_PKdS1_S1_iiii
    520 bytes stack frame, 96 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_summary_matches_whole_kernel_names():
    """P1's refill_probe_kernel is not taken for K2's probe_kernel, nor K4's
    tree_refill_kernel for K3's tree_kernel; device functions are skipped;
    K2's dispersion variants are keyed by their template argument, the
    production one (0) by the plain name, K1's fused kernel by its type."""
    got = chip_smoke.ptxas_summary(LOG)
    assert set(got) == {"probe_kernel", "refill_probe_kernel", "tree_refill_kernel",
                        "mega_kernel", "mega_kernel<3>", "line_roots_kernel<float>",
                        "line_roots_kernel<double>"}
    assert chip_smoke.ptxas_figures(got["line_roots_kernel<float>"]) == (55, 0, 0, 0)
    assert chip_smoke.ptxas_figures(got["line_roots_kernel<double>"]) == (94, 0, 0, 0)
    assert chip_smoke.ptxas_figures(got["mega_kernel"]) == chip_smoke.K2_PTXAS
    assert chip_smoke.ptxas_figures(got["mega_kernel<3>"]) == (255, 464, 80, 48)
    assert got["probe_kernel"].endswith("Used 96 registers, used 1 barriers")
    assert got["refill_probe_kernel"].startswith("0 bytes stack frame")
    assert "96 bytes spill stores" in got["tree_refill_kernel"]
    assert chip_smoke.ptxas_figures(got["tree_refill_kernel"]) == (255, 520, 96, 96)
    assert chip_smoke.ptxas_figures("") == (None, None, None, None)
    assert chip_smoke.source_names("line_scan_kernel") == {"line_scan_kernel"}


def test_chip_smoke_refuses_without_a_card():
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_record_notes_find_the_birth_state():
    """record_notes reads a final record's end state, birth time, order and
    species, and finds its birth state by integrating the end state back to
    the birth time: two rays (an axion, a photon) of the production scene,
    integrated forward from t_b to the end with the same RHS twin, come
    back to their launch radius and angle to 1e-6; the condition there is
    the torch twin's."""
    import math

    from adiabatic_raytracer_tpu_torch.config import NumericsConfig
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops import treekernel as tk
    from adiabatic_raytracer_tpu_torch.ops.integrator import integrate_pool
    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

    f64 = torch.float64
    sc, cfg, *_ = chip_smoke.scene_setup(torch.device("cpu"))
    P = tk.kernel_params(sc, cfg)
    x = torch.tensor([[12.0, 3.0, 4.0], [-20.0, 5.0, 1.0]], dtype=f64)
    k = torch.tensor([[0.3, -0.2, 0.9], [0.1, 0.8, -0.1]], dtype=f64)
    erg = torch.full((2,), 1.0000005e-5, dtype=f64)
    is_ph = torch.tensor([0.0, 1.0], dtype=f64)
    u0 = launch_state(x, k, sc, erg, -torch.ones(2, dtype=f64))
    t_b = torch.tensor([0.98, 0.97], dtype=f64)
    comp = lambda u: tuple(u[:, c] for c in range(7))
    fwd = integrate_pool(
        lambda u, s, a: torch.stack(mk._rhs(P, comp(u), s, erg, is_ph), dim=1),
        lambda u, s: mk._condition(P, comp(u), s), u0, torch.log(t_b), torch.zeros(2, dtype=f64),
        {}, NumericsConfig(rtol=1e-9, atol=1e-11), save_lnt=torch.zeros((2, 1), dtype=f64),
        kill_at_surface=torch.zeros(2, dtype=torch.bool), r_ns=P.r_ns,
        x0_cart=torch.zeros((2, 3), dtype=f64), max_crossings=torch.ones(2, dtype=torch.int64),
        detect_events=False)
    fin = torch.zeros((2, 3, tk.ROWS), dtype=f64)
    fin[:, 1, tk.F_U0:tk.F_U0 + 7] = fwd.u
    fin[:, 1, tk.F_TB] = t_b
    fin[:, 1, tk.F_ORD] = torch.tensor([3.0, 7.0])
    fin[:, 1, tk.F_ISPH] = is_ph
    aux = torch.zeros((2, tk.AUX_ROWS), dtype=f64)
    aux[:, tk.A_ERG] = erg
    notes = chip_smoke.record_notes(fin, aux, torch.tensor([0, 1]), torch.tensor([1, 1]))
    assert "order 3 axion" in notes[0] and "t_b 0.97 order 7 photon" in notes[1]
    assert notes[0].startswith(f"end r {fwd.u[0, 0].item():.6g} km")
    g = mk._condition(P, comp(u0), torch.log(t_b))
    for i, note in enumerate(notes):
        born = note.split(" at r ", 1)[1].split()
        assert math.isclose(float(born[0]), u0[i, 0].item(), rel_tol=1e-6)
        assert math.isclose(float(born[3].rstrip(",")), u0[i, 1].item(), rel_tol=1e-6)
        assert math.isclose(float(born[5]), g[i].item(), rel_tol=1e-2, abs_tol=1e-6)
        assert math.isfinite(float(note.rsplit("dg/dlnt ", 1)[1]))


def test_plain_pool_gives_the_plain_version_bitwise(monkeypatch):
    """chip_smoke's plain_pool (spawned CPU processes, inputs and outputs
    sent pickled) returns K2's plain version's outputs bitwise as a call in
    this process gives them, with its time, and close_plain_pool stops it."""
    from adiabatic_raytracer_tpu_torch.ops import megakernel as mk
    from adiabatic_raytracer_tpu_torch.ops.propagate import launch_state

    monkeypatch.setattr(chip_smoke, "PLAIN_WORKERS", 1)
    f64 = torch.float64
    sc, cfg, *_ = chip_smoke.scene_setup(torch.device("cpu"))
    x = torch.tensor([[12.0, 3.0, 4.0], [-20.0, 5.0, 1.0]], dtype=f64)
    k = torch.tensor([[0.3, -0.2, 0.9], [0.1, 0.8, -0.1]], dtype=f64)
    erg = torch.full((2,), 1.0000005e-5, dtype=f64)
    u0 = launch_state(x, k, sc, erg, -torch.ones(2, dtype=f64))
    args = (u0, torch.full((2,), -1.0, dtype=f64), torch.zeros(2, dtype=f64), erg, x, sc, cfg)
    kw = dict(max_crossings=1, is_photon=torch.tensor([True, False]), species="mixed",
              with_prob=True)
    try:
        fut = chip_smoke.submit_plain("k2", *args, **kw)
        got, sec = chip_smoke.plain_result(fut, torch.device("cpu"))
    finally:
        chip_smoke.close_plain_pool()
    want = mk.integrate_mega_plain(*args, **kw)
    assert sec > 0 and len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not chip_smoke._PLAIN_POOL


def spectrum_rows(n, seed):
    """n output rows (29 columns) with the columns spectrum_gap reads: the
    species (1), phi_f (3), sln_prob (7) and the weight (8)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 29))
    rows[:, 1] = rng.integers(0, 2, n)
    rows[:, 3] = rng.uniform(-math.pi, math.pi, n)
    rows[:, 7] = rng.uniform(0.5, 2.0, n)
    rows[:, 8] = rng.uniform(1e-3, 1.0, n)
    return rows


def test_spectrum_gap_in_standard_errors():
    """spectrum_gap: equal rows give 0; one photon row's weight moved by d
    moves its bin by d x sln_prob over sqrt of the mean of the two runs'
    sum of pps^2 in the bin, and the total photon rate by the same over the
    photons' sums; bins with fewer than SPECTRUM_MIN_ROWS rows are not
    held."""
    a = spectrum_rows(4000, 3)
    assert chip_smoke.spectrum_gap(a, a.copy()) == (0.0, 100, 0.0, 0.0)
    b = a.copy()
    i = int(np.nonzero(a[:, 1] == 1)[0][0])
    b[i, 8] += 0.25
    worst, held, total, rel = chip_smoke.spectrum_gap(a, b)
    pa, pb = a[:, 8] * a[:, 7], b[:, 8] * b[:, 7]
    ph = a[:, 1] == 1
    k = np.floor((a[:, 3] + math.pi) / (2 * math.pi) * 50)
    same = ph & (k == k[i])
    d = 0.25 * a[i, 7]
    assert math.isclose(worst, d / math.sqrt(0.5 * ((pa[same] ** 2).sum() + (pb[same] ** 2).sum())),
                        rel_tol=1e-9)
    assert math.isclose(total, d / math.sqrt(0.5 * ((pa[ph] ** 2).sum() + (pb[ph] ** 2).sum())),
                        rel_tol=1e-9)
    assert math.isclose(rel, d / pb[ph].sum(), rel_tol=1e-9)
    assert held == 100
    assert chip_smoke.spectrum_gap(a[:200], a[:200])[1] < 100


def test_bndry_shell_and_pinned_roots():
    """Phase 28's helpers.  shell_radius: the layer's peak outside the star,
    max(rmax lyr, r_NS), plus three decay lengths of 0.1 rmax.
    reaches_shell: a ray from inside the shell, or one aimed inward whose
    closest approach lies inside it, reaches it; one leaving from outside
    does not.  pinned_only: on lines of the 11.7 km boundary-layer scene,
    where roots sit on r_NS (the condition jumps there), a line whose
    filter decisions differ only at such roots is pinned, and a line that
    also differs at another root, or that has no root, is not.  pin_counts:
    the route against itself differs nowhere; a filter that took rr >= r_NS
    differs on more of the lines with a root on r_NS than PIN_SHARE lets
    through, and one that dropped rr > r_NS accepts roots inside the star."""
    from adiabatic_raytracer_tpu_torch.ops import line_scan, sampler
    from adiabatic_raytracer_tpu_torch.ops.megakernel import bndry_scalars
    from adiabatic_raytracer_tpu_torch.utils import rng

    cpu = torch.device("cpu")
    sc, _, _, maxR, n_grid = chip_smoke.scene_setup(cpu, mass_a=1e-5, b0=1e13, bndry_lyr=0.5)
    _, _, rmax = bndry_scalars(sc)
    r_shell = chip_smoke.shell_radius(sc)
    assert math.isclose(r_shell, max(0.5 * rmax, 10.0) + 0.3 * rmax)
    x = torch.tensor([[r_shell - 1.0, 0, 0], [r_shell + 5.0, 0, 0], [r_shell + 5.0, 0, 0]],
                     dtype=torch.float64)
    k = torch.tensor([[1.0, 0, 0], [1.0, 0, 0], [-1.0, 0.1, 0]], dtype=torch.float64)
    assert chip_smoke.reaches_shell(x, k, r_shell).tolist() == [True, False, True]

    geo = sampler._draw(rng.split(rng.PRNGKey(20261016), 512), maxR, sc, 220.0, True,
                        torch.float64)
    s_grid = torch.linspace(0.0, 2.2 * maxR, n_grid, dtype=torch.float64)
    args = (geo.x0, geo.vvec, geo.vvec_loc, geo.erg_inf)
    g = line_scan.line_scan_plain(*args, s_grid, sc, sc.mass_ns).to(torch.float64)
    s, ok, n, _ = line_scan.line_roots_warp(*args, g, s_grid, sc, sc.mass_ns)
    has = torch.arange(16)[None, :] < n[:, None]
    pin = has & chip_smoke.on_surface(geo, s, sc)[0]
    same = chip_smoke.pin_counts(geo, s, ok, s, ok, has, sc)
    assert (same["n_ok"], same["n_pin"], same["n_inside"]) == (0, 0, 0)
    # rr >= r_NS is rr > r_NS', r_NS' the dtype's next value below r_NS
    ge = dataclasses.replace(sc, r_ns=math.nextafter(float(sc.r_ns), 0.0))
    ok_ge = has & sampler._accept_at(geo.x0, geo.vvec, geo.erg_inf, s, ge, sc.mass_ns)
    mutant = chip_smoke.pin_counts(geo, s, ok_ge, s, ok, has, sc)
    assert mutant["n_ok"] == 0 and mutant["n_pin"] > mutant["bar"]
    no_rns = dataclasses.replace(sc, r_ns=0.0)
    ok_in = has & sampler._accept_at(geo.x0, geo.vvec, geo.erg_inf, s, no_rns, sc.mass_ns)
    assert chip_smoke.pin_counts(geo, s, ok_in, s, ok, has, sc)["n_inside"] > 0
    lines = pin.any(dim=1).nonzero().squeeze(1).tolist()
    assert len(lines) >= 3
    i, j = lines[0], lines[1]
    other = (has[j] & ~pin[j]).nonzero().squeeze(1)
    assert other.numel() > 0
    # the "kernel" decides the pinned roots of lines i and j the other way,
    # and line j's first other root too
    ok_k = ok.clone()
    ok_k[i] = torch.where(pin[i], ~ok[i], ok[i])
    ok_k[j] = torch.where(pin[j], ~ok[j], ok[j])
    ok_k[j, other[0]] = ~ok[j, other[0]]
    kernel = {"geo": geo, "s": s, "ok": ok_k, "n_flips": n, "s_grid": s_grid}
    assert chip_smoke.pinned_only(kernel, i, g[[i]], sc)
    assert not chip_smoke.pinned_only(kernel, j, g[[j]], sc)
    quiet = (n == 0).nonzero().squeeze(1)[0].item()
    assert not chip_smoke.pinned_only(kernel, quiet, g[[quiet]], sc)
