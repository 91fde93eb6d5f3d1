"""The port at scenes of the (MassA, B0) scan grid (SCAN_GATE_r05.json)
against the JAX package on CPU: the CLI's rows at four off-default scenes,
two of them with the boundary layer (--bndry_lyr 0.5),
the quit at a surface inside the star, and the scan-gate census's
ensemble."""

import numpy as np
import torch

from adiabatic_raytracer_tpu_torch.cli import run_from_args

torch.set_num_threads(1)

GRID_ARGS = ["--Nts", "4", "--seed", "1769", "--ThetaM", "0.2", "--saveMode", "1",
             "--event_batch", "3", "--device", "cpu"]

# Pinned from the JAX CLI:
#   python -m adiabatic_raytracer_tpu --Nts 4 --seed 1769 --ThetaM 0.2 --saveMode 1 \
#       --event_batch 3 --platform cpu <flags>
# with adiabatic_raytracer_tpu/ as of commit f94cb70, its last change; rerun
# it there after a change to the JAX package (weights, species,
# processed-node counts, stop codes)
PINNED = {
    # maxR 54.3 km: the scene whose gate the reference's census widened
    ("--MassA", "1e-5", "--B0", "1e15"): (
        [4.1740698816e-03, 3.1197024765e-02, 2.0722657197e-03],
        [1, 1, 1], [1, 1, 1], [2, 2, 2]),
    # maxR 11.7 km: a small surface just outside the star
    ("--MassA", "1e-4", "--B0", "1e15"): (
        [4.9267499129e-01, 2.4533714135e-01, 1.3308417246e-01, 3.526913715e-01],
        [0, 1, 0, 1], [3, 3, 3, 1], [2, 2, 2, 2]),
    # the boundary layer at a 54.2 km surface, its shell's peak at 26.9 km;
    # one event's tree enters the pure-MC mode (13 nodes, stop code -3)
    ("--MassA", "1e-6", "--B0", "1e13", "--bndry_lyr", "0.5"): (
        [3.1067685061e-06, 3.1335644034e-05, 6.7489059894e-10, 1.5665864422e-05,
         5.7068973851e-10, 3.1178988888e-10, 3.3620381187e-11, 1.3016939936e-15],
        [1, 1, 0, 1, 0, 0, 0, 1], [1, 3, 3, 13, 13, 13, 13, 13],
        [2, 2, 2, -3, -3, -3, -3, -3]),
    # the boundary layer at an 11.7 km surface, its peak inside the star
    # (rmax 11.6 km: 5.8 km), so the term reaches the surface at 2.7% of it
    ("--MassA", "1e-5", "--B0", "1e13", "--bndry_lyr", "0.5"): (
        [1.4023578748e-03, 1.5203666688e-06, 3.7894287855e-04, 1.5086498934e-07],
        [1, 0, 1, 0], [3, 3, 3, 3], [2, 2, 2, 2]),
}


def test_grid_scenes_pinned_rows(tmp_path):
    """The port's CLI on CPU reproduces the JAX CLI's rows at each pinned
    scene, two of them at --bndry_lyr 0.5: weights at rtol 1e-6, species,
    node counts and stop codes exact.  (One test for all scenes: xdist's
    loadfile queues files by their test count, and at three tests this file
    queues behind the reference's long tests/test_treekernel.py.)"""
    for flags, (weights, species, count, info) in PINNED.items():
        rows, _, stats = run_from_args(GRID_ARGS + list(flags) + ["--dir_tag", str(tmp_path)])
        assert rows.shape == (len(weights), 29) and stats.events == 3, flags
        np.testing.assert_allclose(rows[:, 8], weights, rtol=1e-6, err_msg=str(flags))
        np.testing.assert_array_equal(rows[:, 1], species, err_msg=str(flags))
        np.testing.assert_array_equal(rows[:, 20], count, err_msg=str(flags))
        np.testing.assert_array_equal(rows[:, 21], info, err_msg=str(flags))
        assert np.all(np.isfinite(rows)) and np.all(rows[:, 7] > 0)


def test_surface_inside_star_quits_as_jax(tmp_path):
    """At (1e-4, 1e13) and (1e-4, 1e14) the conversion surface lies inside
    the star (maxR 2.5 and 5.4 km): both packages' run return None before
    sampling, and the port's CLI writes no npy file."""
    from adiabatic_raytracer_tpu import config as jcfg
    from adiabatic_raytracer_tpu import driver as jdriver
    from adiabatic_raytracer_tpu_torch import config as tcfg
    from adiabatic_raytracer_tpu_torch import driver as tdriver

    for b0 in (1e13, 1e14):
        kw = dict(seed=1769, save_mode=1, event_batch=3, dir_tag=str(tmp_path), verbose=False)
        got_j = jdriver.run(jcfg.Scene(mass_a=1e-4, theta_m=0.2, b0=b0), jcfg.NumericsConfig(),
                            jcfg.TreeConfig(), 4, **kw)
        got_t = tdriver.run(tcfg.Scene(mass_a=1e-4, theta_m=0.2, b0=b0), tcfg.NumericsConfig(),
                            tcfg.TreeConfig(), 4, device="cpu", **kw)
        assert got_j is None and got_t is None
        assert run_from_args(GRID_ARGS + ["--MassA", "1e-4", "--B0", f"{b0:g}", "--dir_tag",
                                          str(tmp_path)]) is None
    assert not list((tmp_path / "npy").glob("*.npy"))


def test_census_ensemble_matches_jax():
    """The census's ensemble (scan_gate_census_check's draw, the reference's
    driver.py:202-223) at (1e-4, 1e15) in f64: the same first 8 events,
    their positions, velocities, energies and k_init at rtol 1e-9 (f64
    roots; the two packages evaluate the condition in other orders)."""
    import jax
    import jax.numpy as jnp

    from adiabatic_raytracer_tpu import config as jcfg
    from adiabatic_raytracer_tpu.ops import sampler as jsampler
    from adiabatic_raytracer_tpu.ops.dispersion import k_norm_cart
    from adiabatic_raytracer_tpu_torch import config as tcfg
    from adiabatic_raytracer_tpu_torch import driver as tdriver
    from adiabatic_raytracer_tpu_torch.models.magnetosphere import conversion_surface_radius

    n = 8
    sc_t = tcfg.Scene(mass_a=1e-4, theta_m=0.2, b0=1e15)
    maxR = conversion_surface_radius(sc_t.mass_a, sc_t.theta_m, sc_t.omega_pul, sc_t.b0,
                                     sc_t.r_ns)
    x, v, e, k = (a.numpy() for a in tdriver.census_ensemble(
        sc_t, tcfg.NumericsConfig(), maxR, n_events=n, device="cpu"))

    # the reference's draw (driver.py:202-223 there), on its first chunk
    sc_j = jcfg.Scene(mass_a=1e-4, theta_m=0.2, b0=1e15)
    key = jax.random.fold_in(jax.random.PRNGKey(0x5CA9), 1)
    _, sub = jax.random.split(key)
    res = jsampler.sample_batch(sub, 2048, maxR, sc_j, sc_j.mass_ns,
                                n_grid=tdriver.sampler.default_n_grid(maxR),
                                line_engine="xla")
    ok = np.nonzero(np.asarray(res.success))[0][:n]
    assert ok.size == n == x.shape[0]
    xj, vj, ej = (np.asarray(a)[ok] for a in (res.xpos, res.v_loc, res.erg_inf))
    kj = np.asarray(k_norm_cart(jnp.asarray(xj), jnp.asarray(vj), 0.0, jnp.asarray(ej), sc_j,
                                sc_j.mass_ns, is_photon=True, ax_fix=True, flat=sc_j.flat))
    for a, b in ((x, xj), (v, vj), (e, ej), (k, kj)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
