"""The port's analysis (analysis/flux.py, analysis/tree_plot.py) against the
JAX package's: flux.analyze field by field on one npy of each column
contract, the tree-plot helpers on a tree file written by the port's
writer, and the figures under matplotlib's Agg backend."""

import dataclasses

import numpy as np
import pytest

from adiabatic_raytracer_tpu.analysis import flux as jflux
from adiabatic_raytracer_tpu.analysis import tree_plot as jplot
from adiabatic_raytracer_tpu.analysis.treeio import load_tree as jload_tree
from adiabatic_raytracer_tpu_torch.analysis import flux as tflux
from adiabatic_raytracer_tpu_torch.analysis import tree_plot as tplot
from adiabatic_raytracer_tpu_torch.analysis.treeio import load_tree
from adiabatic_raytracer_tpu_torch.utils.textio import TreeFile


def _rows(n_cols, n=40, seed=4):
    """Rows of the npy contract: events 1..12 with 1-6 finals each, species,
    phif over [-pi, pi], positive weights and sln_prob, per-event node
    counts and stop codes (MC-negated on some)."""
    rng = np.random.default_rng(seed)
    ev = np.sort(rng.integers(1, 13, n)).astype(float)
    rows = rng.random((n, n_cols))
    rows[:, 0] = ev
    rows[:, 1] = rng.integers(0, 2, n)
    rows[:, 3] = rng.uniform(-np.pi, np.pi, n)
    if n_cols >= 29:
        per_ev = {e: (rng.integers(1, 9), rng.choice([1, 2, 3, 4, -2, -3])) for e in set(ev)}
        rows[:, 20] = [per_ev[e][0] for e in ev]
        rows[:, 21] = [per_ev[e][1] for e in ev]
    return rows


@pytest.mark.parametrize("n_cols", [13, 29])
def test_analyze_matches_jax(tmp_path, n_cols):
    path = str(tmp_path / f"rows{n_cols}.npy")
    np.save(path, _rows(n_cols))
    got, want = tflux.analyze(path), jflux.analyze(path)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.total_photon_rate > 0 and got.photon_hist.sum() > 0
    assert (got.branch_bins is not None) == (n_cols >= 29)


def _tree_file(d):
    """An event's tree dump through the port's writer: the backtraced axion
    with two crossings, a photon and an axion child with one each, and two
    final nodes without (one that falls onto the star)."""
    rng = np.random.default_rng(2)
    tf = TreeFile(str(d), "tp", 1)

    def traj(r0, r1):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        return np.linspace(r0, r1, 12)[:, None] * u[None, :], np.linspace(-3, 0, 12)

    t, s = traj(30.0, 15.0)
    tf.save_node("axion", 1.0, 0.2, 1.0, xc=[18.0, 16.0], yc=[2.0, -1.0], zc=[5.0, 4.0],
                 tc=[0.1, 0.2], traj=t, times=s)
    for species, w, p, pw, cross, (r0, r1) in (
            ("photon", 0.6, 0.3, 1.0, ([17.0], [1.0], [6.0], [0.3]), (15.0, 60.0)),
            ("axion", 0.4, 0.5, 1.0, ([12.0], [-3.0], [2.0], [0.4]), (15.0, 11.0)),
            ("photon", 0.3, 1.0, 0.6, None, (17.0, 400.0)),
            ("axion", 0.2, 1.0, 0.4, None, (12.0, 10.05))):
        t, s = traj(r0, r1)
        kw = dict(zip(("xc", "yc", "zc", "tc"), cross)) if cross else {}
        tf.save_node(species, w, p, pw, traj=t, times=s, **kw)
    tf.close()
    return tf.path


def test_tree_plot_helpers_match_jax(tmp_path):
    path = _tree_file(tmp_path)
    nodes, jnodes = load_tree(path), jload_tree(path)
    lo, hi = tplot._crossings_box(nodes)
    jlo, jhi = jplot._crossings_box(jnodes)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    for n, jn in zip(nodes, jnodes):
        for a, b in zip(tplot._crop(n, lo, hi), jplot._crop(jn, jlo, jhi)):
            np.testing.assert_array_equal(a, b)
    # the long escaping photon leaves the box, so the crop drops points
    assert len(tplot._crop(nodes[3], lo, hi)[0]) < len(nodes[3]["x"])


def test_figures_under_agg(tmp_path):
    """flux.plot (the flux and the two sub-branch figures) and the three
    tree views write their files; matplotlib is imported by them alone."""
    pytest.importorskip("matplotlib")
    npy = str(tmp_path / "rows.npy")
    np.save(npy, _rows(29))
    r = tflux.plot(npy, show=False, save=str(tmp_path / "flux.png"))
    assert r.photon_hist.sum() > 0
    path = _tree_file(tmp_path)
    for fn in (tplot.plot_tree, tplot.plot_tree_publication, tplot.plot_tree_single):
        assert len(fn(path, show=False, save=str(tmp_path / f"{fn.__name__}.png"))) == 5
    import matplotlib.pyplot as plt

    plt.close("all")
    names = {p.name for p in tmp_path.iterdir()}
    assert {"flux.png", "flux_branches.png", "flux_trees.png", "plot_tree.png",
            "plot_tree_publication.png", "plot_tree_single.png"} <= names
