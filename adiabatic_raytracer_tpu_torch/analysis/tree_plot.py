"""3D tree visualizations on the current tree-file format.

Port of adiabatic_raytracer_tpu/analysis/tree_plot.py (numpy only; matplotlib
is imported inside the plotting functions alone), reading trees with the
port's analysis/treeio.py.

Three views, one per reference script (each of which ships a stale parser —
analysis/treeio.load_tree reads the current saveNode output correctly):

  * plot_tree           — plot/plotTree.py: weight-colormapped branches;
  * plot_tree_publication — plot/plotTree_2.py: species-colored branches
    with arrowheads, conversion-point stars, crossings-bounding-box crop,
    symmetric cube limits;
  * plot_tree_single    — jonas_test_analyses/plotSingle.py: branches
    colormapped by log10(|parent_weight| * prob) with a colorbar,
    escaping-final markers, per-species linestyles.
"""

from __future__ import annotations

import numpy as np

from adiabatic_raytracer_tpu_torch.analysis.treeio import load_tree


def _crossings_box(nodes, pad=20.0):
    """Bounding box of all crossing points + the sampled origin, padded
    (plotTree_2.py:114-135 / plotSingle.py:95-116)."""
    pts = [[nodes[0]["x"][0]], [nodes[0]["y"][0]], [nodes[0]["z"][0]]]
    for n in nodes:
        pts[0].extend(n["crossings_x"])
        pts[1].extend(n["crossings_y"])
        pts[2].extend(n["crossings_z"])
    lo = np.array([min(p) for p in pts]) - pad
    hi = np.array([max(p) for p in pts]) + pad
    return lo, hi


def _crop(n, lo, hi):
    """Drop trajectory points outside the box (plotTree_2.py:139-149)."""
    xyz = np.stack([n["x"], n["y"], n["z"]])
    keep = np.all((xyz >= lo[:, None]) & (xyz <= hi[:, None]), axis=0)
    return n["x"][keep], n["y"][keep], n["z"][keep]


def _ns_sphere(ax, r_ns, color, alpha=0.5, res=24):
    u, v = np.mgrid[0:2 * np.pi:res * 1j, 0:np.pi:res // 2 * 1j]
    ax.plot_surface(r_ns * np.cos(u) * np.sin(v), r_ns * np.sin(u) * np.sin(v),
                    r_ns * np.cos(v), alpha=alpha, color=color)


def plot_tree(path: str, r_ns: float = 10.0, cutoff: float = 1e-7,
              show: bool = True, save: str = None):
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    nodes = load_tree(path)
    fig = plt.figure(figsize=(9, 7))
    ax = plt.axes(projection="3d")

    weights = [max(n["weight"], cutoff) for n in nodes]
    lw = np.log10(weights)
    lo, hi = lw.min(), max(lw.max(), lw.min() + 1e-9)

    for n, w in zip(nodes, lw):
        color = cm.viridis((w - lo) / (hi - lo))
        style = "-" if n["species"] == "photon" else "--"
        ax.plot3D(n["x"], n["y"], n["z"], style, color=color, alpha=0.8)
        if n["crossings_x"]:
            ax.scatter(n["crossings_x"], n["crossings_y"], n["crossings_z"],
                       marker="x", color="r", s=18)

    # NS sphere
    u, v = np.mgrid[0:2 * np.pi:24j, 0:np.pi:12j]
    ax.plot_surface(r_ns * np.cos(u) * np.sin(v), r_ns * np.sin(u) * np.sin(v),
                    r_ns * np.cos(v), color="gray", alpha=0.3)
    ax.set_xlabel("x [km]")
    ax.set_ylabel("y [km]")
    ax.set_zlabel("z [km]")
    if save:
        plt.savefig(save, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return nodes


def plot_tree_publication(path: str, r_ns: float = 10.0, show: bool = True,
                          save: str = None):
    """plotTree_2.py's figure: the in-falling parent axion dashed black,
    sourced branches in fixed species colors with arrowheads at their ends,
    conversion points as stars, escaping finals cropped to the crossings
    bounding box, NS sphere, symmetric cube limits
    (plot/plotTree_2.py:96-248)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C_AXION, C_PHOTON, C_CROSS, C_NS = "#33658A", "#F7996E", "#69140E", "#A7A5C6"
    nodes = load_tree(path)
    fig = plt.figure(figsize=(9, 7))
    ax = plt.axes(projection="3d")
    lo, hi = _crossings_box(nodes)

    # sampled origin star + parent (backtraced) axion, dashed black
    # (plotTree_2.py:110,167-170)
    p = nodes[0]
    ax.plot3D(p["x"][0:1], p["y"][0:1], p["z"][0:1], marker="*",
              color=C_CROSS, markersize=10)
    ax.plot3D(p["x"], p["y"], p["z"], linestyle="--", color="k")

    for n in nodes[1:]:
        final = not n["crossings_x"]
        hits_ns = n["r"].min() < 1.01 * r_ns
        is_axion = n["species"].startswith("a")
        c = C_AXION if is_axion else C_PHOTON
        if final and (not hits_ns or is_axion):   # plotTree_2.py:139-149
            x, y, z = _crop(n, lo, hi)
        else:
            x, y, z = n["x"], n["y"], n["z"]
        ax.plot3D(x[:-1], y[:-1], z[:-1], color=c, lw=2)
        if n["crossings_x"]:
            ax.plot3D(n["crossings_x"], n["crossings_y"], n["crossings_z"],
                      linestyle="", marker="*", color=C_CROSS)
        if len(x) >= 2:  # arrowhead at the branch end (plotTree_2.py:208-211)
            ax.quiver(x[-2], y[-2], z[-2], x[-1] - x[-2], y[-1] - y[-2],
                      z[-1] - z[-2], color=c, arrow_length_ratio=0.9, lw=2)

    _ns_sphere(ax, r_ns, C_NS, alpha=0.5, res=48)
    m = float(np.max(np.abs(np.concatenate([lo, hi]))))
    ax.set_xlim(-m, m)
    ax.set_ylim(-m, m)
    ax.set_zlim(-m, m)
    ax.set_xlabel(r"$x/r_\mathrm{NS}$")
    ax.set_ylabel(r"$y/r_\mathrm{NS}$")
    ax.set_zlabel(r"$z/r_\mathrm{NS}$")
    ax.plot([], [], linestyle="--", color="k", label="In-falling Axion")
    ax.plot([], [], linestyle="", marker="*", color=C_CROSS,
            label="Conversion point")
    ax.plot([], [], linestyle="-", color=C_AXION, label="Sourced Axion")
    ax.plot([], [], linestyle="-", color=C_PHOTON, label="Sourced Photon")
    ax.view_init(10, 5)
    fig.legend()
    fig.tight_layout()
    if save:
        plt.savefig(save, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return nodes


def plot_tree_single(path: str, r_ns: float = 10.0, cutoff: float = -1.0,
                     show: bool = True, save: str = None):
    """plotSingle.py's single-event diagnostic: branches colormapped by
    log10(|parent_weight| * prob) (copper, reversed) with a colorbar,
    linestyle by species, crossing stars, escaping finals as squares,
    initial conversion circle (jonas_test_analyses/plotSingle.py:81-197)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes = load_tree(path)
    fig = plt.figure(figsize=(9, 7))
    ax = plt.axes(projection="3d")
    lo, hi = _crossings_box(nodes)

    cmap = plt.get_cmap("copper").reversed()
    vmin = np.log10(abs(min(n["weight"] for n in nodes)))
    if not np.isfinite(vmin):
        vmin = -10.0

    def color(w0):  # plotSingle.py:138-145
        w = w0 if w0 != 0 else 1e-10
        return cmap((np.log10(w) - vmin) / (0.0 - vmin))

    ax.plot3D(nodes[0]["x"][0:1], nodes[0]["y"][0:1], nodes[0]["z"][0:1],
              marker="o", color="r")
    for n in nodes:
        if n["weight"] < cutoff:
            continue
        final = not n["crossings_x"]
        hits_ns = n["r"].min() < 1.1 * r_ns
        if final and not hits_ns:
            x, y, z = _crop(n, lo, hi)
        else:
            x, y, z = n["x"], n["y"], n["z"]
        ls = "--" if n["species"].startswith("a") else "-"
        # root flag: parent_weight == -1 means prob plays no role
        prob = 1.0 if n["parent_weight"] == -1 else n["prob"]
        ax.plot3D(x, y, z, linestyle=ls, color=color(abs(n["parent_weight"])
                                                     * prob))
        if n["crossings_x"]:
            ax.plot3D(n["crossings_x"], n["crossings_y"], n["crossings_z"],
                      linestyle="", marker="*", color="g")
        if final and not hits_ns and len(x):
            ax.plot3D([x[-1]], [y[-1]], [z[-1]], linestyle="", marker="s",
                      color="b")

    _ns_sphere(ax, r_ns, "C0", alpha=0.5, res=20)
    ax.set_xlim(min(-r_ns, lo[0]), max(r_ns, hi[0]))
    ax.set_ylim(min(-r_ns, lo[1]), max(r_ns, hi[1]))
    ax.set_zlim(min(-r_ns, lo[2]), max(r_ns, hi[2]))
    sm = plt.cm.ScalarMappable(cmap=cmap)
    sm._A = [0, vmin]
    fig.colorbar(sm, ax=ax, label="Log probability")
    ax.set_xlabel(r"$x/r_\mathrm{NS}$")
    ax.set_ylabel(r"$y/r_\mathrm{NS}$")
    ax.set_zlabel(r"$z/r_\mathrm{NS}$")
    for style, label in [("", "Initial conversion"), ("", "Level crossing"),
                         ("", "Escaping particle"), ("-", "Photon"),
                         ("--", "Axion")]:
        marker = {"Initial conversion": "o", "Level crossing": "*",
                  "Escaping particle": "s"}.get(label, "")
        col = {"Initial conversion": "r", "Level crossing": "g",
               "Escaping particle": "b"}.get(label, "k")
        ax.plot([], [], linestyle=style, marker=marker, color=col, label=label)
    fig.legend()
    fig.tight_layout()
    if save:
        plt.savefig(save, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return nodes
