"""Flux / pulse-profile analysis of combined npy outputs.

Port of adiabatic_raytracer_tpu/analysis/flux.py (numpy only; matplotlib is
imported inside `plot` alone).  Replicates plot/flux.py of the reference (the
npy column contract, flux.py:6-36; weighting pps = weight * sln_prob,
flux.py:38; stop-reason accounting, flux.py:86-98).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

COLUMNS_0 = ["event_num", "particle_id", "thetaf", "phif", "thetafX", "phifX",
             "absfX", "sln_prob", "weight", "x0", "y0", "z0", "delta_w"]
COLUMNS_1 = COLUMNS_0 + ["tree_weight", "opticalDepth", "weightC", "kx0", "ky0",
                         "kz0", "calpha", "c", "info", "prob", "prob_conv",
                         "prob_conv0", "samp_back_weight", "absfX2", "c_bck",
                         "prob_nonad0"]


@dataclass
class FluxResult:
    phi_bins: np.ndarray
    photon_hist: np.ndarray
    axion_hist: np.ndarray
    n_events: int
    stop_reasons: dict
    n_mc_used: float
    total_photon_rate: float
    total_axion_rate: float
    # sub-branch accounting (saveMode >= 1 only, else None): the reference's
    # convergence-diagnostic figures of column 20 `c` = considered sub-branch
    # count (flux.py:54-82) — pps-weighted per species and raw per-tree
    branch_bins: np.ndarray = None       # np.arange(0, max(c)) (flux.py:55)
    branch_photon_hist: np.ndarray = None
    branch_axion_hist: np.ndarray = None
    tree_branch_hist: np.ndarray = None  # one count per tree (see analyze)


def load_rows(path: str) -> dict:
    res = np.load(path)
    cols = COLUMNS_1 if res.shape[1] >= 29 else COLUMNS_0
    return {name: res[:, i] for i, name in enumerate(cols)}


def analyze(path: str, num_bins: int = 50) -> FluxResult:
    d = load_rows(path)
    pid = d["particle_id"].astype(int)
    pps = d["weight"] * d["sln_prob"]
    ph_hist, bins = np.histogram(d["phif"], bins=num_bins,
                                 weights=pps * (pid == 1))
    ax_hist, _ = np.histogram(d["phif"], bins=bins, weights=pps * (pid == 0))

    stop = {}
    n_mc = 0.0
    branch_bins = branch_ph = branch_ax = tree_branch = None
    n_events = int(d["event_num"][-1]) if d["event_num"].size else 0
    if "c" in d and d["c"].size:
        # sub-branch count figures (flux.py:54-82): c = |column 20|, the
        # per-tree considered-node count replicated on every final row
        c = np.abs(d["c"].astype(int))
        branch_bins = np.arange(0, max(int(c.max()), 2))
        branch_ph, _ = np.histogram(c, bins=branch_bins,
                                    weights=pps * (pid == 1))
        branch_ax, _ = np.histogram(c, bins=branch_bins,
                                    weights=pps * (pid == 0))
        # per-tree counts: the reference takes the first AND last row of
        # each event (flux.py:70-73), double-counting every tree (c is
        # constant within an event); one row per unique event is exact —
        # same correction as the stop-reason /2 below
        ev = d["event_num"].astype(int)
        first_idx = np.unique(ev, return_index=True)[1]
        tree_branch, _ = np.histogram(c[first_idx], bins=branch_bins)
    if "info" in d:
        # one info code per distinct event (the reference's first+last-row/2
        # trick, flux.py:89-98, double-counts nothing only when every event
        # has >= 1 final row; taking the first row per unique event id is
        # exact regardless)
        ev = d["event_num"].astype(int)
        first_idx = np.unique(ev, return_index=True)[1]
        info = d["info"][first_idx].astype(int)
        for code, name in [(1, "full_tree"), (2, "prob_cutoff"),
                           (3, "num_cutoff"), (4, "max_nodes")]:
            stop[name] = float(np.sum(np.abs(info) == code))
        n_mc = float(np.sum(info < 0))

    return FluxResult(
        phi_bins=bins,
        photon_hist=ph_hist,
        axion_hist=ax_hist,
        n_events=n_events,
        stop_reasons=stop,
        n_mc_used=n_mc,
        total_photon_rate=float(np.sum(pps * (pid == 1))),
        total_axion_rate=float(np.sum(pps * (pid == 0))),
        branch_bins=branch_bins,
        branch_photon_hist=branch_ph,
        branch_axion_hist=branch_ax,
        tree_branch_hist=tree_branch,
    )


def plot(path: str, num_bins: int = 50, show: bool = True, save: str = None,
         mc_threshold: int = 10):
    """The flux.py figures: phi flux per species, plus (saveMode >= 1) the
    two sub-branch-count figures (flux.py:54-82) with the Monte-Carlo
    threshold marker (the reference hardcodes 10 = its production MCNodes;
    pass the run's MCNodes).  `save` writes `<save>` and, when the branch
    figures exist, `<save base>_branches.<ext>` / `_trees.<ext>`."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    r = analyze(path, num_bins)
    plt.figure()
    plt.step(r.phi_bins[:-1], r.photon_hist, label="photon")
    plt.step(r.phi_bins[:-1], r.axion_hist, label="axion")
    plt.xlabel(r"$\phi$")
    plt.ylabel("Particles per second")
    plt.yscale("log")
    plt.legend()
    if save:
        plt.savefig(save, dpi=150, bbox_inches="tight")

    if r.branch_bins is not None:
        import os

        stem, ext = (os.path.splitext(save) if save else ("", ""))
        # pps-weighted considered-sub-branch histogram (flux.py:54-67)
        plt.figure()
        plt.plot(r.branch_bins[1:], r.branch_photon_hist, "^", label="photon")
        plt.plot(r.branch_bins[1:], r.branch_axion_hist, "o", label="axion")
        plt.xlabel("Number of considered sub-branches")
        plt.ylabel("Particles per second")
        plt.yscale("log")
        plt.axvline(mc_threshold, color="k", linestyle="--",
                    label="Monte Carlo threshold")
        plt.legend()
        if save:
            plt.savefig(f"{stem}_branches{ext}", dpi=150, bbox_inches="tight")
        # per-tree counts (flux.py:69-82)
        plt.figure()
        plt.plot(r.branch_bins[1:], r.tree_branch_hist, "o")
        plt.xlabel("Number of considered sub-branches")
        plt.ylabel("Number of trees")
        plt.yscale("log")
        plt.axvline(mc_threshold, color="k", linestyle="--",
                    label="Monte Carlo threshold")
        plt.legend()
        if save:
            plt.savefig(f"{stem}_trees{ext}", dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return r
