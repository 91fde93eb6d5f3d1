"""Loaders for the clear-text outputs: tree, event and final files.

Port of adiabatic_raytracer_tpu/analysis/treeio.py (numpy only).

`load_tree` parses the *current* saveNode format (MainRunner.jl:17-65),
including the tc and times lines that the reference's own plot/plotTree*.py
parsers predate (they read only 3 crossing lines and 3 trajectory lines and
mis-parse current files — documented stale-consumer divergence).

`load_event_info` / `load_final_info` mirror
jonas_test_analyses/analysis.py:8-33.
"""

from __future__ import annotations

import numpy as np


def load_tree(path: str) -> list:
    """Parse a saveMode-3 tree file into a list of node dicts."""
    nodes = []
    with open(path) as f:
        line = f.readline()
        while line.strip():
            species, w, prob, pw = line.split()
            node = {
                "species": species,
                "weight": float(w),
                "prob": float(prob),
                "parent_weight": float(pw),
            }
            lc = f.readline()
            # raw first char: crossing lines are indented, the no-crossing
            # marker is a bare "-" (cf. plotTree.py:53 `lc[0] == "-"`)
            if lc.startswith("-"):
                node["crossings_x"] = []
                node["crossings_y"] = []
                node["crossings_z"] = []
                node["crossings_t"] = []
                f.readline()
                f.readline()  # the remaining two '-' lines
            else:
                node["crossings_x"] = [float(v) for v in lc.split()]
                node["crossings_y"] = [float(v) for v in f.readline().split()]
                node["crossings_z"] = [float(v) for v in f.readline().split()]
                node["crossings_t"] = [float(v) for v in f.readline().split()]
            node["x"] = np.array([float(v) for v in f.readline().split()])
            node["y"] = np.array([float(v) for v in f.readline().split()])
            node["z"] = np.array([float(v) for v in f.readline().split()])
            node["times"] = np.array([float(v) for v in f.readline().split()])
            node["r"] = np.sqrt(node["x"] ** 2 + node["y"] ** 2 + node["z"] ** 2)
            nodes.append(node)
            line = f.readline()
    return nodes


def tree_weight_sum(nodes: list) -> float:
    """Total outgoing weight of a tree: sum over nodes without crossings
    (the self-validation invariant — converges to 1 - prob_cutoff;
    plotTree.py:162-178)."""
    return sum(n["weight"] for n in nodes[1:] if not n["crossings_x"])


def load_event_info(path: str):
    """analysis.py:8-19 contract."""
    data = np.loadtxt(path)
    data = np.atleast_2d(data)
    return (data[:, 0], data[:, 1:4], data[:, 4], data[:, 5:8], data[:, 8:11],
            data[:, 11:14], data[:, 14:17], data[:, -2], data[:, -1])


def load_final_info(path: str):
    """analysis.py:21-33 contract."""
    data = np.loadtxt(path)
    data = np.atleast_2d(data)
    return (data[:, 0].astype(int), data[:, 1], data[:, 2], data[:, 3],
            data[:, 4], data[:, 5], data[:, 6], data[:, 7], data[:, 8],
            data[:, 9])


def convergence_summary(event_path: str, final_path: str) -> dict:
    """The convergence check of analysis.py:147: total outgoing weight per
    event should approach 1."""
    num0, _, _, _, _, _, _, time, nodes = load_event_info(event_path)
    num, weight, *_ = load_final_info(final_path)
    return {
        "n_events": int(num0[-1]),
        "weight_sum_per_event": float(np.sum(weight) / num0[-1]),
        "mean_nodes": float(np.mean(nodes)),
        "mean_time": float(np.mean(time)),
    }
