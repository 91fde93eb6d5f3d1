"""npy output files: parameter-encoded filenames and shard combining.

Replicates the reference's output contract:
  * filename encoding          MainRunner.jl:750-761
  * shard combine + cleanup    Gen_Samples.jl:195-239 (the Julia semantics:
    divide column 8 (1-based) = sln_prob by the number of runs.  The Python
    twin Combine_Files.py divides a different row — documented divergence;
    we follow the Julia version.)
"""

from __future__ import annotations

import os

import numpy as np

from adiabatic_raytracer_tpu_torch.utils.format import julia_str


def tree_filename(dir_tag: str, mass_a, ax_g, theta_m, omega_pul, b0, n_trajs: int,
                  ntimes: int, num_cutoff: int, mc_nodes: int, max_nodes: int,
                  file_tag: str, *, subdir: str = "npy") -> str:
    parts = [
        "tree_",
        "MassAx_", julia_str(float(mass_a)), "_AxionG_", julia_str(float(ax_g)),
        "_ThetaM_", julia_str(float(theta_m)), "_rotPulsar_", julia_str(float(omega_pul)),
        "_B0_", julia_str(float(b0)),
        "_Ax_trajs_", str(int(n_trajs)),
        "_N_Times_", str(int(ntimes)),
        "_num_cutoff_", str(int(num_cutoff)),
        "_MC_nodes_", str(int(mc_nodes)),
        "_max_nodes_", str(int(max_nodes)),
        "_", file_tag, ".npy",
    ]
    name = "".join(parts)
    return os.path.join(dir_tag, subdir, name) if subdir else os.path.join(dir_tag, name)


def save_npy(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        np.lib.format.write_array(f, np.asarray(arr, np.float64), allow_pickle=False)


def combine_files(dir_tag: str, mass_a, ax_g, theta_m, omega_pul, b0, n_trajs: int,
                  ntimes: int, num_cutoff: int, mc_nodes: int, max_nodes: int,
                  file_tag: str, n_runs: int, *,
                  renumber_events: bool = False,
                  allow_missing: bool = False) -> str:
    """Concatenate `n_runs` shard files tagged `<file_tag>0..N-1`, divide the
    sln_prob column by n_runs, write the merged file (no npy/ subdir, matching
    Gen_Samples.jl:223-233) and delete the shards.

    The reference ships a second combiner, Combine_Files.py, with two
    divergent behaviors this function covers as opt-ins (the Julia
    semantics stay the default — SURVEY.md §3.4):

    * ``renumber_events``: offset each appended shard's event column (col 0)
      by the LAST event number of the data accumulated so far, so event ids
      stay unique across shards (Combine_Files.py:22, ``tmp[0,:] +=
      data[0,-1]`` on the transposed layout; the offset compounds shard by
      shard exactly as in the reference).
    * ``allow_missing``: skip shards whose file does not exist — the Python
      combiner globs whatever survived (Combine_Files.py:10-25), giving
      shard-level fault tolerance, where the Julia combiner requires all N
      (Gen_Samples.jl:199-219).  The sln_prob division uses the number of
      shards actually merged, matching ``nfiles`` in the reference.

    (Combine_Files.py also divides a DIFFERENT column — 0-based row 9 — than
    the Julia combiner; that is a transcription inconsistency in the
    reference, documented in the module docstring, and is NOT reproduced.)
    """
    shards = [
        tree_filename(dir_tag, mass_a, ax_g, theta_m, omega_pul, b0, n_trajs,
                      ntimes, num_cutoff, mc_nodes, max_nodes, f"{file_tag}{i}")
        for i in range(n_runs)
    ]
    if allow_missing:
        shards = [p for p in shards if os.path.exists(p)]
        if not shards:
            raise FileNotFoundError(
                f"combine_files: no shard files found for tag {file_tag!r}")
    parts = [np.load(p) for p in shards]
    if renumber_events:
        # offset each shard by the last event id of the data accumulated so
        # far (not of the previous shard — empty shards pass the id through);
        # the offset compounds shard by shard (Combine_Files.py:22)
        last = parts[0][-1, 0] if parts[0].shape[0] else 0.0
        for i in range(1, len(parts)):
            parts[i] = parts[i] + np.concatenate(
                [[last], np.zeros(parts[i].shape[1] - 1)])
            if parts[i].shape[0]:
                last = parts[i][-1, 0]
    hold = np.concatenate(parts, axis=0)
    hold[:, 7] /= len(shards)  # Julia column 8 (1-based) = sln_prob
    out = tree_filename(dir_tag, mass_a, ax_g, theta_m, omega_pul, b0,
                        n_trajs * n_runs, ntimes, num_cutoff, mc_nodes, max_nodes,
                        file_tag, subdir="")
    save_npy(out, hold)
    for p in shards:
        os.remove(p)
    return out
