"""Spectrum / pulse-profile histograms as scatter-adds.

Port of adiabatic_raytracer_tpu/parallel/reduce.py: fixed-range weighted
histograms (plot/flux.py:38-48 of the reference: values outside [lo, hi]
dropped) that sum across shards and processes (parallel/mesh.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def weighted_histogram(x, w, nbins: int, lo, hi):
    """Fixed-range weighted histogram of x, an index_add_ over nbins bins;
    values outside [lo, hi) are dropped (x == hi falls in no bin, as in the
    JAX function)."""
    idx = torch.floor((x - lo) / (hi - lo) * nbins).to(torch.int64)
    ok = (idx >= 0) & (idx < nbins)
    return torch.zeros(nbins, dtype=w.dtype, device=w.device).index_add_(
        0, torch.clamp(idx, 0, nbins - 1), torch.where(ok, w, torch.zeros_like(w)))


def pulse_profile_from_pools(pools, samp_back_weight, sln_prob, nbins: int = 50):
    """Per-species phi_f flux histograms from tree pools: pps = weight *
    samp_back_weight * sln_prob per final node, binned in the final
    momentum's azimuth over [-pi, pi].  Returns (photon_hist, axion_hist).
    With the per-event sln_base (driver._event_kinematics) the histograms
    are in its units: multiply by driver.sln_scale for the reference's."""
    final = pools.is_final & (pools.status == 2)
    phi = torch.atan2(pools.fmom[..., 1], pools.fmom[..., 0]).reshape(-1)
    pps = pools.weight * samp_back_weight[:, None] * sln_prob[:, None]
    zero = torch.zeros_like(pps)
    w_ph = torch.where(final & pools.is_photon, pps, zero).reshape(-1)
    w_ax = torch.where(final & ~pools.is_photon, pps, zero).reshape(-1)
    return (weighted_histogram(phi, w_ph, nbins, -math.pi, math.pi),
            weighted_histogram(phi, w_ax, nbins, -math.pi, math.pi))


def pulse_profile_from_rows(rows: np.ndarray, nbins: int = 50):
    """The same histograms from output rows (columns of analysis/flux.py):
    pps = weight * sln_prob binned in phif, per particle_id.  f64 on the
    CPU, so the sum over processes of each process's histogram equals the
    histogram of a one-process run's rows added shard by shard."""
    if rows.ndim != 2 or rows.shape[0] == 0:
        z = torch.zeros(nbins, dtype=torch.float64)
        return z, z.clone()
    r = torch.as_tensor(np.ascontiguousarray(rows), dtype=torch.float64)
    pps = r[:, 8] * r[:, 7]
    zero = torch.zeros_like(pps)
    ph = r[:, 1] == 1
    return (weighted_histogram(r[:, 3], torch.where(ph, pps, zero), nbins, -math.pi, math.pi),
            weighted_histogram(r[:, 3], torch.where(r[:, 1] == 0, pps, zero), nbins,
                               -math.pi, math.pi))
