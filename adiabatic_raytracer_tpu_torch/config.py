"""Scene / numerics / tree configuration as frozen dataclasses.

Field for field the same names and defaults as the JAX package's pytree
dataclasses (adiabatic_raytracer_tpu/config.py:41-393), whose comments carry
the measured rationale for each default.  Here they are plain frozen
dataclasses: nothing is traced, so there is no static/leaf split.

`from_jax_dict` carries a JAX run's configuration across as plain values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Scene:
    """Neutron star + axion parameters (Gen_Samples.jl:137-174)."""

    mass_a: Any = 1e-5        # axion mass [eV]              (--MassA)
    ax_g: Any = 1e-12         # axion-photon coupling [1/GeV] (--Axg)
    theta_m: Any = 0.0        # misalignment angle [rad]      (--ThetaM)
    omega_pul: Any = 1.0      # NS rotation frequency [1/s]   (--rotW)
    b0: Any = 1e14            # surface B field [Gauss]       (--B0)
    r_ns: Any = 10.0          # NS radius [km]                (--rNS)
    mass_ns: Any = 1.0        # NS mass [Msun]                (--Mass_NS)
    bndry_lyr: Any = -1.0     # boundary-layer index; <=0 disables (--bndry_lyr)
    rho_dm: Any = 0.45        # local DM density [GeV/cm^3]
    v_ns: Any = (0.0, 0.0, 0.0)  # NS velocity [c]            (--vNS_*)
    vmean_ax: Any = 220.0     # asymptotic axion speed scale [km/s]
    flat: bool = False        # flat space vs Schwarzschild
    isotropic: bool = False   # isotropic plasma dispersion
    melrose: bool = True      # Melrose anisotropic form (production mode)

    @property
    def mass_ns_eff(self):
        """NS mass with the `flat` switch applied (RayTracer.jl:187-189)."""
        return 0.0 if self.flat else self.mass_ns


@dataclass(frozen=True)
class NumericsConfig:
    """Integrator / event-detection numerics (RayTracer.jl:383-384)."""

    rtol: Any = 1e-7
    atol: Any = 1e-6
    ln_t_start: Any = -30.0
    dt_min: Any = 1e-13
    safety: Any = 0.9
    max_dt_factor: Any = 5.0
    min_dt_factor: Any = 0.2
    pi_beta: Any = 0.0
    max_steps: int = 100_000
    n_save: int = 3
    interp_points: int = 50
    interp_coarse: int = 4
    scan_gate_theta: Any = 0.08
    scan_gate_check: int = 256
    bisect_iters: int = 60
    max_roots_per_step: int = 3
    max_crossings: int = 16
    stall_window: int = 1024
    stall_min_progress: Any = 1e-8
    rhs_mode: str = "hand"
    cond_mode: str = "fast"
    gate_trig: str = "precise"
    engine: str = "pool"
    tree_queue_width: int = 0
    tree_k: int = 0
    tree_window: int = 0
    finals_cap_per_event: int = 8
    tree_prob_width: int = 0
    in_kernel_prob: int = 1
    backtrace_chunk: int = 0
    mc_chain: int = 0
    mc_chain_slots: int = 8
    mc_chain_gate: int = 4
    tree_engine: str = "queue"
    tree_kernel_finals: int = 64
    tree_kernel_chunk: int = 0
    # K4 (ops/treekernel.run_tree_kernel), read only where the kernel tree
    # engine runs, and then before tree_kernel_chunk: 0 off, 1 partitions of
    # 1024 events, else max(tree_refill, 128) events per partition, served by
    # warps pulling events from the partition's queue, one tree per warp.
    # tree_refill_k: a warp whose tree ended takes its next event at the next
    # multiple of this many iterations (results do not depend on it).
    tree_refill: int = 0
    tree_refill_k: int = 8
    # "state" or "f32": the physics-evaluation dtype, as in the reference.
    # "f32" evaluates the sampler, the event kinematics, the conversion
    # probabilities and the pool's RHS (forward-mode derivatives) and
    # crossing condition in f32, the state staying in its dtype, and ships
    # the pipeline's packs in f32.  K2-K4 compute in f64 inside either way.
    compute_dtype: str = "state"


@dataclass(frozen=True)
class TreeConfig:
    """Monte-Carlo tree engine parameters (Gen_Samples.jl:94-120)."""

    prob_cutoff: Any = 1e-10
    num_cutoff: int = 5
    mc_nodes: int = 5
    max_nodes: int = 50
    n_max_sample: int = 6
    flat_sampling: bool = True
    ntimes_ax: int = 50000


def _plain(v):
    """numpy scalar / 0-d array / sequence -> python value."""
    if hasattr(v, "tolist"):
        v = v.tolist()
    if isinstance(v, list):
        v = tuple(v)
    return v


def from_jax_dict(d: dict):
    """Build the port's configs from a JAX run's configuration.

    `d` maps "scene", "numerics" and "tree" to dicts of the JAX dataclasses'
    fields as plain python or numpy values (e.g. ``dataclasses.asdict`` of
    each, passed through ``np.asarray``).  Unknown field names raise, so a
    field added to the reference without a counterpart here is caught.
    Returns (Scene, NumericsConfig, TreeConfig)."""
    out = []
    for name, cls in (("scene", Scene), ("numerics", NumericsConfig),
                      ("tree", TreeConfig)):
        fields = {f.name for f in dataclasses.fields(cls)}
        given = dict(d.get(name, {}))
        unknown = set(given) - fields
        if unknown:
            raise ValueError(f"{name}: fields without a port counterpart: "
                             f"{sorted(unknown)}")
        out.append(cls(**{k: _plain(v) for k, v in given.items()}))
    return tuple(out)
