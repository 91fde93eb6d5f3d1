"""Adiabatic RayTracer, PyTorch + CUDA port of the JAX/Pallas package
``adiabatic_raytracer_tpu`` (which stays in the repository as the reference).

Same module layout as the reference, so each counterpart is found by name:

* configs, constants                                  (config.py, constants.py)
* threefry2x32 stream bit-identical to jax.random    (utils/rng.py)
* Schwarzschild metric, Goldreich-Julian fields       (models/)
* geometry, dispersion, conversion physics            (ops/geometry.py, ...)
* conversion-surface sampler + K1 line-scan kernel    (ops/sampler.py, ops/line_scan.py)
* pool DP5 integrator (CPU engine, K2's plain version) (ops/integrator.py, ops/propagate.py)
* the pool in chunks with straggler compaction        (ops/streaming.py)
* K2 DP5 megakernel, one CUDA warp per ray            (ops/megakernel.py, csrc/)
* backtrace + host work-queue forward tree            (ops/tree.py)
* K3/K4 in-kernel forward trees, one CUDA warp a tree (ops/treekernel.py, csrc/)
* geometry diagnostics, radiative extras              (ops/geometry.py, ops/radiative.py)
* event-axis mesh, process groups, histograms         (parallel/)
* driver / CLI / npy and text output                  (driver.py, cli.py, utils/)
* flux analysis, tree reader and plots                (analysis/)

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"

from adiabatic_raytracer_tpu_torch.config import NumericsConfig, Scene, TreeConfig  # noqa: F401
