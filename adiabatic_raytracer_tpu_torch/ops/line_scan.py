"""K1: the sampler's dense line scan (csrc/line_scan.cu).

Evaluates the thick-surface level-crossing condition at [B, N] points along
B straight sampling lines, in f32 like the TPU kernel it replaces
(adiabatic_raytracer_tpu/ops/pallas_kernels.py:line_scan_pallas).  Unlike
that kernel, whose condition has no boundary-layer term, it adds the
boundary layer to omega_p as its plain version does (the sampler's
_line_condition, the Julia reference's condition).
`line_scan` launches the CUDA kernel for CUDA tensors and runs
`line_scan_plain` (the sampler's torch _line_condition on the grid) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW
from adiabatic_raytracer_tpu_torch.models.magnetosphere import bndry_lyr_scalars
from adiabatic_raytracer_tpu_torch.ops import cuda_lib


class LineScene(ctypes.Structure):
    """Scene scalars passed by value at launch (csrc/physics.cuh, same order)."""

    _fields_ = [("cm", ctypes.c_float), ("sm", ctypes.c_float),
                ("omega", ctypes.c_float), ("b0", ctypes.c_float),
                ("r_ns", ctypes.c_float), ("r_metric", ctypes.c_float),
                ("rs0", ctypes.c_float),
                ("mass_a", ctypes.c_float), ("isotropic", ctypes.c_int),
                ("bndry_lyr", ctypes.c_float), ("bndry_pole", ctypes.c_float),
                ("bndry_center", ctypes.c_float), ("bndry_inv_decay", ctypes.c_float)]


def line_scene(sc: Scene, mass_ns) -> LineScene:
    # the metric's interior branch sits at 10 km, as in the plain version
    # (sampler._line_condition -> metric_inverse's default).  The boundary
    # layer's scalars (bndry_lyr <= 0: none) are rounded to f32 as the plain
    # version rounds them: the pole value, rmax * bndry_lyr, and the f32
    # reciprocal of the decay length 0.1 rmax it divides by
    pole_val, rmax = bndry_lyr_scalars(float(sc.mass_a), float(sc.omega_pul),
                                       float(sc.b0), float(sc.r_ns))
    inv_decay = np.float32(1.0) / np.float32(0.1 * rmax)
    return LineScene(math.cos(float(sc.theta_m)), math.sin(float(sc.theta_m)),
                     float(sc.omega_pul), float(sc.b0), float(sc.r_ns), 10.0,
                     2.0 * G_NEW * float(mass_ns) / C_KM**2, float(sc.mass_a),
                     int(bool(sc.isotropic)), float(sc.bndry_lyr), pole_val,
                     rmax * float(sc.bndry_lyr), float(inv_decay))


def bind(lib):
    lib.art_line_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, LineScene,
                                  ctypes.c_void_p]
    lib.art_line_scan.restype = ctypes.c_int


def pack_params(x0, vvec, vloc, erg) -> torch.Tensor:
    """[B, 10] f32 per-line parameters: x0(3), vvec(3), vloc(3), erg."""
    return torch.cat([x0, vvec, vloc, erg[:, None]], dim=1).to(torch.float32).contiguous()


def line_scan_plain(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns) -> torch.Tensor:
    """K1's plain version: sampler._line_condition on the [B, N] grid, f32."""
    from adiabatic_raytracer_tpu_torch.ops.sampler import _line_condition

    f32 = torch.float32
    par = pack_params(x0, vvec, vloc, erg)
    s = s_grid.to(f32)
    p = par[:, None, 0:3] + s[None, :, None] * par[:, None, 3:6]
    return _line_condition(p, par[:, None, 6:9], par[:, None, 9], sc, mass_ns, True)


def line_scan(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns) -> torch.Tensor:
    """Condition g [B, N] (f32) on the grid x0 + s * vvec, s in s_grid."""
    if x0.device.type == "cpu":
        return line_scan_plain(x0, vvec, vloc, erg, s_grid, sc, mass_ns)
    lib = cuda_lib.lib()
    par = pack_params(x0, vvec, vloc, erg)
    s = s_grid.to(torch.float32).contiguous()
    B, N = par.shape[0], s.shape[0]
    cuda_lib.require(par, "params", torch.float32, (B, 10))
    cuda_lib.require(s, "s_grid", torch.float32, (N,))
    out = torch.empty((B, N), dtype=torch.float32, device=par.device)
    code = lib.art_line_scan(par.data_ptr(), s.data_ptr(), out.data_ptr(), B, N,
                             line_scene(sc, mass_ns), cuda_lib.stream_ptr(par))
    cuda_lib.check(code, "line_scan launch")
    cuda_lib.LAUNCHES["line_scan"] += 1
    return out
