"""K1: the sampler's line scan (csrc/line_scan.cu), two kernels.

Both evaluate the thick-surface level-crossing condition at N points along
B straight sampling lines, in f32 like the TPU kernel they replace
(adiabatic_raytracer_tpu/ops/pallas_kernels.py:line_scan_pallas).  Unlike
that kernel, whose condition has no boundary-layer term, they add the
boundary layer to omega_p as their plain version does (the sampler's
_line_condition, the Julia reference's condition).

* `line_scan` returns the condition grid g [B, N], the TPU function's
  output: the grid kernel `art_line_scan` on a CUDA tensor,
  `line_scan_plain` (the sampler's torch _line_condition on the grid) on a
  CPU tensor.
* `line_roots` returns what the sampler makes of that grid
  (sampler._roots): each line's first 16 sign changes, bisected 50 times in
  the lines' dtype and filtered.  On a CUDA tensor the fused kernel
  `art_line_roots` does all of it in one launch, the grid never leaving the
  chip; on a CPU tensor `line_roots_plain` runs the f32 grid and _roots.
  `line_roots_warp` is a plain model of the fused kernel's algorithm (the
  scan in rounds of 32 points with a carry, the flips ranked in ballot
  order), which the CPU tests hold against _roots; `line_roots_slots`
  launches the fused kernel for the checks, with its slots.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from adiabatic_raytracer_tpu_torch.config import Scene
from adiabatic_raytracer_tpu_torch.constants import C_KM, G_NEW
from adiabatic_raytracer_tpu_torch.models.magnetosphere import bndry_lyr_scalars
from adiabatic_raytracer_tpu_torch.ops import cuda_lib, sampler
from adiabatic_raytracer_tpu_torch.ops.sampler import BISECT_ITERS, MAX_LINE_CROSSINGS

WARP = 32


class LineScene(ctypes.Structure):
    """Scene scalars of the f32 arithmetic, passed by value at launch
    (csrc/physics.cuh LineSceneT<float>, same order)."""

    _fields_ = [("cm", ctypes.c_float), ("sm", ctypes.c_float),
                ("omega", ctypes.c_float), ("b0", ctypes.c_float),
                ("r_ns", ctypes.c_float), ("r_metric", ctypes.c_float),
                ("rs0", ctypes.c_float),
                ("mass_a", ctypes.c_float), ("isotropic", ctypes.c_int),
                ("bndry_lyr", ctypes.c_float), ("bndry_pole", ctypes.c_float),
                ("bndry_center", ctypes.c_float), ("bndry_inv_decay", ctypes.c_float)]


class LineScene64(ctypes.Structure):
    """The same scalars for the f64 bisection (LineSceneT<double>)."""

    _fields_ = [(name, ctypes.c_int if kind is ctypes.c_int else ctypes.c_double)
                for name, kind in LineScene._fields_]


def _scene_values(sc: Scene, mass_ns):
    # the metric's interior branch sits at 10 km, as in the plain version
    # (sampler._line_condition -> metric_inverse's default); the boundary
    # layer (bndry_lyr <= 0: none) as its pole value, rmax * bndry_lyr and
    # the decay length 0.1 rmax
    pole_val, rmax = bndry_lyr_scalars(float(sc.mass_a), float(sc.omega_pul),
                                       float(sc.b0), float(sc.r_ns))
    return (math.cos(float(sc.theta_m)), math.sin(float(sc.theta_m)), float(sc.omega_pul),
            float(sc.b0), float(sc.r_ns), 10.0, 2.0 * G_NEW * float(mass_ns) / C_KM**2,
            float(sc.mass_a), int(bool(sc.isotropic)), float(sc.bndry_lyr), pole_val,
            rmax * float(sc.bndry_lyr), 0.1 * rmax)


def line_scene(sc: Scene, mass_ns) -> LineScene:
    """The f32 scene.  The boundary layer's scalars are rounded to f32 as
    the plain version rounds them, the decay length's reciprocal taken in
    f32 (it divides by that scalar)."""
    *head, decay = _scene_values(sc, mass_ns)
    return LineScene(*head, float(np.float32(1.0) / np.float32(decay)))


def line_scene64(sc: Scene, mass_ns) -> LineScene64:
    *head, decay = _scene_values(sc, mass_ns)
    return LineScene64(*head, 1.0 / decay)


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.art_line_scan.argtypes = [p, p, p, i, i, LineScene, p]
    lib.art_line_scan.restype = ctypes.c_int
    lib.art_line_roots.argtypes = [i, p, p, p, p, i, i, i, LineScene, LineScene64, p, p, p, p,
                                   p]
    lib.art_line_roots.restype = ctypes.c_int


def pack_params(x0, vvec, vloc, erg) -> torch.Tensor:
    """[B, 10] f32 per-line parameters: x0(3), vvec(3), vloc(3), erg."""
    return torch.cat([x0, vvec, vloc, erg[:, None]], dim=1).to(torch.float32).contiguous()


def line_scan_plain(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns) -> torch.Tensor:
    """K1's plain version: sampler._line_condition on the [B, N] grid, f32."""
    f32 = torch.float32
    par = pack_params(x0, vvec, vloc, erg)
    s = s_grid.to(f32)
    p = par[:, None, 0:3] + s[None, :, None] * par[:, None, 3:6]
    return sampler._line_condition(p, par[:, None, 6:9], par[:, None, 9], sc, mass_ns, True)


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


def line_roots_plain(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns):
    """The fused kernel's plain version: the f32 grid (line_scan_plain) in the
    lines' dtype, then sampler._roots, with s_star 0 in the slots past the
    line's flip count as the kernel writes it.  Returns (s_star, ok,
    n_flips)."""
    g = line_scan_plain(x0, vvec, vloc, erg, s_grid, sc, mass_ns).to(x0.dtype)
    s_star, ok, n_flips = sampler._roots(x0, vvec, vloc, erg, g, s_grid, sc, mass_ns)
    has_root = (torch.arange(MAX_LINE_CROSSINGS, device=n_flips.device)[None, :]
                < n_flips[:, None])
    return torch.where(has_root, s_star, torch.zeros_like(s_star)), ok, n_flips


def flip_slots_warp(g):
    """The fused kernel's scan compaction, modelled on g [B, N]: rounds of
    32 points, lane l holding point n = 32 r + l, its left neighbour from
    lane l - 1 or, for lane 0, the previous round's last value (0 before the
    first); a flip is sign(left) * sign(g) < 0 at 1 <= n < N; a flip's rank
    is the line's count so far plus the flips of lower lanes in its round
    (popc of the ballot below it), and ranks < 16 take slot rank with the
    interval n - 1 and the value left.  Returns (slot_idx [B, 16] int64, -1
    past the count; g_lo [B, 16] in g's dtype, 0 past the count; n_flips [B]
    int32)."""
    MAXC = MAX_LINE_CROSSINGS
    B, N = g.shape
    dev = g.device
    lanes = torch.arange(WARP, device=dev)
    carry = torch.zeros(B, dtype=g.dtype, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    slot_idx = torch.full((B, MAXC), -1, dtype=torch.int64, device=dev)
    g_lo = torch.zeros((B, MAXC), dtype=g.dtype, device=dev)
    for base in range(0, N, WARP):
        n = base + lanes
        live = n < N
        gj = torch.zeros((B, WARP), dtype=g.dtype, device=dev)
        gj[:, live] = g[:, n[live]]
        left = torch.cat([carry[:, None], gj[:, :-1]], dim=1)
        carry = gj[:, -1]
        flip = live & (n >= 1) & (torch.sign(left) * torch.sign(gj) < 0)
        rank = count[:, None] + torch.cumsum(flip, dim=1) - flip.to(torch.int64)
        b, lane = (flip & (rank < MAXC)).nonzero(as_tuple=True)
        slot_idx[b, rank[b, lane]] = n[lane] - 1
        g_lo[b, rank[b, lane]] = left[b, lane]
        count += flip.sum(dim=1)
    return slot_idx, g_lo, count.to(torch.int32)


def line_roots_warp(x0, vvec, vloc, erg, g, s_grid, sc: Scene, mass_ns):
    """A plain model of the fused kernel on a given scan g [B, N]: the
    compaction of flip_slots_warp, then lane j < min(count, 16) bisects slot
    j's interval with g_lo rounded to the lines' dtype and filters its root;
    the other slots hold s_star 0 and ok false.  Returns (s_star, ok,
    n_flips, slot_idx)."""
    slot_idx, g_lo, n_flips = flip_slots_warp(g)
    has_root = slot_idx >= 0
    s_star = sampler._bisect(sampler._cond_along(x0, vvec, vloc, erg, sc, mass_ns, True),
                             s_grid, slot_idx.clamp(min=0), g_lo.to(x0.dtype),
                             BISECT_ITERS)
    s_star = torch.where(has_root, s_star, torch.zeros_like(s_star))
    ok = has_root & sampler._accept_at(x0, vvec, erg, s_star, sc, mass_ns)
    return s_star, ok, n_flips, slot_idx


def _launch_roots(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns, bisect_iters: int,
                  slot_idx):
    """Launch the fused kernel on CUDA tensors: (s_star, ok, n_flips), and
    the slots into slot_idx [B, 16] int32 unless it is None."""
    dtype = x0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"line_roots: lines must be f32 or f64, got {dtype}")
    lib = cuda_lib.lib()
    par32 = pack_params(x0, vvec, vloc, erg)
    s32 = s_grid.to(torch.float32).contiguous()
    B, N = par32.shape[0], s32.shape[0]
    if dtype == torch.float32:
        parT, sT = par32, s32
    else:
        parT = torch.cat([x0, vvec, vloc, erg[:, None]], dim=1).contiguous()
        sT = s_grid.contiguous()
    cuda_lib.require(par32, "params", torch.float32, (B, 10))
    cuda_lib.require(s32, "s_grid", torch.float32, (N,))
    cuda_lib.require(parT, "params", dtype, (B, 10))
    cuda_lib.require(sT, "s_grid", dtype, (N,))
    if N < 2:
        raise ValueError(f"line_roots: the grid needs 2 points or more, got {N}")
    dev = par32.device
    s_star = torch.empty((B, MAX_LINE_CROSSINGS), dtype=dtype, device=dev)
    ok = torch.empty((B, MAX_LINE_CROSSINGS), dtype=torch.uint8, device=dev)
    n_flips = torch.empty(B, dtype=torch.int32, device=dev)
    code = lib.art_line_roots(int(dtype == torch.float64), par32.data_ptr(), s32.data_ptr(),
                              parT.data_ptr(), sT.data_ptr(), B, N, int(bisect_iters),
                              line_scene(sc, mass_ns), line_scene64(sc, mass_ns),
                              s_star.data_ptr(), ok.data_ptr(), n_flips.data_ptr(),
                              None if slot_idx is None else slot_idx.data_ptr(),
                              cuda_lib.stream_ptr(par32))
    cuda_lib.check(code, "line_roots launch")
    cuda_lib.LAUNCHES["line_roots"] += 1
    return s_star, ok.view(torch.bool), n_flips


def line_roots(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns):
    """Each line's refined crossings: (s_star [B, 16], ok [B, 16] bool,
    n_flips [B] int32).  The scan runs in f32 on the f32-rounded lines and
    grid; the bisection (BISECT_ITERS steps) and the filter in the dtype of
    x0 (f32 or f64) on x0, vvec, vloc, erg and s_grid as given.  s_star is
    0 in the slots past the line's flip count."""
    if x0.device.type == "cpu":
        return line_roots_plain(x0, vvec, vloc, erg, s_grid, sc, mass_ns)
    return _launch_roots(x0, vvec, vloc, erg, s_grid, sc, mass_ns, BISECT_ITERS, None)


def line_roots_slots(x0, vvec, vloc, erg, s_grid, sc: Scene, mass_ns,
                     bisect_iters: int = BISECT_ITERS):
    """For the checks, CUDA tensors only: the fused kernel's outputs with
    its slots, (s_star, ok, n_flips, slot_idx [B, 16] int32: each slot's
    interval, -1 past the flip count), after `bisect_iters` bisection steps
    (0 times the scan alone)."""
    if x0.device.type != "cuda":
        raise ValueError("line_roots_slots: the kernel's slots need CUDA tensors")
    idx = torch.empty((x0.shape[0], MAX_LINE_CROSSINGS), dtype=torch.int32, device=x0.device)
    return _launch_roots(x0, vvec, vloc, erg, s_grid, sc, mass_ns, bisect_iters, idx) + (idx,)
