"""Build, load and count the hand-written CUDA kernels (csrc/).

The kernels are compiled at first use with nvcc into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds), keyed
by a hash of the sources, under <checkout>/build/torch_kernels/, and bound
with ctypes.  Every source compiles in its own nvcc process, all started
together, and one more links them.  Every C entry point launches on the stream it is given and
returns cudaGetLastError(); `check` raises on a non-zero code.

A variant library holds K2's branches that the default library leaves out
(`Variant`: the canonical condition, the native gate trig, the vjp RHS,
a MEGA_PROFILE step profile, the resumable instantiation): the same
sources, compiled with -D macros (csrc/physics.cuh, csrc/megakernel.cu)
for one dispersion variant and one combination, at the first launch that
needs it, into <source hash>-<combination>/ beside the default library;
K3's and K4's sources join it where it changes their step (condition, gate
or RHS on the Melrose scene).  The default library is built without the
macros, so its code is the code without the branches.  A failed build
raises; nothing falls back to another library.

LAUNCHES counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else.  A launch from a variant library
counts under the wrapper's key with "@" and the variant's tag
(`launch_key`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("line_scan.cu", "megakernel.cu", "treekernel.cu", "treerefill.cu", "refill_probe.cu")
HEADERS = ("physics.cuh", "mega_device.cuh", "tree_warp.cuh", "tree_device.cuh")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"line_scan": 0, "line_roots": 0, "megakernel": 0, "megakernel_chain": 0,
            "megakernel_resume": 0, "treekernel": 0, "treerefill": 0, "probe": 0,
            "refill_probe": 0}

_lib = None
_variant_libs = {}
BUILD_LOG = ""
VARIANT_BUILD_LOGS = {}   # Variant -> its nvcc output (ptxas figures)

PROFILES = ("full", "scan", "coarse", "rhs")   # ART_PROFILE 0..3


class Variant(NamedTuple):
    """A combination of K2's branches: the dispersion variant (art::Disp),
    the condition ("fast" / "canonical"), the gate trig ("precise" /
    "native"), the RHS ("hand" / "vjp"), the step profile (PROFILES) and
    the resumable instantiation."""
    disp: int
    cond: str = "fast"
    gate: str = "precise"
    rhs: str = "hand"
    profile: str = "full"
    resume: bool = False

    def is_default(self) -> bool:
        return self[1:] == Variant(0)[1:]

    def tag(self) -> str:
        """The non-default branches, e.g. "canonical", "vjp+resume"."""
        parts = [v for v, d in zip(self[1:5], Variant(0)[1:5]) if v != d]
        return "+".join(parts + ["resume"] * bool(self.resume))

    def trees(self) -> bool:
        """K3 and K4 share the step: their sources join the library."""
        return (self.disp == 0 and self.profile == "full" and not self.resume
                and (self.cond, self.gate, self.rhs) != ("fast", "precise", "hand"))

    def sources(self):
        return ("megakernel.cu",) + (("treekernel.cu", "treerefill.cu") if self.trees() else ())

    def flags(self):
        return [f"-DART_DISP={self.disp}",
                f"-DART_COND_CANONICAL={int(self.cond == 'canonical')}",
                f"-DART_GATE_NATIVE={int(self.gate == 'native')}",
                f"-DART_RHS_VJP={int(self.rhs == 'vjp')}",
                f"-DART_PROFILE={PROFILES.index(self.profile)}",
                f"-DART_RESUME={int(bool(self.resume))}"]

    def dirname(self) -> str:
        return f"{source_hash()}-d{self.disp}-{self.tag()}"


def launch_key(name: str, variant=None) -> str:
    """LAUNCHES key of a launch of wrapper `name` from `variant`'s library."""
    if variant is None or variant.is_default():
        return name
    return f"{name}@{variant.tag()}"


def count_launch(name: str, variant=None):
    key = launch_key(name, variant)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _start(out_dir, sources, flags):
    """Start one nvcc process per source into a work directory under
    out_dir; returns (work, objs, procs)."""
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    nvcc = _nvcc()
    objs = [os.path.join(work, s + ".o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-I", CSRC, "-c", "-o", o,
                               os.path.join(CSRC, s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    return work, objs, procs


def _finish(out_dir, lib_path, sources, work, objs, procs) -> str:
    """Wait for _start's processes, link, move the library into place;
    returns the build log.  Raises on a failed compile or link."""
    try:
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {s}\n{lg}" for s, lg in zip(sources, logs))
        failed = [s for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed} ({out_dir}):\n{log}")
        tmp = os.path.join(work, "libart_kernels.so")
        proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)   # atomic: concurrent builders agree
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    return log


def _lib_path(variant):
    name = source_hash() if variant is None else variant.dirname()
    out_dir = os.path.join(BUILD_ROOT, name)
    return out_dir, os.path.join(out_dir, "libart_kernels.so")


def build(variant: Variant = None) -> str:
    """Compile csrc/ (or a variant library) into its hashed path, if
    absent; returns the library's path."""
    return build_many([variant])[0]


def build_many(variants) -> list:
    """Build every library of `variants` (None: the default one) that is not
    built yet, every nvcc process of all of them started together; returns
    their paths in order."""
    global BUILD_LOG
    variants = [None if v is None or v.is_default() else v for v in variants]
    paths, jobs = [], []
    for v in variants:
        out_dir, lib_path = _lib_path(v)
        paths.append(lib_path)
        if os.path.exists(lib_path) or any(j[0] == lib_path for j in jobs):
            continue
        sources = SOURCES if v is None else v.sources()
        flags = [] if v is None else v.flags()
        jobs.append((lib_path, v, out_dir, sources) + _start(out_dir, sources, flags))
    errors = []
    for lib_path, v, out_dir, sources, work, objs, procs in jobs:
        try:
            log = _finish(out_dir, lib_path, sources, work, objs, procs)
        except RuntimeError as e:
            errors.append(str(e))
            continue
        if v is None:
            BUILD_LOG = log
        else:
            VARIANT_BUILD_LOGS[v] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def lib(variant: Variant = None) -> ctypes.CDLL:
    """The loaded kernel library (built on first call); a non-default
    `variant`: its variant library."""
    global _lib
    if variant is not None and not variant.is_default():
        if variant not in _variant_libs:
            from adiabatic_raytracer_tpu_torch.ops import megakernel, treekernel

            handle = ctypes.CDLL(build(variant))
            megakernel.bind(handle)
            if variant.trees():
                treekernel.bind(handle)
            _variant_libs[variant] = handle
        return _variant_libs[variant]
    if _lib is None:
        from adiabatic_raytracer_tpu_torch.ops import (line_scan, megakernel, refill_probe,
                                                       treekernel)

        handle = ctypes.CDLL(build())
        for mod in (line_scan, megakernel, treekernel, refill_probe):
            mod.bind(handle)
        _lib = handle
    return _lib


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None):
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
