"""Build, load and count the hand-written CUDA kernels (csrc/).

The kernels are compiled at first use with nvcc into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds), keyed
by a hash of the sources, under <checkout>/build/torch_kernels/, and bound
with ctypes.  Every source compiles in its own nvcc process, all started
together, and one more links them.  Every C entry point launches on the stream it is given and
returns cudaGetLastError(); `check` raises on a non-zero code.

LAUNCHES counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("line_scan.cu", "megakernel.cu", "treekernel.cu", "treerefill.cu", "refill_probe.cu")
HEADERS = ("physics.cuh", "mega_device.cuh", "tree_warp.cuh", "tree_device.cuh")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"line_scan": 0, "line_roots": 0, "megakernel": 0, "megakernel_chain": 0,
            "treekernel": 0, "treerefill": 0, "probe": 0, "refill_probe": 0}

_lib = None
BUILD_LOG = ""


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


def build() -> str:
    """Compile csrc/ into the hashed library path (if absent); returns it."""
    global BUILD_LOG
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, "libart_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        nvcc = _nvcc()
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o,
                                   os.path.join(CSRC, s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        BUILD_LOG = "".join(f"== {s}\n{lg}" for s, lg in zip(SOURCES, logs))
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp = os.path.join(work, "libart_kernels.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                              text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, lib_path)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
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
