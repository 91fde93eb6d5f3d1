"""chip_smoke.py's helpers that run without a card: ptxas parsing, and the
refusal to run on a machine without one."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LOG = """== megakernel.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112probe_kernelEiPKdS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112probe_kernelEiPKdS1_
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Function properties for _ZN3art7prob_ndERKNS_10MegaParamsEPKdd
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
== refill_probe.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_119refill_probe_kernelEPKfPfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, used 1 barriers
== treerefill.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_118tree_refill_kernelEPdS1_PKdS1_S1_iiii
    520 bytes stack frame, 96 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""


def test_ptxas_summary_matches_whole_kernel_names():
    """P1's refill_probe_kernel is not taken for K2's probe_kernel, nor K4's
    tree_refill_kernel for K3's tree_kernel; device functions are skipped."""
    got = chip_smoke.ptxas_summary(LOG)
    assert set(got) == {"probe_kernel", "refill_probe_kernel", "tree_refill_kernel"}
    assert got["probe_kernel"].endswith("Used 96 registers, used 1 barriers")
    assert got["refill_probe_kernel"].startswith("0 bytes stack frame")
    assert "96 bytes spill stores" in got["tree_refill_kernel"]
    assert chip_smoke.ptxas_figures(got["tree_refill_kernel"]) == (255, 520, 96, 96)
    assert chip_smoke.ptxas_figures("") == (None, None, None, None)
    assert chip_smoke.source_names("line_scan_kernel") == {"line_scan_kernel"}


def test_chip_smoke_refuses_without_a_card():
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
