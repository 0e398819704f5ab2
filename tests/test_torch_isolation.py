"""The PyTorch port stands alone: it loads no JAX, it never falls back
from the kernel to its plain version, and it builds for Hopper without
fast math."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hmm_fasta_viterbi_tpu_torch import MSVScanner
from hmm_fasta_viterbi_tpu_torch.ops import _build, msv_cuda

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX = """
import sys
import chip_smoke
import hmm_fasta_viterbi_tpu_torch
import hmm_fasta_viterbi_tpu_torch.__main__
import hmm_fasta_viterbi_tpu_torch.convert
import hmm_fasta_viterbi_tpu_torch.ops._build
from hmm_fasta_viterbi_tpu_torch import cli
assert cli.main(["scan", "--device", "cpu", "--hmm", sys.argv[1],
                 "--fasta", sys.argv[2], "--out", sys.argv[3]]) == 0
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
"""


def test_port_and_chip_smoke_import_no_jax(profile_dir, fasta_dir, tmp_path):
    """In a fresh interpreter: import the port, its CLI and chip_smoke.py,
    run a CPU scan, and find no jax module loaded."""
    proc = subprocess.run(
        [
            sys.executable, "-c", _NO_JAX, str(profile_dir / "100.hmm"),
            str(fasta_dir / "fasta_like_example.fsa"), str(tmp_path / "out.tsv"),
        ],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "out.tsv").read_text().startswith("# target")


def test_cuda_scanner_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        MSVScanner(device="cuda")


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """msv_scan sends every tensor that is not on the CPU to the kernel
    wrapper, which raises for a device it cannot launch on: no fallback."""

    def plain(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(msv_cuda, "msv_scan_plain", plain)
    b, l, m = 4, 8, 16
    args = [
        torch.empty((20, m), device="meta"),
        torch.empty((b, l), dtype=torch.int8, device="meta"),
        torch.empty((b,), dtype=torch.int32, device="meta"),
        torch.empty((2, b), device="meta"),
        torch.empty((3,), device="meta"),
        torch.empty((b, m), device="meta"),
        torch.empty((4, b), device="meta"),
    ]
    before = msv_cuda.msv_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_scan(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msv_cuda.msv_scan_cuda(*[torch.zeros(a.shape, dtype=a.dtype) for a in args])
    assert msv_cuda.msv_scan_cuda.launches == before


def test_nvcc_command_targets_hopper_without_fast_math():
    cmd = _build.nvcc_command("nvcc", pathlib.Path("lib.so"))
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "fast_math" not in joined and "fast-math" not in joined
    assert "-shared" in cmd and "-O3" in cmd
    assert str(_build.CSRC_DIR / "msv_kernel.cu") in cmd


def test_kernel_supports_every_profile(all_profile_paths):
    """Every profile of data/profile_HMMs fits the kernel's register row
    (LENG 100-2405); the lane counts match the C++ switch."""
    from hmm_fasta_viterbi_tpu import parse_hmm

    source = (_build.CSRC_DIR / "msv_kernel.cu").read_text()
    for per in msv_cuda.KERNEL_PER:
        assert per % 8 == 4 and f"MSV_CASE({per})" in source
    lengs = [parse_hmm(p).model_length - 1 for p in all_profile_paths]
    assert len(lengs) == 24 and max(lengs) == 2405
    assert all(32 * msv_cuda.kernel_per(n) >= n for n in lengs)
    assert np.all(np.diff(msv_cuda.KERNEL_PER) == 8)
