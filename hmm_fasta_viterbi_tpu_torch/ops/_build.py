"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain C
interface, which the kernel wrappers load with ``ctypes``. No PyTorch
headers are included, so a build takes seconds rather than the minutes of
``torch.utils.cpp_extension.load``. The library goes into
``hmm_fasta_viterbi_tpu_torch/_kernels/<key>/``, where ``key`` hashes the
sources and the command, so an edit to a source rebuilds and an unchanged
tree reuses the earlier build. Nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_kernels"
LIB_NAME = "libhmm_torch_kernels.so"

# Hopper only: the "a" target also admits wgmma/setmaxnreg for later kernels.
# No --use_fast_math: the MSV kernel must equal the float32 oracle bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the first ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_command(nvcc: str, out: pathlib.Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, sources())]


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels unless a build of the same sources exists.

    Returns the library's path and the compiler's output ("" when an
    earlier build was reused)."""
    nvcc = find_nvcc()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile beside the target and rename: a concurrent build or a killed
    # one never leaves a half-written library under the final name
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        nvcc_command(nvcc, tmp), capture_output=True, text=True, timeout=900
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    log = (
        f"built {lib_path} in {time.perf_counter() - t0:.1f} s\n"
        f"{proc.stdout}{proc.stderr}"
    )
    return lib_path, log

