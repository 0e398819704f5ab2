"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` file is compiled to an object file by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, which the kernel wrappers load with
``ctypes``. No PyTorch headers are included, so a build takes seconds
rather than the minutes of ``torch.utils.cpp_extension.load``. The library
goes into ``hmm_fasta_viterbi_tpu_torch/_kernels/<key>/``, where ``key``
hashes the sources, the ``csrc/*.cuh`` headers they include and the
commands, so an edit to a source or a header rebuilds and
an unchanged tree reuses the earlier build. Nothing is built when a module
is imported.
"""

from __future__ import annotations

import ctypes
import functools
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
BUILD_TIMEOUT_S = 900

# Hopper only: the "a" target also admits wgmma/setmaxnreg for later kernels.
# No --use_fast_math: the MSV and Viterbi kernels must equal their plain
# versions bit for bit, and Forward must not take approximate logarithms.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def headers() -> list[pathlib.Path]:
    """The ``csrc/*.cuh`` files the sources include."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_commands(nvcc: str, out_dir: pathlib.Path, lib: pathlib.Path):
    """``(compile commands, one a source, link command)``."""
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{src.stem}.o"), str(src)]
        for src in sources()
    ]
    link = [nvcc, "-shared", "-o", str(lib),
            *(str(out_dir / f"{src.stem}.o") for src in sources())]
    return compiles, link


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels unless a build of the same sources exists.

    Returns the library's path and the compilers' output ("" when an
    earlier build was reused)."""
    nvcc = find_nvcc()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path, ""
    # objects and the library go to a directory of this process: a
    # concurrent build or a killed one never leaves a half-written library
    # under the final name
    work = out_dir / f"tmp.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    tmp_lib = work / LIB_NAME
    compiles, link = nvcc_commands(nvcc, work, tmp_lib)
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in compiles
    ]
    logs = []
    failed = []
    for cmd, proc in zip(compiles, procs):
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        logs.append(f"$ nvcc {cmd[-1]}  ({time.perf_counter() - t0:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(cmd[-1])
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        logs.append(f"$ nvcc -shared\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + "\n".join(logs))
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    log = f"built {lib_path} in {time.perf_counter() - t0:.1f} s\n" + "\n".join(logs)
    return lib_path, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library of this tree, built first if need be; one handle a
    process, shared by every wrapper."""
    return ctypes.CDLL(str(build()[0]))
