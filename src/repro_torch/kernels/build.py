"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

One source file under ``csrc/`` becomes one shared library with a plain
C interface, compiled for Hopper (``sm_90a``) at first use into
``_build/`` beside this module (listed in ``.gitignore``) and named by
the hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded again.  Without PyTorch's headers a build takes
seconds.  A failed build or load raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # round every float operation on its own, like the plain versions
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


class Built(NamedTuple):
    path: Path
    log: str          # nvcc's output (ptxas register and spill counts)
    seconds: float    # 0.0 when an earlier build was loaded


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under the toolkit PyTorch finds
    (``CUDA_HOME``, ``CUDA_PATH`` or the default install)."""
    nvcc = shutil.which("nvcc")
    if nvcc is not None:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def nvcc_command(nvcc: str, source: Path, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already in ``_build/``."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.is_file():
        return Built(out, log_path.read_text() if log_path.is_file() else "",
                     0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(find_nvcc(), source, Path(tmp)),
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)      # atomic: concurrent builders both succeed
    return Built(out, log, seconds)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed; one
    load per process."""
    return ctypes.CDLL(str(build(name).path))
