"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc
-shared`` call per source builds them in seconds; nothing includes
PyTorch's headers.  The build runs at first use, into ``build/
torch_kernels/`` beside the package (listed in ``.gitignore``), keyed by
a hash of the source and the flags so an edited source rebuilds.  nvcc is
found from ``CUDA_HOME`` or ``PATH``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: another process never loads a partial file
    return lib


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_build(name)))
        return _libs[name]
