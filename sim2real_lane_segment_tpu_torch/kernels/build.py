"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc
-shared`` call per source builds them in seconds; nothing includes
PyTorch's headers.  The build runs at first use, into ``build/
torch_kernels/`` beside the package (listed in ``.gitignore``), keyed by
a hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header rebuilds.  nvcc is
found from ``CUDA_HOME`` or ``PATH``.  A failed build raises.
"""
from __future__ import annotations

import contextlib
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


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu``, keyed by the source, every
    shared header under ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the named sources that are not built yet: one nvcc each, all
    started together.  Raises if any build fails."""
    running = []
    for name in names:
        lib = _target(name)
        if lib.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        running.append((name, lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib, tmp, t0, proc in running:
        out, err = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                          f"{err[-4000:]}")
        else:
            os.replace(tmp, lib)  # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def on_device(device):
    """The device context for a launch on ``device`` (a CUDA
    ``torch.device``): none when it is the current device already, which
    saves a few microseconds a launch."""
    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
