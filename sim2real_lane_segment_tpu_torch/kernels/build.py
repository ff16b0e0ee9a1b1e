"""Build the port's native code and load it with ctypes: the CUDA kernels
(``csrc/*.cu``, with nvcc) and the host codecs (``csrc/*.cpp``, with the
host's C++ compiler).

The sources under ``csrc/`` have a plain C interface, so one ``nvcc
-shared`` (or ``c++ -shared``) call per source builds them in seconds;
nothing includes PyTorch's headers.  The build runs at first use, into
``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers (for a
``.cu``) and the flags, so an edited source or header rebuilds.  nvcc is
found from ``CUDA_HOME`` or ``PATH``, the C++ compiler from ``CXX`` or
``c++`` on ``PATH``.  A failed build raises.

Each compiler's run is one ``setup.build`` span (``core.tracing``) and
each first ``load`` of a library one ``setup.load`` span (the build if
one is missing, then the ``dlopen``), both with the library's name
(``lib``); ``build_seconds()`` reads the ``setup.build`` spans.
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

from ..core import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def build_seconds() -> dict[str, float]:
    """Seconds of each library's build (its ``setup.build`` span), by
    library name, while the ring holds the span."""
    return {s.attrs["lib"]: s.seconds for s in tracing.spans()
            if s.name == "setup.build"}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler: set CXX or put c++ on PATH")
    return cxx


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.is_file() else CSRC / f"{name}.cpp"


def _command(name: str, out: Path) -> list[str]:
    src = _source(name)
    if src.suffix == ".cu":
        return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(src)]


def _target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` (or ``.cpp``), keyed by the
    source, every shared header under ``csrc/`` (for a ``.cu``) and the
    flags."""
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the named sources that are not built yet: one compiler each,
    all started together.  Raises if any build fails."""
    running = []
    for name in names:
        lib = _target(name)
        if lib.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        running.append((name, lib, tmp, time.monotonic_ns(), subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib, tmp, t0, proc in running:
        out, err = proc.communicate()
        tracing.record("setup.build", t0, time.monotonic_ns(), lib=name)
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{_command(name, tmp)[0]} failed "
                          f"({proc.returncode}) for {_source(name).name}:\n"
                          f"{err[-4000:]}")
        else:
            os.replace(tmp, lib)  # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (or ``.cpp``),
    built on first use."""
    with _lock:
        if name not in _libs:
            with tracing.span("setup.load", lib=name):
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
