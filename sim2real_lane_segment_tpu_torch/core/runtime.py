"""Device selection and float32 precision for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU; asking for
the GPU on a machine without one raises instead of silently running on the
CPU.  Every CLI sets the float32 precision (``set_float32_precision``)
before it builds a model.
"""
from __future__ import annotations

import subprocess

import torch

UNREAD = "power limit not read"  # in a label whose nvidia-smi query failed


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` or ``cuda``; raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def set_float32_precision() -> None:
    """Strict float32: TF32 off for cuDNN's convolutions and for matmuls.

    Every CPU gate of the port compares against this route and every card
    time in ``PERF.md`` was taken on it; the port's fast path is the
    bfloat16 ``DEFAULT_POLICY``.  PyTorch's own default lets cuDNN run
    float32 convolutions in TF32, which would make the CLIs run another
    route than the one measured.  The flags need no card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def device_label(device: torch.device) -> str:
    """The name and power limit of the card behind ``device``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, for every time a CLI prints; on the CPU, a label that
    says its times are the host's."""
    if device.type != "cuda":
        return "cpu (host times, no card)"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(device)}, {UNREAD} ({e})"
    if out.returncode != 0 or not out.stdout.strip():
        return (f"{torch.cuda.get_device_name(device)}, {UNREAD} "
                f"(nvidia-smi: {out.stderr.strip()})")
    return out.stdout.strip().splitlines()[0]
