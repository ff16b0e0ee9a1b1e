"""numpy-over-zmq wire framing (reference duckiebot_env.py:31-38).

Counterpart of ``send_array``/``recv_array`` in the JAX package's
``sim/server.py``: one JSON header frame ``{dtype, shape}`` then the raw
buffer.  The gym server itself belongs to the simulator slice.
"""
from __future__ import annotations

import numpy as np


def send_array(socket, arr: np.ndarray, flags: int = 0) -> None:
    """numpy-over-zmq: JSON metadata frame then the raw buffer."""
    import zmq

    header = dict(dtype=str(arr.dtype), shape=arr.shape)
    socket.send_json(header, flags | zmq.SNDMORE)
    socket.send(np.ascontiguousarray(arr), flags, copy=False)


def recv_array(socket, flags: int = 0) -> np.ndarray:
    header = socket.recv_json(flags)
    msg = socket.recv(flags)
    arr = np.frombuffer(msg, dtype=header["dtype"])
    return arr.reshape(header["shape"])
