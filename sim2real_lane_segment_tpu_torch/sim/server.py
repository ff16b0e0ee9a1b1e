"""ZMQ gym server and robot bridge (reference launcher.py and
duckiebot_env.py).

Counterpart of the JAX package's ``sim/server.py``.  The reference had
two network seams:

- a headless gym server that takes commands and answers with
  observations over ZMQ (launcher.py:44-84, the duckietown-start-gym
  console script): ``serve`` and ``main``, configured by the ``DTG_MAP``,
  ``DTG_DOMAIN_RAND`` and ``DTG_PORT`` environment variables;
- ``DuckiebotEnv``, driving a physical robot (``DUCKIEBOT_ADDR``, default
  ``akira.local``, port 7777) with the same gym-like reset/step.

The wire format is the reference's numpy-over-zmq framing
(duckiebot_env.py:31-38): one JSON header frame ``{dtype, shape}``, then
the raw buffer.  ``zmq`` is imported where a socket is made, so the
module imports without it; ``serve`` and ``DuckiebotEnv`` also take a
socket object, which lets a test drive them without zmq.

``DuckiebotEnv`` receives its replies with no flags.  The JAX package's
passes ``zmq.RCVMORE`` there, a socket option whose value (13) read as
flags includes ``DONTWAIT``, so a reply not yet arrived raises
``zmq.Again``.
"""
from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger(__name__)

SNDMORE = 2   # zmq.SNDMORE, libzmq's ZMQ_SNDMORE


def send_array(socket, arr: np.ndarray, flags: int = 0) -> None:
    """numpy-over-zmq: JSON metadata frame then the raw buffer."""
    header = dict(dtype=str(arr.dtype), shape=arr.shape)
    socket.send_json(header, flags | SNDMORE)
    socket.send(np.ascontiguousarray(arr), flags, copy=False)


def recv_array(socket, flags: int = 0) -> np.ndarray:
    header = socket.recv_json(flags)
    msg = socket.recv(flags)
    arr = np.frombuffer(msg, dtype=header["dtype"])
    return arr.reshape(header["shape"])


def _socket(kind: str, *, bind: str | None = None,
            connect: str | None = None):
    import zmq

    sock = zmq.Context.instance().socket(getattr(zmq, kind))
    if bind:
        sock.bind(bind)
    if connect:
        sock.connect(connect)
    return sock


def serve(env, *, host: str = "0.0.0.0", port: int = 8902,
          sock=None) -> None:
    """Blocking command/observation loop on a REP socket: receive an
    action (or reset/close) as JSON, step, reply with reward/done and the
    observation array.  ``sock`` replaces the bound socket."""
    if sock is None:
        sock = _socket("REP", bind=f"tcp://{host}:{port}")
        log.info("gym server listening on %s:%d", host, port)
    obs = env.reset()
    while True:
        msg = sock.recv_json()
        cmd = msg.get("cmd", "step")
        if cmd == "reset":
            obs = env.reset()
            reward, done = 0.0, False
        elif cmd == "close":
            sock.send_json({"ok": True})
            break
        else:
            obs, reward, done, _ = env.step(np.asarray(msg["action"]))
            if done:
                obs = env.reset()
        sock.send_json({"reward": float(reward), "done": bool(done)},
                       SNDMORE)
        send_array(sock, np.asarray(obs))


class DuckiebotEnv:
    """Physical-robot env over ZMQ (duckiebot_env.py:40): actions out,
    camera frames in, the gym-like reset/step.  ``sock`` replaces the
    connected REQ socket."""

    def __init__(self, server_addr: str | None = None,
                 server_port: int = 7777, sock=None):
        if sock is None:
            addr = server_addr or os.environ.get("DUCKIEBOT_ADDR",
                                                 "akira.local")
            sock = _socket("REQ", connect=f"tcp://{addr}:{server_port}")
            log.info("connected to duckiebot at %s:%d", addr, server_port)
        self.sock = sock

    def step(self, action):
        self.sock.send_json({"cmd": "step",
                             "action": np.asarray(action).tolist()})
        meta = self.sock.recv_json()
        obs = recv_array(self.sock)
        return obs, meta.get("reward", 0.0), meta.get("done", False), meta

    def reset(self):
        self.sock.send_json({"cmd": "reset"})
        self.sock.recv_json()
        return recv_array(self.sock)

    def close(self):
        self.sock.send_json({"cmd": "close"})
        self.sock.recv()


def main(args=None, device=None) -> None:
    """The ``duckietown-start-gym`` analog: a headless server configured
    by environment variables (launcher.py:14-84); the env renders on
    ``device`` (default ``cuda``)."""
    logging.basicConfig(level=logging.INFO)
    from .env import DuckietownEnv

    env = DuckietownEnv(
        map_name=os.environ.get("DTG_MAP", "small_loop"),
        domain_rand=os.environ.get("DTG_DOMAIN_RAND", "1") == "1",
        device=device)
    serve(env, port=int(os.environ.get("DTG_PORT", "8902")))


if __name__ == "__main__":
    main()
