"""``cli/train_benchmark.py`` of the port against the JAX package's, on the
CPU.

- The metric names: JAX's ``measure`` run with a stand-in trainer (its
  step is one add, so nothing heavy compiles) under every flag, against
  the port's, which trains for real (tiny FCDenseNet, 32x32, B=2).
- The stage names: the keys of the stage table in JAX's
  ``measure_stages`` (read from its source) against the port's, which
  times every stage (tiny FCDenseNet, B=2).
- The headline line: its unit, its dispatch (``run_scan_chunk`` runs
  eager steps on the CPU; on a card it replays a CUDA graph) and a finite
  loss; LaneNetLite under ``--pallas_train`` trains plain and says so in
  its name.

Torch runs on 2 threads.
"""
import ast
import inspect
import math

import jax.numpy as jnp
import pytest
import torch

from sim2real_lane_segment_tpu.cli import train_benchmark as jax_tb
from sim2real_lane_segment_tpu_torch.cli import train_benchmark as tb

SMALL = ["-b", "2", "--steps", "2", "--iters", "1"]


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    monkeypatch.setattr(tb, "HEIGHT", 32)  # 32x32 frames, the CLI's constants
    monkeypatch.setattr(tb, "WIDTH", 32)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _StandIn:
    """A JAX trainer whose step adds one: ``measure`` compiles in
    milliseconds and names its metric as it does for a real one."""

    lr = 1e-3

    def __init__(self, **kw):
        pass

    def init_state(self, key):
        return jnp.zeros(())

    def train_step(self, st, images, labels, key, lr):
        return st + 1.0, {"tr_loss": st}


@pytest.mark.parametrize("fast,pallas", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_metric_names_equal_jax(monkeypatch, fast, pallas):
    from sim2real_lane_segment_tpu.train import supervised

    monkeypatch.setattr(supervised, "SupervisedTrainer", _StandIn)
    want = jax_tb.measure("67", 1, 1, 1, fast_train=fast,
                          pallas_train=pallas)
    assert tb.metric_name("67", fast, pallas) == want["metric"]
    got = tb.main(["--archs", "tiny", *SMALL]
                  + (["--fast_train"] if fast else [])
                  + (["--pallas_train"] if pallas else []), device="cpu")
    assert got[0]["metric"] == want["metric"].replace("_67", "_tiny")
    assert got[0]["unit"] == want["unit"]
    assert got[0]["dispatch"] == "eager"
    assert math.isfinite(got[0]["final_loss"]) and got[0]["value"] > 0


def _jax_stage_names() -> list:
    """The keys of the ``stages`` dict literal in JAX's
    ``measure_stages``, in order."""
    tree = ast.parse(inspect.getsource(jax_tb.measure_stages))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "stages"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no stages table in the JAX measure_stages")


def test_stage_names_equal_jax():
    names = _jax_stage_names()
    assert names == list(tb.STAGES)
    row = tb.main(["--archs", "tiny", "--stages", "-b", "2", "--steps", "1",
                   "--iters", "1"], device="cpu")[0]
    assert row["metric"] == "train_stage_ms_tiny"
    assert row["unit"] == "ms/step" and row["dispatch"] == "eager"
    for name in names:
        assert math.isfinite(row[name]) and row[name] > 0, name


def test_lite_under_pallas_train_trains_plain():
    rows = tb.main(["--archs", "lite", "--pallas_train", *SMALL],
                   device="cpu")
    assert rows[0]["metric"] == "train_images_per_sec_lite"
    assert math.isfinite(rows[0]["final_loss"])
