"""The cost file's operations against the configurations and against a
count taken from the reference network's own convolutions."""
import os

import pytest
import torch
from portbench_tiny import ROOT, TINY, harness

from portbench.cost import fcdensenet as cost
from portbench.reference.fcdensenet import FCDenseNet


def config(name):
    return harness.read_json(os.path.join(ROOT, "portbench", "configs",
                                          f"{name}.json"))


# GFLOP a 120x160 forward, fixed apart from both the configuration's file
# and the cost function, so that the two cannot drift together
ANCHOR_GFLOP = {"fcdensenet67": 15.9, "fcdensenet57": 6.77}


@pytest.mark.parametrize("entry", harness.benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_forward_gflop(entry):
    cfg = harness.read_json(os.path.join(ROOT, entry["file"]))
    assert cost.forward_flops(cfg) / 1e9 == pytest.approx(
        cfg["forward_gflop_per_image"], abs=1e-3)
    if entry["name"] in ANCHOR_GFLOP:
        assert cost.forward_flops(cfg) / 1e9 == pytest.approx(
            ANCHOR_GFLOP[entry["name"]], abs=0.01)


def test_forward_flops_match_the_reference_convolutions():
    counted = []

    class Counting:
        def conv2d(self, x, w, b, padding=0):
            y = torch.nn.functional.conv2d(x, w, b, padding=padding)
            counted.append(2 * y[0].numel() * w[0].numel())
            return y

        def conv_transpose2d(self, x, w, b):
            counted.append(2 * x[0].numel() * w.shape[1] * 9)
            return torch.nn.functional.conv_transpose2d(x, w, b, stride=2)

    model = FCDenseNet(TINY)
    model.logits(torch.zeros(1, 3, TINY["height"], TINY["width"]),
                 Counting())
    convs = [m for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert len(counted) == len(convs) == len(cost.layers(TINY))
    assert sum(counted) == cost.forward_flops(TINY)


def test_serve_bound_at_b64():
    # the kernels' table in PERF.md: 1.979 + 0.302 + 0.223 ms
    assert cost.serve_kernels(config("fcdensenet67"), 64) * 1e3 == \
        pytest.approx(2.504, abs=0.01)


def test_bounds_grow_with_the_batch():
    cfg = config("fcdensenet57")
    assert cost.serve_kernels(cfg, 1) < cost.serve_kernels(cfg, 64)
    assert cost.train_kernels(cfg, 32) > cost.serve_kernels(cfg, 32)
