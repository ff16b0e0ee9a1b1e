"""The numbers that decide ``correct``, and their limits.

Training (three steps from the same weights, rows, draws and masks):

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad1_gap``: the first step's gradient as the optimiser got it, per
  leaf its norm; the worst leaf's gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and
  of the median leaf.
- ``delta3_gap``: the same for the change of the parameters over the
  three steps.

Both leave out, by a rule on the reference's first gradient and not by
name, the leaves whose gradient is under a thousandth of the median
leaf's: a bias that only BatchNorms follow (the transposed convolutions'
of every up block but the last) has a gradient of zero up to rounding,
and in bfloat16 the program's reads its round-off, a third of the median
leaf's norm; Adam then moves it by round-off alone.
- ``stats1_gap``: the same for the change of the running statistics
  over the first step: the batch statistics of the augmented forward
  alone, averaged over every pixel of the batch at each BatchNorm.
- ``stats3_gap``: the same over the three steps.

Serving: ``mask_gap``, the widest gap by which the reference's logit of a
served class lies below the reference's best logit at that pixel, over
every pixel of the sampled replies. Argmax flips where two logits lie
within rounding read small; a wrong class reads the distance between
the classes.

``limits/<config>.json`` holds one configuration's limits and the
readings they were set from (``PERF.md`` gives them too); a new
configuration brings its own file.
"""
from __future__ import annotations

import json
import os
import statistics

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GRAD_FLOOR = 1e-3


def limits(config: str) -> dict:
    """``limits/<config>.json``'s limits."""
    path = os.path.join(HERE, "limits", f"{config}.json")
    try:
        with open(path) as f:
            return json.load(f)["limits"]
    except FileNotFoundError:
        raise SystemExit(f"no limits for configuration {config!r}: "
                         f"{path} is missing") from None


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    med = statistics.median(ref["grad1"].values())
    moved = {k for k, v in ref["grad1"].items() if v >= GRAD_FLOOR * med}
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["loss"], ref["loss"],
                                        strict=True)),
        "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"], moved),
        "delta3_gap": leaf_gap(prog["delta"], ref["delta"], moved),
        "stats1_gap": leaf_gap(prog["stats1"], ref["stats1"]),
        "stats3_gap": leaf_gap(prog["stats"], ref["stats"]),
    }


def mask_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """ref_logits (N, C, H, W), served (N, H, W) class indices."""
    best = ref_logits.amax(1)
    got = ref_logits.gather(1, served.to(torch.int64)[:, None])[:, 0]
    return float((best - got).amax())


def judge(numbers: dict, lim: dict) -> bool:
    """Every number that has a limit at or under it (NaN fails)."""
    return all(v <= lim[k] for k, v in numbers.items() if k in lim)
