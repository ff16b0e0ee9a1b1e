"""``correct`` comes out false, through the whole harness, for each
fault the cells can have planted in the program, and for the control:
the reference in float8 put in the program's place."""
import pytest
from portbench_tiny import TINY, TINY_LIMITS, harness, run_tiny, traffic

from portbench.reference import compare
from portbench.reference import train as ref_train
from portbench.reference.lowp import Float8Convs


@pytest.mark.parametrize("which,fault", [("train", "unchanged"),
                                         ("train", "half_batch"),
                                         ("fleet", "altered"),
                                         ("video", "altered")])
def test_a_planted_fault_is_not_correct(which, fault):
    rc, line, err = run_tiny(which, faults=(fault,))
    assert rc == 0, err
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items()
              if c["limit"] is not None and not c["value"] <= c["limit"]]
    assert failed, line["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_fails_training(seed):
    ctx = harness.Ctx({"name": "fcd67.train_sup"}, TINY, traffic("train"),
                      seed, 1.0, False, "cpu", {})
    cell = harness.driver("train_scan").Cell(ctx)
    cell.setup()
    cell.release()
    want = cell.reference()
    numbers = compare.train_numbers(cell.reference(Float8Convs()), want)
    assert not compare.judge(numbers, TINY_LIMITS), numbers


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float8_control_fails_serving(seed):
    from portbench import inputs
    weights = inputs.weights(TINY, seed, "cpu")
    frames = inputs.frames(16, TINY["height"], TINY["width"], seed, "pool",
                           "cpu")
    want = ref_train.serve_logits(TINY, weights, frames)
    low = ref_train.serve_logits(TINY, weights, frames, Float8Convs())
    gap = compare.mask_gap(want, low.argmax(1))
    assert gap > TINY_LIMITS["mask_gap"]
