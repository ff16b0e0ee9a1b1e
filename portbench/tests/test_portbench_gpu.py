"""The harness on the card at the tiny size: the program's kernels under
the whole run, and the float8 control failing there too. Skips without a
card; on one:

    python -m pytest -p no:cacheprovider -m gpu portbench/tests
"""
import pytest
from portbench_tiny import TINY, TINY_LIMITS, harness, run_tiny, traffic

from portbench.reference import compare
from portbench.reference.lowp import Float8Convs


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["train", "fleet", "video"])
def test_a_tiny_run_on_the_card_is_correct(cuda, which):
    rc, line, err = run_tiny(which, device=cuda, trace=1)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_planted_fault_on_the_card_is_not_correct(cuda, fault):
    rc, line, err = run_tiny("train", device=cuda, faults=(fault,))
    assert rc == 0, err
    assert line["correct"] is False


@pytest.mark.gpu
def test_the_float8_control_fails_on_the_card(cuda):
    ctx = harness.Ctx({"name": "fcd67.train_sup"}, TINY, traffic("train"),
                      11, 1.0, False, cuda, {})
    cell = harness.driver("train_scan").Cell(ctx)
    cell.setup()
    cell.release()
    numbers = compare.train_numbers(cell.reference(Float8Convs()),
                                    cell.reference())
    assert not compare.judge(numbers, TINY_LIMITS), numbers
