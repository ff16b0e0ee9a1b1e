"""The reference agrees with the program at a tiny size on the CPU when
the program computes in float32: the augmentation, the served logits and
three training steps."""
import numpy as np
import pytest
import torch
from portbench_tiny import TINY, harness, traffic

from portbench import inputs
from portbench.reference import augment as ref_aug
from portbench.reference import compare
from portbench.reference import train as ref_train

PORT = harness.PORT


@pytest.fixture
def f32_program(monkeypatch):
    """The program's models built with its float32 policy."""
    import importlib
    ct = importlib.import_module(f"{PORT}.cli.test")
    dtypes = importlib.import_module(f"{PORT}.core.dtypes")
    real = ct.build_model
    monkeypatch.setattr(ct, "build_model", lambda arch, n, policy=None:
                        real(arch, n, dtypes.F32_POLICY))
    return real


def test_augmentation_matches_the_program():
    import importlib
    sup = importlib.import_module(f"{PORT}.train.supervised")
    aug = importlib.import_module(f"{PORT}.ops.augment")
    tr = traffic("train")
    n, h, w = 6, TINY["height"], TINY["width"]
    images = inputs.frames(n, h, w, 5, "split", "cpu")
    labels = inputs.labels(n, h, w, 4, 5, "cpu")
    d = inputs.step_draws(inputs.draws(TINY, tr["augment"], 1, n, 5, "cpu"),
                          0)
    cfg = aug.AugmentConfig(height=h, width=w, min_crop_height=h // 2,
                            max_crop_height=h * 4)
    x, y = sup.model_batch(images, labels, cfg, aug.AugmentDraws(**d))
    rx, ry = ref_aug.augment(images, labels.to(torch.int64), d, h, w)
    assert torch.equal(y, ry)
    np.testing.assert_allclose(x.numpy(), rx.numpy(), atol=2e-4, rtol=0)


def test_served_logits_match_the_program(f32_program):
    import importlib
    fused = importlib.import_module(f"{PORT}.models.tiramisu_fused")
    dtypes = importlib.import_module(f"{PORT}.core.dtypes")
    weights = inputs.weights(TINY, 9, "cpu")
    model = f32_program("tiny", 4, dtypes.F32_POLICY)
    model.load_state_dict(weights)
    frames = inputs.frames(5, TINY["height"], TINY["width"], 9, "pool", "cpu")
    x = ref_aug.eval_input(frames)
    got = fused.fused_apply(model, x, use_softmax=False)
    want = ref_train.serve_logits(TINY, weights, frames)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_training_steps_match_the_program(f32_program):
    ctx = harness.Ctx({"name": "fcd67.train_sup"}, TINY, traffic("train"),
                      2 ** 40 + 3, 1.0, False, "cpu", {})
    cell = harness.driver("train_scan").Cell(ctx)
    cell.setup()
    cell.release()
    got = compare.train_numbers(cell.prog, cell.reference())
    assert got["loss_gap"] < 1e-5
    assert got["grad1_gap"] < 1e-4
    assert got["stats3_gap"] < 1e-3
    # Adam moves elements whose gradient is round-off by a full step of
    # either sign, so the change's norms agree less closely
    assert got["delta3_gap"] < 0.05
