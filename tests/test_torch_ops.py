"""Port of ``ops/resize.py`` and ``eval_batch``: the same uint8 frames
through the JAX function and the port, float32, atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_common  # noqa: F401  (caps torch threads)

from sim2real_lane_segment_tpu.ops.augment import AugmentConfig as JaxCfg
from sim2real_lane_segment_tpu.ops.augment import eval_batch as jax_eval
from sim2real_lane_segment_tpu_torch.ops.augment import AugmentConfig
from sim2real_lane_segment_tpu_torch.ops.augment import eval_batch
from sim2real_lane_segment_tpu_torch.ops.resize import to_gray


@pytest.mark.parametrize("src_hw,gray", [((24, 32), False),
                                         ((48, 64), False),
                                         ((48, 64), True),
                                         ((30, 41), False)])
def test_eval_batch_matches_jax(src_hw, gray):
    """24x32 -> 24x32 takes the skip-resample branch; the others resize
    (2x down, and a non-integer ratio)."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, *src_hw, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (2, *src_hw), dtype=np.uint8)
    x_ref, y_ref = jax_eval(jnp.asarray(frames), jnp.asarray(labels),
                            JaxCfg(height=24, width=32, gray=gray))
    x, y = eval_batch(torch.from_numpy(frames), torch.from_numpy(labels),
                      AugmentConfig(height=24, width=32, gray=gray))
    assert x.dtype == torch.float32 and x.shape == (2, 24, 32, 3)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-5,
                               rtol=0)
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))


def test_eval_batch_without_labels():
    frames = torch.zeros(1, 24, 32, 3, dtype=torch.uint8)
    x, y = eval_batch(frames, None, AugmentConfig(height=24, width=32),
                      with_labels=False)
    assert y is None and x.shape == (1, 24, 32, 3)


def test_to_gray_channel_orders():
    img = torch.tensor([[[[10.0, 20.0, 30.0]]]])
    bgr = to_gray(img, "bgr")[0, 0, 0]
    rgb = to_gray(img, "rgb")[0, 0, 0]
    assert torch.allclose(bgr, torch.full((3,), 0.114 * 10 + 0.587 * 20
                                          + 0.299 * 30))
    assert torch.allclose(rgb, torch.full((3,), 0.299 * 10 + 0.587 * 20
                                          + 0.114 * 30))
