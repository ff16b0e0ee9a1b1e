"""The port's training augmentation against the JAX package's, on JAX's
own draws (``test_torch_common.jax_augment_draws`` replays its key chain).

Tolerances: the colour ops and the blur are float32 arithmetic in another
order or fusion (values in [0, 255]: atol 1e-3); crop boxes and labels are
exact (a coordinate-coded label map pins every box); whole batches are
normalized values at atol 1e-4; the augmented train step is held as the
unaugmented one in ``test_torch_train_steps.py`` (loss at 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, jax_augment_draws,
                               jax_drop_masks, jax_variables, load_port,
                               unflatten)

from sim2real_lane_segment_tpu.ops import augment as jaug
from sim2real_lane_segment_tpu.ops import colorspace as jcs
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models.tiramisu import dropout_sites
from sim2real_lane_segment_tpu_torch.ops import augment as aug
from sim2real_lane_segment_tpu_torch.ops import colorspace as cs
from sim2real_lane_segment_tpu_torch.train.supervised import SupervisedTrainer

PIXEL_ATOL = 1e-3
NORM_ATOL = 1e-4


def _cfgs(h, w, gray=False):
    kw = dict(height=h, width=w, gray=gray, min_crop_height=h // 2,
              max_crop_height=4 * h)
    return jaug.AugmentConfig(**kw), aug.AugmentConfig(**kw)


@pytest.mark.parametrize("order", ["bgr", "rgb"])
def test_shift_hsv_matches_jax(order):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (4, 9, 11, 3), dtype=np.uint8)
    img[0, 0, :3] = [[0, 0, 0], [255, 255, 255], [7, 7, 7]]  # grays: c == 0
    shifts = rng.uniform(-1, 1, (3, 4, 1, 1)).astype(np.float32) * \
        np.array([20, 30, 20], np.float32)[:, None, None, None]
    want = jcs.shift_hsv(img, *shifts, channel_order=order)
    got = cs.shift_hsv(torch.from_numpy(img),
                       *(torch.from_numpy(s) for s in shifts), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIXEL_ATOL,
                               rtol=0)


def test_hsv_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 255, (5, 7, 3)).astype(np.float32)
    hsv = cs.rgb_to_hsv_cv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jcs.rgb_to_hsv_cv(rgb)),
                               atol=PIXEL_ATOL, rtol=0)
    back = cs.hsv_to_rgb_cv(hsv).numpy()
    np.testing.assert_allclose(back, rgb, atol=PIXEL_ATOL, rtol=0)
    np.testing.assert_allclose(
        back, np.asarray(jcs.hsv_to_rgb_cv(jcs.rgb_to_hsv_cv(rgb))),
        atol=PIXEL_ATOL, rtol=0)


def test_motion_blur_bank_bit_equal():
    np.testing.assert_array_equal(aug.MOTION_BLUR_BANK,
                                  np.asarray(jaug.MOTION_BLUR_BANK))
    assert aug.MOTION_BLUR_BANK.dtype == np.float32


def test_motion_blur_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (3, 10, 13, 3)).astype(np.float32)
    idx = np.array([0, 11, 23])
    got = aug.motion_blur(torch.from_numpy(img),
                          torch.from_numpy(aug.MOTION_BLUR_BANK[idx]))
    for i, k in enumerate(idx):
        want = jaug.motion_blur(img[i], jaug.MOTION_BLUR_BANK[k])
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=PIXEL_ATOL, rtol=0)


# (source h, w, output h, w): crops up to 4h tall, so the 16x24 output from
# 16x24 or 24x32 sources clamps most crops to the source
@pytest.mark.parametrize("src,out", [((48, 64), (16, 24)),
                                     ((24, 32), (16, 24)),
                                     ((16, 24), (16, 24)),
                                     ((37, 29), (12, 20))])
def test_crop_boxes_and_labels_exact(src, out):
    jcfg, cfg = _cfgs(*out)
    n, (sh, sw) = 8, src
    rng = np.random.default_rng(sh * sw)
    img = rng.uniform(0, 255, (n, sh, sw, 3)).astype(np.float32)
    code = np.arange(sh * sw, dtype=np.int32).reshape(sh, sw)
    labels = np.broadcast_to(code, (n, sh, sw)).copy()
    key = jax.random.key(sh + sw)
    draws = jax_augment_draws(key, n, cfg)
    x, y = aug.random_sized_crop(torch.from_numpy(img),
                                 torch.from_numpy(labels), draws, cfg)
    k_crop = [jax.random.split(k, 5)[1] for k in jax.random.split(key, n)]
    crop_h, crop_w, y1, x1 = aug.crop_boxes(draws, sh, sw, cfg)
    assert (crop_h <= sh).all() and (crop_w <= sw).all()
    assert (y1 >= 0).all() and (y1 + crop_h <= sh).all()
    clamped = 0
    for i in range(n):
        xj, yj = jaug._random_sized_crop(k_crop[i], img[i], labels[i], jcfg)
        np.testing.assert_array_equal(y[i].numpy(), np.asarray(yj))
        np.testing.assert_allclose(x[i].numpy(), np.asarray(xj),
                                   atol=PIXEL_ATOL, rtol=0)
        # the coded labels are the box: its rows and columns, exactly
        rows = np.asarray(yj)[:, 0] // sw
        cols = np.asarray(yj)[0] % sw
        assert rows.min() >= y1[i] and cols.min() >= x1[i]
        clamped += int(draws.crop_h[i]) > sh
    if sh <= 24:
        assert clamped, "no crop larger than the source was drawn"


@pytest.mark.parametrize("with_labels,gray", [(True, False), (False, False),
                                              (True, True)])
def test_augment_batch_matches_jax(with_labels, gray):
    jcfg, cfg = _cfgs(16, 24, gray)
    rng = np.random.default_rng(3)
    n = 6
    img = rng.integers(0, 256, (n, 30, 40, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (n, 30, 40), dtype=np.uint8)
    key = jax.random.key(4)
    xj, yj = jaug.augment_batch(key, img, labels if with_labels else None,
                                jcfg, with_labels=with_labels)
    draws = jax_augment_draws(key, n, cfg)
    assert draws.use_blur.any() and not draws.use_blur.all()
    x, y = aug.augment_batch(torch.from_numpy(img),
                             torch.from_numpy(labels) if with_labels
                             else None, cfg, draws, with_labels=with_labels)
    assert x.shape == (n, 16, 24, 3) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=NORM_ATOL,
                               rtol=0)
    if with_labels:
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    else:
        assert y is None and yj is None


def test_draw_augment_ranges_and_seeding():
    cfg = aug.AugmentConfig(height=16, width=24, min_crop_height=8,
                            max_crop_height=64)
    d = aug.draw_augment(torch.Generator().manual_seed(0), 256, cfg, "cpu")
    assert d.noise.shape == (256, 16, 24, 3)
    assert ((d.hsv >= -1) & (d.hsv < 1)).all()
    assert d.crop_h.min() >= 8 and d.crop_h.max() <= 64
    assert ((d.sigma2 >= 10) & (d.sigma2 < 50)).all()
    assert d.blur_idx.min() >= 0 and d.blur_idx.max() < 24
    assert 0 < d.use_blur.sum() < 256
    again = aug.draw_augment(torch.Generator().manual_seed(0), 256, cfg,
                             "cpu")
    for a, b in zip(d, again):
        assert torch.equal(a, b)


def test_augmented_train_step_matches_jax():
    """One ``train_step`` with ``augment=True`` and ``pallas_train`` on
    both sides (JAX interpret-mode kernels, the port's plain kernel
    versions) on JAX's ``k_aug, k_drop`` draws; the source frames are
    larger than the model's input, so the crop resamples."""
    from sim2real_lane_segment_tpu.train.supervised import \
        SupervisedTrainer as JaxTrainer
    from sim2real_lane_segment_tpu.train.supervised import TrainState

    h, w, b, lr = 16, 24, 2, 1e-3
    jax_model = tiny_model()
    flat = jax_variables(jax_model, (b, h, w, 3), seed=21)
    rng = np.random.default_rng(22)
    images = rng.integers(0, 255, (b, 24, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (b, 24, 32), dtype=np.uint8)
    key = jax.random.key(23)

    jt = JaxTrainer(num_cls=4, height=h, width=w, augment=True,
                    model=jax_model, pallas_train=True)
    assert jt.pallas_train
    v = unflatten(flat)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jt.tx.init(v["params"]))
    new_state, logs = jax.device_get(jt.train_step(
        state, jnp.asarray(images), jnp.asarray(labels), key,
        jnp.float32(lr)))

    model = load_port(build_model("tiny", 4, F32_POLICY), flat)
    trainer = SupervisedTrainer(num_cls=4, height=h, width=w, model=model,
                                augment=True, pallas_train=True,
                                device="cpu")
    k_aug, k_drop = jax.random.split(key)
    masks = jax_drop_masks(k_drop, dropout_sites(model), model.dropout_rate,
                           b)
    got = trainer.train_step(images, labels, lr,
                             draws=jax_augment_draws(k_aug, b, trainer.cfg),
                             masks=masks)
    np.testing.assert_allclose(float(got["tr_loss"]), float(logs["tr_loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(got["tr_acc"]), float(logs["tr_acc"]),
                               atol=1e-4)
    assert_adam_step_matches(model, trainer.opt.mu, new_state.params,
                             new_state.opt_state[0].mu, lr)
    assert_batch_stats_match(model, new_state.batch_stats)


def test_train_step_draws_its_own_augmentation():
    """Without ``draws`` the step draws them from its generator: the same
    seed gives the same step."""
    h, w = 16, 24
    rng = np.random.default_rng(5)
    images = rng.integers(0, 255, (2, 20, 28, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (2, 20, 28), dtype=np.uint8)
    losses = []
    for _ in range(2):
        torch.manual_seed(0)
        trainer = SupervisedTrainer(num_cls=4, height=h, width=w,
                                    model=build_model("tiny", 4),
                                    augment=True, device="cpu")
        logs = trainer.train_step(images, labels, 1e-3,
                                  generator=torch.Generator().manual_seed(7))
        losses.append(float(logs["tr_loss"]))
    assert np.isfinite(losses).all() and losses[0] == losses[1]
