"""The CycleGAN CLIs of the port (``cli.train_cyclegan``,
``cli.sim2real_convert``) on tiny trees, and ``sim2real_convert`` against
the JAX CLI from the same Flax generator.

Tolerances: ``sim2real_convert`` computes the generator in bfloat16
(``DEFAULT_POLICY``, both packages).  The two sum their products in
another order, and XLA keeps float32 between fused bfloat16 operations
where PyTorch rounds each, so the tanh output (a bf16 step is half a
level near +-1) differs on about half the values, and the truncation to
uint8 and the LANCZOS4 upscale spread it: the restyled frames may differ
by at most BF16_MAX_LEVELS, by BF16_MEAN_LEVELS on average (measured: 5
and 0.58).  The same pipeline in float32 (the generator under
``F32_POLICY``) may differ by at most 1 level on at most F32_SHARE of the
generator's output values (measured: 2e-4): a float32 value that lands
within rounding of an integer truncates either way; its cv2 resizes and
the port's are bit-equal.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.cyclegan import \
    GeneratorResNet as JaxGenerator
from sim2real_lane_segment_tpu_torch.cli import sim2real_convert
from sim2real_lane_segment_tpu_torch.cli import train_cyclegan
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data.png import read_png, write_png
from sim2real_lane_segment_tpu_torch.ops.resize import (resize_cubic_u8,
                                                        resize_lanczos4_u8)

torch.set_num_threads(2)

BF16_MAX_LEVELS = 8
BF16_MEAN_LEVELS = 1.0
F32_SHARE = 1e-3


def _domain(root, n, shift, rng, size=(32, 32)):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 120, (*size, 3), dtype=np.uint8)
        img += np.asarray(shift, np.uint8)
        write_png(os.path.join(root, f"{i:03d}.png"), img)


def test_train_cyclegan_writes_loadable_generators(tmp_path, rng):
    _domain(str(tmp_path / "a"), 8, (0, 0, 60), rng)
    _domain(str(tmp_path / "b"), 8, (60, 0, 0), rng)
    out = str(tmp_path / "cg")
    res = train_cyclegan.main(
        ["--source_dir", str(tmp_path / "a"), "--target_dir",
         str(tmp_path / "b"), "--out", out, "--epochs", "2", "-b", "4",
         "--width", "32", "--height", "32", "--num_residual_blocks", "1"],
        device="cpu")
    assert np.isfinite(res["final"]["loss_G"])
    with open(os.path.join(out, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"loss_G", "loss_D", "loss_gan", "loss_cyc",
                            "loss_id", "epoch"}
    for name in ("g_ab", "g_ba"):
        model = sim2real_convert.load_generator(
            os.path.join(out, f"{name}.pt"), 1, device="cpu")
        with torch.no_grad():
            y = model(torch.zeros(1, 3, 32, 32))
        assert y.shape == (1, 3, 32, 32) and torch.isfinite(y).all()

    # the trained generator restyles a tree in place at the reference size
    db = tmp_path / "db" / "input"
    _domain(str(db), 2, (0, 0, 0), rng, size=(48, 64))
    n = sim2real_convert.main(["--dataPath", str(tmp_path / "db"),
                               "--modelWeightsPath",
                               os.path.join(out, "g_ab.pt"),
                               "--num_residual_blocks", "1"], device="cpu")
    assert n == 2
    assert read_png(str(db / "000.png")).shape == (480, 640, 3)


def test_load_image_stack_matches_jax(tmp_path, rng):
    from sim2real_lane_segment_tpu.cli.train_cyclegan import \
        load_image_stack as jax_load

    _domain(str(tmp_path / "x"), 3, (10, 20, 30), rng, size=(480, 640))
    want = jax_load(str(tmp_path / "x"), 120, 160)
    got = train_cyclegan.load_image_stack(str(tmp_path / "x"), 120, 160,
                                          device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def flax_generator(tmp_path):
    """A 1-block JAX generator's ``g_ab.msgpack`` and its variables."""
    model = JaxGenerator(num_residual_blocks=1)
    variables = model.init(jax.random.key(4), jnp.zeros((1, 120, 160, 3)))
    path = str(tmp_path / "g_ab.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes({"params": variables["params"]}))
    return path, variables


def _frames(rng, n=2):
    return rng.integers(0, 256, (n, 480, 640, 3), dtype=np.uint8)


def _levels(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    return diff.max(), diff.mean(), (diff > 0).mean()


def test_convert_against_jax_cli(tmp_path, rng, flax_generator):
    from sim2real_lane_segment_tpu.cli import sim2real_convert as jax_cli

    path, _ = flax_generator
    frames = _frames(rng)
    for side in ("jax", "port"):
        for i, img in enumerate(frames):
            d = tmp_path / side / "train" / "input"
            os.makedirs(d, exist_ok=True)
            write_png(str(d / f"{i:06d}.png"), img)
    argv = lambda side: ["--dataPath", str(tmp_path / side),
                         "--modelWeightsPath", path,
                         "--num_residual_blocks", "1"]
    assert jax_cli.main(argv("jax")) == 2
    assert sim2real_convert.main(argv("port"), device="cpu") == 2
    for i in range(2):
        name = f"train/input/{i:06d}.png"
        got = read_png(str(tmp_path / "port" / name))
        want = cv2.imread(str(tmp_path / "jax" / name))
        assert got.shape == want.shape == (480, 640, 3)
        worst, mean, _ = _levels(got, want)
        assert worst <= BF16_MAX_LEVELS and mean <= BF16_MEAN_LEVELS, \
            (worst, mean)


def test_convert_pipeline_f32_against_jax(rng, flax_generator):
    _, variables = flax_generator
    frames = _frames(rng)
    small = np.stack([cv2.resize(f, (160, 120), interpolation=cv2.INTER_CUBIC)
                      for f in frames])
    model = JaxGenerator(num_residual_blocks=1, policy=JAX_F32)

    @jax.jit
    def generate(batch_u8):
        x = batch_u8.astype(jnp.float32) / 255.0
        y = model.apply(variables, (x - 0.5) / 0.5)
        return jnp.clip((y + 1.0) / 2.0 * 255.0, 0, 255).astype(jnp.uint8)

    want = np.array(generate(small))

    from sim2real_lane_segment_tpu_torch.models.cyclegan import \
        GeneratorResNet
    from sim2real_lane_segment_tpu_torch.models.flax_import import \
        cyclegan_state_dict_from_flax
    from test_torch_common import flat_numpy

    port = GeneratorResNet(num_residual_blocks=1, policy=F32_POLICY)
    port.load_state_dict(cyclegan_state_dict_from_flax(
        flat_numpy(variables), port))
    x = resize_cubic_u8(torch.from_numpy(frames), 120, 160)
    np.testing.assert_array_equal(x.numpy(), small)
    got = sim2real_convert.generate(port.eval(), x)
    worst, _, share = _levels(got.numpy(), want)
    assert worst <= 1 and share <= F32_SHARE, (worst, share)
    # the LANCZOS4 upscale of the same generator output is cv2's
    up = np.stack([cv2.resize(img, (640, 480),
                              interpolation=cv2.INTER_LANCZOS4)
                   for img in want])
    np.testing.assert_array_equal(
        resize_lanczos4_u8(torch.from_numpy(want), 480, 640).numpy(), up)
