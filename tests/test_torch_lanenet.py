"""The port's LaneNetLite (float eval forward, ``serve_apply``) and its
weight paths (Flax ``.msgpack`` reader, legacy flat layout, the Flax
bridge) against the JAX package, on the CPU in float32.

Inputs come from numpy seeds; weights are Flax-initialized with perturbed
BatchNorm (``test_torch_common``), or the committed trained student
``artifacts/lanenet_lite_sim.msgpack``.
"""
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from test_torch_common import (jax_variables, load_port, nchw_to_nhwc,
                               nhwc_to_nchw, unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.lanenet_lite import \
    LaneNetLite as JaxLite
from sim2real_lane_segment_tpu.models.lanenet_lite import \
    serve_apply as jax_serve_apply
from sim2real_lane_segment_tpu.ops.augment import AugmentConfig as JaxCfg
from sim2real_lane_segment_tpu.ops.augment import eval_batch as jax_eval_batch
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models.flax_import import \
    state_dict_from_flax
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import (LaneNetLite,
                                                                 same_pad,
                                                                 serve_apply)
from sim2real_lane_segment_tpu_torch.ops.augment import AugmentConfig
from sim2real_lane_segment_tpu_torch.train.checkpoint import (
    flatten, load_weights, read_msgpack, remap_legacy_flat)

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "lanenet_lite_sim.msgpack")
SMALL = dict(stem=(8, 16), body=((16, 1), (16, 2), (32, 4)))
# float32 on both sides; the convs and BatchNorm sum in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def small_pair(h, w, seed=3):
    jm = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    flat = jax_variables(jm, (1, h, w, 3), seed=seed)
    pm = load_port(LaneNetLite(4, policy=F32_POLICY, **SMALL), flat)
    return jm, unflatten(flat), pm


@pytest.mark.parametrize("size", [(24, 32), (25, 33)])
@pytest.mark.parametrize("use_softmax", [False, True])
def test_forward_matches_flax(size, use_softmax):
    """Odd sizes exercise the asymmetric SAME padding of the stride-2
    stem: 25x33 -> 13x17 -> 7x9 -> 28x36 out."""
    h, w = size
    jm, var, pm = small_pair(h, w)
    x = np.random.default_rng(1).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(var, x, train=False, use_softmax=use_softmax))
    with torch.no_grad():
        out = nchw_to_nhwc(pm(nhwc_to_nchw(x), use_softmax=use_softmax))
    stem_out = [-(-(-(-n // 2)) // 2) for n in size]
    assert out.shape == ref.shape == (2, stem_out[0] * 4, stem_out[1] * 4, 4)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("size", [(24, 32), (25, 33)])
def test_serve_apply_matches_jax(size):
    """uint8 frames -> class maps: equal maps, float32 on both sides."""
    h, w = size
    jm, var, pm = small_pair(h, w, seed=5)
    u8 = np.random.default_rng(2).integers(0, 255, (3, h, w, 3),
                                           dtype=np.uint8)
    ref = np.asarray(jax_serve_apply(jm, var, u8, cfg=JaxCfg(height=h,
                                                             width=w)))
    out = serve_apply(pm, torch.from_numpy(u8), AugmentConfig(height=h,
                                                              width=w))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_same_pad_is_asymmetric_for_strided_convs():
    assert same_pad(120, 3, 2, 1) == (0, 1)
    assert same_pad(25, 3, 2, 1) == (1, 1)
    assert same_pad(30, 3, 1, 4) == (4, 4)
    assert same_pad(30, 1, 1, 1) == (0, 0)


@pytest.fixture(scope="module")
def trained():
    """The committed student on both sides: the JAX tree re-nested as
    tests/test_lanenet_int8.py does, the port through its own reader."""
    with open(ART, "rb") as f:
        d = serialization.msgpack_restore(f.read())
    variables = {
        "params": {"featureExtractor": {k: v for k, v in d["params"].items()
                                        if k != "head"},
                   "classifier": {"head": d["params"]["head"]}},
        "batch_stats": {"featureExtractor": d["batch_stats"]}}
    model = load_weights(ART, build_model("lite", 4, F32_POLICY))
    return JaxLite(n_classes=4, policy=JAX_F32), variables, model.eval()


def test_committed_student_matches_flax(trained):
    """Full width (751,844 values) on 2 frames at 120x160."""
    jm, var, pm = trained
    u8 = np.random.default_rng(4).integers(0, 255, (2, 120, 160, 3),
                                           dtype=np.uint8)
    x = np.asarray(jax_eval_batch(u8, None, JaxCfg(), with_labels=False)[0])
    ref = np.asarray(jm.apply(var, x, train=False, use_softmax=False))
    with torch.no_grad():
        out = nchw_to_nhwc(pm(nhwc_to_nchw(x), use_softmax=False))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.9999
    n_params = sum(p.numel() for p in pm.parameters())
    n_stats = sum(b.numel() for k, b in pm.state_dict().items()
                  if k.endswith(("running_mean", "running_var")))
    assert (n_params, n_params + n_stats) == (749_860, 751_844)


def test_msgpack_reader_matches_flax():
    with open(ART, "rb") as f:
        blob = f.read()
    ours = flatten(read_msgpack(blob))
    ref = traverse_util.flatten_dict(serialization.msgpack_restore(blob),
                                     sep="/")
    assert set(ours) == set(ref) and len(ours) == 64
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and np.array_equal(ours[k], v), k


def test_msgpack_reader_scalars_and_containers():
    tree = {"i": 7, "neg": -300, "big": 2 ** 40, "f": 1.25, "none": None,
            "t": True, "s": "x" * 40, "l": [1, -2, 3.5],
            "nested": {"a": np.arange(6, dtype=np.int8).reshape(2, 3),
                       "s": np.float32(2.5)}}
    out = read_msgpack(serialization.msgpack_serialize(tree))
    arr = out["nested"].pop("a")
    assert arr.dtype == np.int8 and arr.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["nested"]["s"] == np.float32(2.5)
    assert {k: v for k, v in out.items() if k != "nested"} == {
        k: v for k, v in tree.items() if k != "nested"}
    with pytest.raises(ValueError, match="trailing"):
        read_msgpack(serialization.msgpack_serialize(tree) + b"\x00")


def test_nested_msgpack_and_legacy_layout_load_alike(tmp_path):
    """The same weights saved nested (today's Flax layout) and flat (the
    legacy layout) load to the same state dict; an unrelated layout is
    refused."""
    jm = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    variables = jax.device_get(jm.init(jax.random.key(0),
                                       np.zeros((1, 24, 32, 3), np.float32)))
    nested = tmp_path / "nested.msgpack"
    nested.write_bytes(serialization.to_bytes(variables))
    legacy = {c: {k: v for sub in variables[c].values() for k, v in
                  sub.items()} for c in variables}
    flat_path = tmp_path / "legacy.msgpack"
    flat_path.write_bytes(serialization.msgpack_serialize(legacy))
    a = load_weights(str(nested), LaneNetLite(4, **SMALL)).state_dict()
    b = load_weights(str(flat_path), LaneNetLite(4, **SMALL)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    flat = flatten(legacy)
    assert remap_legacy_flat(flat, LaneNetLite(4, **SMALL)) is not None
    flat["params/Unknown_0/kernel"] = np.zeros(1)
    assert remap_legacy_flat(flat, LaneNetLite(4, **SMALL)) is None


def test_flax_bridge_maps_shortcut_and_head():
    jm = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    flat = jax_variables(jm, (1, 24, 32, 3), seed=9)
    sd = state_dict_from_flax(flat, LaneNetLite(4, **SMALL))
    k = flat["params/featureExtractor/ResBlock_2/Conv_1/kernel"]
    np.testing.assert_array_equal(
        sd["featureExtractor.ResBlock_2.Conv_1.weight"].numpy(),
        k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["classifier.head.bias"].numpy(),
                                  flat["params/classifier/head/bias"])
    assert sd["classifier.head.weight"].shape == (4, 32, 1, 1)


def test_lite_train_mode_returns_outputs_and_updates():
    """Train mode (formerly refused) returns the output and the running
    updates of every BatchNorm, written nowhere; the eval forward is
    unchanged by it.  ``tests/test_torch_lanenet_train.py`` holds its
    values against Flax."""
    _, _, pm = small_pair(24, 32)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, 24, 32)).astype(np.float32))
    before = pm(x)
    out, updates = pm(x, train=True)
    assert out.shape == before.shape == (2, 4, 24, 32)
    bns = {n for n, m in pm.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    assert set(updates) == bns and len(bns) == 2 + 2 * 3
    torch.testing.assert_close(pm(x), before, rtol=0, atol=0)
    torch.testing.assert_close(out.sum(1), torch.ones(2, 24, 32))
