"""Port of ``models/tiramisu.py``, the weight bridge and the fused forward,
held against the JAX package on the same weights (Flax variables with
perturbed BatchNorm statistics, crossed as numpy).

Float32 throughout (``F32_POLICY`` on both sides).  Logits at atol=rtol
1e-4: the two frameworks sum the same float32 products in another order,
and the logits carry the x20 of the classifier temperature.
"""
import jax
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import (flat_numpy, jax_variables, load_port,
                               nchw_to_nhwc, nhwc_to_nchw, unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.tiramisu import \
    FCDenseNet as JaxFCDenseNet
from sim2real_lane_segment_tpu.models.tiramisu import \
    TransitionUp as JaxTransitionUp
from sim2real_lane_segment_tpu.models.tiramisu_pallas import pallas_apply
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models.flax_import import \
    state_dict_from_flax
from sim2real_lane_segment_tpu_torch.models.tiramisu import (
    FCDenseNet, TransitionUp, fcdensenet57, fcdensenet67, fcdensenet103)
from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import fused_apply

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("factory,golden", [
    (fcdensenet57, 1_375_444),
    (fcdensenet67, 3_461_220),
    (fcdensenet103, 9_320_292),
])
def test_param_counts(factory, golden):
    model = factory(4)
    assert sum(p.numel() for p in model.parameters()) == golden


def test_feature_channels_67():
    assert fcdensenet67(4).featureExtractor.feature_channels == 288


def test_transition_up_bridge_matches_flax():
    """ConvTranspose HWIO -> IOHW with the spatial flip, then floor
    center-crop and concat, against Flax on odd sizes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    skip = rng.normal(size=(2, 11, 14, 3)).astype(np.float32)
    mod = JaxTransitionUp(features=6, policy=JAX_F32)
    variables = mod.init(jax.random.key(0), x, skip)
    flat = flat_numpy(variables)
    flat["params/ConvTranspose_0/bias"] = rng.normal(size=6).astype(
        np.float32)
    ref = mod.apply(unflatten(flat), x, skip)
    port = load_port(TransitionUp(6, F32_POLICY), flat)
    out = port(nhwc_to_nchw(x), nhwc_to_nchw(skip))
    assert out.shape == (2, 9, 11, 14)
    np.testing.assert_allclose(nchw_to_nhwc(out), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)


def test_bridge_rejects_incomplete_and_mismatched_trees():
    flat = jax_variables(tiny_model(), (1, 24, 32, 3), seed=0)
    model = FCDenseNet(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
                       bottleneck_layers=2, growth_rate=4,
                       out_chans_first_conv=8, policy=F32_POLICY)
    missing = {k: v for k, v in flat.items() if "firstconv" not in k}
    with pytest.raises(KeyError, match="do not cover"):
        state_dict_from_flax(missing, model)
    wrong = dict(flat)
    key = "params/featureExtractor/firstconv/bias"
    wrong[key] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(wrong, model)


def _ladders():
    """(JAX model, port model, input shape): the helpers.tiny_model() shape
    at 24x32, and the odd 30x40 three-level ladder (30->15->7->3 and
    back through 2x+1 transposed convs and floor crops)."""
    kw3 = dict(n_classes=4, down_blocks=(2, 2, 2), up_blocks=(2, 2, 2),
               bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)
    kw2 = dict(kw3, down_blocks=(2, 2), up_blocks=(2, 2))
    return {"tiny24x32": (tiny_model(), FCDenseNet(**kw2, policy=F32_POLICY),
                          (2, 24, 32, 3)),
            "odd30x40": (JaxFCDenseNet(**kw3, policy=JAX_F32),
                         FCDenseNet(**kw3, policy=F32_POLICY),
                         (2, 30, 40, 3))}


@pytest.fixture(scope="module", params=["tiny24x32", "odd30x40"])
def ladder(request):
    jax_model, port_model, shape = _ladders()[request.param]
    flat = jax_variables(jax_model, shape, seed=11)
    x = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    ref = jax.jit(lambda v, xx: jax_model.apply(
        v, xx, train=False, use_softmax=False))(unflatten(flat), x)
    return dict(jax_model=jax_model, flat=flat, x=x,
                ref=np.asarray(ref), port=load_port(port_model, flat))


def _check(out, ref):
    out = nchw_to_nhwc(out)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_plain_module_matches_flax(ladder):
    with torch.no_grad():
        out = ladder["port"](nhwc_to_nchw(ladder["x"]), use_softmax=False)
    _check(out, ladder["ref"])


def test_fused_apply_matches_flax(ladder):
    out = fused_apply(ladder["port"], nhwc_to_nchw(ladder["x"]),
                      use_softmax=False)
    _check(out, ladder["ref"])


def test_fused_apply_softmax(ladder):
    x = nhwc_to_nchw(ladder["x"])
    probs = fused_apply(ladder["port"], x)
    with torch.no_grad():
        ref = ladder["port"](x)
    np.testing.assert_allclose(probs.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(probs.sum(1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("ladder", ["tiny24x32"], indirect=True)
def test_fused_apply_matches_pallas_interpret(ladder):
    """Against the JAX fused forward itself (Pallas interpret mode); 24x32
    only, as interpret mode at 30x40 is one of the JAX suite's slow gates."""
    model = ladder["jax_model"]
    ref = jax.jit(lambda v, xx: pallas_apply(
        model, v, xx, use_softmax=False, interpret=True))(
            unflatten(ladder["flat"]), ladder["x"])
    out = fused_apply(ladder["port"], nhwc_to_nchw(ladder["x"]),
                      use_softmax=False)
    _check(out, np.asarray(ref))


def test_wide_classifier_takes_plain_tail():
    """kernel_size=3 cannot be fused into the kernel: the plain tail runs
    and still matches Flax."""
    kw = dict(n_classes=4, down_blocks=(2,), up_blocks=(2,),
              bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8,
              kernel_size=3)
    jax_model = JaxFCDenseNet(**kw, policy=JAX_F32)
    flat = jax_variables(jax_model, (1, 16, 16, 3), seed=5)
    x = np.random.default_rng(6).normal(size=(1, 16, 16, 3)).astype(
        np.float32)
    ref = jax.jit(lambda v, xx: jax_model.apply(
        v, xx, train=False, use_softmax=False))(unflatten(flat), x)
    port = load_port(FCDenseNet(**kw, policy=F32_POLICY), flat)
    _check(fused_apply(port, nhwc_to_nchw(x), use_softmax=False),
           np.asarray(ref))


def test_train_mode_not_ported():
    model = fcdensenet57(4)
    with pytest.raises(NotImplementedError, match="train"):
        model(torch.zeros(1, 3, 16, 16), train=True)
