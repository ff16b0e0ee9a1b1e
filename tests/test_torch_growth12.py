"""Growth 12 (FCDenseNet57) on the port's tensor-core route, on the CPU.

- The padded weight layout the tensor-core 3x3 kernels read
  (``kernels.dense_block.pad_growth``: a [c, 9, 12] view of [c, 9, 16]
  rows whose columns 12-15 are zero) through the plain versions of K4,
  K1, K3a and K3b equals the unpadded weights exactly, dW included
  (float32: the same products in the same order).
- Where the layout copies make it: ``fold_block_params`` once at fold
  time, ``conv_weight_rows`` in the per-step re-layout, whose backward
  hands the unpadded cotangent back; a bf16 FCDenseNet57 step on padded
  weights equals one on contiguous weights bit for bit.
- FCDenseNet57 itself against the JAX package, F32 policy, weights carried
  across, on 32x32 frames (its five pools): the fused forward
  (``fused_apply``) against the Flax forward, and the ``--pallas_train``
  forward (``fused_apply_train``) with its batch statistics and every
  parameter gradient against the Flax train forward under ``jax.grad``,
  at the JAX package's own gate between its train paths (atol 5e-4, rtol
  5e-3).  Dropout rate 0 on both sides: the Flax forward draws its masks
  from its own generator; the masks' own gates are in
  ``test_torch_train_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (load_port, nchw_to_nhwc, nhwc_to_nchw,
                               perturb_bn, torch_grad_like, unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.tiramisu import \
    FCDenseNet as JaxFCDenseNet
from sim2real_lane_segment_tpu_torch.core.dtypes import (DEFAULT_POLICY,
                                                         F32_POLICY)
from sim2real_lane_segment_tpu_torch.kernels import dense_block as kdb
from sim2real_lane_segment_tpu_torch.kernels import train_block as ktb
from sim2real_lane_segment_tpu_torch.models import tiramisu_train_fused as tf
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             fcdensenet57)
from sim2real_lane_segment_tpu_torch.models.tiramisu_fused import (
    fold_block_params, fused_apply)

GATE = dict(atol=5e-4, rtol=5e-3)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
B, H, W, C, G = 2, 7, 9, 60, 12   # c = 60: no multiple of 8 or of 16


def _rand(gen, *shape, s=1.0):
    return torch.randn(*shape, generator=gen) * s


# ---------------------------------------------------------------------------
# the padded layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_growth_layout(dtype):
    """A [c, 9, g] view of zeroed [c, 9, 16] rows: the values, the strides
    the tensor-core kernels read, zero columns g-15, and slices of rows
    (K3a's y_j rows, K3b's c_in rows) keep the layout."""
    rows = _rand(torch.Generator().manual_seed(0), C, 9, G)
    w = kdb.pad_growth(rows, dtype)
    assert w.shape == (C, 9, G) and w.dtype == dtype
    assert w.stride() == (9 * 16, 16, 1) and kdb.mma_layout(w)
    assert torch.equal(w, rows.to(dtype))
    assert w._base.shape == (C, 9, 16)
    assert not w._base[:, :, G:].any()
    assert kdb.mma_layout(w[24:36]) and kdb.mma_layout(w[:48])
    assert not kdb.mma_layout(rows)
    full = kdb.pad_growth(_rand(torch.Generator(), C, 9, 16), dtype)
    assert full.is_contiguous() and kdb.mma_layout(full)


def test_padded_weights_through_the_plain_versions_are_exact():
    """K4's, K1's, K3a's and K3b's plain versions give the same bits with
    the padded layout as with contiguous weights, dW [c, 9, 12] included
    (float32)."""
    gen = torch.Generator().manual_seed(1)
    c_tot = C + 3 * G
    x = _rand(gen, B, c_tot, H, W)
    x[:, 1] = 0
    ws = [_rand(gen, C + j * G, 9, G, s=0.1) for j in range(3)]
    pads = [kdb.pad_growth(w) for w in ws]
    sc = [torch.rand(C + j * G, generator=gen) + 0.5 for j in range(3)]
    sh = [_rand(gen, C + j * G, s=0.3) for j in range(3)]
    bias = _rand(gen, G, s=0.1)
    mask = (torch.rand(B, G, generator=gen) > 0.3).float() / 0.8
    mask[:, 0] = 0

    def both(fn):
        a, b = fn(ws), fn(pads)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(u, v)

    def k4(w):
        feat = x.clone()
        kdb.dense_layer(feat, kdb.FoldedLayer(sc[0], sh[0], w[0], bias))
        return feat
    both(k4)
    both(lambda w: ktb.consumer_fwd(x, sc[0], sh[0], w[0], bias, mask))
    ext = _rand(gen, B, G, H, W)
    gps = [_rand(gen, B, G, H, W) for _ in range(2)]
    lo = C
    both(lambda w: ktb.stage(x, x[:, lo:lo + G], ext, gps,
                             [w[1][lo:lo + G], w[2][lo:lo + G]], sc[0], sh[0],
                             [sc[1][lo:lo + G], sc[2][lo:lo + G]],
                             [sh[1][lo:lo + G], sh[2][lo:lo + G]], w[0],
                             mask))
    both(lambda w: ktb.final(x, gps + [gps[0]], [v[:C] for v in w],
                             [s[:C] for s in sc], [s[:C] for s in sh]))
    _, dw, *_ = ktb.stage(x, x[:, lo:lo + G], ext, [], [], sc[0], sh[0], [],
                          [], pads[0], mask)
    assert dw.shape == (C, 9, G)


# ---------------------------------------------------------------------------
# where the layout is made
# ---------------------------------------------------------------------------

def test_fold_pads_where_the_tensor_cores_read():
    """``fold_block_params``: FCDenseNet57's bf16 layers in the padded
    layout, its float32 ones (the CUDA-core parity control) contiguous;
    the values are the conv's either way."""
    block = fcdensenet57(4).featureExtractor.denseDown0
    for dtype, padded in ((torch.bfloat16, True), (torch.float32, False)):
        for lay, mod in zip(fold_block_params(block, dtype), block.layers()):
            w = mod.Conv_0.weight.detach()
            ref = w.permute(1, 2, 3, 0).reshape(w.shape[1], 9, 12)
            assert torch.equal(lay.weight, ref.to(dtype))
            assert kdb.mma_layout(lay.weight) is padded
            assert lay.weight.is_contiguous() is not padded


@pytest.mark.parametrize("dtype,growth,padded", [
    (torch.bfloat16, 12, True), (torch.float32, 12, False),
    (torch.bfloat16, 16, False), (torch.bfloat16, 4, False)])
def test_conv_weight_rows_layout_and_gradient(dtype, growth, padded):
    """The per-step re-layout pads exactly where K1, K3a and K3b take the
    tensor cores with growth 12 (16 is padded by nature), and its
    gradient reaches the OIHW weight as the contiguous layout's does."""
    conv = torch.nn.Conv2d(36, growth, 3, padding=1)
    rows = tf.conv_weight_rows(conv, dtype)
    assert rows.shape == (36, 9, growth) and rows.dtype == dtype
    assert (not rows.is_contiguous()) is padded
    assert kdb.mma_layout(rows) is (dtype == torch.bfloat16
                                    and growth in (12, 16))
    cot = _rand(torch.Generator().manual_seed(2), 36, 9, growth).to(dtype)
    (g,) = torch.autograd.grad(rows, conv.weight, cot)
    ref = conv.weight.detach().requires_grad_()
    flat = ref.permute(1, 2, 3, 0).reshape(36, 9, growth).to(dtype)
    (g_ref,) = torch.autograd.grad(flat, ref, cot)
    assert torch.equal(g, g_ref)


def test_bf16_57_step_on_padded_weights_equals_contiguous(monkeypatch):
    """One bf16 FCDenseNet57 train-mode forward and backward through the
    fused kernels' plain versions: padded weights (the tensor-core layout)
    and contiguous ones give the same outputs and gradients bit for bit."""
    torch.manual_seed(3)
    model = fcdensenet57(4, policy=DEFAULT_POLICY)
    x = torch.rand(1, 3, 32, 32)

    def run():
        model.zero_grad()
        out, _ = tf.fused_apply_train(model, x, use_softmax=False)
        (out.float() ** 2).mean().backward()
        return out.detach(), [p.grad.clone() for p in model.parameters()]

    calls = []
    real = tf._PadGrowth.apply

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(tf._PadGrowth, "apply", counting)
    out_p, grads_p = run()
    assert len(calls) == 44 and {s[2] for s in calls} == {12}
    monkeypatch.setattr(tf._PadGrowth, "apply",
                        lambda rows, dtype: rows.to(dtype).contiguous())
    out_c, grads_c = run()
    assert torch.equal(out_p, out_c)
    assert all(torch.equal(a, b) for a, b in zip(grads_p, grads_c))


# ---------------------------------------------------------------------------
# FCDenseNet57 against the JAX package (F32)
# ---------------------------------------------------------------------------

def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.shape
    return out


@pytest.fixture(scope="module")
def fcdn57():
    """The JAX FCDenseNet57 (F32, dropout 0) with seeded weights (He-normal
    kernels, small biases, perturbed BatchNorm: shapes by ``eval_shape``,
    values from numpy), the same weights in the port, and two 32x32
    frames."""
    kw = dict(n_classes=4, down_blocks=(4,) * 5, up_blocks=(4,) * 5,
              bottleneck_layers=4, growth_rate=12, out_chans_first_conv=48)
    jax_model = JaxFCDenseNet(**kw, policy=JAX_F32, dropout_rate=0.0)
    shapes = _flat_shapes(jax.eval_shape(
        jax_model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(57)
    flat = {}
    for k, shape in shapes.items():
        if k.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            flat[k] = rng.normal(0, (2 / fan_in) ** 0.5, shape)
        else:
            flat[k] = rng.normal(0, 0.05, shape)
        flat[k] = flat[k].astype(np.float32)
    flat = perturb_bn(flat, 58)
    port = load_port(FCDenseNet(**kw, policy=F32_POLICY), flat)
    assert sum(p.numel() for p in port.parameters()) == 1_375_444
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return jax_model, flat, port, x


def test_fcdensenet57_fused_forward_matches_jax(fcdn57):
    jax_model, flat, port, x = fcdn57
    ref = jax.jit(lambda v, xx: jax_model.apply(
        v, xx, train=False, use_softmax=False))(unflatten(flat), x)
    out = fused_apply(port, nhwc_to_nchw(x), use_softmax=False)
    np.testing.assert_allclose(nchw_to_nhwc(out), np.asarray(ref), **FWD_TOL)


def test_fcdensenet57_pallas_train_step_matches_jax(fcdn57):
    """``fused_apply_train`` (K1-K3b's plain versions): output, new batch
    statistics and every parameter gradient under mean(out**2)."""
    jax_model, flat, port, x = fcdn57
    v = unflatten(flat)

    def loss(params):
        out, mut = jax_model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, use_softmax=False, mutable=["batch_stats"])
        return jnp.mean(out ** 2), (out, mut["batch_stats"])

    (_, (out_ref, bs_ref)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(v["params"])
    port.zero_grad()
    out, updates = tf.fused_apply_train(port, nhwc_to_nchw(x),
                                        use_softmax=False)
    np.testing.assert_allclose(nchw_to_nhwc(out), np.asarray(out_ref),
                               **GATE)
    bs_flat = _flat_leaves(bs_ref, "batch_stats/")
    assert len(updates) == len(bs_flat) // 2
    for path, arr in bs_flat.items():
        key, _ = torch_grad_like(path, arr)
        mod, leaf = key.rsplit(".", 1)
        got = updates[mod]["mean" if leaf == "running_mean" else "var"]
        np.testing.assert_allclose(got.detach().numpy(), arr, atol=1e-5,
                                   rtol=1e-4, err_msg=path)
    (out ** 2).mean().backward()
    named = dict(port.named_parameters())
    g_flat = _flat_leaves(grads, "params/")
    assert len(g_flat) == len(named)
    for path, arr in g_flat.items():
        key, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(named[key].grad.numpy(), want, **GATE,
                                   err_msg=path)


def _flat_leaves(tree, prefix):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out
