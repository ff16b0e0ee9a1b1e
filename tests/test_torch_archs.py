"""The archs ``67r`` and ``encdec`` and the two spare losses against the
JAX package.

- ``67r``: FCDenseNet67 with every dense block checkpointed
  (``torch.utils.checkpoint``) equals ``67`` bit for bit (outputs,
  running updates, gradients; the recompute reuses the injected dropout
  masks) and equals JAX's ``FCDenseNet(remat=True)`` (dropout off: Flax
  draws its own masks) at ``GATE``; ``build_model("67r")`` has the Flax
  tree of ``fcdensenet67(remat=True)``.
- ``encdec``: ``EncDecNet``'s parameter counts (tests/test_models.py's
  golden values), eval and train forwards and gradients against JAX's
  ``EncDecNet`` on Flax-imported weights (relu and PReLU), the x2
  bilinear upsample against ``jax.image.resize``, and ``cli.test --arch
  encdec`` on the CPU.
- ``iou_loss_thresholded`` and ``dice_loss`` against JAX's.

Float32 on both sides.  Tolerances: forwards atol/rtol 1e-4, train
outputs, statistics and gradients ``GATE`` (atol 5e-4, rtol 5e-3), the
upsample and the losses 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import (flat_numpy, jax_variables, load_port,
                               nhwc_to_nchw, torch_grad_like, unflatten)
from test_torch_train_model import GATE, _check_port

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models import encdec as jencdec
from sim2real_lane_segment_tpu.models.tiramisu import \
    FCDenseNet as JaxFCDenseNet
from sim2real_lane_segment_tpu.models.tiramisu import \
    fcdensenet67 as jax_fcdensenet67
from sim2real_lane_segment_tpu.train import losses as jlosses
from sim2real_lane_segment_tpu_torch.cli import test as test_cli
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models import encdec
from sim2real_lane_segment_tpu_torch.models import tiramisu
from sim2real_lane_segment_tpu_torch.models.flax_import import _torch_key
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             dropout_sites)
from sim2real_lane_segment_tpu_torch.train import losses

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
            bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)


def n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


# -- 67r -----------------------------------------------------------------------

def test_67r_builds_fcdensenet67_with_remat():
    plain, remat = build_model("67", 4), build_model("67r", 4)
    assert remat.featureExtractor.remat and not plain.featureExtractor.remat
    assert n_params(remat) == n_params(plain) == 3_461_220
    sd = remat.state_dict()
    assert list(sd) == list(plain.state_dict())
    # the Flax tree of fcdensenet67(remat=True) maps onto it leaf for leaf
    shapes = jax.eval_shape(
        lambda: jax_fcdensenet67(4, remat=True).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    flat = flat_numpy(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    for path, arr in flat.items():
        key, convert = _torch_key(path)
        shape = (convert(arr) if convert else arr).shape
        assert tuple(sd[key].shape) == shape, path


def _counting_blocks(monkeypatch):
    calls = []
    real = tiramisu.DenseBlock.forward

    def spy(self, *a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(self, *a, **kw)

    monkeypatch.setattr(tiramisu.DenseBlock, "forward", spy)
    return calls


def test_remat_equals_plain_bit_for_bit_with_masks(monkeypatch):
    """The same masks in both runs; the remat backward recomputes every
    dense block (twice the block calls) and gives the same gradients."""
    torch.manual_seed(0)
    plain = FCDenseNet(**TINY, policy=F32_POLICY)
    remat = FCDenseNet(**TINY, policy=F32_POLICY, remat=True)
    remat.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 3, 24, 32)).astype(np.float32))
    masks = [torch.from_numpy((rng.random((2, c)) > 0.2).astype(np.float32)
                              / 0.8) for c in dropout_sites(plain)]
    calls = _counting_blocks(monkeypatch)
    res = []
    for model in (plain, remat):
        calls.clear()
        out, upd = model(x, train=True, masks=masks)
        (out ** 2).mean().backward()
        res.append((out, upd, [p.grad for p in model.parameters()],
                    len(calls)))
    (o1, u1, g1, n1), (o2, u2, g2, n2) = res
    assert n1 == 5 and n2 == 10  # remat: each block again in the backward
    assert torch.equal(o1, o2)
    assert u1.keys() == u2.keys()
    for k in u1:
        assert all(torch.equal(u1[k][s], u2[k][s]) for s in ("mean", "var"))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_remat_matches_jax_remat():
    """Dropout off (Flax draws its own masks): outputs, running updates and
    gradients of the port's remat model against JAX's ``remat=True``."""
    jax_model = JaxFCDenseNet(**TINY, policy=JAX_F32, remat=True,
                              dropout_rate=0.0)
    flat = jax_variables(jax_model, (2, 24, 32, 3), seed=3)
    x = np.random.default_rng(4).normal(size=(2, 24, 32, 3)).astype(
        np.float32)
    v = unflatten(flat)

    def loss(params):
        out, mut = jax_model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"], use_softmax=False)
        return jnp.mean(out ** 2), (out, mut["batch_stats"])

    (_, (out, bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    ref = (np.transpose(np.asarray(out), (0, 3, 1, 2)),
           flat_numpy({"batch_stats": bs}), flat_numpy({"params": grads}))
    port = load_port(FCDenseNet(**TINY, policy=F32_POLICY, remat=True,
                                dropout_rate=0.0), flat)
    _check_port(port, lambda m, xt: m(xt, train=True, use_softmax=False), x,
                ref)


def test_remat_eval_and_no_grad_forwards_do_not_checkpoint(monkeypatch):
    calls = []
    monkeypatch.setattr(tiramisu, "_remat_block",
                        lambda *a, **kw: calls.append(1))
    model = FCDenseNet(**TINY, remat=True)
    x = torch.zeros(1, 3, 16, 16)
    with torch.no_grad():
        model(x)
        model(x, train=True)
    assert not calls


# -- encdec --------------------------------------------------------------------

@pytest.mark.parametrize("kernel,golden", [(7, 7_237_570), (3, 1_331_650)])
def test_encdec_param_counts(kernel, golden):
    """tests/test_models.py's golden counts, EncDecNet(64, 3, k), 2
    classes; ``build_model("encdec", 4)`` is the k=3 net with 4."""
    assert n_params(encdec.EncDecNet(64, 3, kernel)) == golden
    assert n_params(build_model("encdec", 4)) == 1_331_650 + 2 * 64 + 2


def _encdec_case(activation, dropout=0.0, seed=5):
    kw = dict(n_features=8, n_levels=2, kernel_size=3, activation=activation,
              dropout=dropout, n_classes=4)
    jax_model = jencdec.EncDecNet(**kw, policy=JAX_F32)
    flat = jax_variables(jax_model, (2, 16, 24, 3), seed=seed)
    if activation == "prelu":
        for k in flat:
            if k.endswith("prelu_alpha"):
                flat[k] = np.float32(0.1 + 0.05 * int(k.split("/")[1][-1]))
    port = load_port(encdec.EncDecNet(**kw, policy=F32_POLICY), flat)
    x = np.random.default_rng(seed + 1).normal(
        size=(2, 16, 24, 3)).astype(np.float32)
    return jax_model, flat, port, x


@pytest.mark.parametrize("activation", ["relu", "prelu"])
def test_encdec_eval_matches_jax(activation):
    jax_model, flat, port, x = _encdec_case(activation)
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        unflatten(flat), x)
    with torch.no_grad():
        got = port(nhwc_to_nchw(x))
    assert got.shape == (2, 4, 16, 24)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **TOL)


def test_encdec_train_matches_jax():
    """Dropout off: outputs, running updates and gradients (mean(out**2)
    of the logits)."""
    jax_model, flat, port, x = _encdec_case("relu", seed=7)
    v = unflatten(flat)

    def loss(params):
        out, mut = jax_model.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"], use_softmax=False)
        return jnp.mean(out ** 2), (out, mut["batch_stats"])

    (_, (out, bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    ref = (np.transpose(np.asarray(out), (0, 3, 1, 2)),
           flat_numpy({"batch_stats": bs}), flat_numpy({"params": grads}))
    _check_port(port, lambda m, xt: m(xt, train=True, use_softmax=False), x,
                ref)


def test_encdec_dropout_masks_are_elementwise_operands():
    """One [B, C*h*w] mask per ConvBlock in order; a mask that drops
    everything in the last decoder leaves the classifier's bias alone."""
    model = encdec.EncDecNet(8, 2, 3, n_classes=4, dropout=0.3,
                             policy=F32_POLICY)
    sizes = dropout_sites(model, (16, 24))
    assert sizes == [8 * 16 * 24, 16 * 8 * 12, 16 * 4 * 6, 8 * 8 * 12]
    flat = tiramisu.draw_drop_masks(torch.Generator().manual_seed(0), model,
                                    2, size=(16, 24))
    masks = tiramisu.split_masks(flat, model, 2, (16, 24))
    kept = torch.cat([m.reshape(-1) for m in masks])
    assert set(kept.unique().tolist()) == {0.0, np.float32(1 / 0.7)}
    masks[-1] = torch.zeros_like(masks[-1])
    out, upd = model(torch.randn(2, 3, 16, 24), train=True, masks=masks,
                     use_softmax=False)
    bias = model.classifier.bias.detach()
    torch.testing.assert_close(out, bias[None, :, None, None].expand_as(out))
    assert len(upd) == 4


def test_upsample_matches_jax_resize():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, 5, 7)).astype(np.float32)
    ref = jencdec.upsample_bilinear_2x(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = encdec.upsample_bilinear_2x(torch.from_numpy(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-6)


def test_test_cli_evaluates_encdec(tmp_path, capsys):
    from helpers import write_split

    root = str(tmp_path / "test")
    write_split(root, 3, np.random.default_rng(10), h=24, w=32)
    torch.manual_seed(0)
    weights = str(tmp_path / "encdec.pt")
    torch.save(build_model("encdec", 4).state_dict(), weights)
    res = test_cli.main(["-t", "baseline", "--checkpointPath", weights,
                         "--testDataPath", root, "--arch", "encdec",
                         "--height", "24", "--width", "32"], device="cpu")
    assert int(res["confusion"].sum()) == 3 * 24 * 32
    assert 0.0 <= res["acc"] <= 100.0
    assert "IoU on test set" in capsys.readouterr().out


# -- the spare losses ------------------------------------------------------------

def test_iou_loss_thresholded_matches_jax():
    rng = np.random.default_rng(11)
    a = rng.random((4, 16, 24)) > 0.5
    b = a.copy()
    b[1:] ^= rng.random((3, 16, 24)) > np.array([0.95, 0.7, 0.4])[:, None,
                                                                   None]
    for outs, labs in ((a, b), (a, a), (np.zeros_like(a), np.zeros_like(a))):
        want = float(jlosses.iou_loss_thresholded(jnp.asarray(outs),
                                                  jnp.asarray(labs)))
        got = float(losses.iou_loss_thresholded(torch.from_numpy(outs),
                                                torch.from_numpy(labs)))
        assert got == pytest.approx(want, abs=1e-6)


def test_dice_loss_matches_jax_and_differentiates():
    rng = np.random.default_rng(12)
    pred = rng.random((2, 4, 8, 8)).astype(np.float32)
    target = (rng.random((2, 4, 8, 8)) > 0.5).astype(np.float32)
    want, jgrad = jax.value_and_grad(jlosses.dice_loss)(jnp.asarray(pred),
                                                        jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.dice_loss(p, torch.from_numpy(target))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), atol=1e-6)
