"""The port's losses, metrics, schedule, samplers, AdamW and supervised
train step against the JAX package, on the same inputs.

Exact where JAX is exact (sampler indices, metric counts); losses and
metrics at float32 rounding; AdamW against optax at atol 1e-6; one train
step of the tiny FC-DenseNet against ``SupervisedTrainer(pallas_train=
True, augment=False).train_step`` at atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import (flat_numpy, jax_drop_masks, jax_variables,
                               load_port, torch_grad_like, unflatten)

from sim2real_lane_segment_tpu.data import samplers as jsamplers
from sim2real_lane_segment_tpu.ops import metrics as jmetrics
from sim2real_lane_segment_tpu.train import losses as jlosses
from sim2real_lane_segment_tpu.train import optim as joptim
from sim2real_lane_segment_tpu.train.schedules import \
    cosine_annealing as jcosine
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import samplers
from sim2real_lane_segment_tpu_torch.models.tiramisu import dropout_sites
from sim2real_lane_segment_tpu_torch.ops import metrics
from sim2real_lane_segment_tpu_torch.train import losses
from sim2real_lane_segment_tpu_torch.train.optim import AdamW
from sim2real_lane_segment_tpu_torch.train.schedules import cosine_annealing
from sim2real_lane_segment_tpu_torch.train.supervised import SupervisedTrainer


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


@pytest.mark.parametrize("absent", [False, True])
def test_losses_match_jax(absent):
    rng = np.random.default_rng(1)
    out = rng.normal(size=(2, 6, 7, 4)).astype(np.float32)
    y = rng.integers(0, 4, (2, 6, 7)).astype(np.int32)
    if absent:
        y[y == 2] = 0  # an absent class gets weight 0
    np.testing.assert_array_equal(
        losses.get_class_weight(torch.from_numpy(y), 4).numpy(),
        np.asarray(jlosses.get_class_weight(y, 4)))
    for fn in ("cross_entropy", "weighted_cross_entropy"):
        args = (4,) if fn == "weighted_cross_entropy" else ()
        want = float(getattr(jlosses, fn)(out, y, *args))
        got = float(getattr(losses, fn)(_nchw(out), torch.from_numpy(y),
                                        *args))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 4 - seed, (3, 5, 6))  # seed 1: top class absent
    target = rng.integers(0, 4 - seed, (3, 5, 6))
    pt, tt = torch.from_numpy(pred), torch.from_numpy(target)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(pt, tt, 4).numpy(),
        np.asarray(jmetrics.confusion_matrix(pred, target, 4)))
    for fn in ("iou", "dice_score"):
        np.testing.assert_allclose(
            float(getattr(metrics, fn)(pt, tt, 4)),
            float(getattr(jmetrics, fn)(pred, target, 4)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics.accuracy(pt, tt)),
                               float(jmetrics.accuracy(pred, target)))
    probas = rng.random((3, 5, 6, 4)).astype(np.float32)
    outs_j = [jmetrics.evaluate_outputs(probas, target, jnp.float32(0.5), 4)]
    outs_t = [metrics.evaluate_outputs(_nchw(probas), tt,
                                       torch.tensor(0.5), 4)]
    want = jmetrics.summarize_weighted(outs_j * 2)
    got = metrics.summarize_weighted(outs_t * 2)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_cosine_annealing_matches_jax():
    for epoch in range(0, 80, 7):
        assert cosine_annealing(1e-3, 1e-6, 25, epoch) == \
            jcosine(1e-3, 1e-6, 25, epoch)


@pytest.mark.parametrize("n,shards,batch", [(37, 1, 4), (50, 3, 5)])
def test_samplers_bit_equal(n, shards, batch):
    for epoch in range(3):
        idx = samplers.shuffle_epoch(n, 42, epoch)
        np.testing.assert_array_equal(idx,
                                      jsamplers.shuffle_epoch(n, 42, epoch))
        for s in range(shards):
            a = samplers.shard(idx, s, shards, batch)
            np.testing.assert_array_equal(a, jsamplers.shard(idx, s, shards,
                                                             batch))
            for drop in (True, False):
                for x, y in zip(samplers.batched(a, batch, drop),
                                jsamplers.batched(a, batch, drop),
                                strict=True):
                    np.testing.assert_array_equal(x, y)


def test_adamw_matches_optax():
    rng = np.random.default_rng(2)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    tx = joptim.adamw(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(params)
    ports = [torch.from_numpy(p0[k].copy()) for k in ("a", "b")]
    opt = AdamW(ports, 1e-3)
    for step in range(6):
        lr = 1e-2 / (step + 1)  # a different rate every step
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p0.items()}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, params)
        params = joptim.apply_updates(params, updates, lr)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")], lr)
        for k, t in zip(("a", "b"), ports):
            np.testing.assert_allclose(t.numpy(), params[k], atol=1e-6,
                                       rtol=0)


def test_train_step_matches_jax_supervised_trainer():
    """One step, pallas_train on both sides: JAX interpret-mode kernels,
    the port's fused path through the plain kernel versions.  Gradients
    are read back from the first Adam moment (mu = 0.1 g).  A gradient
    that is zero in exact arithmetic (a bias whose output only feeds
    BatchNorm) is float noise on both sides, and Adam turns it into a step
    of up to lr of either sign: such elements are held to |dp| <= 2 lr."""
    from sim2real_lane_segment_tpu.train.supervised import \
        SupervisedTrainer as JaxTrainer
    from sim2real_lane_segment_tpu.train.supervised import TrainState

    h, w, b, lr = 16, 24, 2, 1e-3
    jax_model = tiny_model()
    flat = jax_variables(jax_model, (b, h, w, 3), seed=11)
    rng = np.random.default_rng(12)
    images = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (b, h, w), dtype=np.uint8)
    key = jax.random.key(13)

    jt = JaxTrainer(num_cls=4, height=h, width=w, augment=False,
                    model=jax_model, pallas_train=True)
    assert jt.pallas_train
    v = unflatten(flat)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jt.tx.init(v["params"]))
    new_state, logs = jt.train_step(state, jnp.asarray(images),
                                    jnp.asarray(labels), key,
                                    jnp.float32(lr))
    new_state, logs = jax.device_get((new_state, logs))

    model = load_port(build_model("tiny", 4, F32_POLICY), flat)
    trainer = SupervisedTrainer(num_cls=4, height=h, width=w, model=model,
                                pallas_train=True, device="cpu")
    assert trainer.pallas_train
    masks = jax_drop_masks(jax.random.split(key)[1], dropout_sites(model),
                           model.dropout_rate, b)
    p_old = {k: p.detach().clone() for k, p in model.named_parameters()}
    got = trainer.train_step(images, labels, lr, masks=masks)
    np.testing.assert_allclose(float(got["tr_loss"]), float(logs["tr_loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(got["tr_acc"]), float(logs["tr_acc"]),
                               atol=1e-4)

    named = dict(model.named_parameters())
    mu = dict(zip(named, trainer.opt.mu))
    mu_ref = flat_numpy({"params": new_state.opt_state[0].mu})
    new_params = flat_numpy({"params": new_state.params})
    assert len(new_params) == len(named)
    for path, arr in new_params.items():
        key_t, want = torch_grad_like(path, arr)
        _, g_ref = torch_grad_like(path, mu_ref[path] / 0.1)
        g = mu[key_t].numpy() / 0.1
        np.testing.assert_allclose(g, g_ref, atol=5e-4, rtol=5e-3,
                                   err_msg=path)
        p = named[key_t].detach().numpy()
        real = np.abs(g_ref) > 1e-5
        np.testing.assert_allclose(p[real], want[real], atol=1e-4,
                                   err_msg=path)
        step = np.abs(p - p_old[key_t].numpy())
        assert (step[~real] <= 2 * lr).all(), path
    bs = flat_numpy({"batch_stats": new_state.batch_stats})
    for path, arr in bs.items():
        key_t, _ = torch_grad_like(path, arr)
        np.testing.assert_allclose(model.state_dict()[key_t].numpy(), arr,
                                   atol=1e-4, err_msg=path)


def test_train_entry_points_need_a_card_unless_cpu(monkeypatch):
    from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SupervisedTrainer, MMETrainer):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(model=build_model("tiny", 4), augment=True)
        trainer = cls(model=build_model("tiny", 4), augment=True,
                      device="cpu")
        assert trainer.augment and trainer.device.type == "cpu"


def test_pallas_train_never_falls_back_to_the_plain_step():
    """``pallas_train`` is kept as given: a model the fused path cannot
    take raises instead of training through the plain step."""
    from sim2real_lane_segment_tpu_torch.models.tiramisu import FCDenseNet

    with pytest.raises(NotImplementedError, match="FCDenseNet"):
        SupervisedTrainer(model=torch.nn.Conv2d(3, 4, 1), pallas_train=True,
                          device="cpu")
    model = FCDenseNet(n_classes=4, down_blocks=(1,), up_blocks=(1,),
                       bottleneck_layers=1, growth_rate=4,
                       out_chans_first_conv=8, kernel_size=3)
    trainer = SupervisedTrainer(num_cls=4, height=8, width=8, model=model,
                                pallas_train=True, device="cpu")
    assert trainer.pallas_train
    images = np.zeros((2, 8, 8, 3), np.uint8)
    labels = np.zeros((2, 8, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="1x1 classifier"):
        trainer.train_step(images, labels, 1e-3)
