"""LaneNetLite's train mode on the port against the JAX package, on the
CPU in float32: the train-mode forward (logits, the updated running
statistics) and the parameter gradients against Flax ``apply(train=True,
mutable=["batch_stats"])`` and ``jax.grad``; one ``SupervisedTrainer``
step and one ``MMETrainer`` step against the JAX trainers on JAX's
augmentation draws; the ``--device_cache`` epoch against the per-batch
one through ``cli.train --arch lite``.

The student is small: stem (8, 16), body ((16, 1), (16, 2), (24, 1)), so
one dilated block and one width change (a 1x1 shortcut) are exercised.

Tolerances: the forward at rtol/atol 1e-4 (the convs sum in another
order and batch statistics divide by the batch's spread); running
statistics at 1e-5; gradients at rtol 1e-3, atol 1e-5 of a loss near 1;
the trainer steps as the FC-DenseNet steps are held
(``assert_adam_step_matches``, losses 1e-4, running statistics 1e-4);
the cached epoch against the per-batch one bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_simreal_tree, write_split
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, flat_numpy,
                               jax_augment_draws, jax_variables, load_port,
                               nchw_to_nhwc, nhwc_to_nchw, torch_grad_like,
                               unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.lanenet_lite import \
    LaneNetLite as JaxLite
from sim2real_lane_segment_tpu_torch.cli import train as train_cli
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import LaneNetLite
from sim2real_lane_segment_tpu_torch.models.tiramisu import (
    apply_batch_stats, draw_drop_masks, dropout_sites)
from sim2real_lane_segment_tpu_torch.train.checkpoint import load_train_state
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer
from sim2real_lane_segment_tpu_torch.train.supervised import \
    SupervisedTrainer

SMALL = dict(stem=(8, 16), body=((16, 1), (16, 2), (24, 1)))
H, W, B = 16, 24, 2


def small_pair(h, w, seed):
    jm = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    flat = jax_variables(jm, (1, h, w, 3), seed=seed)
    pm = load_port(LaneNetLite(4, policy=F32_POLICY, **SMALL), flat)
    return jm, flat, pm


@pytest.mark.parametrize("size", [(24, 32), (25, 33)])
def test_train_forward_stats_and_grads_match_flax(size):
    """Odd sizes keep the stride-2 stem's asymmetric SAME padding in the
    train path.  The loss is sum(logits * r) / n for a fixed r, so every
    gradient is a real one."""
    h, w = size
    jm, flat, pm = small_pair(h, w, seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, h, w, 3)).astype(np.float32)
    v = unflatten(flat)
    out_shape = jm.apply(v, x, train=False, use_softmax=False).shape
    r = rng.normal(size=out_shape).astype(np.float32)

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, x,
                            train=True, use_softmax=False,
                            mutable=["batch_stats"])
        return jnp.sum(out * r) / r.size, (out, mut["batch_stats"])

    (_, (ref, new_bs)), grads = jax.value_and_grad(jloss, has_aux=True)(
        v["params"])

    before = {k: t.clone() for k, t in pm.state_dict().items()}
    out, updates = pm(nhwc_to_nchw(x), train=True, use_softmax=False)
    np.testing.assert_allclose(nchw_to_nhwc(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    loss = torch.sum(out * nhwc_to_nchw(r)) / r.size
    got = dict(zip(dict(pm.named_parameters()),
                   torch.autograd.grad(loss, list(pm.parameters()))))
    want = flat_numpy({"params": grads})
    assert len(want) == len(got)
    for path, arr in want.items():
        key, g_ref = torch_grad_like(path, arr)
        np.testing.assert_allclose(got[key].numpy(), g_ref, rtol=1e-3,
                                   atol=1e-5, err_msg=path)
    # the running statistics are returned, not written
    assert all(torch.equal(before[k], t)
               for k, t in pm.state_dict().items())
    assert len(updates) == len(flat_numpy({"batch_stats": new_bs})) // 2
    apply_batch_stats(pm, updates)
    assert_batch_stats_match(pm, new_bs, atol=1e-5)


def test_lite_has_no_dropout_sites():
    pm = LaneNetLite(4, **SMALL)
    assert dropout_sites(pm) == []
    flat = draw_drop_masks(torch.Generator().manual_seed(0), pm, 4)
    assert flat.numel() == 0


# -- the trainers' steps against JAX ----------------------------------------

def _batches(seed, src):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (B, *src, 3), dtype=np.uint8),
            rng.integers(0, 4, (B, *src), dtype=np.uint8),
            rng.integers(0, 255, (B, *src, 3), dtype=np.uint8))


@pytest.mark.parametrize("augment", [False, True])
def test_supervised_step_matches_jax(augment):
    """One AdamW step of the JAX ``SupervisedTrainer.train_step`` (its
    ``split(key)``: augmentation, then a dropout key LaneNetLite does not
    use) against the port's on JAX's augmentation draws."""
    from sim2real_lane_segment_tpu.train.supervised import \
        SupervisedTrainer as JaxTrainer

    jm, flat, pm = small_pair(H, W, seed=11)
    images, labels, _ = _batches(12, (20, 28) if augment else (H, W))
    key = jax.random.key(13)
    lr = 1e-3
    jt = JaxTrainer(num_cls=4, height=H, width=W, augment=augment, model=jm)
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state, logs = jax.device_get(jt.train_step(
        state, jnp.asarray(images), jnp.asarray(labels), key,
        jnp.float32(lr)))

    trainer = SupervisedTrainer(num_cls=4, height=H, width=W, model=pm,
                                augment=augment, device="cpu")
    k_aug, _ = jax.random.split(key)
    draws = jax_augment_draws(k_aug, B, trainer.cfg) if augment else None
    got = trainer.train_step(images, labels, lr, draws=draws)
    for k in ("tr_loss", "tr_acc"):
        np.testing.assert_allclose(float(got[k]), float(logs[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert_adam_step_matches(pm, trainer.opt.mu, new_state.params,
                             new_state.opt_state[0].mu, lr)
    assert_batch_stats_match(pm, new_state.batch_stats)


def test_mme_step_matches_jax():
    """One MME step (phase G through featureExtractor -> grad_reverse ->
    classifier, then phase F), both batches augmented on JAX's
    ``split(key, 4)`` draws, against the JAX ``MMETrainer``."""
    from sim2real_lane_segment_tpu.train.mme import MMETrainer as JaxMME

    jm, flat, pm = small_pair(H, W, seed=21)
    batches = _batches(22, (20, 28))
    key = jax.random.key(23)
    lrs = (3e-3, 1e-2, 1e-3)
    jt = JaxMME(num_cls=4, height=H, width=W, augment=True, model=jm)
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state, logs = jax.device_get(jt.mme_train_step(
        state, *(jnp.asarray(a) for a in batches), key,
        *(jnp.float32(lr) for lr in lrs)))

    trainer = MMETrainer(num_cls=4, height=H, width=W, model=pm,
                         augment=True, device="cpu")
    k_aug_l, k_aug_u, _, _ = jax.random.split(key, 4)
    got = trainer.mme_train_step(
        *batches, *lrs, draws_l=jax_augment_draws(k_aug_l, B, trainer.cfg),
        draws_u=jax_augment_draws(k_aug_u, B, trainer.cfg))
    for k in ("tr_loss_adent", "tr_loss"):
        np.testing.assert_allclose(float(got[k]), float(logs[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    trace = dict(zip(dict(pm.named_parameters()), trainer.opt_g.trace))
    for path, arr in flat_numpy({"params": new_state.opt_state_g[1].trace}
                                ).items():
        key_t, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(trace[key_t].numpy(), want, atol=5e-5,
                                   rtol=5e-3, err_msg=path)
    assert_adam_step_matches(pm, trainer.opt.mu, new_state.params,
                             new_state.opt_state_f[0].mu, lrs[2])
    assert_batch_stats_match(pm, new_state.batch_stats)


def test_pallas_train_stays_fcdensenet_only():
    with pytest.raises(NotImplementedError, match="FCDenseNet"):
        SupervisedTrainer(model=LaneNetLite(4, **SMALL), pallas_train=True,
                          device="cpu")


# -- the --device_cache epoch ------------------------------------------------

def _cli_args(regime, root, out, *extra):
    return ["--trainType", regime, "--dataPath", root, "--arch", "lite",
            "--max_epochs", "2", "-b", "2", "--height", "24", "--width",
            "32", "--default_root_dir", out, "--log_every", "1",
            "--model_name", regime, "--augment", *extra]


@pytest.mark.parametrize("regime", ["sim", "mme"])
def test_cached_epochs_repeat_the_per_batch_ones(tmp_path, regime):
    """``cli.train --arch lite --device_cache`` runs its epochs through
    ``run_scan_chunk`` and repeats the uncached run bit for bit: every
    logged row and the final weights and running statistics."""
    rng = np.random.default_rng(31)
    extra = []
    if regime == "sim":
        root = str(tmp_path / "sim")
        for split, n in (("train", 5), ("valid", 3), ("test", 3)):
            write_split(os.path.join(root, split), n, rng, h=24, w=32)
    else:
        root = make_simreal_tree(tmp_path, rng, n_source=3, n_target=2,
                                 n_unlabelled=6, n_test=2)
        base = str(tmp_path / "base")
        torch.save(LaneNetLite(4).state_dict(), base + ".pt")
        extra = ["--pretrained_path", base + ".pt"]
    calls = []
    real = SupervisedTrainer.run_scan_chunk

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    runs = {}
    for cache in (False, True):
        out = str(tmp_path / f"run{int(cache)}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SupervisedTrainer, "run_scan_chunk", spy)
            res = train_cli.main(
                _cli_args(regime, root, out, *extra,
                          *(["--device_cache"] if cache else [])),
                device="cpu")
        runs[cache] = res["out_dir"]
        assert len(calls) == (2 if cache else 0)
    rows = []
    for c in (False, True):
        with open(os.path.join(runs[c], "metrics.jsonl")) as f:
            rows.append(f.read())
    assert rows[0] == rows[1] and "train/" in rows[0]
    want, got = (load_train_state(os.path.join(runs[c], "checkpoints_latest",
                                               "latest.pt"))
                 for c in (False, True))
    for k, t in want["model"].items():
        torch.testing.assert_close(got["model"][k], t, rtol=0, atol=0,
                                   msg=k)
