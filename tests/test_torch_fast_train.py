"""The port's segment-wise FC-DenseNet (``models/tiramisu_fast.py``,
``--fast_train``) against the JAX package's ``models/tiramisu_fast.py``.

Mirrors ``tests/test_tiramisu_fast.py``: ``fast_apply`` against JAX's
``fast_apply`` and the ordinary forward (eval mode, the tiny ladder, the
odd 30x40 ladder, a 3x3 classifier); ``fast_apply_train`` against JAX's
with the JAX path's own dropout masks (``jax_drop_masks``), and with
dropout off: outputs, the running-statistics updates and every parameter
gradient; MME's reversed features; and the trainers' ``fast_train``
steps against JAX's (``SupervisedTrainer`` and ``MMETrainer``), with
``--pallas_train`` taking precedence as in JAX.

Float32 on both sides.  Tolerances: eval outputs atol/rtol 1e-4 (the
per-segment sums reassociate the convs); train outputs, statistics and
gradients at atol 5e-4, rtol 5e-3 (``GATE``, the JAX package's own gate
between its train paths); steps as ``tests/test_torch_mme.py`` states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, flat_numpy,
                               jax_drop_masks, jax_variables, load_port,
                               nhwc_to_nchw, torch_grad_like, unflatten)
from test_torch_mme import B, H, W, _batches, _check_step
from test_torch_train_model import GATE, _check_port, _run_jax

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models import tiramisu_fast as jfast
from sim2real_lane_segment_tpu.models.tiramisu import \
    FCDenseNet as JaxFCDenseNet
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.models import tiramisu_fast as fast
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import LaneNetLite
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             dropout_sites)
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer
from sim2real_lane_segment_tpu_torch.train.supervised import \
    SupervisedTrainer

EVAL_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(n_classes=4, bottleneck_layers=2, growth_rate=4,
            out_chans_first_conv=8)
LADDERS = {
    "tiny_24x32": (dict(down_blocks=(2, 2), up_blocks=(2, 2)), (2, 24, 32)),
    "odd_30x40": (dict(down_blocks=(2, 2, 2), up_blocks=(2, 2, 2)),
                  (1, 30, 40)),
}


def _case(blocks, shape, seed, **kw):
    jax_model = JaxFCDenseNet(**TINY, **blocks, policy=JAX_F32, **kw)
    flat = jax_variables(jax_model, (*shape, 3), seed=seed)
    port = load_port(FCDenseNet(**TINY, **blocks, policy=F32_POLICY, **kw),
                     flat)
    x = np.random.default_rng(seed + 1).normal(
        size=(*shape, 3)).astype(np.float32)
    return jax_model, flat, port, x


# -- eval mode ---------------------------------------------------------------

@pytest.mark.parametrize("ladder", list(LADDERS))
@pytest.mark.parametrize("use_softmax", [False, True])
def test_fast_apply_matches_jax(ladder, use_softmax):
    blocks, shape = LADDERS[ladder]
    jax_model, flat, port, x = _case(blocks, shape, seed=2)
    v = unflatten(flat)
    ref_fast, ref = (np.asarray(a) for a in jax.jit(lambda v, x: (
        jfast.fast_apply(jax_model, v, x, use_softmax=use_softmax),
        jax_model.apply(v, x, train=False, use_softmax=use_softmax)))(v, x))
    with torch.no_grad():
        got = fast.fast_apply(port, nhwc_to_nchw(x), use_softmax=use_softmax)
        plain = port(nhwc_to_nchw(x), use_softmax=use_softmax)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref_fast, **EVAL_TOL)
    np.testing.assert_allclose(got, ref, **EVAL_TOL)
    np.testing.assert_allclose(got, plain.permute(0, 2, 3, 1).numpy(),
                               **EVAL_TOL)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_fast_apply_wide_classifier_kernel():
    blocks = dict(down_blocks=(2,), up_blocks=(2,))
    jax_model, flat, port, x = _case(blocks, (1, 16, 16), seed=6,
                                     kernel_size=3)
    ref = jax.jit(lambda v, x: jfast.fast_apply(jax_model, v, x,
                                                 use_softmax=False))(
        unflatten(flat), x)
    with torch.no_grad():
        got = fast.fast_apply(port, nhwc_to_nchw(x), use_softmax=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), **EVAL_TOL)


# -- train mode --------------------------------------------------------------

def _fast(reverse=False):
    return lambda m, x, masks: fast.fast_apply_train(
        m, x, masks, use_softmax=False, reverse_features=reverse)


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_fast_apply_train_matches_jax_with_dropout(ladder):
    """Outputs, running updates and gradients under mean(out**2), with the
    masks JAX's fold-in key chain draws (rate 0.2)."""
    blocks, (b, h, w) = LADDERS[ladder]
    jax_model, flat, port, x = _case(blocks, (b, h, w), seed=8)
    key = jax.random.key(10)
    ref = _run_jax(jax_model, flat, x, key, jfast.fast_apply_train)
    masks = jax_drop_masks(key, dropout_sites(port), 0.2, b)
    _check_port(port, lambda m, xt: _fast()(m, xt, masks), x, ref)


def test_fast_apply_train_matches_jax_nodropout():
    """``dropout_rate=0``: the JAX gate's deterministic case, and the
    port's plain train forward gives the same."""
    blocks, shape = LADDERS["tiny_24x32"]
    jax_model, flat, port, x = _case(blocks, shape, seed=12,
                                     dropout_rate=0.0)
    ref = _run_jax(jax_model, flat, x, jax.random.key(0),
                   jfast.fast_apply_train)
    _check_port(port, lambda m, xt: _fast()(m, xt, None), x, ref)
    plain = load_port(FCDenseNet(**TINY, **blocks, policy=F32_POLICY,
                                 dropout_rate=0.0), flat)
    _check_port(plain, lambda m, xt: m(xt, train=True, use_softmax=False),
                x, ref)


def test_fast_reverse_features_grads_match_jax():
    """MME's phase G: grad_reverse on every segment entering the head,
    against JAX's ``fast_apply_train(reverse_features=True)`` under the
    adversarial entropy."""
    from sim2real_lane_segment_tpu.train.losses import adentropy as jent
    from sim2real_lane_segment_tpu_torch.train.losses import adentropy

    blocks = dict(down_blocks=(1,), up_blocks=(1,))
    jax_model, flat, port, x = _case(blocks, (2, 8, 16), seed=14,
                                     dropout_rate=0.0)
    v = unflatten(flat)

    def loss(params):
        probs, _ = jfast.fast_apply_train(
            jax_model, {"params": params, "batch_stats": v["batch_stats"]},
            x, jax.random.key(0), reverse_features=True)
        return jent(probs, 0.1)

    grads = flat_numpy({"params": jax.jit(jax.grad(loss))(v["params"])})
    probs, _ = fast.fast_apply_train(port, nhwc_to_nchw(x),
                                     reverse_features=True)
    adentropy(probs, 0.1).backward()
    named = dict(port.named_parameters())
    for path, arr in grads.items():
        key_t, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(named[key_t].grad.numpy(), want,
                                   atol=5e-5, rtol=5e-3, err_msg=path)


# -- the trainers ------------------------------------------------------------

def test_supervised_fast_train_step_matches_jax():
    """One ``train_step`` with ``fast_train`` on both sides (JAX draws its
    masks from ``split(key)``'s dropout key; the port is given them)."""
    from sim2real_lane_segment_tpu.train.supervised import \
        SupervisedTrainer as JaxTrainer

    jax_model = tiny_model()
    flat = jax_variables(jax_model, (B, H, W, 3), seed=20)
    images, labels, _ = _batches(21)
    key, lr = jax.random.key(22), 1e-3
    jt = JaxTrainer(num_cls=4, height=H, width=W, augment=False,
                    model=jax_model, fast_train=True)
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state, logs_ref = jax.device_get(jt.train_step(
        state, jnp.asarray(images), jnp.asarray(labels), key,
        jnp.float32(lr)))

    model = load_port(FCDenseNet(**TINY, down_blocks=(2, 2),
                                 up_blocks=(2, 2), policy=F32_POLICY), flat)
    trainer = SupervisedTrainer(num_cls=4, height=H, width=W, model=model,
                                fast_train=True, device="cpu")
    assert trainer.fast_train and not trainer.pallas_train
    _, k_drop = jax.random.split(key)
    masks = jax_drop_masks(k_drop, dropout_sites(model), 0.2, B)
    logs = trainer.train_step(images, labels, lr, masks=masks)
    np.testing.assert_allclose(float(logs["tr_loss"]),
                               float(logs_ref["tr_loss"]), atol=1e-4,
                               rtol=1e-4)
    assert_adam_step_matches(model, trainer.opt.mu, new_state.params,
                             new_state.opt_state[0].mu, lr)
    assert_batch_stats_match(model, new_state.batch_stats)


def test_mme_fast_train_step_matches_jax():
    from sim2real_lane_segment_tpu.train.mme import MMETrainer as JaxMME

    jax_model = tiny_model()
    flat = jax_variables(jax_model, (B, H, W, 3), seed=30)
    batches = _batches(31)
    key, lrs = jax.random.key(32), (3e-3, 1e-2, 1e-3)
    jt = JaxMME(num_cls=4, height=H, width=W, augment=False,
                model=jax_model, fast_train=True)
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state = jax.device_get(jt.mme_train_step(
        state, *(jnp.asarray(a) for a in batches), key,
        *(jnp.float32(lr) for lr in lrs)))

    model = load_port(FCDenseNet(**TINY, down_blocks=(2, 2),
                                 up_blocks=(2, 2), policy=F32_POLICY), flat)
    trainer = MMETrainer(num_cls=4, height=H, width=W, model=model,
                         fast_train=True, device="cpu")
    _, _, k_drop_g, k_drop_f = jax.random.split(key, 4)
    masks_g, masks_f = (jax_drop_masks(k, dropout_sites(model), 0.2, B)
                        for k in (k_drop_g, k_drop_f))
    logs = trainer.mme_train_step(*batches, *lrs, masks_g=masks_g,
                                  masks_f=masks_f)
    _check_step(trainer, model, (None, logs), new_state, lrs[2])


def test_fast_train_precedence():
    """``--pallas_train`` wins over ``--fast_train``; ``fast_train``
    applies to an FC-DenseNet only (JAX ``train/supervised.py``)."""
    net = FCDenseNet(**TINY, down_blocks=(1,), up_blocks=(1,))
    both = SupervisedTrainer(model=net, fast_train=True, pallas_train=True,
                             device="cpu")
    assert both.pallas_train and not both.fast_train
    lite = SupervisedTrainer(model=LaneNetLite(), fast_train=True,
                             device="cpu")
    assert not lite.fast_train
