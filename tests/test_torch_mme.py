"""The port's ``st`` and ``mme`` regimes against the JAX package's: the
two-domain samplers and data modules (bit-equal), ``adentropy``,
``SGDNesterov`` against optax, ``grad_reverse``, one MME step on the fused
and the plain route, and the train and test CLIs on the CPU.

Tolerances: samplers, modules and confusion matrices exact; losses at
float32 rounding (1e-6); SGD against optax at atol 1e-6; the MME step's
losses at 1e-4, SGD momentum (phase G's gradient plus decay) at atol 5e-5,
Adam's first moment and the parameters as in ``test_torch_train_steps.py``
(``assert_adam_step_matches``), running statistics at atol 1e-4.
"""
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_simreal_tree, tiny_model, write_split
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, flat_numpy,
                               jax_augment_draws, jax_drop_masks,
                               jax_variables, load_port, torch_grad_like,
                               unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.data import modules as jmodules
from sim2real_lane_segment_tpu.data import samplers as jsamplers
from sim2real_lane_segment_tpu.models.tiramisu import FCDenseNet as JaxNet
from sim2real_lane_segment_tpu.train import losses as jlosses
from sim2real_lane_segment_tpu.train import optim as joptim
from sim2real_lane_segment_tpu_torch.cli import test as test_cli
from sim2real_lane_segment_tpu_torch.cli import train as train_cli
from sim2real_lane_segment_tpu_torch.cli.test import (build_model,
                                                      load_trainer_and_state)
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import modules, samplers
from sim2real_lane_segment_tpu_torch.data.png import read_png
from sim2real_lane_segment_tpu_torch.models.flax_import import _torch_key
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             dropout_sites,
                                                             grad_reverse)
from sim2real_lane_segment_tpu_torch.train import mme as port_mme
from sim2real_lane_segment_tpu_torch.train.losses import adentropy
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer
from sim2real_lane_segment_tpu_torch.train.optim import (SGDNesterov,
                                                         lr_factors)

H, W, B = 16, 24, 2
TINY = dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
            bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)


# -- samplers and data modules ---------------------------------------------

@pytest.mark.parametrize("n_src,n_tgt,n_unl", [(8, 4, 16), (30, 10, 50),
                                               (5, 1, 7)])
def test_two_domain_samplers_bit_equal(n_src, n_tgt, n_unl):
    for epoch in range(3):
        np.testing.assert_array_equal(
            samplers.two_domain_epoch(n_src, n_tgt, 42, epoch),
            jsamplers.two_domain_epoch(n_src, n_tgt, 42, epoch))
        for a, b in zip(samplers.mme_epoch(n_src, n_tgt, n_unl, 7, epoch),
                        jsamplers.mme_epoch(n_src, n_tgt, n_unl, 7, epoch),
                        strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("regime", ["st", "mme"])
def test_two_domain_modules_match_jax(tmp_path, regime):
    root = make_simreal_tree(tmp_path, np.random.default_rng(8), n_source=5,
                             n_target=3, n_unlabelled=9, n_test=3)
    name = {"st": "TwoDomainDataModule",
            "mme": "TwoDomainMMEDataModule"}[regime]
    ours = getattr(modules, name)(root, batch_size=2, seed=3)
    theirs = getattr(jmodules, name)(root, batch_size=2, seed=3)
    ours.setup()
    theirs.setup()
    assert ours.native_size == theirs.native_size
    for epoch in range(2):
        pairs = list(zip(ours.train_batches(epoch),
                         theirs.train_batches(epoch), strict=True))
        assert len(pairs) == 4
        for a, b in pairs:
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b), strict=True):
                np.testing.assert_array_equal(x, y)
    for split in ("val_batches", "test_batches"):
        for a, b in zip(getattr(ours, split)(), getattr(theirs, split)(),
                        strict=True):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_mme_module_requires_enough_unlabelled(tmp_path):
    root = make_simreal_tree(tmp_path, np.random.default_rng(9),
                             n_unlabelled=2)
    with pytest.raises(ValueError, match="unlabelled"):
        modules.TwoDomainMMEDataModule(root, batch_size=4).setup()


# -- MME's parts -------------------------------------------------------------

def test_adentropy_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 5, 6, 4)).astype(np.float32) * 4
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    probs[0, 0, 0] = [1, 0, 0, 0]  # log(0 + 1e-5) stays finite
    want = float(jlosses.adentropy(probs, 0.1))
    got = float(adentropy(torch.from_numpy(
        np.ascontiguousarray(probs.transpose(0, 3, 1, 2))), 0.1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sgd_nesterov_matches_optax():
    """Three steps at a different rate each, with per-leaf factors (0 and
    1, as MME's feature-extractor mask, and 0.5)."""
    rng = np.random.default_rng(11)
    names = ("featureExtractor.a", "classifier.b", "featureExtractor.c")
    p0 = {n: rng.normal(size=s).astype(np.float32)
          for n, s in zip(names, [(5, 3), (4,), (2, 2)])}
    factor = {"featureExtractor.a": 1.0, "classifier.b": 0.0,
              "featureExtractor.c": 0.5}
    tx = joptim.sgd_nesterov(1e-3)
    params = {n: jnp.asarray(v) for n, v in p0.items()}
    facs = {n: jnp.float32(factor[n]) for n in names}
    state = tx.init(params)
    ports = [torch.from_numpy(p0[n].copy()) for n in names]
    opt = SGDNesterov(ports, 1e-3)
    f = lr_factors([(n, None) for n in names], factor.get)
    assert f == [factor[n] for n in names]
    for step in range(3):
        lr = 1e-1 / (step + 1)
        g = {n: rng.normal(size=v.shape).astype(np.float32)
             for n, v in p0.items()}
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, params)
        params = joptim.apply_updates(params, upd, lr, facs)
        opt.step([torch.from_numpy(g[n]) for n in names],
                 [lr * fi for fi in f])
        for n, t in zip(names, ports):
            np.testing.assert_allclose(t.numpy(), params[n], atol=1e-6,
                                       rtol=0)
    for n, t in zip(names, opt.trace):
        np.testing.assert_allclose(t.numpy(), state[1].trace[n], atol=1e-6)


def test_grad_reverse():
    x = torch.randn(2, 3, requires_grad=True)
    y = grad_reverse(x)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    (g,) = torch.autograd.grad((y * torch.arange(3.0)).sum(), x)
    torch.testing.assert_close(g, -torch.arange(3.0).expand(2, 3))


def test_mme_lrs_and_feature_mask_match_jax():
    from sim2real_lane_segment_tpu.train.mme import MMETrainer as JaxMME

    jt = JaxMME(num_cls=4, height=H, width=W, model=tiny_model())
    state = jt.init_state(jax.random.key(0))
    trainer = MMETrainer(num_cls=4, height=H, width=W,
                         model=build_model("tiny", 4), device="cpu")
    for epoch in (0, 3, 25, 31):
        assert trainer.lrs_at(epoch) == jt.lrs_at(epoch)
    mask = dict(zip(dict(trainer.model.named_parameters()),
                    trainer.lr_mask_fe))
    flat = flat_numpy({"params": state.lr_mask_fe})
    assert len(flat) == len(mask)
    for path, m in flat.items():
        assert mask[_torch_key(path)[0]] == float(m), path


# -- one MME step against JAX -------------------------------------------------

def _jax_step(jax_model, flat, pallas, augment, batches, key, lrs):
    from sim2real_lane_segment_tpu.train.mme import MMETrainer as JaxMME

    jt = JaxMME(num_cls=4, height=H, width=W, augment=augment,
                model=jax_model, pallas_train=pallas)
    assert jt.pallas_train == pallas
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state, logs = jt.mme_train_step(
        state, *(jnp.asarray(a) for a in batches), key,
        *(jnp.float32(lr) for lr in lrs))
    return jt, jax.device_get((new_state, logs))


def _check_step(trainer, model, logs, new_state, lr_f):
    np.testing.assert_allclose(float(logs[1]["tr_loss_adent"]),
                               float(new_state[1]["tr_loss_adent"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(logs[1]["tr_loss"]),
                               float(new_state[1]["tr_loss"]), atol=1e-4,
                               rtol=1e-4)
    state = new_state[0]
    trace = dict(zip(dict(model.named_parameters()), trainer.opt_g.trace))
    for path, arr in flat_numpy({"params": state.opt_state_g[1].trace}
                                ).items():
        key_t, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(trace[key_t].numpy(), want, atol=5e-5,
                                   rtol=5e-3, err_msg=path)
    assert_adam_step_matches(model, trainer.opt.mu, state.params,
                             state.opt_state_f[0].mu, lr_f)
    assert_batch_stats_match(model, state.batch_stats)


def _batches(seed, src=(H, W)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (B, *src, 3), dtype=np.uint8),
            rng.integers(0, 4, (B, *src), dtype=np.uint8),
            rng.integers(0, 255, (B, *src, 3), dtype=np.uint8))


@pytest.mark.parametrize("augment", [False, True])
def test_mme_step_fused_matches_jax(augment, monkeypatch):
    """pallas_train on both sides (JAX interpret-mode kernels, the port's
    plain kernel versions), on JAX's ``split(key, 4)`` draws: augmentation
    of each batch, then each phase's ``_drop_mask`` masks.  Phase G's
    running-statistics update (the first of the step's two) is also held
    against JAX's ``pallas_apply_train(..., reverse_features=True)``."""
    from sim2real_lane_segment_tpu.models.tiramisu_train_pallas import \
        pallas_apply_train

    jax_model = tiny_model()
    flat = jax_variables(jax_model, (B, H, W, 3), seed=31)
    batches = _batches(32, (20, 28) if augment else (H, W))
    key = jax.random.key(33)
    lrs = (3e-3, 1e-2, 1e-3)
    jt, new_state = _jax_step(jax_model, flat, True, augment, batches, key,
                              lrs)

    model = load_port(build_model("tiny", 4, F32_POLICY), flat)
    trainer = MMETrainer(num_cls=4, height=H, width=W, model=model,
                         augment=augment, pallas_train=True, device="cpu")
    k_aug_l, k_aug_u, k_drop_g, k_drop_f = jax.random.split(key, 4)
    sites = dropout_sites(model)
    masks_g, masks_f = (jax_drop_masks(k, sites, model.dropout_rate, B)
                        for k in (k_drop_g, k_drop_f))
    draws = {}
    if augment:
        draws = dict(draws_l=jax_augment_draws(k_aug_l, B, trainer.cfg),
                     draws_u=jax_augment_draws(k_aug_u, B, trainer.cfg))
    stages = []
    real_apply = port_mme.apply_batch_stats

    def spy(m, updates):
        stages.append({k: {s: t.clone() for s, t in v.items()}
                       for k, v in updates.items()})
        real_apply(m, updates)

    monkeypatch.setattr(port_mme, "apply_batch_stats", spy)
    logs = trainer.mme_train_step(*batches, *lrs, masks_g=masks_g,
                                  masks_f=masks_f, **draws)
    assert len(stages) == 2
    _check_step(trainer, model, (None, logs), new_state, lrs[2])

    # phase G's update of the running statistics, alone
    if augment:
        from sim2real_lane_segment_tpu.ops.augment import augment_batch
        x_unl, _ = augment_batch(k_aug_u, batches[2], None, jt.cfg,
                                 with_labels=False)
    else:
        from sim2real_lane_segment_tpu.ops.augment import eval_batch
        x_unl, _ = eval_batch(batches[2], None, jt.cfg, with_labels=False)
    v = unflatten(flat)
    _, bs1 = pallas_apply_train(jax_model, v, x_unl, k_drop_g,
                                reverse_features=True)
    for path, arr in flat_numpy({"batch_stats": bs1}).items():
        key_t, _ = torch_grad_like(path, arr)
        bn, stat = key_t.rsplit(".", 1)
        got = stages[0][bn][{"running_mean": "mean",
                             "running_var": "var"}[stat]]
        np.testing.assert_allclose(got.numpy(), arr, atol=1e-4,
                                   err_msg=path)


def test_mme_step_plain_matches_jax():
    """The plain route (autograd through featureExtractor -> grad_reverse
    -> classifier, then the whole module) against JAX's standard apply,
    with dropout off on both sides (Flax draws its own masks)."""
    jax_model = JaxNet(**TINY, policy=JAX_F32, dropout_rate=0.0)
    flat = jax_variables(jax_model, (B, H, W, 3), seed=41)
    batches = _batches(42)
    lrs = (3e-3, 1e-2, 1e-3)
    _, new_state = _jax_step(jax_model, flat, False, False, batches,
                             jax.random.key(43), lrs)
    model = load_port(FCDenseNet(**TINY, policy=F32_POLICY,
                                 dropout_rate=0.0), flat)
    trainer = MMETrainer(num_cls=4, height=H, width=W, model=model,
                         device="cpu")
    assert not trainer.pallas_train
    logs = trainer.mme_train_step(*batches, *lrs)
    _check_step(trainer, model, (None, logs), new_state, lrs[2])


def test_mme_state_dict_round_trip_and_fresh_optimizers(tmp_path):
    torch.manual_seed(0)
    trainer = MMETrainer(num_cls=4, height=H, width=W,
                         model=build_model("tiny", 4), device="cpu")
    trainer.mme_train_step(*_batches(50), *trainer.lrs_at(0))
    sd = trainer.state_dict()
    assert set(sd["optimizer"]) == {"g", "f"}
    assert sd["optimizer"]["f"]["count"] == 1
    other = MMETrainer(num_cls=4, height=H, width=W,
                       model=build_model("tiny", 4), device="cpu")
    other.load_state_dict(sd)
    for a, b in zip(other.opt_g.trace + other.opt.mu,
                    trainer.opt_g.trace + trainer.opt.mu):
        assert torch.equal(a, b)
    path = str(tmp_path / "w.pt")
    torch.save(trainer.model.state_dict(), path)
    other.from_pretrained(path)
    assert other.opt.count == 0
    assert all(not t.any() for t in other.opt_g.trace + other.opt.mu)
    for a, b in zip(other.model.state_dict().values(),
                    trainer.model.state_dict().values()):
        assert torch.equal(a, b)


# -- the CLIs on the CPU -----------------------------------------------------

def _cli_args(regime, root, out, *extra):
    return ["--trainType", regime, "--dataPath", root, "--arch", "tiny",
            "--max_epochs", "1", "-b", "2", "--height", "24", "--width",
            "32", "--default_root_dir", out, "--log_every", "1",
            "--model_name", regime, *extra]


def test_train_cli_st_then_mme_on_cpu(tmp_path):
    rng = np.random.default_rng(12)
    root = str(tmp_path / "simRealData")
    for split, n in (("source", 3), (os.path.join("target", "train"), 3),
                     (os.path.join("target", "test"), 2)):
        write_split(os.path.join(root, split), n, rng, h=24, w=32)
    write_split(os.path.join(root, "target", "unlabelled"), 6, rng, h=24,
                w=32, with_labels=False)
    out = str(tmp_path / "runs")
    st = train_cli.main(_cli_args("st", root, out, "--augment",
                                  "--pallas_train"), device="cpu")
    weights = os.path.join(st["out_dir"], "best_weights.pt")
    assert os.path.isfile(weights)
    res = train_cli.main(_cli_args("mme", root, out, "--augment",
                                   "--pallas_train", "--pretrained_path",
                                   weights), device="cpu")
    import json
    with open(os.path.join(res["out_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    g = [r["train/tr_loss_adent"] for r in rows if "train/tr_loss" in r]
    f_ = [r["train/tr_loss"] for r in rows if "train/tr_loss" in r]
    assert len(g) == len(f_) == 3 and np.isfinite(g + f_).all()
    ck = torch.load(os.path.join(res["out_dir"], "checkpoints_latest",
                                 "latest.pt"), weights_only=True)
    assert set(ck["optimizer"]) == {"g", "f"}
    trainer = load_trainer_and_state(
        "mme", os.path.join(res["out_dir"], "best_weights.pt"), arch="tiny",
        height=24, width=32, device="cpu")
    assert isinstance(trainer, MMETrainer)


def test_mme_cli_requires_pretrained_path(tmp_path):
    with pytest.raises(SystemExit, match="pretrained_path"):
        train_cli.main(["--trainType", "mme", "--dataPath", str(tmp_path)],
                       device="cpu")


@pytest.mark.parametrize("module_type,fused", [("mme", True),
                                               ("baseline", False)])
def test_test_cli_and_montage_match_jax(tmp_path, module_type, fused, capsys,
                                        monkeypatch):
    """``cli/test.main`` on a tiny tree, against the JAX ``cli/test.main``
    on the same ``.msgpack`` weights (bfloat16 compute, the default):
    metrics at 1e-4, the confusion matrix exact.  The JAX fused forward
    has no bfloat16 product on the CPU, so the port's ``--fused`` is held
    against JAX's plain predictions: another bfloat16 rounding order, so
    at most 1% of the pixels may move to another cell.  Then the sample
    montage (formerly refused): both CLIs draw the same paths, and on
    them, through one fixed ``predict``, the two montages are equal pixel
    for pixel (frames of another size, resized with LANCZOS4)."""
    from flax import serialization

    from sim2real_lane_segment_tpu.cli import test as jtest

    h, w = 24, 32
    root = str(tmp_path / "test")
    write_split(root, 5, np.random.default_rng(13), h=h, w=w)
    flat = jax_variables(tiny_model(), (1, h, w, 3), seed=14)
    path = str(tmp_path / "w.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(unflatten(flat)))
    args = ["-t", module_type, "--checkpointPath", path, "--testDataPath",
            root, "--arch", "tiny", "--batch_size", "2", "--height", str(h),
            "--width", str(w)]
    want = jtest.main(args)
    got = test_cli.main(args + (["--fused"] if fused else []), device="cpu")
    printed = capsys.readouterr().out
    assert printed.count("IoU on test set") == 2
    for k in ("loss", "acc", "dice", "iou"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    assert got["confusion"].sum() == want["confusion"].sum() == 5 * h * w
    moved = np.abs(got["confusion"] - want["confusion"]).sum() // 2
    assert moved <= (0.01 * 5 * h * w if fused else 0), moved

    big = str(tmp_path / "big")
    write_split(big, 4, np.random.default_rng(15), h=45, w=61)
    montage = ["--trainDataPath", os.path.join(big, "input"),
               "--realDataPath", os.path.join(root, "input"), "-c", "3"]
    drawn = {}

    def spy(name, real, lead):
        def f(*a, **kw):
            drawn[name] = a[lead:lead + 2]
            return real(*a, **kw)
        return f

    monkeypatch.setattr(jtest, "sample_montage",
                        spy("jax", jtest.sample_montage, 2))
    monkeypatch.setattr(test_cli, "sample_montage",
                        spy("port", test_cli.sample_montage, 1))
    monkeypatch.chdir(tmp_path)
    jtest.main(args + montage)
    got = test_cli.main(args + montage + (["--fused"] if fused else []),
                        device="cpu")
    assert drawn["port"] == drawn["jax"]
    assert [len(p) for p in drawn["port"]] == [3, 3]
    assert read_png(got["montage"]).shape == (3 * h, 4 * w, 3)

    def fixed(frames):  # class = the green channel's quarter
        return (np.asarray(frames)[..., 1] // 64).astype(np.uint8)

    cfg = types.SimpleNamespace(height=h, width=w)
    jax_png, port_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jtest.sample_montage(types.SimpleNamespace(cfg=cfg), None,
                         *drawn["jax"], jax_png,
                         predict=lambda state, imgs: fixed(imgs))
    test_cli.sample_montage(
        types.SimpleNamespace(cfg=cfg, device=torch.device("cpu")),
        *drawn["port"], port_png,
        predict=lambda imgs: torch.from_numpy(fixed(imgs.numpy())))
    want = cv2.imread(jax_png, cv2.IMREAD_COLOR)
    assert (fixed(want) > 0).any()
    np.testing.assert_array_equal(read_png(port_png), want)
