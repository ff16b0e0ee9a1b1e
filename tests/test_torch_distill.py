"""Distillation on the port against the JAX package, on the CPU in
float32: ``train.distill.DistillTrainer`` (``train_step``,
``train_step_unl``, ``eval_step``, ``lr_at``) against the JAX
``DistillTrainer`` on JAX's augmentation draws, ``fit``'s scan rule,
``cli.distill`` into ``cli.serve --arch lite --int8``, and the study's
``--distill`` with its default ``--arch lite``.

The student is a small LaneNetLite (stem (8, 16), body ((16, 1), (16, 2),
(24, 1))), the teacher ``helpers.tiny_model``.  Tolerances: the losses
(``tr_loss``, ``tr_kd``, ``tr_ce``) at 1e-4; Adam's first moment and the
parameters through ``assert_adam_step_matches``; running statistics at
1e-4 (the trainer steps' gates); the eval metrics at 1e-4; ``lr_at``
exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_model, write_split
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, jax_augment_draws,
                               jax_variables, load_port, unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.models.lanenet_lite import \
    LaneNetLite as JaxLite
from sim2real_lane_segment_tpu.train.distill import \
    DistillTrainer as JaxDistill
from sim2real_lane_segment_tpu_torch.cli import distill as distill_cli
from sim2real_lane_segment_tpu_torch.cli import domain_study
from sim2real_lane_segment_tpu_torch.cli import serve as port_serve
from sim2real_lane_segment_tpu_torch.cli.test import build_model
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import modules
from sim2real_lane_segment_tpu_torch.models.lanenet_lite import LaneNetLite
from sim2real_lane_segment_tpu_torch.train import loop
from sim2real_lane_segment_tpu_torch.train.distill import DistillTrainer

SMALL = dict(stem=(8, 16), body=((16, 1), (16, 2), (24, 1)))
H, W, B = 16, 24, 2


def _pair(augment, t_max=25):
    """The JAX trainer and state, and the port's trainer, on the same
    weights (teacher seed 51, student seed 52)."""
    jt_model = tiny_model()
    t_flat = jax_variables(jt_model, (1, H, W, 3), seed=51)
    js_model = JaxLite(n_classes=4, policy=JAX_F32, **SMALL)
    s_flat = jax_variables(js_model, (1, H, W, 3), seed=52)
    tv, sv = unflatten(t_flat), unflatten(s_flat)
    jt = JaxDistill(teacher_model=jt_model, teacher_params=tv["params"],
                    teacher_batch_stats=tv["batch_stats"], num_cls=4,
                    height=H, width=W, augment=augment,
                    student_model=js_model, t_max=t_max)
    state = jt.init_state(jax.random.key(0)).replace(
        params=sv["params"], batch_stats=sv["batch_stats"])
    teacher = load_port(build_model("tiny", 4, F32_POLICY), t_flat)
    student = load_port(LaneNetLite(4, policy=F32_POLICY, **SMALL), s_flat)
    pt = DistillTrainer(teacher=teacher, num_cls=4, height=H, width=W,
                        augment=augment, student_model=student,
                        t_max=t_max, device="cpu")
    return jt, state, pt


def _check(pt, got, new_state, logs, lr):
    for k in ("tr_loss", "tr_kd", "tr_ce"):
        np.testing.assert_allclose(float(got[k]), float(logs[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert_adam_step_matches(pt.student, pt.opt.mu, new_state.params,
                             new_state.opt_state[0].mu, lr)
    assert_batch_stats_match(pt.student, new_state.batch_stats)


def _frames(rng, n, size, labels=True):
    x = rng.integers(0, 255, (n, *size, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (n, *size), dtype=np.uint8)
    return (x, y) if labels else x


@pytest.mark.parametrize("augment", [False, True])
def test_train_step_matches_jax(augment):
    """JAX's ``split(key)``: the augmentation, then a dropout key the
    student does not use."""
    jt, state, pt = _pair(augment)
    rng = np.random.default_rng(53)
    images, labels = _frames(rng, B, (20, 28) if augment else (H, W))
    key, lr = jax.random.key(54), 1e-3
    new_state, logs = jax.device_get(jt.train_step(
        state, jnp.asarray(images), jnp.asarray(labels), key,
        jnp.float32(lr)))
    k_aug, _ = jax.random.split(key)
    draws = jax_augment_draws(k_aug, B, pt.cfg) if augment else None
    got = pt.train_step(images, labels, lr, draws=draws)
    _check(pt, got, new_state, logs, lr)


@pytest.mark.parametrize("augment", [False, True])
def test_train_step_unl_matches_jax(augment):
    """KD over [labelled; unlabelled] in one student forward, CE over the
    labelled rows; JAX's ``split(key, 3)``: the labelled half's draws,
    the unlabelled half's, a dropout key.  The halves differ in size."""
    jt, state, pt = _pair(augment)
    rng = np.random.default_rng(55)
    size = (20, 28) if augment else (H, W)
    images, labels = _frames(rng, B, size)
    unl = _frames(rng, B + 1, size, labels=False)
    key, lr = jax.random.key(56), 2e-3
    new_state, logs = jax.device_get(jt.train_step_unl(
        state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(unl),
        key, jnp.float32(lr)))
    k_l, k_u, _ = jax.random.split(key, 3)
    draws = {}
    if augment:
        draws = dict(draws_l=jax_augment_draws(k_l, B, pt.cfg),
                     draws_u=jax_augment_draws(k_u, B + 1, pt.cfg))
    got = pt.train_step_unl(images, labels, unl, lr, **draws)
    _check(pt, got, new_state, logs, lr)


def test_eval_step_and_lr_at_match_jax():
    jt, state, pt = _pair(False, t_max=10)
    images, labels = _frames(np.random.default_rng(57), 3, (H, W))
    want = jax.device_get(jt.eval_step(state, jnp.asarray(images),
                                       jnp.asarray(labels)))
    got = pt.eval_step(images, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # both sides of t_max: torch's cosine rises again past it
    for epoch in (0, 3, 9, 10, 11, 17, 30):
        assert pt.lr_at(epoch) == jt.lr_at(epoch), epoch
    assert pt.lr_at(15) > pt.lr_at(10)


def test_default_step_fn_dispatches_on_the_batch_form(monkeypatch):
    _, _, pt = _pair(False)
    calls = []
    monkeypatch.setattr(pt, "train_step",
                        lambda *a, **kw: calls.append("lab"))
    monkeypatch.setattr(pt, "train_step_unl",
                        lambda *a, **kw: calls.append("unl"))
    x, y = _frames(np.random.default_rng(58), B, (H, W))
    gen = torch.Generator()
    pt.default_step_fn((x, y), gen, 0)
    pt.default_step_fn(((x, y), x), gen, 0)
    assert calls == ["lab", "unl"]


def test_teacher_is_frozen_and_plain_on_the_cpu():
    _, _, pt = _pair(False)
    assert pt._folded is None
    before = {k: t.clone() for k, t in pt.teacher.state_dict().items()}
    images, labels = _frames(np.random.default_rng(59), B, (H, W))
    pt.train_step(images, labels, 1e-2)
    for k, t in pt.teacher.state_dict().items():
        assert torch.equal(t, before[k]), k
    x = torch.zeros(1, 3, H, W)
    torch.testing.assert_close(pt.teacher_logits(x),
                               pt.teacher(x, use_softmax=False))


# -- the fit loop's scan rule --------------------------------------------------

def test_fit_runs_per_batch_for_a_trainer_without_run_scan_chunk(
        tmp_path, monkeypatch):
    """A cached module offers ``train_scan_inputs``; the distillation
    trainer has no ``run_scan_chunk``, so ``fit`` runs the per-batch loop
    on batches gathered on the device, as JAX's ``fit`` does."""
    rng = np.random.default_rng(60)
    root = str(tmp_path / "sim")
    for split, n in (("train", 5), ("valid", 2), ("test", 2)):
        write_split(os.path.join(root, split), n, rng, h=H, w=W)
    data = modules.SimulatorDataModule(root, batch_size=2, device_cache=True,
                                       device="cpu")
    data.setup()
    assert data.train_scan_inputs(0) is not None
    _, _, pt = _pair(False)
    assert not hasattr(pt, "run_scan_chunk")
    ran = []
    real = loop._run_train_epoch
    monkeypatch.setattr(loop, "_run_train_epoch",
                        lambda *a: ran.append(1) or real(*a))
    monkeypatch.setattr(loop, "_run_train_epoch_scanned",
                        lambda *a: pytest.fail("took the scanned path"))
    loop.fit(pt, data, max_epochs=1, out_dir=str(tmp_path / "out"))
    assert ran == [1]


# -- the CLIs ------------------------------------------------------------------

def test_distill_cli_weights_serve_in_int8(tmp_path):
    """``cli.distill`` from a tiny FC-DenseNet teacher on a tiny tree; its
    ``best_weights.pt`` then loads into ``cli.serve --arch lite --int8``
    (K6's plain version on the CPU)."""
    rng = np.random.default_rng(61)
    root = str(tmp_path / "sim")
    for split, n in (("train", 4), ("valid", 2), ("test", 2)):
        write_split(os.path.join(root, split), n, rng)
    teacher = str(tmp_path / "teacher.pt")
    torch.manual_seed(0)
    torch.save(build_model("tiny", 4).state_dict(), teacher)
    res = distill_cli.main(
        ["--dataPath", root, "--teacherPath", teacher, "--teacher_arch",
         "tiny", "--max_epochs", "1", "-b", "2", "--height", "48",
         "--width", "64", "--augment", "--default_root_dir",
         str(tmp_path / "results")], device="cpu")
    weights = os.path.join(res["out_dir"], "best_weights.pt")
    assert np.isfinite(res["best_iou"]) and os.path.exists(weights)
    with open(os.path.join(res["out_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert "val/iou" in rows[0] and "test/iou" in rows[-1]
    for flags in (["--int8"], ["--int8", "--fused"]):
        predict, h, w = port_serve.build_predict_fn(port_serve.parse_args(
            ["--checkpointPath", weights, "--height", "48", "--width", "64",
             *flags]), device="cpu")
        frames = rng.integers(0, 255, (3, h, w, 3), dtype=np.uint8)
        masks = predict(frames)
        assert masks.shape == (3, 48, 64) and masks.max() < 4


def test_study_distills_students_with_its_default_arch(tmp_path):
    """``cli.domain_study --distill`` with no ``--arch``: LaneNetLite
    trains in each regime (the default) and a student is distilled from
    each, scored on the target test split; a second call resumes without
    training."""
    rng = np.random.default_rng(62)
    for dom in ("sourceData", "targetData"):
        for split, n in (("train", 8), ("valid", 4), ("test", 4)):
            write_split(str(tmp_path / dom / split), n, rng)
    argv = ["--workdir", str(tmp_path), "--epochs", "1", "--n_labelled",
            "2", "-b", "4", "--regimes", "baseline", "mme", "--distill",
            "--device_cache"]
    res = domain_study.main(argv, device="cpu")
    assert list(res) == ["baseline", "mme", "student_baseline",
                         "student_mme"]
    for row in res.values():
        assert all(np.isfinite(v) for v in row.values())
    for name in ("baseline", "student_mme"):
        sd = torch.load(tmp_path / "results" / name / "best_weights.pt")
        assert "featureExtractor.ResBlock_4.Conv_0.weight" in sd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "fit", lambda *a, **kw: pytest.fail("refitted"))
        assert domain_study.main(argv, device="cpu") == res
