"""The port's device-resident split cache and multi-step dispatch on the
CPU: ``data.device_cache``, the modules' ``device_cache`` and
``train_scan_inputs``, the trainers' ``run_scan_chunk`` against the JAX
package's ``train_steps_scan`` and ``mme_train_steps_scan``, and ``fit``
with and without the cache, on a tiny model at 24x32 (16x24 for the JAX
gates).

Tolerances: gathers, index matrices, and the port against itself (logged
rows, weights, running statistics, optimizer state) exact; the chunk
against JAX as one train step's gates (``test_torch_train_steps.py``,
``test_torch_mme.py``): losses 1e-4, Adam's first moment and the
parameters through ``assert_adam_step_matches`` over the chunk's two
steps, SGD's momentum 5e-5, running statistics 1e-4 plus what that gate's
noise bound moves them by (``_stats_atol``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import write_split
from test_torch_common import (assert_adam_step_matches,
                               assert_batch_stats_match, flat_numpy,
                               jax_augment_draws, jax_drop_masks,
                               jax_variables, load_port, torch_grad_like,
                               unflatten)

from sim2real_lane_segment_tpu.core.dtypes import F32_POLICY as JAX_F32
from sim2real_lane_segment_tpu.data import modules as jmodules
from sim2real_lane_segment_tpu.models.tiramisu import FCDenseNet as JaxNet
from sim2real_lane_segment_tpu_torch.cli import train as train_cli
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import modules
from sim2real_lane_segment_tpu_torch.data.device_cache import \
    DeviceCachedView
from sim2real_lane_segment_tpu_torch.models.tiramisu import (FCDenseNet,
                                                             dropout_sites)
from sim2real_lane_segment_tpu_torch.train.checkpoint import load_train_state
from sim2real_lane_segment_tpu_torch.train.mme import MMETrainer
from sim2real_lane_segment_tpu_torch.train.supervised import \
    SupervisedTrainer

H, W, B = 16, 24, 2
TINY = dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
            bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)

MODULES = {"sim": (modules.SimulatorDataModule,
                   jmodules.SimulatorDataModule),
           "st": (modules.TwoDomainDataModule, jmodules.TwoDomainDataModule),
           "mme": (modules.TwoDomainMMEDataModule,
                   jmodules.TwoDomainMMEDataModule)}


def _tree(tmp_path, regime, seed=0, h=24, w=32, n=(5, 3, 3, 9), grow=4):
    """A sim tree (train, valid, test) or a two-domain tree (source,
    target/train, target/test, target/unlabelled) of ``n`` frames each;
    the two-domain target splits ``grow`` pixels larger than the source
    (whose reads are then resized to the target's size)."""
    rng = np.random.default_rng(seed)
    root = str(tmp_path / regime)
    if regime == "sim":
        for split, k in zip(("train", "valid", "test"), n):
            write_split(os.path.join(root, split), k, rng, h=h, w=w)
        return root
    for split, k in zip(("source", "target/train", "target/test"), n):
        size = (h, w) if split == "source" else (h + grow, w + grow)
        write_split(os.path.join(root, split), k, rng, *size)
    write_split(os.path.join(root, "target", "unlabelled"), n[3], rng,
                h=h + grow, w=w + grow, with_labels=False)
    return root


def _module(cls, root, **kw):
    m = cls(root, batch_size=2, seed=3, **kw)
    m.setup()
    return m


# -- the cache and the modules ---------------------------------------------

@pytest.mark.parametrize("regime", ["sim", "st", "mme"])
def test_gathers_equal_host_reads(tmp_path, regime):
    """Every split's gathers against the host reads of the same rows, bit
    for bit, the concatenated source+target index space included; the
    two-domain valid and test splits share one device copy."""
    root = _tree(tmp_path, regime)
    cls = MODULES[regime][0]
    host = _module(cls, root)
    dev = _module(cls, root, device_cache=True, device="cpu")
    for epoch in (0, 1):
        for a, b in zip(host.train_batches(epoch), dev.train_batches(epoch),
                        strict=True):
            if regime == "mme":
                (a, a_unl), (b, b_unl) = a, b
                np.testing.assert_array_equal(b_unl.numpy(), a_unl)
            assert isinstance(b[0], torch.Tensor)
            np.testing.assert_array_equal(b[0].numpy(), a[0])
            np.testing.assert_array_equal(b[1].numpy(), a[1])
    for split in ("val_batches", "test_batches"):
        for a, b in zip(getattr(host, split)(), getattr(dev, split)(),
                        strict=True):
            np.testing.assert_array_equal(b[0].numpy(), a[0])
            np.testing.assert_array_equal(b[1].numpy(), a[1])
    if regime != "sim":
        n_src = len(dev.datasets["source"])
        view = dev._view(dev.datasets["source"], dev.datasets["targetTrain"])
        idx = [0, n_src - 1, n_src, len(view.images) - 1]
        x, y = view.gather(idx)
        x_ref, y_ref = host._host_read_train(idx)
        np.testing.assert_array_equal(x.numpy(), x_ref)
        np.testing.assert_array_equal(y.numpy(), y_ref)
        assert dev.datasets["valid"] is dev.datasets["test"]
        views = {id(v) for v in dev._views.values()}
        assert len(views) == len(dev._views) == (3 if regime == "mme" else 2)


@pytest.mark.parametrize("regime", ["sim", "st", "mme"])
def test_scan_inputs_equal_jax(tmp_path, regime):
    """``train_scan_inputs``: the index matrices of the JAX modules with
    ``device_cache=True``, exactly, and the arrays they index; None without
    the cache, and when an epoch has no whole batch.  One frame size: the
    JAX reads resize through cv2, the port's through PyTorch."""
    root = _tree(tmp_path, regime, grow=0)
    ours, theirs = MODULES[regime]
    port = _module(ours, root, device_cache=True, device="cpu")
    ref = _module(theirs, root, device_cache=True)
    for epoch in (0, 1, 4):
        arrays, idx = port.train_scan_inputs(epoch)
        arrays_ref, idx_ref = ref.train_scan_inputs(epoch)
        assert idx.dtype == idx_ref.dtype == np.int32
        np.testing.assert_array_equal(idx, idx_ref)
        assert len(arrays) == len(arrays_ref)
        for a, a_ref in zip(arrays, arrays_ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert _module(ours, root).train_scan_inputs(0) is None
    big = ours(root, batch_size=64, seed=3, device_cache=True, device="cpu")
    big.setup()
    assert big.train_scan_inputs(0) is None


def test_upload_that_does_not_fit_raises():
    """No fallback to host reads: the upload raises, naming the split and
    its bytes."""
    frames = np.broadcast_to(np.zeros((1, 480, 640, 3), np.uint8),
                             (10 ** 9, 480, 640, 3))
    with pytest.raises(MemoryError, match=r"'huge' needs "
                                          r"921,600,000,000,000 bytes"):
        DeviceCachedView.from_arrays(frames, None, "cpu", name="huge")


def test_upload_in_chunks_equals_the_arrays(monkeypatch):
    from sim2real_lane_segment_tpu_torch.data import device_cache
    monkeypatch.setattr(device_cache, "CHUNK_BYTES", 1000)  # 3 rows a chunk
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (7, 10, 10, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (7, 10, 10), dtype=np.uint8)
    view = DeviceCachedView.from_arrays(x, y, "cpu")
    np.testing.assert_array_equal(view.images.numpy(), x)
    np.testing.assert_array_equal(view.labels.numpy(), y)
    assert view.nbytes == x.nbytes + y.nbytes
    gx, gy = view.gather([6, 0, 6])
    np.testing.assert_array_equal(gx.numpy(), x[[6, 0, 6]])
    np.testing.assert_array_equal(gy.numpy(), y[[6, 0, 6]])


# -- one chunk against JAX's scanned steps ---------------------------------

def _stats_atol(lr: float, updates: int) -> float:
    """The one-step running-statistics gate (1e-4) after Adam steps.  A
    conv bias that feeds BatchNorm only has a gradient of float noise, and
    Adam turns it into a step of up to lr of either sign on each side
    (``assert_adam_step_matches``): the two sides' biases then differ by up
    to 2 lr, which shifts the next batch mean by as much, and a running
    mean by 0.1 of it at each of the ``updates`` writes that follow."""
    return 1e-4 + 0.1 * 2 * lr * updates


def _split_chain(key, k: int, n: int):
    """The scan body's per-step keys: ``key, k_step = split(key)``, then
    ``split(k_step, n)``."""
    out = []
    for _ in range(k):
        key, k_step = jax.random.split(key)
        out.append(jax.random.split(k_step, n))
    return out


def _split(rng, n, src=(20, 28), labels=True):
    x = rng.integers(0, 255, (n, *src, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (n, *src), dtype=np.uint8) if labels else None
    return x, y


def test_scan_chunk_matches_jax_train_steps_scan():
    """Two supervised steps in one chunk, augmented, on JAX's key chain,
    against ``train_steps_scan`` (the plain route, dropout off on both
    sides: Flax draws its own masks there)."""
    from sim2real_lane_segment_tpu.train.supervised import \
        SupervisedTrainer as JaxTrainer
    from sim2real_lane_segment_tpu.train.supervised import TrainState

    jax_model = JaxNet(**TINY, policy=JAX_F32, dropout_rate=0.0)
    flat = jax_variables(jax_model, (B, H, W, 3), seed=51)
    images, labels = _split(np.random.default_rng(52), 6)
    idx = np.array([[4, 1], [0, 4]], np.int32)
    key = jax.random.key(53)
    jt = JaxTrainer(num_cls=4, height=H, width=W, augment=True,
                    model=jax_model)
    v = unflatten(flat)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jt.tx.init(v["params"]))
    new_state, _, logs = jax.device_get(jt.run_scan_chunk(
        state, (jnp.asarray(images), jnp.asarray(labels)), idx, key, 3))

    model = load_port(FCDenseNet(**TINY, policy=F32_POLICY,
                                 dropout_rate=0.0), flat)
    trainer = SupervisedTrainer(num_cls=4, height=H, width=W, model=model,
                                augment=True, device="cpu")
    sites = dropout_sites(model)
    draws = [dict(draws=jax_augment_draws(k_aug, B, trainer.cfg),
                  masks=jax_drop_masks(k_drop, sites, 0.0, B))
             for k_aug, k_drop in _split_chain(key, 2, 2)]
    got = trainer.run_scan_chunk(
        (torch.from_numpy(images), torch.from_numpy(labels)), idx,
        torch.Generator(), 3, draws=draws)
    for k in ("tr_loss", "tr_acc"):
        np.testing.assert_allclose(got[k].numpy(), logs[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    assert trainer.opt.count == 2
    assert_adam_step_matches(model, trainer.opt.mu, new_state.params,
                             new_state.opt_state[0].mu, jt.lr_at(3), steps=2)
    assert_batch_stats_match(model, new_state.batch_stats,
                             atol=_stats_atol(jt.lr_at(3), 1))


def test_scan_chunk_matches_jax_mme_train_steps_scan():
    """Two MME steps in one chunk, both batches augmented, on JAX's key
    chain (``split(k_step, 4)``: draws_l, draws_u, masks_g, masks_f),
    against ``mme_train_steps_scan``; the plain route, dropout off."""
    from sim2real_lane_segment_tpu.train.mme import MMETrainer as JaxMME

    jax_model = JaxNet(**TINY, policy=JAX_F32, dropout_rate=0.0)
    flat = jax_variables(jax_model, (B, H, W, 3), seed=61)
    rng = np.random.default_rng(62)
    lab, lab_y = _split(rng, 5)
    unl, _ = _split(rng, 7, labels=False)
    idx = np.array([[[0, 3], [6, 2]], [[4, 4], [1, 5]]], np.int32)
    key = jax.random.key(63)
    jt = JaxMME(num_cls=4, height=H, width=W, augment=True, model=jax_model)
    v = unflatten(flat)
    state = jt.init_state(jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    new_state, _, logs = jax.device_get(jt.run_scan_chunk(
        state, tuple(jnp.asarray(a) for a in (lab, lab_y, unl)), idx, key,
        2))

    model = load_port(FCDenseNet(**TINY, policy=F32_POLICY,
                                 dropout_rate=0.0), flat)
    trainer = MMETrainer(num_cls=4, height=H, width=W, model=model,
                         augment=True, device="cpu")
    sites = dropout_sites(model)
    draws = [dict(draws_l=jax_augment_draws(k_l, B, trainer.cfg),
                  draws_u=jax_augment_draws(k_u, B, trainer.cfg),
                  masks_g=jax_drop_masks(k_g, sites, 0.0, B),
                  masks_f=jax_drop_masks(k_f, sites, 0.0, B))
             for k_l, k_u, k_g, k_f in _split_chain(key, 2, 4)]
    got = trainer.run_scan_chunk(
        tuple(torch.from_numpy(a) for a in (lab, lab_y, unl)), idx,
        torch.Generator(), 2, draws=draws)
    for k in ("tr_loss_adent", "tr_loss"):
        np.testing.assert_allclose(got[k].numpy(), logs[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    trace = dict(zip(dict(model.named_parameters()), trainer.opt_g.trace))
    for path, arr in flat_numpy({"params": new_state.opt_state_g[1].trace}
                                ).items():
        key_t, want = torch_grad_like(path, arr)
        np.testing.assert_allclose(trace[key_t].numpy(), want, atol=5e-5,
                                   rtol=5e-3, err_msg=path)
    lr_f = jt.lrs_at(2)[2]
    assert_adam_step_matches(model, trainer.opt.mu, new_state.params,
                             new_state.opt_state_f[0].mu, lr_f, steps=2)
    # the second step's two passes write the statistics after phase F's
    # first Adam step
    assert_batch_stats_match(model, new_state.batch_stats,
                             atol=_stats_atol(lr_f, 2))


# -- fit with and without the cache ----------------------------------------

def _fit_args(regime, root, out, *extra, routes=("--augment",
                                                 "--pallas_train")):
    return ["--trainType", regime, "--dataPath", root, "--arch", "tiny",
            "--max_epochs", "2", "-b", "2", "--height", "24", "--width",
            "32", "--default_root_dir", out, "--log_every", "1",
            "--model_name", regime, *routes, *extra]


def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("regime,routes", [
    ("sim", ("--augment", "--pallas_train")),
    ("st", ("--augment", "--pallas_train")),
    ("mme", ("--augment", "--pallas_train")), ("sim", ()), ("mme", ())])
def test_fit_with_the_cache_repeats_fit_without(tmp_path, regime, routes):
    """``cli.train --device_cache`` against the same run without it: equal
    metrics rows (train, val, test) and equal final state, bit for bit;
    the multi-step dispatch really ran.  With ``--augment
    --pallas_train``, and without either (the plain module)."""
    root = _tree(tmp_path, regime, n=(5, 3, 3, 9))
    extra = []
    if regime == "mme":
        sim = _tree(tmp_path, "sim", seed=1)
        base = train_cli.main(_fit_args("sim", sim, str(tmp_path / "base")),
                              device="cpu")
        extra = ["--pretrained_path",
                 os.path.join(base["out_dir"], "best_weights.pt")]
    runs = {}
    calls = []
    real = SupervisedTrainer.run_scan_chunk

    def spy(self, arrays, idx_chunk, *a, **kw):
        calls.append(len(idx_chunk))
        return real(self, arrays, idx_chunk, *a, **kw)

    for cache in (False, True):
        out = str(tmp_path / f"run{int(cache)}")
        args = _fit_args(regime, root, out, *extra,
                         *(["--device_cache"] if cache else []),
                         routes=routes)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(SupervisedTrainer, "run_scan_chunk", spy)
            res = train_cli.main(args, device="cpu")
        runs[cache] = res["out_dir"]
    steps = 2 if regime == "sim" else 4  # per epoch: 5 // 2, 8 // 2
    assert calls == [steps, steps]
    rows = [_rows(runs[c]) for c in (False, True)]
    assert rows[0] == rows[1]
    assert len([r for r in rows[0] if any(k.startswith("train/") for k in r)
                ]) == 2 * steps
    want = load_train_state(os.path.join(runs[False], "checkpoints_latest",
                                         "latest.pt"))
    got = load_train_state(os.path.join(runs[True], "checkpoints_latest",
                                        "latest.pt"))
    for k, t in want["model"].items():
        torch.testing.assert_close(got["model"][k], t, rtol=0, atol=0,
                                   msg=k)
    opt = (lambda s: [s["optimizer"]["f"], s["optimizer"]["g"]]
           if regime == "mme" else [s["optimizer"]])
    for a, b in zip(opt(want), opt(got), strict=True):
        for k in a:
            va, vb = a[k], b[k]
            if k == "count":
                assert va == vb
                continue
            for x, y in zip(va, vb, strict=True):
                torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_resumed_cached_run_repeats_an_uninterrupted_one(tmp_path):
    root = _tree(tmp_path, "sim")
    full = train_cli.main(_fit_args("sim", root, str(tmp_path / "a"),
                                    "--device_cache") + ["--max_epochs", "3"],
                          device="cpu")
    part = str(tmp_path / "b")
    train_cli.main(_fit_args("sim", root, part, "--device_cache"),
                   device="cpu")
    res = train_cli.main(_fit_args("sim", root, part, "--device_cache",
                                   "--resume") + ["--max_epochs", "3"],
                         device="cpu")

    def train_rows(d):
        return [r for r in _rows(d) if "train/tr_loss" in r]

    assert train_rows(res["out_dir"]) == train_rows(full["out_dir"])


def test_profile_writes_a_trace(tmp_path):
    root = _tree(tmp_path, "sim")
    res = train_cli.main(_fit_args("sim", root, str(tmp_path / "p"),
                                   "--profile", "--device_cache"),
                         device="cpu")
    path = os.path.join(res["out_dir"], "profile", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
