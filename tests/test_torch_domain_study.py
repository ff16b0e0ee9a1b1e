"""The port's domain study (``cli.domain_study``) on pre-made tiny trees.

``sourceData`` and ``targetData`` are written here (12/4/4 frames of
48x64 each), so the study skips rendering, as the JAX study does with
cached trees.  ``--arch tiny``, one epoch; the CycleGAN regime's CLIs get
``--num_residual_blocks 1`` (and 32x32 training frames) added, the only
change from the study's own calls, so that it runs on the CPU.
"""
import filecmp
import json
import os
import random

import numpy as np
import pytest
import torch

from helpers import write_split

from sim2real_lane_segment_tpu_torch.cli import domain_study
from sim2real_lane_segment_tpu_torch.cli import sim2real_convert
from sim2real_lane_segment_tpu_torch.cli import train_cyclegan
from sim2real_lane_segment_tpu_torch.data.png import read_png

torch.set_num_threads(2)

REGIMES = ["baseline", "st", "hm", "cyclegan", "mme"]


def _trees(root):
    rng = np.random.default_rng(0)
    for dom in ("sourceData", "targetData"):
        for split, n in (("train", 12), ("valid", 4), ("test", 4)):
            write_split(str(root / dom / split), n, rng)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    _trees(tmp_path)
    train, convert = train_cyclegan.main, sim2real_convert.main
    monkeypatch.setattr(train_cyclegan, "main", lambda a, device=None: train(
        a + ["--num_residual_blocks", "1", "--height", "32", "--width",
             "32"], device=device))
    monkeypatch.setattr(sim2real_convert, "main",
                        lambda a, device=None: convert(
                            a + ["--num_residual_blocks", "1"],
                            device=device))
    return tmp_path


def _run(workdir, regimes, extra=()):
    return domain_study.main(
        ["--workdir", str(workdir), "--arch", "tiny", "--epochs", "1",
         "--n_labelled", "2", "-b", "4", "--cg_epochs", "1",
         "--regimes", *regimes, *extra], device="cpu")


def _no_fit(*a, **kw):
    raise AssertionError("a regime was refitted")


def test_five_regimes_then_resume(workdir, monkeypatch):
    from sim2real_lane_segment_tpu_torch.train import checkpoint, loop, mme

    pretrained = []
    orig = mme.MMETrainer.from_pretrained

    def spy(self, path):
        pretrained.append(path)
        orig(self, path)
        base = checkpoint.load_weights(
            str(workdir / "results" / "baseline" / "best_weights.pt"),
            type(self.model)(**_tiny_kw()))
        for k, v in base.state_dict().items():
            torch.testing.assert_close(self.model.state_dict()[k].cpu(), v,
                                       rtol=0, atol=0)

    monkeypatch.setattr(mme.MMETrainer, "from_pretrained", spy)
    r1 = _run(workdir, REGIMES)
    summary = workdir / "study_summary.json"
    assert list(r1) == REGIMES
    assert json.loads(summary.read_text()) == r1
    for row in r1.values():
        assert {"loss", "acc", "dice", "iou"} <= set(row)
        assert all(np.isfinite(v) for v in row.values())
    assert pretrained == ["results/baseline/best_weights.pt"]
    # the cyclegan regime restyled its source tree to the reference size
    src = workdir / "srd_cg" / "source" / "input"
    assert read_png(str(src / "000000.png")).shape == (480, 640, 3)
    # the hm regime matched its source tree in place
    assert not filecmp.cmp(str(workdir / "srd_hm/source/input/000000.png"),
                           str(workdir / "sourceData/train/input/"
                               "000000.png"), shallow=False)

    # resume: a finished summary is kept as written, nothing refits
    monkeypatch.setattr(loop, "fit", _no_fit)
    poisoned = {k: dict(v, iou=99.0) for k, v in r1.items()}
    summary.write_text(json.dumps(poisoned))
    assert _run(workdir, REGIMES) == poisoned

    # without the summary every regime restores its best weights and
    # evaluates them again to the same numbers
    os.remove(summary)
    r3 = _run(workdir, REGIMES)
    for k in REGIMES:
        assert r3[k]["iou"] == pytest.approx(r1[k]["iou"], abs=1e-6), k


def _tiny_kw():
    return dict(n_classes=4, down_blocks=(2, 2), up_blocks=(2, 2),
                bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8)


def test_force_retrains(workdir):
    _run(workdir, ["baseline"])
    summary = workdir / "study_summary.json"
    summary.write_text(json.dumps(
        {"baseline": {"loss": 0, "acc": 0, "dice": 0, "iou": 99.0}}))
    r = _run(workdir, ["baseline"], extra=["--force"])
    assert r["baseline"]["iou"] != 99.0


def test_device_cache_reaches_the_data_modules(workdir, monkeypatch):
    from sim2real_lane_segment_tpu_torch.data import modules

    seen = []
    for name in ("SimulatorDataModule", "TwoDomainDataModule"):
        cls = getattr(modules, name)

        class Spy(cls):
            def __init__(self, *a, **kw):
                seen.append((type(self).__mro__[1].__name__,
                             kw.get("device_cache")))
                super().__init__(*a, **kw)
        monkeypatch.setattr(modules, name, Spy)
    _run(workdir, ["baseline", "st"], extra=["--device_cache"])
    # the baseline's and st's train modules, and each evaluation's reader
    assert ("SimulatorDataModule", True) in seen
    assert ("TwoDomainDataModule", True) in seen


def test_missing_trees_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        domain_study.main(["--workdir", str(tmp_path), "--arch", "tiny"],
                          device="cpu")


def test_entry_points_need_a_card_unless_cpu(workdir, monkeypatch):
    from sim2real_lane_segment_tpu_torch.cli import hist_match

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(workdir / "sourceData" / "train")
    calls = {
        hist_match: ["--ds_source", src, "--ds_reference", src],
        train_cyclegan: ["--source_dir", src, "--target_dir", src],
        sim2real_convert: ["--dataPath", src, "--modelWeightsPath",
                           "g_ab.pt"],
        domain_study: ["--workdir", str(workdir), "--arch", "tiny"]}
    for cli, argv in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)


def test_distill_raises(workdir):
    with pytest.raises(NotImplementedError, match="--distill"):
        _run(workdir, ["baseline"], extra=["--distill"])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("hm", [False, True])
def test_build_tree_matches_jax(tmp_path, hm):
    from sim2real_lane_segment_tpu.cli import domain_study as jax_study

    _trees(tmp_path)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        random.seed(3)
        jax_study._build_tree("jax_tree", "sourceData", "targetData", 2, hm)
        random.seed(3)
        domain_study._build_tree("port_tree", "sourceData", "targetData", 2,
                                 hm, device="cpu")
    finally:
        os.chdir(cwd)
    files = _files(tmp_path / "port_tree")
    assert files == _files(tmp_path / "jax_tree")
    assert len(files) == 12 * 2 + 2 * 2 + 16 + 4 * 2
    for f in files:
        a, b = tmp_path / "port_tree" / f, tmp_path / "jax_tree" / f
        if hm and f.startswith("source/input"):
            np.testing.assert_array_equal(read_png(str(a)),
                                          read_png(str(b)), err_msg=f)
        else:
            assert filecmp.cmp(str(a), str(b), shallow=False), f
