"""The port's HPO sweep (``train/bayesopt.py``, ``cli/tune.py``) against
the JAX package's.

- TPE and random proposals bit-equal to JAX's for fixed seeds and
  observations (the port keeps its own numpy copy);
- the successive-halving schedule: both CLIs driven with the same trial
  scores (``run_trial`` replaced by a function of the configuration) give
  the same trials, rungs, pruning, ``trials.json`` and best configuration;
- the three repairs of JAX faults: a fresh trial truncates its
  ``metrics.jsonl``, the JSON files are replaced atomically, and
  ``--eval_default`` runs with a seed of its own (JAX reuses trial 0's;
  the test says so and compares the rest);
- a real sweep on the CPU (one trainer for every trial, the decay in its
  device operand), and trials sharded over two ranks.

Exact comparisons throughout: the proposals are numpy on both sides.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import make_simreal_tree

from sim2real_lane_segment_tpu.cli import tune as jtune
from sim2real_lane_segment_tpu.train import bayesopt as jbo
from sim2real_lane_segment_tpu_torch.cli import tune
from sim2real_lane_segment_tpu_torch.parallel.multihost import free_port
from sim2real_lane_segment_tpu_torch.train import bayesopt as bo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = tune.SEARCH_SPACE


def objective(cfg) -> float:
    """Peaked at (-3.2, -1.0, -4.5) (tests/test_bayesopt.py's, noiseless)."""
    return (-(cfg["log_lr"] + 3.2) ** 2 - 0.5 * (cfg["log_lrRatio"] + 1.0) ** 2
            - 0.1 * (cfg["log_decay"] + 4.5) ** 2)


@pytest.mark.parametrize("kind", ["tpe", "random"])
@pytest.mark.parametrize("seed", [0, 1, 7919])
def test_proposals_bit_equal_to_jax(kind, seed):
    ours = bo.make_proposer(kind, SPACE, seed=seed)
    theirs = jbo.make_proposer(kind, SPACE, seed=seed)
    for _ in range(30):  # past TPE's 8 random start-up proposals
        cfg = ours.propose()
        assert cfg == theirs.propose()
        ours.observe(cfg, objective(cfg))
        theirs.observe(cfg, objective(cfg))


def test_make_proposer_rejects_unknown():
    with pytest.raises(ValueError):
        bo.make_proposer("gp", SPACE)


def test_rungs():
    assert tune.rungs(25, 4, 175) == [25, 100, 175]
    assert tune.rungs(1, 2, 2) == [1, 2]
    assert tune.rungs(5, 4, 5) == [5]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_simreal_tree(tmp_path_factory.mktemp("tune"),
                             np.random.default_rng(0))


def _argv(tree, out_dir, *extra):
    return ["--dataPath", tree, "--reproducible", "--num_samples", "6",
            "--num_epochs", "8", "--grace_period", "2",
            "--reduction_factor", "2", "--arch", "tiny", "-b", "4",
            "--height", "24", "--width", "32", "--out_dir", out_dir, *extra]


def _fake_trial(calls):
    def run_trial(config, data, trainer, *, epochs_from, epochs_to, out_dir,
                  seed, state=None, **kw):
        calls.append((os.path.basename(out_dir), epochs_from, epochs_to,
                      seed))
        return {"epochs": epochs_to}, objective(config) + 0.01 * epochs_to
    return run_trial


def test_sweep_schedule_matches_jax(tree, tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jtune, "run_trial", _fake_trial(calls["jax"]))
    monkeypatch.setattr(tune, "run_trial", _fake_trial(calls["port"]))
    out = {k: str(tmp_path / k) for k in calls}
    want = jtune.main(_argv(tree, out["jax"], "--eval_default"))
    got = tune.main(_argv(tree, out["port"], "--eval_default"),
                    device="cpu")
    # rungs 2, 4, 8: 6 trials, then 3, then 2
    assert [c[2] for c in calls["port"]].count(2) == 6
    assert [c[2] for c in calls["port"]].count(8) == 3  # two + the default
    # the default run's seed: JAX reuses trial 0's (seed 42), the port
    # takes one no trial has (42 + num_samples)
    assert calls["jax"][-1] == ("trial_default", 0, 8, 42)
    assert calls["port"][-1] == ("trial_default", 0, 8, 48)
    assert calls["port"][:-1] == calls["jax"][:-1]
    assert got == want
    for name in ("trials.json", "best.json"):
        with open(os.path.join(out["jax"], name)) as a, \
                open(os.path.join(out["port"], name)) as b:
            assert json.load(a) == json.load(b), name


def test_json_files_are_replaced_atomically(tmp_path, monkeypatch):
    path = str(tmp_path / "trials.json")
    tune.write_json(path, [{"id": 0}])

    def broken(obj, f, **kw):
        f.write("[{")
        raise OSError("disk full")

    monkeypatch.setattr(tune.json, "dump", broken)
    with pytest.raises(OSError):
        tune.write_json(path, [{"id": 0}, {"id": 1}])
    with open(path) as f:
        assert json.load(f) == [{"id": 0}]


@pytest.fixture(scope="module")
def trainer(tree):
    from sim2real_lane_segment_tpu_torch.data.modules import \
        TwoDomainMMEDataModule

    data = TwoDomainMMEDataModule(tree, batch_size=4, seed=0)
    data.setup()
    return data, tune.make_trainer(num_cls=4, augment=True, arch="tiny",
                                   height=24, width=32, device="cpu")


def test_fresh_trial_truncates_its_metrics(trainer, tmp_path):
    data, tr = trainer
    out_dir = str(tmp_path / "trial_000")
    cfg = {"log_lr": -3.0, "log_lrRatio": 0.0, "log_decay": -2.0}
    path = os.path.join(out_dir, "metrics.jsonl")
    for _ in range(2):  # a stale history from an earlier sweep
        state, _ = tune.run_trial(cfg, data, tr, epochs_from=0, epochs_to=1,
                                  out_dir=out_dir, seed=3, arch="tiny")
        with open(path) as f:
            assert [json.loads(line)["step"] for line in f] == [0]
    tune.run_trial(cfg, data, tr, epochs_from=1, epochs_to=2,
                   out_dir=out_dir, seed=3, arch="tiny", state=state)
    with open(path) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]
    # the trial's decay sits in the shared trainer's device operands
    for opt in (tr.opt, tr.opt_g):
        assert float(opt.weight_decay) == pytest.approx(1e-2)


def test_fresh_trials_start_alike(trainer, tmp_path):
    """Two fresh trials of one configuration and seed on the shared
    trainer give the same history: weights and optimizer state reset."""
    data, tr = trainer
    cfg = {"log_lr": -2.5, "log_lrRatio": -1.0, "log_decay": -4.0}
    runs = [tune.run_trial(cfg, data, tr, epochs_from=0, epochs_to=1,
                           out_dir=str(tmp_path / f"t{i}"), seed=5,
                           arch="tiny")[1] for i in range(2)]
    assert runs[0] == runs[1]


def test_sweep_on_cpu(tree, tmp_path, monkeypatch):
    made = []
    real = tune.make_trainer

    def counting(**kw):
        made.append(real(**kw))
        return made[-1]

    monkeypatch.setattr(tune, "make_trainer", counting)
    out = str(tmp_path / "sweep")
    res = tune.main(["--dataPath", tree, "--reproducible", "--num_samples",
                     "3", "--num_epochs", "2", "--grace_period", "1",
                     "--reduction_factor", "2", "--arch", "tiny", "-b", "4",
                     "--height", "24", "--width", "32", "--out_dir", out],
                    device="cpu")
    assert len(made) == 1
    with open(os.path.join(out, "trials.json")) as f:
        trials = json.load(f)
    assert sorted(t["epochs"] for t in trials) == [1, 2, 2]
    assert sum(t["pruned"] for t in trials) == 1
    assert res["best_iou"] == max(t["best_iou"] for t in trials)
    for t in trials:
        with open(os.path.join(out, f"trial_{t['id']:03d}",
                               "metrics.jsonl")) as f:
            assert len(f.readlines()) == t["epochs"]


def test_trials_shard_over_two_ranks(tree, tmp_path):
    """Two processes of one sweep (torchrun's environment): rank r runs
    the trials with id % 2 == r under ``host_<r>``."""
    out = str(tmp_path / "mh")
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "import torch; torch.set_num_threads(1); "
            "from sim2real_lane_segment_tpu_torch.cli import tune; "
            "tune.main(json.loads(sys.argv[2]), device='cpu')")
    argv = ["--dataPath", tree, "--reproducible", "--num_samples", "2",
            "--num_epochs", "1", "--grace_period", "1", "--arch", "tiny",
            "-b", "4", "--height", "24", "--width", "32", "--out_dir", out]
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, REPO, json.dumps(argv)], cwd=REPO,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    for r in range(2):
        host = os.path.join(out, f"host_{r}")
        with open(os.path.join(host, "trials.json")) as f:
            assert [t["id"] for t in json.load(f)] == [r]
        assert sorted(d for d in os.listdir(host)
                      if d.startswith("trial_")) == [f"trial_{r:03d}"]
