"""Data parallelism over ``torch.distributed`` (``cli.train --dp``,
``parallel/{dp,sharding,multihost}.py``), gloo on the CPU.

Mirrors ``tests/test_dp_train.py`` and ``tests/test_multihost.py``:

- ``--dp auto`` without a launcher is a world of one rank, which runs the
  collectives and gives ``--dp off``'s rows and weights bit for bit
  (``sim`` and ``mme``, plain and through the kernels' plain twins, with
  and without ``--device_cache``);
- two ranks at per-rank batch B (each in its own process, torchrun's
  environment) agree with each other bit for bit and with one process at
  2B, for ``sim`` and ``mme``, plain and ``--pallas_train``: every
  logged train loss and validation/test loss within 1e-4, argmax metrics
  (acc, iou, in percent) within 0.07 (two of the 3,072 validation
  pixels flipping at a near tie), dice within 1e-3, and the weights
  within 5e-3 (AdamW turns float noise in a gradient that is zero in
  exact arithmetic into up to lr a step, ``tests/test_dp_train.py``'s
  bound).  The models run in float32, as JAX's gates do;
- ``parallel.multihost``'s worker: two processes' losses equal each
  other and one process's at the doubled batch (rtol 1e-5);
- the data modules' per-rank shards against the JAX modules' (exact).

Each process has a timeout (``communicate``); every run is a tiny
FC-DenseNet at 24x32.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import make_sim_tree, make_simreal_tree

from sim2real_lane_segment_tpu.data import modules as jmodules
from sim2real_lane_segment_tpu_torch.cli import test as test_cli
from sim2real_lane_segment_tpu_torch.cli import train as train_cli
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
from sim2real_lane_segment_tpu_torch.data import modules
from sim2real_lane_segment_tpu_torch.parallel import dp
from sim2real_lane_segment_tpu_torch.parallel.multihost import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

# a worker process: cli.train.main on the CPU with the model in float32
WORKER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from sim2real_lane_segment_tpu_torch.cli import test, train
from sim2real_lane_segment_tpu_torch.core.dtypes import F32_POLICY
build = test.build_model
test.build_model = lambda arch, n, policy=None: build(arch, n, F32_POLICY)
print(json.dumps(train.main(json.loads(sys.argv[2]), device="cpu")))
"""


def test_resolve_dp():
    assert not any(dp.resolve_dp(v, 1) for v in (None, "off", "0"))
    assert dp.resolve_dp("auto", 1) and dp.resolve_dp("auto", 4)
    assert dp.resolve_dp("2", 2)
    with pytest.raises(SystemExit):
        dp.resolve_dp("2", 1)


def test_helpers_are_the_identity_without_a_world():
    x = torch.arange(6.0)
    assert dp.current() is None
    assert dp.all_sum(x) is x and dp.all_mean(x) is x and dp.share(x) is x
    assert dp.reduce_grads([x])[0] is x


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    sim = make_sim_tree(tmp, np.random.default_rng(0))
    mme = make_simreal_tree(tmp, np.random.default_rng(1))
    torch.manual_seed(3)
    weights = str(tmp / "pretrained.pt")
    torch.save(test_cli.build_model("tiny", 4, F32_POLICY).state_dict(),
               weights)
    return {"sim": sim, "mme": mme, "weights": weights}


def _argv(trees, regime, batch, out, *extra):
    argv = ["--trainType", regime, "--dataPath", trees[regime], "--arch",
            "tiny", "--max_epochs", "2", "-b", str(batch), "--height", "24",
            "--width", "32", "--default_root_dir", out, "--log_every", "1",
            "--augment", *extra]
    if regime == "mme":
        argv += ["--pretrained_path", trees["weights"]]
    return argv


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _weights(run_dir):
    return torch.load(os.path.join(run_dir, "best_weights.pt"),
                      weights_only=True)


ROUTES = {"plain": [], "fused": ["--pallas_train"]}


@pytest.mark.parametrize("regime", ["sim", "mme"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_world_of_one_is_dp_off_bit_for_bit(trees, tmp_path, regime, route):
    runs = {}
    for dp_flag in ("off", "auto"):
        for cache in ([], ["--device_cache"]):
            out = str(tmp_path / f"{dp_flag}{len(cache)}")
            res = train_cli.main(_argv(trees, regime, 4, out,
                                       *ROUTES[route], "--dp", dp_flag,
                                       *cache), device="cpu")
            runs[dp_flag, bool(cache)] = (_rows(res["out_dir"]),
                                          _weights(res["out_dir"]))
    ref_rows, ref_w = runs["off", False]
    assert any("train/tr_loss" in r for r in ref_rows)
    for rows, w in runs.values():
        assert rows == ref_rows
        assert all(torch.equal(w[k], ref_w[k]) for k in ref_w)
    assert not torch.distributed.is_initialized()  # the CLI ended its world


def _launch(argv, env=None):
    return subprocess.Popen([sys.executable, "-c", WORKER, REPO,
                             json.dumps(argv)], cwd=REPO,
                            env=dict(os.environ, **(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, label):
    _, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, f"{label} failed:\n{err[-3000:]}"


@pytest.mark.parametrize("regime", ["sim", "mme"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_two_ranks_equal_one_rank_at_twice_the_batch(trees, tmp_path, regime,
                                                     route):
    port = str(free_port())
    two = str(tmp_path / "two")
    procs = [_launch(_argv(trees, regime, 2, two, *ROUTES[route], "--dp",
                           "auto"),
                     dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
             for r in range(2)]
    one = _launch(_argv(trees, regime, 4, str(tmp_path / "one"),
                        *ROUTES[route]))
    for r, p in enumerate(procs):
        _finish(p, f"rank {r}")
    _finish(one, "one rank")
    run0 = os.path.join(two, "baseline")
    rows = _rows(run0)
    # the state is replicated: rank 1 logs what rank 0 logs
    assert _rows(os.path.join(run0, "proc1")) == rows
    w0, w1 = _weights(run0), _weights(os.path.join(run0, "proc1"))
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    ref = _rows(os.path.join(tmp_path, "one", "baseline"))
    assert [r["step"] for r in rows] == [r["step"] for r in ref]
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    for got, want in zip(rows, ref):
        for k in got:
            name = k.split("/")[-1]
            tol = ({"acc": 0.07, "iou": 0.07, "dice": 1e-3}.get(name, 1e-4))
            assert abs(got[k] - want[k]) <= tol, (got["step"], k, got[k],
                                                  want[k])
    w_ref = _weights(os.path.join(tmp_path, "one", "baseline"))
    assert max(float((w0[k].float() - w_ref[k].float()).abs().max())
               for k in w0) < 5e-3


def test_multihost_worker_two_processes_match_one():
    port = str(free_port())

    def launch(*argv):
        return subprocess.Popen(
            [sys.executable, "-m",
             "sim2real_lane_segment_tpu_torch.parallel.multihost", "--cpu",
             "--steps", "2", *argv], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(proc):
        out, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1])

    workers = [launch("--process_id", str(r), "--num_processes", "2",
                      "--coordinator", f"127.0.0.1:{port}",
                      "--per_device_batch", "2") for r in range(2)]
    single = launch("--per_device_batch", "4")
    r0, r1, ref = (result(w) for w in (*workers, single))
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(ref["losses"], r0["losses"], rtol=1e-5)


@pytest.mark.parametrize("regime", ["sim", "mme"])
def test_data_module_shards_match_jax(trees, regime):
    """Each rank's train batches (2 shards at B=2) are the JAX module's
    shards, and together the one-shard module's batches at B=4."""
    ours_cls, jax_cls = {
        "sim": (modules.SimulatorDataModule, jmodules.SimulatorDataModule),
        "mme": (modules.TwoDomainMMEDataModule,
                jmodules.TwoDomainMMEDataModule)}[regime]

    def batches(cls, **kw):
        m = cls(data_path=trees[regime], seed=5, **kw)
        m.setup()
        return list(m.train_batches(1))

    def flat(batch):
        return (*batch[0], batch[1]) if regime == "mme" else batch

    whole = batches(ours_cls, batch_size=4)
    shards = [batches(ours_cls, batch_size=2, shard_id=r, num_shards=2)
              for r in range(2)]
    for r in range(2):
        theirs = batches(jax_cls, batch_size=2, shard_id=r, num_shards=2)
        assert len(shards[r]) == len(theirs) == len(whole)
        for a, b in zip(shards[r], theirs):
            for x, y in zip(flat(a), flat(b)):
                np.testing.assert_array_equal(x, y)
    for k, w in enumerate(whole):
        for part, (x0, x1) in enumerate(zip(flat(shards[0][k]),
                                            flat(shards[1][k]))):
            np.testing.assert_array_equal(np.concatenate([x0, x1]),
                                          flat(w)[part])
