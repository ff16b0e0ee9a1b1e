"""A configuration joins the benchmark as new files and entries alone: a
copy of the tree gains a configuration's file, its limits, a cell, the
cell's name in the end-to-end metric it reports and a per-layer metric
of its own, and the unchanged harness runs that cell on the CPU."""
import contextlib
import copy
import io
import json
import os
import shutil

import pytest
from portbench_tiny import ROOT, TINY, TINY_LIMITS, harness, run, traffic

from portbench.reference import compare
from portbench.reference.fcdensenet import FCDenseNet

CELL = "tinyadd.train_sup"
METRIC = "tinyadd.host_ms_per_step"


def snapshot(paths) -> dict:
    """Size and modification time of every file under ``paths``, bytecode
    caches left out."""
    files = [p for p in paths if os.path.isfile(p)]
    for top in paths:
        for d, subdirs, names in os.walk(top):
            subdirs[:] = [s for s in subdirs if s != "__pycache__"]
            files += [os.path.join(d, f) for f in names]
    return {p: (os.stat(p).st_size, os.stat(p).st_mtime_ns) for p in files}


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def added_tree(tree: str) -> None:
    """``tree`` as the repository would be with the configuration
    ``tinyadd`` added: BENCHMARK.json with new entries, new files, and
    the per-layer readers the harness finds by name."""
    here = os.path.join(tree, "portbench")
    shutil.copytree(os.path.join(harness.HERE, "metrics"),
                    os.path.join(here, "metrics"))
    shutil.copy(os.path.join(harness.HERE, "metrics",
                             "train.host_ms_per_step.py"),
                os.path.join(here, "metrics", f"{METRIC}.py"))
    params = sum(p.numel() for p in FCDenseNet(TINY).parameters())
    write(os.path.join(here, "configs", "tinyadd.json"),
          dict(TINY, name="tinyadd", parameters=params))
    write(os.path.join(here, "reference", "limits", "tinyadd.json"),
          {"limits": TINY_LIMITS,
           "readings": {k: "portbench_tiny.TINY_LIMITS" for k in
                        TINY_LIMITS}})
    bench = copy.deepcopy(harness.benchmark())
    bench["configs"].append(
        {"name": "tinyadd", "source": "https://arxiv.org/abs/1611.09326",
         "file": "portbench/configs/tinyadd.json", "reduced": [],
         "why": "a configuration added as files and entries"})
    bench["workloads"].append(
        {"name": CELL, "config": "tinyadd", "traffic": "train_sup_b32",
         "chips": 1, "why": "the graphed steps of the added configuration"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append(CELL)
    bench["per_layer"].append(
        {"name": METRIC, "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "train step",
         "moves": "train_images_per_s", "workloads": [CELL]})
    write(os.path.join(tree, "BENCHMARK.json"), bench)


def test_a_configuration_added_as_files_and_entries_runs(tmp_path,
                                                         monkeypatch):
    real = [os.path.join(ROOT, "BENCHMARK.json"), harness.HERE]
    before = snapshot(real)
    mix = traffic("train")  # train_sup_b32 at the tiny size
    tree = str(tmp_path / "tree")
    added_tree(tree)
    monkeypatch.setattr(harness, "ROOT", tree)
    monkeypatch.setattr(harness, "HERE", os.path.join(tree, "portbench"))
    monkeypatch.setattr(compare, "HERE",
                        os.path.join(tree, "portbench", "reference"))

    lines = {}
    for trace in (0, 1):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            # the configuration and its limits are found by name
            rc = run.main(["--workload", CELL, "--seed", str(2 ** 33 + 17),
                           "--seconds", "1.5", "--trace", str(trace)],
                          device="cpu", traffic=mix)
        assert rc == 0, err.getvalue()
        lines[trace] = json.loads(out.getvalue().strip().splitlines()[-1])
        assert lines[trace]["correct"] is True, err.getvalue()
    assert set(lines[0]["metrics"]) == {"setup_s", "train_images_per_s"}
    assert lines[1]["metrics"][METRIC]["value"] > 0
    for name, c in lines[0]["checks"].items():  # the added file's limits
        assert c["limit"] == TINY_LIMITS.get(name, 0), name
    assert snapshot(real) == before


def test_a_configuration_without_limits_names_the_missing_file(tmp_path,
                                                               monkeypatch):
    monkeypatch.setattr(compare, "HERE", str(tmp_path))
    with pytest.raises(SystemExit) as e:
        compare.limits("tinyadd")
    assert os.path.join(str(tmp_path), "limits", "tinyadd.json") in \
        str(e.value)
