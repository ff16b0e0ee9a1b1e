"""BENCHMARK.json and the files it names: the contract's shapes, names
and cross-references."""
import os
import re

import pytest
from portbench_tiny import ROOT, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = harness.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def reports(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_top_level_and_sizes():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in cmd)
    assert any(w.startswith(BENCH["paths"][0] + "/") for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


def test_a_full_check_fits_its_time():
    # 24 cells: 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a
    # cell to compile, 1200 s spare
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"],
                                   *metrics()],
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_its_files(cell):
    config = harness.find(BENCH["configs"], cell["config"], "configuration")
    path = os.path.join(ROOT, config["file"])
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    cfg = harness.read_json(path)
    assert cfg["name"] == config["name"]
    traffic = harness.read_json(os.path.join(
        harness.HERE, "traffic", f"{cell['traffic']}.json"))
    assert traffic["name"] == cell["traffic"]
    assert hasattr(harness.driver(traffic["kind"]), "Cell")
    from portbench.reference import compare
    assert compare.limits(cell["config"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader_and_moves_one_metric(metric):
    assert callable(harness.reader(metric["name"]).read)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", [w["name"]
                                         for w in BENCH["workloads"]]):
        assert metric["moves"] in reports(cell)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    got = reports(cell["name"])
    assert "setup_s" in got and len(got) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_every_config_is_used_and_files_are_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_config_files_state_the_published_widths():
    from portbench.reference.fcdensenet import FCDenseNet
    for c in BENCH["configs"]:
        cfg = harness.read_json(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
        n = sum(p.numel() for p in FCDenseNet(cfg).parameters())
        assert n == cfg["parameters"]
