"""The whole harness at a tiny size on the CPU: one contract line, the
card check, and the check for JAX."""
import sys
import types

import pytest
from portbench_tiny import CELLS, harness, run, run_tiny

BENCH = harness.benchmark()


@pytest.mark.parametrize("which", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_one_contract_line(which, trace):
    rc, line, err = run_tiny(which, trace=trace, seed=2 ** 33 + 5)
    assert rc == 0, err
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = CELLS[which]
    if trace == 0:
        want = {m["name"] for m in BENCH["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
    else:
        allowed = {m["name"] for m in BENCH["per_layer"]
                   if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) <= allowed
        assert "breakdown" in line
    for name, m in line["metrics"].items():
        # padding is 0 where every batch is full; nothing else reads 0
        assert m["value"] > 0 or name == "engine.pad_pct", name
        assert m["unit"]
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_same_seed_same_inputs():
    a = run_tiny("train", seed=77)[1]["checks"]
    b = run_tiny("train", seed=77)[1]["checks"]
    assert a == b


def test_no_card_no_result(capsys):
    rc = run.main(["--workload", CELLS["train"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_jax_loaded_after_the_window_refuses_the_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("x"))
    rc, line, err = run_tiny("video")
    assert rc == 3 and line is None and "jaxlib.fake" in err


def test_the_port_and_lookalikes_are_not_jax(monkeypatch):
    for name in ("sim2real_lane_segment_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in harness.forbidden_modules()
                if m in ("sim2real_lane_segment_tpu_torch", "jaxtyping",
                         "flaxen")]


def test_a_run_loads_no_jax():
    import subprocess
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "from portbench_tiny import run_tiny, harness;"
            "rc, line, err = run_tiny('train');"
            "print(rc, line['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.split()[-3:] == ["0", "True", "[]"], out.stderr[-2000:]
