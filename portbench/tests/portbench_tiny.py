"""A tiny FC-DenseNet and tiny traffic, for running the harness on the
CPU in the tests."""
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, run  # noqa: E402

TINY = dict(name="tiny", arch="tiny", down_blocks=[2, 2], up_blocks=[2, 2],
            bottleneck_layers=2, growth_rate=4, out_chans_first_conv=8,
            dropout_rate=0.2, temperature=0.05, n_classes=4, height=32,
            width=32)
# limits for the tiny network only, set from its readings on the CPU:
# sound runs read loss <= 1.4e-4, first gradient <= 0.09, change <=
# 0.22, statistics after one step <= 5e-4 and after three <= 1.5e-3,
# masks <= 0.021; the float8 control reads statistics after one step >=
# 5.2e-3, each fault far more
TINY_LIMITS = {"loss_gap": 5e-4, "grad1_gap": 0.4, "delta3_gap": 0.5,
               "stats1_gap": 2e-3, "stats3_gap": 3e-3, "mask_gap": 0.2}
CELLS = {"train": "fcd67.train_sup", "fleet": "fcd67.serve_fleet",
         "video": "fcd67.serve_video"}


def traffic(which: str) -> dict:
    cell = harness.find(harness.benchmark()["workloads"], CELLS[which], "")
    t = harness.read_json(os.path.join(harness.HERE, "traffic",
                                       f"{cell['traffic']}.json"))
    if which == "train":
        t.update(batch=4, scan_chunk=2, split_frames=32, draw_pool_steps=8)
    else:
        t.update(pool_frames=64, checked_frames=8)
        if which == "fleet":
            t.update(rate_per_s=40.0)
        else:
            t.update(frames_per_request=8, max_batch=8, clients=2)
    return t


def run_tiny(which: str, seed: int = 3000000001, trace: int = 0,
             faults=(), seconds: float = 1.5, device: str = "cpu"):
    """(exit code, last stdout line as a dict or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELLS[which], "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device=device, cfg=TINY, traffic=traffic(which),
                      limits=TINY_LIMITS, faults=faults)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
