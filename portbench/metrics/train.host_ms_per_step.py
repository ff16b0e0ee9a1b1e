"""Host milliseconds a train step in the host work the step's enqueue
waits on: the mean ``train.draw`` (the step's draws), plus on a card the
mean ``train.stage`` (indices and draws written into the graph's static
buffers). The replay's enqueue (``train.replay``) is left out: it waits
for room in the device's queue (``train.replay_wait_ms_per_step``)."""
from portbench import spans

NAMES = ("train.draw", "train.stage")


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = spans.window(rec, NAMES)
    if not got or not got["train.draw"]:
        return None
    return sum(spans.mean_ms(got[n]) or 0.0 for n in NAMES)
