"""Host milliseconds a train step waits in the enqueue of the graph's
replay (the mean ``train.replay``): while the device runs behind, the
enqueue waits for room in its command queue, so this reads the device's
back-pressure on the host, not host work. None off a card, which
replays no graph."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = spans.window(rec, ("train.replay",))
    return spans.mean_ms(got["train.replay"]) if got else None
