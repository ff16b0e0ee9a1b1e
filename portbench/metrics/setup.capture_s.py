"""Seconds of set-up in the program's ``train.capture`` span, the last
before the window: the graph's eager warm-up steps and its capture, less
the ``setup.load`` spans inside it (a checkout's first run builds the
kernels at their first launch, in the warm-up). None off a card, which
captures no graph."""
from portbench import spans


def read(rec):
    s = spans.last_before(rec, "train.capture")
    if s is None:
        return None
    loads = spans.inside(s, "setup.load")
    return s.seconds - sum(x.seconds for x in loads)
