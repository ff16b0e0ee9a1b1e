"""K3a's own-layer items of one captured train step whose loads were
issued while an earlier item's products ran in the same block, as a share
of all its items: 100 * ``stage_prefetched`` / ``stage_items``, the
attributes of the program's ``train.capture`` span, the last before the
window. None off a card, which captures no graph, and for a program whose
capture span lacks the attributes."""
from portbench import spans


def read(rec):
    s = spans.last_before(rec, "train.capture")
    if s is None:
        return None
    items = s.attrs.get("stage_items")
    prefetched = s.attrs.get("stage_prefetched")
    if not items or prefetched is None:
        return None
    return 100.0 * prefetched / items
