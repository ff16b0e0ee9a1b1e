"""Model FLOPs of the images trained on (three times the forward a
image) over the seconds they took at the card's dense bf16 peak, over
the window's chunks that were not profiled."""
from portbench.cost import fcdensenet as cost


def read(rec):
    if rec.get("kind") != "train":
        return None
    plain = [(a, b) for a, b, profiled in rec["chunks"] if not profiled]
    if not plain:
        return None
    seconds = sum(b - a for a, b in plain)
    images = len(plain) * rec["chunk_steps"] * rec["batch"]
    done = 3.0 * cost.forward_flops(rec["cfg"]) * images
    return 100.0 * done / (seconds * cost.PEAK["bf16_flops_per_s"])
