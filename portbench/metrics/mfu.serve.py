"""Model FLOPs of the real frames replied in the window (the forward,
``cost.fcdensenet.forward_flops``) over the window's seconds at the
card's dense bf16 peak."""
from portbench.cost import fcdensenet as cost


def read(rec):
    if rec.get("kind") != "serve" or not rec["frames_in_window"]:
        return None
    done = cost.forward_flops(rec["cfg"]) * rec["frames_in_window"]
    return 100.0 * done / (rec["window_s"] * cost.PEAK["bf16_flops_per_s"])
