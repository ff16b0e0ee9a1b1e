"""The served forward's kernels against their roofline: the least time
of the dense layers, TransitionDowns and classifier at every padded
batch computed in the profiled stretch (``cost.fcdensenet``) over the
device time of the program's own kernels there. A batch whose predictor
call straddles an end of the stretch counts by the share of its call
inside it."""
from portbench.cost import fcdensenet as cost


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "serve" or not t or t["port_s"] <= 0:
        return None
    least = 0.0
    for a, b, n in rec["batches"]:
        inside = min(b, t["t_stop"]) - max(a, t["t_start"])
        if inside > 0:
            least += cost.serve_kernels(rec["cfg"], n) * inside / (b - a)
    return 100.0 * least / t["port_s"] if least else None
