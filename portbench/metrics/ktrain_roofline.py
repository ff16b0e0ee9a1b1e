"""The train step's kernels (K1's forwards, K2, K3a, K3b) against their
roofline: the least time of the dense layers' and TransitionDowns'
forwards and backwards of the profiled steps (``cost.fcdensenet``) over
the device time of the program's own kernels there."""
from portbench.cost import fcdensenet as cost


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or t["port_s"] <= 0:
        return None
    least = cost.train_kernels(rec["cfg"], rec["batch"]) * rec["trace_steps"]
    return 100.0 * least / t["port_s"]
