"""Share of the profiled stretch of a training window (one chunk) in
which no operation ran on the device."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
