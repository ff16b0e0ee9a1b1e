"""Device milliseconds a step in operations that are not the program's
own kernels (BatchNorm statistics and folds, concatenation copies, the
optimiser, augmentation, the first and transposed convolutions): the
captured glue, from the profiled steps."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t or not t["kernels"]:
        return None
    return 1e3 * t["other_s"] / rec["trace_steps"]
