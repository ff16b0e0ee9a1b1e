"""Mean milliseconds from a request's due time (open loop) or send
(closed loop) to the start of the predictor call of the batch that
served it: the engine's gather and queueing. A request belongs to the
last batch that ended before its reply was set."""
import bisect


def read(rec):
    if rec.get("kind") != "serve" or not rec["requests"]:
        return None
    batches = rec["batches"]
    ends = [b[1] for b in batches]
    waits = []
    for origin, replied, _ in rec["requests"]:
        j = bisect.bisect_right(ends, replied) - 1
        if j >= 0:
            waits.append(batches[j][0] - origin)
    return 1e3 * sum(waits) / len(waits) if waits else None
