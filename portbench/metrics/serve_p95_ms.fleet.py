"""The open loop's 95th percentile of latency (nearest rank), from each
request's due time to its reply, over the requests due before the
profiled stretch starts: the profiler's start and cost hold the engine
back, and the queue they leave takes seconds to drain. A request never
replied counts as infinite, and then nothing is read. It is the
end-to-end ``serve_p95_ms`` of a closed loop, read per layer in the open
loop, where it swings with the host's speed (``PERF.md`` §2)."""
import math

from portbench.harness import nearest_rank


def read(rec):
    if rec.get("kind") != "serve" or rec.get("origin") != "due":
        return None
    t = rec.get("trace")
    before = t["t_start"] if t else math.inf
    lat = [1e3 * (replied - due) for due, replied, _ in rec["requests"]
           if due < before]
    if not lat:
        return None
    lat += [math.inf] * (len(rec["send_late_ms"]) - len(rec["requests"]))
    p95 = nearest_rank(lat, 95)
    return p95 if math.isfinite(p95) else None
