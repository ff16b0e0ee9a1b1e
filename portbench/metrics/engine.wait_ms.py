"""Mean milliseconds a request waited in the engine, by the program's
own spans: from its submission to the start of the ``engine.predict``
span of the batch that served it (each such span carries the sum of its
requests' waits and their number)."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("engine.predict",))
    if not got or not got["engine.predict"]:
        return None
    p = got["engine.predict"]
    requests = sum(s.attrs["requests"] for s in p)
    return 1e-6 * sum(s.attrs["wait_ns"] for s in p) / requests
