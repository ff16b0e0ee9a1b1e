"""The engine thread's own host milliseconds a batch, by the program's
spans: the mean ``engine.assemble`` (concatenation and padding) plus the
mean ``engine.reply`` (slicing the result and waking the callers)."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("engine.assemble", "engine.reply"))
    if not got:
        return None
    assemble = spans.mean_ms(got["engine.assemble"])
    reply = spans.mean_ms(got["engine.reply"])
    if assemble is None or reply is None:
        return None
    return assemble + reply
