"""Mean host milliseconds the engine spends gathering a batch (its
``engine.gather`` span): from taking the batch's first request to the
batch closing, full or at the engine's ``max_wait_ms``."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("engine.gather",))
    return spans.mean_ms(got["engine.gather"]) if got else None
