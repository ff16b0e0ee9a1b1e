"""Mean host milliseconds a served batch spends in the program's
``serve.launch`` span: normalisation, the fused forward and the argmax
enqueued; the host returns before the device finishes."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("serve.launch",))
    return spans.mean_ms(got["serve.launch"]) if got else None
