"""Mean host milliseconds a served batch spends in the program's
``serve.download`` span: the wait for the forward's tail and the copy of the
class maps back to the host."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("serve.download",))
    return spans.mean_ms(got["serve.download"]) if got else None
