"""Mean host milliseconds a served batch spends in the program's
``serve.upload`` span: the batch's uint8 frames copied to the device."""
from portbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    got = spans.window(rec, ("serve.upload",))
    return spans.mean_ms(got["serve.upload"]) if got else None
