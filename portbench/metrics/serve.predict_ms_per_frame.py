"""Host milliseconds of the predictor calls (upload, forward, argmax,
copy back) over the real frames they served."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["engine"]["frames"]:
        return None
    busy = sum(b[1] - b[0] for b in rec["batches"])
    return 1e3 * busy / rec["engine"]["frames"]
