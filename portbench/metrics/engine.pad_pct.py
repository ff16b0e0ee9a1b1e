"""Share of the frames the engine computed that were padding (its
``padded_frames`` over ``frames`` plus ``padded_frames``)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    s = rec["engine"]
    total = s["frames"] + s["padded_frames"]
    return 100.0 * s["padded_frames"] / total if total else None
