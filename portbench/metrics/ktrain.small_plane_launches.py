"""K1-K3b launches of one captured train step at small planes: planes
whose pixels fill under half of their 12x16 tensor-core tiles (15x20,
7x10 and 3x5 on 120x160 frames), where a launch leaves most tile
positions idle. Read from the ``small_plane_launches`` attribute of the
program's ``train.capture`` span, the last before the window. None off a
card, which captures no graph, and for a program whose capture span
lacks the attribute."""
from portbench import spans


def read(rec):
    s = spans.last_before(rec, "train.capture")
    if s is None:
        return None
    return s.attrs.get("small_plane_launches")
