"""Operations the optimizer issues in one captured train step, a
multi-tensor call counted as one: read from the ``optim_ops`` attribute of
the program's ``train.capture`` span, the last before the window. None off
a card, which captures no graph, and for a program whose capture span
lacks the attribute."""
from portbench import spans


def read(rec):
    s = spans.last_before(rec, "train.capture")
    if s is None:
        return None
    return s.attrs.get("optim_ops")
