"""backward_call_ms.train (ms, the program's span): the mean host time of
the Trainer's `train.backward` span (`loss.backward()` and the zero
gradients' fill) over the window's steps before the traced stretch (CUPTI
off), the steps `trainer_call_ms.train` reads."""
import statistics


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "train" or not sp \
            or not sp["before"].get("train.backward"):
        return None
    return statistics.fmean(sp["before"]["train.backward"])
