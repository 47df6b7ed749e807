"""forward_call_ms.train (ms, the program's span): the mean host time of
the Trainer's `train.forward` span (the objective's call: its forward
launches and their torch glue) over the window's steps before the traced
stretch (CUPTI off), the steps `trainer_call_ms.train` reads."""
import statistics


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "train" or not sp \
            or not sp["before"].get("train.forward"):
        return None
    return statistics.fmean(sp["before"]["train.forward"])
