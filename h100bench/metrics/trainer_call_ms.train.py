"""trainer_call_ms.train (ms, the harness's span): the mean host time
from the call of `Trainer.train_step` to its return, over the window's
steps before the traced stretch (before the profiler first starts): the
host's share of a step, since the call returns before the device
finishes."""


def read(rec):
    pre = rec.get("before_trace")
    if rec["kind"] != "train" or not pre or not pre["call_s"]:
        return None
    return 1e3 * sum(pre["call_s"]) / len(pre["call_s"])
