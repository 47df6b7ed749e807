"""optim_call_ms.train (ms, the program's span): the host time of the
Trainer's `train.clip` and `train.adam` spans (the global-norm clip and
`optimizer.step()`) a step, over the window's steps before the traced
stretch (CUPTI off), the steps `trainer_call_ms.train` reads."""


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "train" or not sp \
            or not sp["before"].get("train.step"):
        return None
    b = sp["before"]
    return (sum(b.get("train.clip", [])) + sum(b.get("train.adam", []))) \
        / len(b["train.step"])
