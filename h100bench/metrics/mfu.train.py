"""mfu.train (%, host clock): the step's analytic matmul FLOPs (the
yardstick's copy of flops.py) times the steps the window completed before
the traced stretch, over those seconds (ended by a device synchronise),
over the card's float32 peak. Read before the profiler first starts, so
CUPTI's cost a launch is not in it."""
from h100bench.yardstick import flops


def read(rec):
    pre, peak = rec.get("before_trace"), rec.get("peak")
    if rec["kind"] != "train" or not pre or not pre["steps"] or not peak:
        return None
    f = flops.train_step_flops(rec["cfg"], rec["family"], batch=rec["batch"])
    return 100.0 * f * pre["steps"] / pre["seconds"] / \
        peak[rec["cfg"]["dtype"] + "_flops"]
