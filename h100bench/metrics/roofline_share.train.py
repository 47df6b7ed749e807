"""roofline_share.train (%, device trace): the least time the card could
take for one step's required operations (the yardstick's operation list,
each max(FLOPs / peak, bytes / bandwidth)) over the device-busy time a
step of the traced stretch."""
from h100bench.yardstick import roofline


def read(rec):
    t, peak = rec.get("trace"), rec.get("peak")
    if rec["kind"] != "train" or not t or not t["busy_s"] or not peak:
        return None
    ops = roofline.train_step_ops(rec["cfg"], rec["family"],
                                  rec["stepped_floats"], batch=rec["batch"])
    bound = roofline.bound_seconds(ops, peak[rec["cfg"]["dtype"] + "_flops"],
                                   peak["hbm_bytes_per_s"])
    return 100.0 * bound / (t["busy_s"] / t["steps"])
