"""roofline_share.serve (%, device trace): the least time the card could
take for one served batch (max_batch rows: the encoder over the prompt
and the whole greedy decode; the yardstick's operation list) over the
device-busy time a batch of the traced stretch (batches counted by the
server as it completes them)."""
from h100bench.yardstick import roofline


def read(rec):
    t, peak = rec.get("trace"), rec.get("peak")
    if rec["kind"] != "serve" or not t or not t["busy_s"] or not peak \
            or not t["batches"]:
        return None
    ops = roofline.serve_batch_ops(rec["cfg"], rec["rows"],
                                   rec["cfg"]["transfer_decode_steps"])
    bound = roofline.bound_seconds(ops, peak[rec["cfg"]["dtype"] + "_flops"],
                                   peak["hbm_bytes_per_s"])
    return 100.0 * bound / (t["busy_s"] / t["batches"])
