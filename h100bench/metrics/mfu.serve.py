"""mfu.serve (%, host clock): the matmul FLOPs of the batches the server
completed in the window before the traced stretch (max_batch rows each,
padding included), over those seconds, over the card's float32 peak.
Read before the profiler first starts."""
from h100bench.yardstick import flops


def read(rec):
    pre, peak = rec.get("before_trace"), rec.get("peak")
    if rec["kind"] != "serve" or not pre or not pre["batches"] or not peak:
        return None
    f = flops.serve_batch_flops(rec["cfg"], rec["rows"],
                                rec["cfg"]["transfer_decode_steps"])
    return 100.0 * f * pre["batches"] / pre["seconds"] / \
        peak[rec["cfg"]["dtype"] + "_flops"]
