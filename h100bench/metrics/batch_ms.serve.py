"""batch_ms.serve (ms, the program's span): the median over the requests
completed in the window of their response's `batch_ms`, the server's own
time from its batch's launch to its tokens back on the host."""
import statistics


def read(rec):
    vals = [v for v in rec.get("batch_ms", []) if v is not None]
    if rec["kind"] != "serve" or not vals:
        return None
    return statistics.median(vals)
