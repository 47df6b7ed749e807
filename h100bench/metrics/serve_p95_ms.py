"""serve_p95_ms (ms, host clock): the 95th percentile (linear
interpolation) of the latency of every request completed in the window,
from submit (open loop: from when it was due) to its result. In a closed
loop at capacity the tail follows the rate (Little's law) and swings with
the host: a per-layer metric there (PERF.md, section 2)."""
import numpy as np


def read(rec):
    if rec["kind"] != "serve" or not rec["latency_s"]:
        return None
    return float(np.percentile(np.asarray(rec["latency_s"]) * 1e3, 95))
