"""enqueue_ms.serve (ms, the program's span): the median over batches of
the dispatch thread's `serve.enqueue` span (a batch's host-to-device
copies and every launch), for the batches enqueued before the traced
stretch (CUPTI off)."""
import statistics


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "serve" or not sp \
            or not sp["before"].get("serve.enqueue"):
        return None
    return statistics.median(sp["before"]["serve.enqueue"])
