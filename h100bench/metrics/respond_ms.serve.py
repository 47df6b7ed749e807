"""respond_ms.serve (ms, the program's span): the median over batches of
the fetch thread's `serve.respond` span (the stats, the marshalling and
every `set_result` with the callbacks it runs), for the batches answered
before the traced stretch (CUPTI off)."""
import statistics


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "serve" or not sp \
            or not sp["before"].get("serve.respond"):
        return None
    return statistics.median(sp["before"]["serve.respond"])
