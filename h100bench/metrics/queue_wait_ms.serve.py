"""queue_wait_ms.serve (ms, the program's span): the median over requests
of the server's `serve.queue` span, from a request's put until the
dispatcher takes it into a batch, for the requests taken before the
traced stretch (CUPTI off)."""
import statistics


def read(rec):
    sp = rec.get("spans")
    if rec["kind"] != "serve" or not sp \
            or not sp["before"].get("serve.queue"):
        return None
    return statistics.median(sp["before"]["serve.queue"])
