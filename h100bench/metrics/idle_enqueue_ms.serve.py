"""idle_enqueue_ms.serve (ms, the program's span on the device trace's
clock): the device's idle time in the traced stretch while the dispatch
thread was inside `serve.enqueue`, whatever the other threads were doing
(the stretch's idle attribution), over the batches the server completed
in it; None when the clock check failed."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or not t.get("idle_attribution") \
            or not t["batches"]:
        return None
    idle = sum(s for label, s in t["idle_attribution"]
               if "dispatch:serve.enqueue" in label.split("|"))
    return 1e3 * idle / t["batches"]
