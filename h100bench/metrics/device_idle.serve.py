"""device_idle.serve (%, device trace): 1 - the union of the device's
activity intervals over the traced stretch's wall time (a fixed stretch
in the middle of the window, the load running)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
