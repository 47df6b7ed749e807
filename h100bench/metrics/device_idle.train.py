"""device_idle.train (%, device trace): 1 - the union of the device's
activity intervals over the traced stretch's wall time (whole steps,
between two device synchronises)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
