"""launches_per_step.train (launches, device trace): kernels and memsets
on the device in the traced stretch over its steps (whole steps between
two synchronises, so the count repeats exactly)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t or not t["events"]:
        return None
    return t["launches"] / t["steps"]
