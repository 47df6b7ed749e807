"""launches_per_batch.serve (launches, device trace): kernels and memsets
on the device in the traced stretch over the batches the server completed
in it (the stretch cuts batches at its ends, so the ratio is near the
count, not exact)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or not t["events"] \
            or not t["batches"]:
        return None
    return t["launches"] / t["batches"]
