"""serve_req_per_s (req/s, host clock): requests completed inside the
window over the window's seconds."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["completed"] / rec["window_s"]
