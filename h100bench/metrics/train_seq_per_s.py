"""train_seq_per_s (seq/s, host clock): sequences of every step completed
in the window over the window's seconds; the window ends with a device
synchronise."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["steps"] * rec["batch"] / rec["window_s"]
