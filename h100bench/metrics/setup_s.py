"""setup_s (s, host clock): from the start of the run's process to the
window's start: imports, loading (or building) the kernels' library, the
weights and inputs from the seed, the program's object, its first steps or
warm-up batches."""


def read(rec):
    return rec["setup_s"]
