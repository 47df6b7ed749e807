"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the check lines last on standard error and one JSON object as the
last line of standard output. Exits with another code than 0, and prints
no result, without CUDA or with fewer cards than the cell asks for, or
when JAX, its libraries or the JAX package were loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the bytecode of every module imported from here on, written once under
# the checkout (also where the environment turned writing it off) and
# read by the runs after
sys.pycache_prefix = str(ROOT / "build" / "h100bench" / "pycache")
sys.dont_write_bytecode = False
# kernel caches at fixed paths inside the checkout (the port's own library
# is built under build/torch_kernels/ beside them)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "h100bench" / sub)


def main(argv=None) -> int:
    faulthandler.enable()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import harness
    cell = harness.Cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process, few threads: the port's window runs no CPU kernel,
    # and idle intra-op workers would only contend for the cores
    torch.set_num_threads(1)
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
