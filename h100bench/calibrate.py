"""The readings that set the limits of `correct`, on the card at the cells'
own sizes:

    python3 h100bench/calibrate.py --workload <name> --seeds 11,12,... \
        [--control 3] [--seconds 3] [--out FILE]

For every seed, the program's readings as a run takes them (a training
cell: its compared first steps, no window; a serving cell: a window of
`--seconds` at the cell's load, then the sampled check). For the first
`--control` seeds besides, the control: the reference computed in TF32 put
in the program's place (serving: at each position of the same prompts and
served tokens, the gap of the token TF32 puts first), and for a training
cell the fault "half of the batch left out" planted in the program. One
JSON line a reading. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _train(cell, seed, device, control):
    import torch
    from h100bench import compare, faults
    from h100bench.reference.common import Arith
    from h100bench.train_cell import (PortTrainer, ReferenceTrainer,
                                        reference_train, setup)
    K, start = cell.traffic["check_steps"], cell.traffic["start_step"]
    kinds = [("program", PortTrainer)]
    if control:
        kinds += [("control_tf32", lambda c, t, d: ReferenceTrainer(
            c, t, d, Arith(tf32=True))), ("fault_half_batch", faults.HalfBatch)]
    ref, out = None, []
    for kind, make in kinds:
        t0 = time.perf_counter()
        tree0, pool, prog, first = setup(cell, seed, device, make)
        got = {"loss": [float(x.detach()) for x in first["loss_t"]],
               "grad1": first["grad1"], "params": first["params"]}
        feeds = pool[:K]
        del prog, pool, first
        torch.cuda.empty_cache()
        if ref is None:
            ref = reference_train(cell, tree0, feeds, start, Arith())
        r = compare.train_readings(got, ref, tree0)
        r.update(compare.leaf_detail(got, ref, tree0))
        out.append({"kind": kind, "seed": seed, **r,
                    "seconds": time.perf_counter() - t0})
    return out


def serve_control(cell):
    """The serving control as an extra check of a run: at each position of
    the sampled prompts and served tokens, the gap (on the float32
    reference's logits) of the token that the reference in TF32 puts
    first."""
    import torch
    from h100bench import compare
    from h100bench.reference.common import Arith

    def tf32_control(tree0, req):
        cfg, size, gap = cell.cfg, cell.traffic["check_block"], 0.0
        with torch.no_grad():
            for a in range(0, req["tokens"].shape[0], size):
                blk = {k: v[a:a + size] for k, v in req.items()}
                with Arith(tf32=True) as low:
                    first = compare.first_tokens(
                        cell.reference.served_logits(low, tree0, blk, cfg))
                with Arith() as ar:
                    gap = max(gap, compare.serve_gap(
                        cell.reference.served_logits(ar, tree0, blk, cfg),
                        first))
        return {"control_tf32": gap}

    return tf32_control


def _serve(cell, seed, device, control, seconds):
    from h100bench import serve_cell
    rec = serve_cell.run(cell, seed, seconds, False, device,
                           time.perf_counter(),
                           also_check=serve_control(cell) if control else None)
    r = rec["readings"]
    out = [{"kind": "program", "seed": seed, "logit_gap": r["logit_gap"],
            "whole": r["whole"], "sampled": r["sampled"],
            "completed": rec["completed"]}]
    if control:
        out.append({"kind": "control_tf32", "seed": seed,
                    "logit_gap": r["control_tf32"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench.harness import Cell
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py runs on a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(seeds):
            control = n < args.control
            if cell.traffic["kind"] == "train":
                lines = _train(cell, seed, device, control)
            else:
                lines = _serve(cell, seed, device, control, args.seconds)
            for line in lines:
                line["workload"] = args.workload
                text = json.dumps(line)
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
