"""The harness: one cell of `BENCHMARK.json` run once.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name in `BENCHMARK.json`:

  configs/<config>.json      the configuration as run (its `file`), with
                             the program's entry points, the reference's
                             name, the optimizer and the noise it draws
  reference/<name>.py        the configuration's plain reference
  workloads/<traffic>.json   the traffic mix, read by the module that runs
                             its kind (`train_cell` or `serve_cell`)
  limits/<workload>.json     the limit of each number that decides
                             `correct`, with the readings it was set from
  metrics/<metric>.py        the metric's reader: read(rec) -> a number, or
                             None when the run has nothing to read for it

The readers read one record, which that module returns and the harness
completes with the cell's configuration, its FLOP family, the number of
floats Adam steps and the card's peaks.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from h100bench import compare

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "music_fader_nets_tpu")


class Cell:
    """One workload of the manifest, with its files loaded."""

    def __init__(self, root: Path, name: str):
        self.root = root
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        self.manifest = manifest
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in manifest["configs"]}[
            self.entry["config"]]
        self.config_path = str(root / conf["file"])
        self.cfg = json.loads(Path(self.config_path).read_text())
        self.traffic = json.loads(
            (HERE / "workloads" / f"{self.entry['traffic']}.json").read_text())
        limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        self.limits = {k: v["limit"] for k, v in limits.items()}
        self.reference = importlib.import_module(
            f"h100bench.reference.{self.cfg['reference']}")

    @staticmethod
    def resolve(spec: str):
        """'package.module:attr' -> the object (the program's entry)."""
        mod, attr = spec.split(":")
        return getattr(importlib.import_module(mod), attr)

    def metrics(self, trace: bool) -> List[Dict]:
        """The manifest's metrics this cell reports in this mode."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(kind: str) -> Optional[Dict]:
    table = json.loads((HERE / "yardstick" / "peaks.json").read_text())
    return table.get(kind)


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        make_program=None) -> Tuple[Dict, List[str]]:
    """Run the cell once; returns (the result line's object, the check
    lines for standard error). `make_program` puts another program in the
    port's place (the control, the faults)."""
    from h100bench import serve_cell, train_cell
    runner = {"train": train_cell, "serve": serve_cell}[
        cell.traffic["kind"]]
    kw = {} if make_program is None else {"make_program": make_program}
    rec = runner.run(cell, seed, seconds, trace, device, t_start, **kw)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    spec = cell.reference.param_spec(cell.cfg)
    rec.update(cfg=cell.cfg, family=cell.cfg["flops_family"],
               peak=peaks(kind), stepped_floats=sum(
                   math.prod(shape) for _, shape, _, used in spec
                   if used is True))
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    expected = "kernel" if device.type == "cuda" else "plain-cpu"
    readings = rec["readings"]
    ok, checks = compare.check(readings, cell.limits)
    whole = readings.get("whole", True)
    correct = bool(ok and whole and rec["failed"] == 0
                   and rec["path"] == expected)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips,
           "memory_peak_bytes": rec["memory_peak_bytes"],
           "power": power_limit() if device.type == "cuda" else None}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": dev}
    if trace and "trace" in rec:
        t = rec["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["wall_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    lines = compare.describe(checks)
    extra = {"path": {"value": rec["path"], "limit": expected},
             "failed": {"value": rec["failed"], "limit": 0}}
    if "whole" in readings:
        extra["whole"] = {"value": whole, "limit": True}
        lines.append(f"check whole {whole!r} expected True")
    lines.append(f"check path {rec['path']!r} expected {expected!r}")
    lines.append(f"check failed {rec['failed']} limit 0")
    result["checks"] = dict(checks, **extra)
    return result, lines

