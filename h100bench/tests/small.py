"""A cell of the manifest at a size a CPU test can hold: the real files,
read as the harness reads them, with the widths, lengths, batch and load
cut down. The configuration is rewritten to a temporary file, since the
program reads its own configuration from the cell's file."""
from __future__ import annotations

import json
from pathlib import Path

from h100bench.harness import Cell

ROOT = Path(__file__).resolve().parents[2]

SIZES = {"hidden_dim": 32, "z_dim": 8, "seq_len": 12, "attr_len": 5,
         "transfer_decode_steps": 16, "batch_size": 8}
TRAIN = {"batch": 8, "pool_batches": 6, "trace_steps": 2}
SERVE = {"arrival": {"kind": "closed", "clients": 8},
         "server": {"max_batch": 4}, "prompt_len": 12, "steps": 16,
         "pool_requests": 64, "warm_requests": 4, "keep_share": 0.5,
         "check_requests": 12, "check_block": 8, "trace_seconds": 0.2}


def small_cell(name: str, tmp: Path, **sizes) -> Cell:
    """The cell `name` at SIZES (and `sizes`), its configuration file
    written under `tmp`."""
    cell = Cell(ROOT, name)
    cell.cfg.update(SIZES, **sizes)
    path = tmp / f"{cell.entry['config']}.json"
    path.write_text(json.dumps(cell.cfg))
    cell.config_path = str(path)
    cell.traffic.update(TRAIN if cell.traffic["kind"] == "train" else SERVE)
    return cell
