"""Metrics logging (own copy of `music_fader_nets_tpu/utils/logging.py`).

The reference creates a `log/` directory at startup but never writes to it
(reference trainer.py:22-23, SURVEY.md §5). Here per-epoch metrics stream to
`<log_dir>/<run>.jsonl` — one JSON object per line with a wall-clock
timestamp — so training curves are recoverable without TensorBoard/W&B
dependencies.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, run_name: str, log_dir: str = "log"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None,
            **context) -> None:
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        rec.update(context)
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
