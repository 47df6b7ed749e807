"""Configuration of the port: its own copy of the reference-format model
config (the flat JSON of `model_config_v2.json` / `gmm_model_config.json`)
and the model dimension constants. Field names and defaults are those of
the JAX package's `ModelConfig`, so the same JSON files load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

EVENT_DIMS = 342
RHYTHM_DIMS = 3
NOTE_DIMS = 16
CHROMA_DIMS = 24


@dataclasses.dataclass
class ModelConfig:
    """Model dimensions; defaults replicate `model_config_v2.json` and the
    JAX package's `ModelConfig`. Only the fields the ported slices read
    are here; `load_config` ignores the rest of a reference JSON."""
    hidden_dims: int = 512
    z_dims: int = 128
    num_clusters: int = 2          # GM-VAE components (gmm_model_config.json)

    roll_dims: int = EVENT_DIMS
    rhythm_dims: int = RHYTHM_DIMS
    note_dims: int = NOTE_DIMS
    chroma_dims: int = CHROMA_DIMS

    seq_len: int = 100             # padded token length of a segment
    transfer_decode_steps: int = 300   # arousal_transfer.ipynb cells 15/17


_KEY_ALIASES = {
    "hidden_dim": "hidden_dims",
    "z_dim": "z_dims",
}


def load_config(path: Optional[str] = None, **overrides) -> ModelConfig:
    """Load a reference-format JSON config (flat dict) into a ModelConfig.
    Accepts `hidden_dim` / `z_dim` as aliases and ignores unknown keys."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kwargs = {}
    if path is not None:
        with open(path) as f:
            raw = json.load(f)
        for k, v in raw.items():
            k = _KEY_ALIASES.get(k, k)
            if k in fields:
                kwargs[k] = v
    kwargs.update({k: v for k, v in overrides.items() if k in fields})
    return ModelConfig(**kwargs)
