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
    """Model and training hyperparameters; defaults replicate
    `model_config_v2.json` and the JAX package's `ModelConfig`. Only the
    fields the ported slices read are here; `load_config` ignores the rest
    of a reference JSON."""
    batch_size: int = 128
    n_epochs: int = 30
    lr: float = 1e-3
    hidden_dims: int = 512
    z_dims: int = 128
    beta: float = 0.2
    num_clusters: int = 2          # GM-VAE components (gmm_model_config.json)

    roll_dims: int = EVENT_DIMS
    rhythm_dims: int = RHYTHM_DIMS
    note_dims: int = NOTE_DIMS
    chroma_dims: int = CHROMA_DIMS

    seq_len: int = 100             # padded token length of a segment
    attr_len: int = 16             # rhythm/note track length
    eval_decode_steps: int = 100   # reference test_class.py:253
    transfer_decode_steps: int = 300   # arousal_transfer.ipynb cells 15/17

    # compute dtype; the port's kernels are float32 and "bfloat16" raises
    # NotImplementedError (mixed precision waits, ROADMAP.md)
    dtype: str = "float32"
    # Kept so the JAX package's JSON configs load unchanged. The port takes
    # no such switch: on CUDA tensors the kernels always run, on CPU
    # tensors their plain versions.
    use_pallas_gru: bool = False

    # faithful replication of reference quirks (True = as the reference)
    # KL anneal window with a negative beta for steps in (1000, 10000)
    # (reference trainer.py:93-96)
    faithful_negative_beta: bool = True
    # sub-decoder log_softmax over the TIME axis (reference
    # model_v2.py:109,114)
    faithful_subdecoder_softmax_axis: bool = True
    # GLSR soft rhythm density from batch element 0 (trainer_glsr.py:154)
    faithful_glsr_batch0: bool = True

    # extensions of the JAX package, not in the reference: a linear
    # 0 -> beta KL warmup over this many steps (0 = the reference
    # schedule), and a per-dimension KL floor in nats (0 = off)
    kl_warmup_steps: int = 0
    free_bits: float = 0.0

    def __post_init__(self):
        if self.dtype == "bfloat16":
            raise NotImplementedError(
                "bfloat16 mixed precision is not ported yet: the port's "
                "kernels are float32")
        if self.dtype != "float32":
            raise ValueError(f"unknown dtype {self.dtype!r}")

    @property
    def ce_x_weight(self) -> float:
        """Reconstruction CE weight on the token stream (reference
        trainer.py:105)."""
        return 5.0


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
