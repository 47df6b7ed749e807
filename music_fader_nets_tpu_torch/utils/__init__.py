"""Checkpoints and parameter trees, metrics logging, profiling helpers."""
from music_fader_nets_tpu_torch.utils.checkpoint import (  # noqa: F401
    save_checkpoint,
    restore_checkpoint,
    convert_torch_state_dict,
    params_to_torch_state_dict,
)
