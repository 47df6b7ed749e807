"""Arousal transfer: the latent shift, the transfer itself, its MIDI and
WAV outputs, and its CLI (`python -m music_fader_nets_tpu_torch.transfer.cli`)."""
from music_fader_nets_tpu_torch.transfer.arousal import (  # noqa: F401
    compute_shift_vectors,
    arousal_transfer,
)
from music_fader_nets_tpu_torch.transfer.audio import (  # noqa: F401
    notes_to_wav,
    render_notes,
    write_wav,
)
