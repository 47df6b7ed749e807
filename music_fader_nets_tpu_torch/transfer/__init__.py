"""Arousal transfer: the latent shift, the transfer itself, its MIDI and
WAV outputs, and its CLI (`python -m music_fader_nets_tpu_torch.transfer.cli`)."""
