"""Arousal style transfer (counterpart of
`music_fader_nets_tpu/transfer/arousal.py`), the library form of the
reference's `arousal_transfer.ipynb` (cells 8-17): encode a segment with
the GM-VAE, shift the latent along the line between the mixture component
means (low to high arousal or back), and decode a long autoregressive run.

On the card the encoder is the token-id GRU kernel (Pallas kernel 3's
counterpart), the decode the greedy kernel (11) or, with a temperature,
the Gumbel-max sampling kernel (12); on the CPU their plain versions run.
The noise is the caller's, as everywhere in the port: `eps_r` / `eps_n`
for the latent, `gumbel` for the sampled decode, by default drawn from
`torch.Generator`s seeded with `seed`. Tokens become notes with the port's
performance codec and a MIDI file with its MIDI writer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.gmvae import reg_gmvae_encode
from music_fader_nets_tpu_torch.models.vae import _global_view
from music_fader_nets_tpu_torch.ops import cuda_decode
from music_fader_nets_tpu_torch.tokenizer.midi_io import (
    MidiData, MidiNote, write_midi,
)
from music_fader_nets_tpu_torch.tokenizer.performance_codec import (
    performance_decode,
)

DIRECTIONS = ("low_to_high", "high_to_low")


def compute_shift_vectors(params) -> Dict[str, np.ndarray]:
    """Shift directions from the mixture mean tables (notebook cell 11:
    `r_low_to_high = mu_r_lookup(1) - mu_r_lookup(0)` and the note-stream
    analog), as float32 numpy vectors."""
    mu_r = params["mu_r_lookup"].detach().cpu().numpy()
    mu_n = params["mu_n_lookup"].detach().cpu().numpy()
    return {
        "r_low_to_high": mu_r[1] - mu_r[0],
        "r_high_to_low": mu_r[0] - mu_r[1],
        "n_low_to_high": mu_n[1] - mu_n[0],
        "n_high_to_low": mu_n[0] - mu_n[1],
    }


def transfer_latent(params, item: Dict[str, np.ndarray],
                    direction: str = "low_to_high", lam: float = 1.0,
                    eps_r: Optional[torch.Tensor] = None,
                    eps_n: Optional[torch.Tensor] = None, seed: int = 0,
                    device=None) -> torch.Tensor:
    """The shifted latent (1, 2 * z_dims + chroma_dims) of one segment:
    z = mu + std * eps per stream, plus lam times the stream's shift, then
    the segment's chroma. eps_r / eps_n (1, z_dims) default to standard
    normal draws from a generator seeded with `seed`."""
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got "
                         f"{direction!r}")
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(item["x"]))[None]
    (mu_r, std_r), (mu_n, std_n) = reg_gmvae_encode(params, tokens,
                                                    device=dev)
    gen = torch.Generator().manual_seed(seed)
    if eps_r is None:
        eps_r = torch.randn(mu_r.shape, generator=gen)
    if eps_n is None:
        eps_n = torch.randn(mu_n.shape, generator=gen)
    shifts = compute_shift_vectors(params)
    z_r = mu_r + std_r * eps_r.to(dev, torch.float32)
    z_n = mu_n + std_n * eps_n.to(dev, torch.float32)
    z_r = z_r + lam * torch.from_numpy(shifts[f"r_{direction}"]).to(dev)
    z_n = z_n + lam * torch.from_numpy(shifts[f"n_{direction}"]).to(dev)
    c = torch.as_tensor(np.asarray(item["c"]), dtype=torch.float32)[None]
    return torch.cat([z_r, z_n, c.to(dev)], dim=-1)


def arousal_transfer(params, cfg: ModelConfig, item: Dict[str, np.ndarray],
                     direction: str = "low_to_high", lam: float = 1.0,
                     steps: int = 300, temperature: float = 0.0,
                     eps_r: Optional[torch.Tensor] = None,
                     eps_n: Optional[torch.Tensor] = None,
                     gumbel: Optional[torch.Tensor] = None, seed: int = 0,
                     device=None) -> Tuple[np.ndarray, List[MidiNote]]:
    """item: one dataset element with 'x' tokens and 'c' chroma.
    direction: 'low_to_high' | 'high_to_low'; lam = transfer strength
    (notebook cell 15). temperature > 0 samples each token from
    softmax(logits / temperature) by Gumbel-max (the reference decodes
    greedily only), with `gumbel` (steps, 1, Vp) Gumbel(0, 1) noise, by
    default one generator's draws seeded with `seed`. Runs on CUDA unless
    device='cpu'. Returns (the `steps` generated tokens, decoded notes)."""
    dev = resolve_device(device)
    z = transfer_latent(params, item, direction, lam, eps_r, eps_n, seed,
                        dev)
    gview = _global_view(params)
    if temperature > 0:
        tokens = cuda_decode.sample_decode_tokens(
            gview, z, steps, [seed], temperature, dev, noise=gumbel)
    else:
        tokens = cuda_decode.greedy_decode_tokens(gview, z, steps, dev)
    tokens = tokens[0].cpu().numpy()
    notes = performance_decode([t for t in tokens.tolist() if t > 1])
    return tokens, notes


def transfer_to_midi(tokens_or_notes, path: str) -> None:
    """Write a transfer result (tokens or decoded notes) as a MIDI file at
    120 bpm in 4/4 (the notebook's fluidsynth preview becomes a standard
    artifact)."""
    if len(tokens_or_notes) and isinstance(tokens_or_notes[0], MidiNote):
        notes = tokens_or_notes
    else:
        notes = performance_decode(
            [t for t in np.asarray(tokens_or_notes).tolist() if t > 1])
    end = max((n.end for n in notes), default=1.0)
    write_midi(MidiData(notes, [(0.0, 120.0)], [(0.0, 4, 4)], end_time=end),
               path)
