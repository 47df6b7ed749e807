r"""The arousal transfer entry point (counterpart of the repo root's
`arousal_transfer.py`, the reference's `arousal_transfer.ipynb` cells 8-17
as a script): load the GM-VAE from `--from-pt` or the checkpoint the
training CLI saved under `--save-dir`, pick a VGMIDI test segment, shift
its latent along the mixture component-mean direction, decode `--steps`
tokens, and write them as a MIDI file (and, with `--wav`, a WAV preview).

    python -m music_fader_nets_tpu_torch.transfer.cli --save-dir params \
        [--direction low_to_high|high_to_low] [--lam 1.0] [--steps 300] \
        [--index N] [--temperature T] [--out transfer.mid] [--wav PATH]

Runs on CUDA unless `--device cpu` is given; `main(argv)` returns the
generated tokens and the decoded notes.
"""
from __future__ import annotations

import numpy as np

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.eval.cli import _load_params
from music_fader_nets_tpu_torch.train.cli import (
    build_argparser, config_from_args, load_vgmidi,
)
from music_fader_nets_tpu_torch.transfer.arousal import (
    DIRECTIONS, arousal_transfer, transfer_to_midi,
)
from music_fader_nets_tpu_torch.transfer.audio import notes_to_wav

SAMPLE_RATE = 22050


def main(argv=None):
    ap = build_argparser("Arousal style transfer of a VGMIDI test segment "
                         "with a trained GM-VAE")
    ap.add_argument("--direction", default="low_to_high", choices=DIRECTIONS)
    ap.add_argument("--lam", type=float, default=1.0,
                    help="transfer strength (notebook cell 15)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--index", type=int, default=0,
                    help="VGMIDI test-set segment index")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for the decode; 0 (default) "
                         "= the reference's greedy argmax, >0 = Gumbel-max "
                         "sampling from softmax(logits/T) (seeded by "
                         "--seed, reproducible)")
    ap.add_argument("--out", default="transfer.mid")
    ap.add_argument("--wav", default=None, metavar="PATH",
                    help="also render an audio preview WAV (in place of the "
                         "notebook's fluidsynth playback, cell 2)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config_from_args("gmm", args)
    params = _load_params("gmm", cfg, args)
    vgm = load_vgmidi(args)["test"]
    item = vgm[args.index % len(vgm)]
    tokens, notes = arousal_transfer(
        params, cfg, item, args.direction, lam=args.lam, steps=args.steps,
        temperature=args.temperature, seed=args.seed, device=dev)
    n_events = int(np.count_nonzero(tokens > 1))
    print(f"direction={args.direction} lam={args.lam} steps={args.steps} "
          f"temperature={args.temperature} "
          f"-> {len(notes)} notes from {n_events} non-pad tokens")
    transfer_to_midi(notes, args.out)
    print(f"Wrote {args.out}")
    if args.wav:
        audio = notes_to_wav(notes, args.wav, sample_rate=SAMPLE_RATE)
        print(f"Wrote {args.wav} "
              f"({audio.size / SAMPLE_RATE:.1f}s audio preview)")
    return tokens, notes


if __name__ == "__main__":
    main()
