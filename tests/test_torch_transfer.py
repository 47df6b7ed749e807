"""PyTorch port, arousal transfer (`transfer/arousal.py`, `transfer/
audio.py`) against the JAX package on the CPU, at H=32, z=8 and the real
342-token vocabulary (the performance codec reads the tokens).

The same params and the same noise on both sides: the JAX transfer's key
split into (kr, kn, kd), its z draws normal(kr) / normal(kn) and its
Gumbel noise gumbel(kd, (steps, 1, Vp)) handed to the port as eps_r,
eps_n and gumbel. The output head is sharpened 8x, so that no decode step
is a near-tie (tests/test_torch_decode.py): greedy tokens and sampled
tokens are equal, and `transfer_to_midi` writes byte-identical files. The
JAX decode runs its scan (the Pallas kernel has no CPU lowering and the
JAX package falls back, warning once)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.tokenizer.midi_io import MidiNote as JNote
from music_fader_nets_tpu.transfer import arousal as j_arousal
from music_fader_nets_tpu.transfer import audio as j_audio
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.tokenizer.midi_io import MidiNote
from music_fader_nets_tpu_torch.transfer import arousal, audio
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

DIMS = dict(hidden_dims=32, z_dims=8, num_clusters=2)
STEPS, VP = 120, 384


@pytest.fixture(scope="module")
def setup():
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3),
                                        JConfig(**DIMS)))
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 8.0
    rng = np.random.default_rng(5)
    item = {"x": rng.integers(2, 342, 100).astype(np.int32),
            "c": (rng.random(24) < 0.2).astype(np.float32)}
    return p, item


@pytest.mark.parametrize("direction,temperature", [
    ("low_to_high", 0.0), ("high_to_low", 0.0), ("low_to_high", 1.0)])
def test_arousal_transfer_matches_jax(setup, tmp_path, direction,
                                      temperature):
    p, item = setup
    key = jax.random.PRNGKey(11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # scan fallback
        want, want_notes = j_arousal.arousal_transfer(
            p, JConfig(**DIMS), item, direction, lam=1.5, steps=STEPS,
            rng=key, temperature=temperature)
    kr, kn, kd = jax.random.split(key, 3)
    z = DIMS["z_dims"]
    got, notes = arousal.arousal_transfer(
        params_from_numpy(p), ModelConfig(**DIMS), item, direction,
        lam=1.5, steps=STEPS, temperature=temperature,
        eps_r=torch.from_numpy(np.array(jax.random.normal(kr, (1, z)))),
        eps_n=torch.from_numpy(np.array(jax.random.normal(kn, (1, z)))),
        gumbel=torch.from_numpy(np.array(jax.random.gumbel(
            kd, (STEPS, 1, VP), jnp.float32))),
        device="cpu")
    assert got.dtype == np.int32 and got.shape == (STEPS,)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert [(n.pitch, n.velocity, n.start, n.end) for n in notes] == [
        (n.pitch, n.velocity, n.start, n.end) for n in want_notes]
    if direction == "low_to_high":
        # these draws decode notes, so the MIDI files hold real content
        assert len(notes) > 0
    j_arousal.transfer_to_midi(want, str(tmp_path / "jax.mid"))
    arousal.transfer_to_midi(got, str(tmp_path / "port.mid"))
    arousal.transfer_to_midi(notes, str(tmp_path / "notes.mid"))
    jax_bytes = (tmp_path / "jax.mid").read_bytes()
    assert (tmp_path / "port.mid").read_bytes() == jax_bytes
    assert (tmp_path / "notes.mid").read_bytes() == jax_bytes


def test_transfer_defaults_and_checks(setup):
    """Default noise: seeded (repeatable, another seed moves z); an
    unknown direction raises; the port's decode refuses noise of the
    wrong shape."""
    p, item = setup
    tp = params_from_numpy(p)
    z1 = arousal.transfer_latent(tp, item, seed=1, device="cpu")
    assert z1.shape == (1, 2 * DIMS["z_dims"] + 24)
    assert torch.equal(z1, arousal.transfer_latent(tp, item, seed=1,
                                                   device="cpu"))
    assert not torch.equal(z1, arousal.transfer_latent(tp, item, seed=2,
                                                       device="cpu"))
    with pytest.raises(ValueError, match="direction"):
        arousal.transfer_latent(tp, item, "sideways", device="cpu")
    a, _ = arousal.arousal_transfer(tp, None, item, steps=20,
                                    temperature=1.0, seed=4, device="cpu")
    b, _ = arousal.arousal_transfer(tp, None, item, steps=20,
                                    temperature=1.0, seed=4, device="cpu")
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="noise must be"):
        arousal.arousal_transfer(tp, None, item, steps=20, temperature=1.0,
                                 gumbel=torch.zeros(20, 1, 7), device="cpu")


def test_audio_copy_matches_jax(tmp_path):
    spec = [(60, 90, 0.0, 0.5), (64, 70, 0.25, 1.0), (67, 40, 0.9, 1.3)]
    mine = audio.notes_to_wav([MidiNote(*n) for n in spec],
                              str(tmp_path / "port.wav"))
    theirs = j_audio.notes_to_wav([JNote(*n) for n in spec],
                                  str(tmp_path / "jax.wav"))
    np.testing.assert_array_equal(mine, theirs)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
    assert audio.render_notes([]).size == j_audio.render_notes([]).size
