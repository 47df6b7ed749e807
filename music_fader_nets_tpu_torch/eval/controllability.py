"""Controllability evaluation: consistency / restrictiveness / monotonicity
(paper Table 1; reference test_class.py:73-322; counterpart of
`music_fader_nets_tpu/eval/controllability.py`).

Metric definitions replicate the reference exactly:
  * monotonicity  = R^2 of LinearRegression(attribute vs slider value)
                    (test_class.py:268-272),
  * consistency   = 1 - avg std across samples at the same slider value,
                    densities normalized by the dataset std
                    (test_class.py:170-174, 259-260),
  * restrictiveness = 1 - avg std of the NON-target attribute across slider
                    values (test_class.py:174, 265-266),
reported mean +/- std over `epochs` repetitions.

The reference decodes one (sample, slider-value) pair at a time and
round-trips each output through a MIDI file on disk (test_class.py:125-137).
Here all samples x 8 slider values of a wave decode as one batch on the
device, and the token -> notes -> pianoroll -> attributes round trip runs
in memory on the host (the same attribute semantics, no file I/O).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.ops.cuda_decode import _CHUNK
from music_fader_nets_tpu_torch.tokenizer.pipeline import (
    attributes_from_tokens,
)
from music_fader_nets_tpu_torch.utils.checkpoint import tree_to

EOS = 1


def clean_output(logp_or_tokens) -> np.ndarray:
    """argmax -> strip leading/trailing zeros -> truncate at first EOS
    (reference test_class.py:44-50)."""
    arr = np.asarray(logp_or_tokens)
    tokens = arr if arr.ndim == 1 else np.argmax(arr, axis=-1)
    tokens = np.trim_zeros(tokens)
    if EOS in tokens:
        last = int(np.argwhere(tokens == EOS)[0][0])
        tokens = np.where(tokens == EOS, 0, tokens)[:last]
    return tokens


def get_classes(rhythm, note) -> Tuple[float, float, int, int]:
    """Densities + 3-class buckets (reference test_class.py:59-70)."""
    rhythm = np.asarray(rhythm)
    r_density = float((rhythm == 1).sum() / len(rhythm))
    c_r = 0 if r_density < 0.3 else (1 if r_density < 0.5 else 2)
    note = np.asarray(note)
    n_density = float(note.sum() / len(note))
    c_n = 0 if n_density <= 2 else (1 if n_density <= 3.5 else 2)
    return r_density, n_density, c_r, c_n


def _r2(x: np.ndarray, y: np.ndarray) -> float:
    """R^2 of a 1-D least-squares fit, sklearn LinearRegression's `.score`
    for a single feature; 1.0 for a constant target, as sklearn scores it
    (reference test_class.py:268-272)."""
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    vx = x - x.mean()
    vy = y - y.mean()
    ss_tot = float((vy * vy).sum())
    if ss_tot == 0.0:
        return 1.0
    denom = float((vx * vx).sum())
    slope = float((vx * vy).sum()) / denom if denom > 0 else 0.0
    resid = y - (y.mean() + slope * vx)
    return 1.0 - float((resid * resid).sum()) / ss_tot


def _batch_generator(seed: int, start: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed * 1_000_003 + start)


def _encode_corpus(encode_batched: Callable, arrays: Dict[str, np.ndarray],
                   batch_size: int, seed: int, dev: torch.device):
    """dim 0 of both latents over the whole of `arrays`, the final partial
    batch included (the reference's DataLoader has drop_last=False).
    encode_batched(batch of device tensors, generator) -> (z_r, z_n)."""
    z_r0, z_n0 = [], []
    n = len(arrays["x"])
    batch_size = max(1, min(batch_size, n))
    for s in range(0, n, batch_size):
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            v[s: s + batch_size])).to(dev) for k, v in arrays.items()}
        with torch.no_grad():
            zr, zn = encode_batched(batch, _batch_generator(seed, s))
        z_r0.append(zr[:, 0].cpu().numpy())
        z_n0.append(zn[:, 0].cpu().numpy())
    if not z_r0:
        return None, None
    return np.concatenate(z_r0), np.concatenate(z_n0)


def latent_stats(encode_batched: Callable, arrays: Dict[str, np.ndarray],
                 cfg: ModelConfig, batch_size: int = 128, seed: int = 0,
                 device=None) -> Dict[str, float]:
    """Full-corpus encode: z[:, 0] ranges per stream + attribute stds, the
    `run_through` / `train_test_evaluation` pass of the reference eval
    scripts (test_vanilla_v2.py:20-100)."""
    z_r0, z_n0 = _encode_corpus(encode_batched, arrays, batch_size, seed,
                                resolve_device(device))
    if z_r0 is None:
        z_r0 = z_n0 = np.zeros(1)
    return {
        "z_r_min": float(z_r0.min()), "z_r_max": float(z_r0.max()),
        "z_n_min": float(z_n0.min()), "z_n_max": float(z_n0.max()),
        "r_std": float(np.std(arrays["r_density"])),
        "n_std": float(np.std(arrays["n_density"])),
    }


def latent_monotonicity(encode_batched: Callable,
                        arrays: Dict[str, np.ndarray], cfg: ModelConfig,
                        batch_size: int = 128, seed: int = 0,
                        device=None) -> Dict[str, float]:
    """z-space monotonicity: R^2 of the regularized latent dimension
    against the attribute, on the encoder outputs over the corpus
    (reference test_singlevae_v2.py:311-330)."""
    z_r0, z_n0 = _encode_corpus(encode_batched, arrays, batch_size, seed,
                                resolve_device(device))
    if z_r0 is None:
        return {}
    return {"z_r_monotonicity": _r2(z_r0, np.asarray(arrays["r_density"])),
            "z_n_monotonicity": _r2(z_n0, np.asarray(arrays["n_density"]))}


@dataclasses.dataclass
class EvalScores:
    consistency: Tuple[float, float]
    restrictiveness: Tuple[float, float]
    monotonicity: Tuple[float, float]

    def report(self) -> str:
        return ("============================================\n"
                f"Consistency: {self.consistency[0]} +/- {self.consistency[1]}\n"
                f"Restrictiveness: {self.restrictiveness[0]} +/- {self.restrictiveness[1]}\n"
                f"Monotonicity: {self.monotonicity[0]} +/- {self.monotonicity[1]}\n"
                "============================================")


class ControllabilityEvaluator:
    """Latent-sliding evaluator for the disentangled models (RegVAE, GLSR
    variant, RegGMVAE): shifts z_r[:, 0] or z_n[:, 0] (reference
    test_class.py:226-322, test_gmm_v2.py:27-50)."""

    def __init__(self, params, cfg: ModelConfig,
                 encode: Callable,    # (params, x_oh, tokens=) -> (mu, std)s
                 decode: Callable,    # (params, z_full, steps) -> logp
                 target: str = "rhythm",
                 epochs: int = 2, num_of_samples: int = 20,
                 decode_steps: int = 100, seed: int = 0,
                 verbose: bool = True,
                 decode_tokens: Optional[Callable] = None,
                 sample_z: bool = True, device=None):
        """decode_tokens: optional (params, z_full, steps, device) -> int
        tokens, the greedy decode kernel's path
        (`models.reg_vae_decode_tokens`); the default is the argmax of
        `decode`'s log-probs.

        sample_z: True (as the reference, test_class.py:233-254) draws z ~
        q(z|x) from a `torch.Generator` seeded with `seed`; False uses the
        posterior mean, which takes the sampling noise out of the
        consistency metric.

        Runs on CUDA unless device='cpu'."""
        self.device = resolve_device(device)
        self.params, self.cfg = tree_to(params, self.device), cfg
        self.encode, self.decode = encode, decode
        self.decode_tokens = decode_tokens
        self.target = target
        self.epochs, self.num_of_samples = epochs, num_of_samples
        self.decode_steps = decode_steps
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator().manual_seed(seed)
        self.verbose = verbose
        self.sample_z = sample_z

    # -- latent construction ------------------------------------------------

    def _draw(self, mu, std):
        if not self.sample_z:
            return mu
        eps = torch.randn(mu.shape, generator=self.gen)
        return mu + std * eps.to(mu.device, mu.dtype)

    def _tensor(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                            dtype)

    def _sweep(self, values: np.ndarray, n_items: int, dtype):
        """The slider values, one run of 8 per item."""
        return self._tensor(np.tile(values, n_items), dtype)

    def _z_batch_many(self, items: Dict[str, np.ndarray],
                      values: np.ndarray) -> torch.Tensor:
        """S test items -> (S*8, z_total) rows, target dim swept per item;
        rows are grouped per sample (sample-major). The encoder takes the
        token ids (the embedded-token kernel on the card)."""
        V8 = len(values)
        tok = self._tensor(items["x"], torch.int32)
        (mu_r, std_r), (mu_n, std_n) = self.encode(self.params, None,
                                                   tokens=tok)
        z_r = self._draw(mu_r, std_r).repeat_interleave(V8, dim=0)
        z_n = self._draw(mu_n, std_n).repeat_interleave(V8, dim=0)
        vals = self._sweep(values, len(items["x"]), z_r.dtype)
        if self.target == "rhythm":
            z_r[:, 0] = vals
        else:
            z_n[:, 0] = vals
        c = self._tensor(items["c"], z_r.dtype).repeat_interleave(V8, dim=0)
        return torch.cat([z_r, z_n, c], dim=-1)

    # -- device decode --------------------------------------------------------

    def _decode_all(self, z_full: torch.Tensor) -> np.ndarray:
        """(M, z_total) -> (M, steps) int tokens in one decode call, the
        rows zero-padded to a multiple of the decode kernel's chunk, as the
        JAX package pads them."""
        M, zt = z_full.shape
        if M == 0:
            return np.zeros((0, self.decode_steps), np.int32)
        pad = (-M) % _CHUNK
        if pad:
            z_full = torch.cat([z_full, z_full.new_zeros((pad, zt))])
        if self.decode_tokens is not None:
            toks = self.decode_tokens(self.params, z_full, self.decode_steps,
                                      self.device)
        else:
            toks = torch.argmax(
                self.decode(self.params, z_full, self.decode_steps), dim=-1)
        return toks[:M].cpu().numpy()

    # -- main loop ----------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, arrays: Dict[str, np.ndarray], min_val: float,
                 max_val: float, r_std: float, n_std: float) -> EvalScores:
        """Metric semantics are the reference's exactly
        (test_class.py:79-194); every wave of samples x 8 slider values
        decodes as one device batch, and the token -> attribute round trip
        runs on the host afterwards."""
        c_lst, r_lst, m_lst = [], [], []
        n_items = len(arrays["x"])
        gap = (max_val - min_val) / 8
        values = np.array([min_val + k * gap for k in range(8)])
        V8 = len(values)

        for _ in range(self.epochs):
            r_all, n_all, mono = [], [], []
            attempts = 0
            while len(mono) < self.num_of_samples and \
                    attempts < 4 * self.num_of_samples:
                wave = min(self.num_of_samples - len(mono),
                           4 * self.num_of_samples - attempts)
                attempts += wave
                idx = self.rng.integers(0, n_items, size=wave)
                items = {k: v[idx] for k, v in arrays.items()}
                z_full = self._z_batch_many(items, values)
                tokens = self._decode_all(z_full)        # (wave*8, steps)

                for si in range(wave):
                    r_row, n_row = [], []
                    for k in range(V8):
                        res = attributes_from_tokens(
                            clean_output(tokens[si * V8 + k]))
                        if res is None:
                            break
                        rhythm, note = res
                        rd, nd, _, _ = get_classes(rhythm, note)
                        r_row.append(rd)
                        n_row.append(nd)
                    if len(r_row) < V8:
                        continue               # discard, like the reference
                    r_all.append(r_row)
                    n_all.append(n_row)
                    tgt = r_row if self.target == "rhythm" else n_row
                    mono.append(_r2(values, np.array(tgt)))

            if not r_all:
                # no sample survived the token -> attribute round trip this
                # epoch (a checkpoint that decodes nothing parseable). The
                # reference would feed empty arrays into np.std and print
                # nan with warnings; the nan is explicit here.
                if self.verbose:
                    print("WARNING: every sample discarded this epoch "
                          "(no decode parsed back to attributes)")
                c_lst.append(float("nan"))
                r_lst.append(float("nan"))
                m_lst.append(float("nan"))
                continue
            r_all = np.array(r_all) / r_std
            n_all = np.array(n_all) / n_std
            if self.target == "rhythm":
                consistency = 1 - np.average(np.std(r_all, axis=0))
                restrictiveness = 1 - np.average(np.std(n_all, axis=-1))
            else:
                consistency = 1 - np.average(np.std(n_all, axis=0))
                restrictiveness = 1 - np.average(np.std(r_all, axis=-1))
            monotonicity = float(np.mean(mono)) if mono else 0.0
            if self.verbose:
                print("Generator consistency: ", consistency)
                print("Generator restrictiveness: ", restrictiveness)
                print("Generator monotonicity:", monotonicity)
            c_lst.append(consistency)
            r_lst.append(restrictiveness)
            m_lst.append(monotonicity)

        scores = EvalScores(
            (float(np.mean(c_lst)), float(np.std(c_lst))),
            (float(np.mean(r_lst)), float(np.std(r_lst))),
            (float(np.mean(m_lst)), float(np.std(m_lst))))
        if self.verbose:
            print(scores.report())
        return scores


class SingleVAEControllabilityEvaluator(ControllabilityEvaluator):
    """Shifts dim 0 (rhythm) / dim 1 (note) of the single latent
    (reference test_singlevae_v2.py:195,241)."""

    def _z_batch_many(self, items, values):
        V8 = len(values)
        tok = self._tensor(items["x"], torch.int32)
        mu, std = self.encode(self.params, None, tokens=tok)
        z = self._draw(mu, std).repeat_interleave(V8, dim=0)
        dim = 0 if self.target == "rhythm" else 1
        z[:, dim] = self._sweep(values, len(items["x"]), z.dtype)
        c = self._tensor(items["c"], z.dtype).repeat_interleave(V8, dim=0)
        return torch.cat([z, c], dim=-1)


class ConditionControllabilityEvaluator(ControllabilityEvaluator):
    """CVAE / FaderNets: sweeps the decoder CONDITION value k/8 instead of
    a latent dimension (reference test_cvae_v2.py:37,74-78). `encode` is
    (params, x_oh, r_density, n_density) -> (mu, std): the CVAE's encoder
    reads the conditions beside the one-hot tokens, so it takes no token
    ids."""

    def _z_batch_many(self, items, values):
        V8 = len(values)
        x_oh = F.one_hot(self._tensor(items["x"]).long(),
                         self.cfg.roll_dims).float()
        rd = self._tensor(items["r_density"], torch.float32)[:, None]
        nd = self._tensor(items["n_density"], torch.float32)[:, None]
        mu, std = self.encode(self.params, x_oh, rd, nd)
        z = self._draw(mu, std).repeat_interleave(V8, dim=0)
        vals = self._sweep(values, len(items["x"]), z.dtype)[:, None]
        rd_col = rd.repeat_interleave(V8, dim=0).to(z.dtype)
        nd_col = nd.repeat_interleave(V8, dim=0).to(z.dtype)
        if self.target == "rhythm":
            rd_col = vals
        else:
            nd_col = vals
        return torch.cat([z, rd_col, nd_col], dim=-1)
