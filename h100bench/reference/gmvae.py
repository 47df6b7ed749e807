"""Plain PyTorch reference of the GM-VAE (Music FaderNets' MusicAttrRegGMVAE,
reference `gmm_model.py` and `trainer_gmm.py`): its parameter tree, the
unsupervised training loss, and the served transfer (encode, shift the
latent along the mixture means, decode greedily).

Independent of the program: written from the reference's definitions,
float32, every matmul through `Arith` so the control can run it in TF32.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List

import torch

from h100bench.reference import common as C


def param_spec(cfg: dict) -> List:
    """The canonical tree's leaves as (path, shape, init, used): init is
    ("uniform", bound) for U(-bound, bound) (torch.nn's defaults, Xavier
    for the mixture means) or ("const", value); `used` is False for the
    layers the reference builds and no forward reads. The logvar tables
    are frozen (no gradient reaches them; gmm_model.py:151-184)."""
    H, Z, V = cfg["hidden_dim"], cfg["z_dim"], cfg["roll_dims"]
    R, N, Cd = cfg["rhythm_dims"], cfg["note_dims"], cfg["chroma_dims"]
    K = cfg["num_clusters"]
    spec = []
    for s in ("r", "n", "c"):
        used = s != "c"
        for d in ("fwd", "bwd"):
            spec += C.gru_spec(f"gru_{s}/{d}", V, H, used)
        spec += C.linear_spec(f"mu_{s}", 2 * H, Z, used)
        spec += C.linear_spec(f"var_{s}", 2 * H, Z, used)
    spec += C.gru_spec("gru_d_r", Z + R, H)
    spec += C.gru_spec("gru_d_n", Z + N, H)
    spec += C.gru_spec("gru_d_c", Z + Cd, H, used=False)
    spec += C.linear_spec("linear_init_r", Z, H)
    spec += C.linear_spec("linear_init_n", Z, H)
    spec += C.linear_spec("linear_init_c", Z, H, used=False)
    spec += C.linear_spec("linear_out_r", H, R)
    spec += C.linear_spec("linear_out_n", H, N)
    spec += C.linear_spec("linear_out_c", Z, Cd, used=False)
    spec += C.linear_spec("c_r", Z, 3, used=False)
    spec += C.linear_spec("c_n", Z, 3, used=False)
    spec += C.decoder_spec(2 * Z + Cd, V, H)
    xavier = math.sqrt(6.0 / (K + Z))
    for s in ("r", "n"):
        spec.append(((f"mu_{s}_lookup",), (K, Z), ("uniform", xavier), True))
    for s in ("r", "n"):
        # pow_exp = -2 (gmm_model.py:71): logvar = 2 * pow_exp
        spec.append(((f"logvar_{s}_lookup",), (K, Z), ("const", -4.0),
                     "frozen"))
    return spec


def encode(ar: C.Arith, p: Dict, tokens: torch.Tensor, V: int):
    """((mu_r, std_r), (mu_n, std_n)) of token ids (B, T): both streams'
    bi-GRUs over the one-hot tokens (model_v2.py:81-97)."""
    x = torch.nn.functional.one_hot(tokens.long(), V).float()
    h_r, h_n = C.bigru_finals(ar, [p["gru_r"], p["gru_n"]], x)
    return (C.encoder_heads(ar, p["mu_r"], p["var_r"], h_r),
            C.encoder_heads(ar, p["mu_n"], p["var_n"], h_n))


def _qy_x(z, mu_lookup, logvar_lookup):
    """log q(y|x) logits and q(y|x) ~= p(y|z) (gmm_model.py:194-218)."""
    logvar = logvar_lookup.detach()
    llh = -0.5 * ((z[:, None, :] - mu_lookup[None]) ** 2
                  / torch.exp(logvar)[None] + logvar[None]
                  + math.log(2.0 * math.pi))
    log_logit = llh.sum(-1) + math.log(1.0 / mu_lookup.shape[0])
    return log_logit, torch.softmax(log_logit, dim=-1)


def _unsupervised_kl(mu, std, qy_x, log_logit, mu_lookup, logvar_lookup):
    """sum_k q(k|x) KL[q(z|x) || p(z|k)] (per-sample mean over D, batch
    mean, summed over K) and KL[q(y|x) || uniform] (a mean over K), the
    prior's scale being exp(logvar) (trainer_gmm.py:150-178)."""
    std_p = torch.exp(logvar_lookup.detach())[None]
    kl = (torch.log(std_p / std[:, None, :])
          + (std[:, None, :] ** 2 + (mu[:, None, :] - mu_lookup[None]) ** 2)
          / (2.0 * std_p ** 2) - 0.5)
    kld_lat = (kl.mean(-1) * qy_x).mean(0).sum()
    K = qy_x.shape[-1]
    h = (qy_x * torch.log_softmax(log_logit, dim=-1)).mean(-1)
    return kld_lat, (h - math.log(1.0 / K)).mean()


def loss(ar: C.Arith, p: Dict, eps, batch: Dict, step: int, cfg: dict):
    """The unsupervised GM-VAE loss of one batch (trainer_gmm.py:109-178
    with the Pati regularization of trainer.py:117-132): 5 CE_X + CE_R +
    CE_N + beta(step) (KL terms) + Pati(z_r[:, 0], rhythm density) +
    Pati(z_n[:, 0], note density). eps = (eps_r, eps_n) (B, Z)."""
    V = cfg["roll_dims"]
    (mu_r, std_r), (mu_n, std_n) = encode(ar, p, batch["x"], V)
    z_r = mu_r + std_r * eps[0]
    z_n = mu_n + std_n * eps[1]
    r_out = C.sub_decoder(ar, p["gru_d_r"], p["linear_init_r"],
                          p["linear_out_r"], batch["r"], cfg["rhythm_dims"],
                          z_r)
    n_out = C.sub_decoder(ar, p["gru_d_n"], p["linear_init_n"],
                          p["linear_out_n"], batch["n"], cfg["note_dims"],
                          z_n)
    z = torch.cat([z_r, z_n, batch["c"]], dim=-1)
    ce_x = C.decoder_teacher_nll(ar, p, z, batch["x"])
    ce = 5.0 * ce_x + C.nll_mean(r_out, batch["r"]) + C.nll_mean(n_out,
                                                                 batch["n"])
    kl = 0.0
    for s, mu, std, zz in (("r", mu_r, std_r, z_r), ("n", mu_n, std_n, z_n)):
        log_logit, qy = _qy_x(zz, p[f"mu_{s}_lookup"], p[f"logvar_{s}_lookup"])
        lat, cls = _unsupervised_kl(mu, std, qy, log_logit,
                                    p[f"mu_{s}_lookup"],
                                    p[f"logvar_{s}_lookup"])
        kl = kl + lat + cls
    beta = C.anneal_beta(step, cfg["beta"])
    return (ce + beta * kl + C.pati(z_r[:, 0], batch["r_density"])
            + C.pati(z_n[:, 0], batch["n_density"]))


DIRECTIONS = {"none": 0.0, "low_to_high": 1.0, "high_to_low": -1.0}


def served_latent(ar: C.Arith, p: Dict, tokens: torch.Tensor,
                  chroma: torch.Tensor, sign: torch.Tensor,
                  lam: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The served transfer's latent (arousal_transfer.ipynb cells 11-15):
    each stream's posterior mean moved by lam along the line between the
    mixture's component means (component 1 minus component 0 for
    low_to_high, sign +1; the reverse for high_to_low, -1; none, 0), then
    the chroma."""
    (mu_r, _), (mu_n, _) = encode(ar, p, tokens, cfg["roll_dims"])
    k = (sign * lam)[:, None]
    shift_r = p["mu_r_lookup"][1] - p["mu_r_lookup"][0]
    shift_n = p["mu_n_lookup"][1] - p["mu_n_lookup"][0]
    return torch.cat([mu_r + k * shift_r, mu_n + k * shift_n, chroma], -1)


def served_logits(ar: C.Arith, p: Dict, req: Dict, cfg: dict
                  ) -> Iterator[torch.Tensor]:
    """The logits (N, V) at each step of the greedy decode that served
    `req["served"]` (N, S) for the requests' prompts, chroma, directions'
    signs and lam."""
    z = served_latent(ar, p, req["tokens"], req["chroma"], req["sign"],
                      req["lam"], cfg)
    return C.decoder_fed_logits(ar, p, z, req["served"])
