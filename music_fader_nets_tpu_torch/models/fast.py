"""Kernel-layout parameter views ("fast params") of every family's tree
(counterpart of `music_fader_nets_tpu/models/fast.py`).

The canonical tree keeps the reference's per-layer names (the checkpoint
contract). The training kernels take stacked weights, so the Trainer
converts once with `split_fast` and Adam steps the stacked leaves;
`merge_canonical` inverts it exactly (stack/pad <-> slice/unstack, no
arithmetic). `split_fast` also sets aside the reference layers that no
forward uses (`FROZEN_KEYS`); `merge_canonical` puts them back unchanged.

Fast-layout groups (keys absent from canonical trees, so the forwards
detect the layout by key):

  enc_rn    {w_ih_p (4,Vp,3H), b_ih (4,3H), w_hh (4,H,3H), b_hh (4,3H)}
            directions [r.fwd, r.bwd, n.fwd, n.bwd]; Vp = ceil128(in_dim)
  enc_1     the same, 2 directions, from `gru` (SingleVAE)
  enc_e     the same, 2 directions, from `gru_e` (CVAE, in_dim = V + 2;
            FaderNets, in_dim = V)
  sub_rn    {w_ih (2,Dm+Z,3H), b_ih, w_hh, b_hh}; input rows [track
            padded to Dm = max(rhythm, note dims), z]
  grucell_g {w_tok_p (Vp,3H), w_z (Z,3H), b_ih, w_hh, b_hh}: the decoder
            cell's w_ih split at the vocab boundary, token rows padded

Pad rows and columns get exactly zero gradients (pad vocab rows are never
selected; pad input columns are zero), so Adam leaves them at their stored
value and `merge_canonical` after any number of steps equals the
canonical computation.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from music_fader_nets_tpu_torch.ops.gru import vocab_pad

# reference layers built for state-dict parity but used by no forward
# (reference model_v2.py:28,36-37)
FROZEN_KEYS = ("gru_c", "gru_d_c", "linear_init_c", "linear_out_c",
               "c_r", "c_n")


def _pack_dirs(grus) -> Dict:
    dirs = [d for g in grus for d in (g["fwd"], g["bwd"])]
    w_ih = torch.stack([d["w_ih"] for d in dirs])            # (L, I, 3H)
    I = w_ih.shape[1]
    return {
        "w_ih_p": F.pad(w_ih, (0, 0, 0, vocab_pad(I) - I)),
        "b_ih": torch.stack([d["b_ih"] for d in dirs]),
        "w_hh": torch.stack([d["w_hh"] for d in dirs]),
        "b_hh": torch.stack([d["b_hh"] for d in dirs]),
    }


def _unpack_dirs(group: Dict, in_dims: int, n_streams: int):
    out = []
    for s in range(n_streams):
        stream = {}
        for j, dname in enumerate(("fwd", "bwd")):
            li = 2 * s + j
            stream[dname] = {"w_ih": group["w_ih_p"][li, :in_dims],
                             "b_ih": group["b_ih"][li],
                             "w_hh": group["w_hh"][li],
                             "b_hh": group["b_hh"][li]}
        out.append(stream)
    return out


def _pack_subs(d_r: Dict, d_n: Dict, z_dims: int) -> Dict:
    dr = d_r["w_ih"].shape[0] - z_dims
    dn = d_n["w_ih"].shape[0] - z_dims
    dm = max(dr, dn)

    def scatter(w, d):
        return torch.cat([w[:d], w.new_zeros((dm - d,) + w.shape[1:]),
                          w[d:]])

    return {
        "w_ih": torch.stack([scatter(d_r["w_ih"], dr),
                             scatter(d_n["w_ih"], dn)]),    # (2, Dm+Z, 3H)
        "b_ih": torch.stack([d_r["b_ih"], d_n["b_ih"]]),
        "w_hh": torch.stack([d_r["w_hh"], d_n["w_hh"]]),
        "b_hh": torch.stack([d_r["b_hh"], d_n["b_hh"]]),
    }


def _unpack_subs(group: Dict, dr: int, dn: int, z_dims: int):
    dm = group["w_ih"].shape[1] - z_dims

    def mk(i, d):
        w = group["w_ih"][i]
        return {"w_ih": torch.cat([w[:d], w[dm:]]),
                "b_ih": group["b_ih"][i], "w_hh": group["w_hh"][i],
                "b_hh": group["b_hh"][i]}

    return mk(0, dr), mk(1, dn)


def split_fast(params: Dict) -> Tuple[Dict, Dict]:
    """Canonical params -> (fast params, the FROZEN_KEYS leaves)."""
    p = dict(params)
    frozen = {k: p.pop(k) for k in FROZEN_KEYS if k in p}
    if "gru_r" in p and "gru_n" in p:
        p["enc_rn"] = _pack_dirs([p.pop("gru_r"), p.pop("gru_n")])
    elif isinstance(p.get("gru"), dict) and "fwd" in p["gru"]:
        p["enc_1"] = _pack_dirs([p.pop("gru")])
    elif "gru_e" in p:
        p["enc_e"] = _pack_dirs([p.pop("gru_e")])
    if "gru_d_r" in p and "gru_d_n" in p:
        z_dims = p["mu_r"]["w"].shape[1]
        p["sub_rn"] = _pack_subs(p.pop("gru_d_r"), p.pop("gru_d_n"), z_dims)
    if "grucell_g" in p and "w_ih" in p["grucell_g"]:
        g = dict(p["grucell_g"])
        w_ih = g.pop("w_ih")
        V = p["linear_out_g"]["w"].shape[1]
        g["w_tok_p"] = F.pad(w_ih[:V], (0, 0, 0, vocab_pad(V) - V))
        g["w_z"] = w_ih[V:]
        p["grucell_g"] = g
    return p, frozen


def merge_canonical(fast: Dict, frozen: Dict, template: Dict) -> Dict:
    """Inverse of `split_fast`; `template` is any tree with the canonical
    structure (only shapes are read)."""
    p = dict(fast)
    p.update(frozen)
    if "enc_rn" in p:
        in_dims = template["gru_r"]["fwd"]["w_ih"].shape[0]
        p["gru_r"], p["gru_n"] = _unpack_dirs(p.pop("enc_rn"), in_dims, 2)
    for group, key in (("enc_1", "gru"), ("enc_e", "gru_e")):
        if group in p:
            in_dims = template[key]["fwd"]["w_ih"].shape[0]
            (p[key],) = _unpack_dirs(p.pop(group), in_dims, 1)
    if "sub_rn" in p:
        z_dims = template["mu_r"]["w"].shape[1]
        dr = template["gru_d_r"]["w_ih"].shape[0] - z_dims
        dn = template["gru_d_n"]["w_ih"].shape[0] - z_dims
        p["gru_d_r"], p["gru_d_n"] = _unpack_subs(p.pop("sub_rn"), dr, dn,
                                                  z_dims)
    if "grucell_g" in p and "w_tok_p" in p["grucell_g"]:
        g = dict(p["grucell_g"])
        V = template["linear_out_g"]["w"].shape[1]
        g["w_ih"] = torch.cat([g.pop("w_tok_p")[:V], g.pop("w_z")])
        p["grucell_g"] = g
    return p
