"""Parameter trees, checkpoints, and the converter for the reference's
PyTorch `.pt` state_dicts (counterpart of
`music_fader_nets_tpu/utils/checkpoint.py`).

The port keeps the JAX package's parameter tree — the same nested dict
names, the same input-major layouts — so a JAX params tree converts with
`params_from_numpy(jax.tree.map(np.asarray, params), device)` and back with
`params_to_numpy`, copying values and changing nothing else.

Checkpoints. The reference saves `model.cpu().state_dict()` each epoch and
nothing else (reference trainer.py:43-45, 267-277), so its resume restarts
the optimizer and the KL anneal. A checkpoint here is a directory holding
one file, `state.pt`: one `torch.save` of CPU tensors in canonical trees
(`params`, the canonical Adam state `opt_state` = {"count", "mu", "nu"})
and Python ints (`step`, `epoch`). It is read with `weights_only=True`,
which refuses anything but tensors, containers and plain values. A file
that holds a bare params tree is the params-only layout: it restores with
a fresh optimizer at step 0. The JAX package's Orbax directories are not
read (the port imports no Orbax): export their params with the JAX
package's `params_to_torch_state_dict` and `torch.save`, then pass the
file as a `.pt` checkpoint.

The converter only renames and transposes (gate order r, z, n is already
PyTorch's):

  torch `layer.weight (O,I)`            <-> params[layer]['w'] (I,O)
  torch `gru.weight_ih_l0 (3H,I)`       <-> params[gru]['fwd']['w_ih'] (I,3H)
  torch `gru.weight_ih_l0_reverse`      <-> params[gru]['bwd']['w_ih']
  torch `grucell.weight_ih (3H,I)`      <-> params[grucell]['w_ih'] (I,3H)
  torch `emb_lookup.weight (K,D)`       <-> params['emb_lookup'] (K,D)
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

STATE_FILE = "state.pt"
# files the JAX package's Orbax StandardCheckpointer writes into its
# checkpoint directory
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")
FROM_PT_HINT = (
    "export its params with the JAX package (sd = music_fader_nets_tpu."
    "utils.checkpoint.params_to_torch_state_dict(params); torch.save({k: "
    "torch.from_numpy(v) for k, v in sd.items()}, 'model.pt')) and pass "
    "--from-pt model.pt")


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict (or list/tuple) of numpy arrays -> the same structure of
    tensors on `device`; float arrays become float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of `params_from_numpy`: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def tree_map(fn, tree: Any) -> Any:
    """`fn` applied to every leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict/list to `device` (no copy where a
    tensor already lies there)."""
    return tree_map(lambda t: t.to(device), tree)


def named_leaves(tree: Any, prefix=()):
    """(path tuple, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def check_params_like(params: Dict, template: Dict) -> None:
    """Raise ValueError unless `params` has `template`'s leaves with the
    same shapes (a checkpoint of another family or width)."""
    got = {k: tuple(v.shape) for k, v in named_leaves(params)}
    want = {k: tuple(v.shape) for k, v in named_leaves(template)}
    if got == want:
        return
    for k in sorted(set(got) | set(want)):
        if got.get(k) != want.get(k):
            raise ValueError(
                f"checkpoint parameter {'.'.join(k)}: shape {got.get(k)}, "
                f"but the model configured here has {want.get(k)} (another "
                "family or width; pass the matching --config)")


# ---------------------------------------------------------------------------
# checkpoints of the port's own format
# ---------------------------------------------------------------------------


def _cpu_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).contiguous()
    if isinstance(tree, (int, np.integer)) and not isinstance(tree, bool):
        return int(tree)
    raise TypeError(f"a checkpoint holds tensors, dicts and ints, not "
                    f"{type(tree).__name__}")


def save_checkpoint(path: str, state: Mapping) -> str:
    """Write `state` (a dict such as {"params", "opt_state", "step",
    "epoch"}, or a bare params tree) to `<path>/state.pt` as CPU tensors
    and ints. The file is written beside its final name, flushed to disk
    and renamed into place, so a run cut short leaves the previous
    checkpoint whole. Returns the file's path."""
    if hasattr(state, "_asdict"):                 # a TrainState
        state = state._asdict()
    tree = _cpu_tree(dict(state))
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(tree, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint directory written by `save_checkpoint` ->
    {"params", "opt_state", "step", "epoch", "layout"}: the full-state
    layout gives all of them ("full"); the params-only layout gives
    opt_state None, step 0 and epoch 0 ("params-only"). Tensors come back
    on the CPU. A missing, truncated or corrupt file raises, as does an
    Orbax directory of the JAX package (with the route that reads it)."""
    final = os.path.join(path, STATE_FILE)
    if not os.path.isfile(final):
        found = set(os.listdir(path)) if os.path.isdir(path) else set()
        if found & set(ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an Orbax checkpoint of the JAX package, which "
                f"the port does not read: {FROM_PT_HINT}")
        raise FileNotFoundError(f"no checkpoint file {final}")
    raw = torch.load(final, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict):
        raise ValueError(f"{final} holds a {type(raw).__name__}, not a "
                         "checkpoint dict")
    if "params" in raw:
        missing = {"opt_state", "step"} - set(raw)
        if missing:
            raise ValueError(f"{final}: full-state checkpoint without "
                             f"{sorted(missing)}")
        opt = raw["opt_state"]
        if not (isinstance(opt, dict) and {"count", "mu", "nu"} <= set(opt)):
            raise ValueError(f"{final}: opt_state is not the canonical "
                             "Adam state {count, mu, nu}")
        return {"params": raw["params"], "opt_state": opt,
                "step": int(raw["step"]), "epoch": int(raw.get("epoch", 0)),
                "layout": "full"}
    if "grucell_g" not in raw:
        raise ValueError(f"{final} holds neither a full state nor a params "
                         f"tree (keys {sorted(raw)[:6]})")
    return {"params": raw, "opt_state": None, "step": 0, "epoch": 0,
            "layout": "params-only"}


# ---------------------------------------------------------------------------
# torch state_dict <-> params conversion
# ---------------------------------------------------------------------------

_GRU_SUFFIXES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
_CELL_SUFFIXES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_GRU_LEAF = {"weight_ih": "w_ih", "weight_hh": "w_hh",
             "bias_ih": "b_ih", "bias_hh": "b_hh"}


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def convert_torch_state_dict(sd: Mapping[str, Any]) -> Dict:
    """Reference-named torch state_dict -> the canonical params tree of
    float32 CPU tensors. Parameter names match the reference modules 1:1
    for every family; unknown keys raise ValueError."""
    params: Dict[str, Any] = {}

    def put(layer, leaf, value):
        params.setdefault(layer, {})[leaf] = _f32(value)

    for key, tensor in sd.items():
        t = torch.as_tensor(tensor)
        if "." not in key:
            raise ValueError(f"unexpected flat key {key!r}")
        layer, leaf = key.split(".", 1)
        if leaf in ("weight", "bias") and layer.endswith("_lookup"):
            # nn.Embedding tables (gmm_model.py:157-183): stored as they are
            params[layer] = _f32(t)
        elif leaf == "weight":
            put(layer, "w", t.T)
        elif leaf == "bias":
            put(layer, "b", t)
        elif leaf in _GRU_SUFFIXES:                       # nn.GRU, forward
            kind = leaf.split("_l0")[0]
            dest = params.setdefault(layer, {})
            is_bigru = any(k.endswith("_reverse") for k in sd
                           if k.startswith(layer + "."))
            sub = dest.setdefault("fwd", {}) if is_bigru else dest
            sub[_GRU_LEAF[kind]] = _f32(t.T if kind.startswith("weight")
                                        else t)
        elif leaf.endswith("_reverse") and leaf.split("_l0")[0] in _GRU_LEAF:
            kind = leaf.split("_l0")[0]
            sub = params.setdefault(layer, {}).setdefault("bwd", {})
            sub[_GRU_LEAF[kind]] = _f32(t.T if kind.startswith("weight")
                                        else t)
        elif leaf in _CELL_SUFFIXES:                      # nn.GRUCell
            put(layer, _GRU_LEAF[leaf],
                t.T if leaf.startswith("weight") else t)
        else:
            raise ValueError(f"unrecognized state_dict key {key!r}")
    return params


def params_to_torch_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """Canonical params tree -> reference-named state_dict of CPU tensors
    (for exporting trained weights to the reference's PyTorch modules)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        t = t.detach().to("cpu")
        sd[name] = (t.T if transpose else t).contiguous()

    for layer, val in params.items():
        if isinstance(val, torch.Tensor):                 # embedding table
            put(f"{layer}.weight", val)
            continue
        if set(val.keys()) == {"fwd", "bwd"}:             # bidirectional GRU
            for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
                for ours, theirs in (("w_ih", "weight_ih_l0"),
                                     ("w_hh", "weight_hh_l0"),
                                     ("b_ih", "bias_ih_l0"),
                                     ("b_hh", "bias_hh_l0")):
                    put(f"{layer}.{theirs}{suffix}", val[d][ours],
                        ours.startswith("w"))
        elif set(val.keys()) == {"w_ih", "w_hh", "b_ih", "b_hh"}:
            # the reference's sub-decoders are nn.GRU (-> _l0 names), its
            # global decoder cells nn.GRUCell (-> bare names)
            is_cell = layer.startswith("grucell")
            for ours, base in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                put(f"{layer}.{base if is_cell else base + '_l0'}",
                    val[ours], ours.startswith("w"))
        elif set(val.keys()) == {"w", "b"}:
            put(f"{layer}.weight", val["w"], True)
            put(f"{layer}.bias", val["b"])
        else:
            raise ValueError(f"unrecognized param group {layer!r}")
    return sd


def load_pt_checkpoint(path: str, device="cpu") -> Dict:
    """Load a reference `.pt` state_dict (tensors, read with
    weights_only=True) into a canonical params tree on `device`. A missing
    or unreadable file raises."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no .pt checkpoint at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state_dict")
    return tree_to(convert_torch_state_dict(sd), device)
