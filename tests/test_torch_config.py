"""PyTorch port, `config.py` and `train/trainer.py::make_optimizer` against
the JAX package's: `ModelConfig`'s fields (names, order, defaults), both
reference JSON configs loaded field by field, the dimension constants, and
one optimizer step from the same params and gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_fader_nets_tpu import config as j_config
from music_fader_nets_tpu.train.trainer import (
    make_optimizer as j_make_optimizer,
)
from music_fader_nets_tpu_torch import config
from music_fader_nets_tpu_torch.train.trainer import make_optimizer


def test_model_config_fields_match_jax():
    got = [(f.name, f.type, f.default)
           for f in dataclasses.fields(config.ModelConfig)]
    want = [(f.name, f.type, f.default)
            for f in dataclasses.fields(j_config.ModelConfig)]
    assert got == want
    cfg = config.ModelConfig(decay=0.9, name="x", time_step=8,
                             data_axis="d", model_axis="m")
    assert (cfg.decay, cfg.name, cfg.time_step, cfg.data_axis,
            cfg.model_axis) == (0.9, "x", 8, "d", "m")


@pytest.mark.parametrize("path", ["configs/model_config_v2.json",
                                  "configs/gmm_model_config.json"])
def test_load_config_matches_jax(path):
    got = config.load_config(path)
    want = j_config.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.decay == 0.9999 and got.time_step == 32


def test_dimension_constants_match_jax():
    names = ("EVENT_DIMS", "RHYTHM_DIMS", "NOTE_DIMS", "CHROMA_DIMS",
             "TEMPO_DIMS", "VELOCITY_DIMS")
    assert [getattr(config, n) for n in names] == [
        getattr(j_config, n) for n in names]
    assert (config.TEMPO_DIMS, config.VELOCITY_DIMS) == (264, 126)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_make_optimizer_matches_optax(scale):
    """One step of the clip at 1.0 and Adam(lr) from the same params and
    gradients, with the global norm below the clip (scale 0.1) and above
    it (10): the params after it to atol 2e-5, the Trainer's bound."""
    cfg = config.ModelConfig(lr=1e-3)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 12)).astype(np.float32),
              "b": rng.standard_normal(12).astype(np.float32)}
    grads = {k: (scale * rng.standard_normal(v.shape) / np.sqrt(v.size))
             .astype(np.float32) for k, v in params.items()}

    tx = j_make_optimizer(j_config.ModelConfig(lr=1e-3))
    jp = jax.tree.map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(jp), jp)
    want = jax.tree.map(np.asarray, optax.apply_updates(jp, updates))

    opt = make_optimizer(cfg)
    assert (opt.lr, opt.max_norm) == (1e-3, 1.0)
    tensors = {k: torch.tensor(v) for k, v in params.items()}
    adam = opt.adam(list(tensors.values()))
    for k, t in tensors.items():
        t.grad = torch.tensor(grads[k])
    norm = opt.clip_([t.grad for t in tensors.values()])
    assert (float(norm) > 1.0) == (scale > 1.0)
    adam.step()
    for k, t in tensors.items():
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
