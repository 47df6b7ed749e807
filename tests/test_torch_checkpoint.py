"""PyTorch port, checkpoints (`utils/checkpoint.py`, the canonical Adam
state of `models/fast.py`, `Trainer.state` / `load_state`) against the JAX
package, on the CPU at a small size (H=32, z=8, T=8, attr_len=4, B=4).

- The `.pt` converter, for all six families: the port's
  `params_to_torch_state_dict` gives the JAX one's keys and bit-equal
  arrays; a file `torch.save`d from the JAX state_dict loads through
  `load_pt_checkpoint` to the JAX canonical tree, bit-equal; unknown keys
  raise.
- The Adam state: after three steps of each trainer from the same params,
  batches and noise, the port's canonical {count, mu, nu} against optax's
  `opt_state[1][0]`: count equal, mu and nu to atol 1e-5 (this holds for the
  sub-decoders' output biases too, whose true gradient is exactly 0, see
  tests/test_torch_train_trainer.py: their moments are float32 noise far
  below 1e-5; only their params move by up to 2 * lr a step), the frozen
  leaves exactly 0.
- JAX's state after three steps, handed over as numpy, resumes in the port:
  three more steps on both sides agree to the bounds of
  `test_trainer_steps_match_jax`.
- Save -> restore -> three steps is bit-equal to six straight steps.
- The restore layouts: full state, params-only (fresh optimizer), a
  truncated file, an Orbax directory of the JAX package and a missing
  `--from-pt` file, which raise.

The JAX trainer runs its scan path (use_pallas_gru=False); the Pallas
kernels' parity is held in tests/test_torch_train_trainer.py."""
import argparse
import functools
import os

import jax
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.train import cli as j_cli
from music_fader_nets_tpu.train.trainer import Trainer as JTrainer
from music_fader_nets_tpu.utils import checkpoint as j_ckpt
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data import datasets
from music_fader_nets_tpu_torch.eval import cli as eval_cli
from music_fader_nets_tpu_torch.models import fast
from music_fader_nets_tpu_torch.train import cli as train_cli
from music_fader_nets_tpu_torch.train.trainer import TrainState, Trainer
from music_fader_nets_tpu_torch.utils import checkpoint as ckpt
from music_fader_nets_tpu_torch.utils.checkpoint import (
    named_leaves, params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B, LR, STEPS = 4, 1e-3, 3
NOISE_ONLY = {("linear_out_r", "b"), ("linear_out_n", "b")}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    g, w = list(named_leaves(got)), list(named_leaves(want))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(k))


# ------------------------------------------------------------- converter

@pytest.mark.parametrize("kind", sorted(train_cli.MODEL_REGISTRY))
def test_pt_round_trip_matches_jax(tmp_path, kind):
    # the family's tree as numpy, from the port's init, whose leaves and
    # shapes are the JAX init's
    p = params_to_numpy(train_cli.MODEL_REGISTRY[kind]["init"](
        torch.Generator().manual_seed(0), ModelConfig(**SMALL)))
    shapes = jax.eval_shape(functools.partial(
        j_cli.MODEL_REGISTRY[kind]["init"], cfg=JConfig(**SMALL)),
        jax.random.PRNGKey(0))
    assert [(k, v.shape) for k, v in named_leaves(p)] == [
        (k, v.shape) for k, v in named_leaves(shapes)]
    want = j_ckpt.params_to_torch_state_dict(p)
    got = ckpt.params_to_torch_state_dict(params_from_numpy(p))
    assert list(got) == list(want)
    for k in want:
        assert got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    path = tmp_path / "model.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in want.items()},
               path)
    _assert_trees_equal(ckpt.load_pt_checkpoint(str(path)), p)
    # the two converters read a state_dict to the same tree
    _assert_trees_equal(ckpt.convert_torch_state_dict(got),
                        _np_tree(j_ckpt.convert_torch_state_dict(want)))
    bad = dict(got, **{"extra.thing": torch.zeros(2)})
    with pytest.raises(ValueError, match="unrecognized"):
        ckpt.convert_torch_state_dict(bad)
    with pytest.raises(ValueError, match="flat key"):
        ckpt.convert_torch_state_dict({"flat": torch.zeros(2)})


# ------------------------------------------- Adam state and resume vs JAX

def _corpus(seed):
    rng = np.random.default_rng(seed)
    T, A, n = SMALL["seq_len"], SMALL["attr_len"], 4 * B
    return datasets.YamahaDataset(
        rng.integers(0, 342, (n, T)), rng.integers(0, 3, (n, A)),
        rng.integers(0, 16, (n, A)), rng.random((n, 24)),
        mode="train").arrays()                        # 3 batches


def _jax_noise_fn(seed):
    """The JAX Trainer's streaming draws, fold_in(PRNGKey(seed),
    host_step) split into the two streams' keys."""
    base = jax.random.PRNGKey(seed)

    def noise(host_step, n, loss_fn):
        keys = jax.random.split(jax.random.fold_in(base, host_step))
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n, SMALL["z_dims"])))) for k in keys)
    return noise


def _gmm():
    from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
    from music_fader_nets_tpu.train.objectives import gmm_loss as j_loss
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    from music_fader_nets_tpu_torch.train.objectives import gmm_loss
    return j_init, j_loss, init_reg_gmvae, gmm_loss


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer's state at the start, after 3 and after 6 steps."""
    j_init, j_loss, _, _ = _gmm()
    j_tr = JTrainer(JConfig(**SMALL, batch_size=B), j_init,
                    {"default": j_loss}, seed=0)
    start = _np_tree(j_tr.params)
    j_tr.run_epoch(_corpus(2), compiled=False, seed=1)
    s3 = _np_tree(j_tr.state)
    j_tr.run_epoch(_corpus(3), compiled=False, seed=2)
    return start, s3, _np_tree(j_tr.state), j_tr._host_step


def _port_trainer(params, jax_noise=True):
    """The port's GM-VAE trainer on the CPU; with jax_noise, fed the JAX
    Trainer's draws, else on its own seeded noise."""
    _, _, init, loss = _gmm()
    return Trainer(ModelConfig(**SMALL, batch_size=B), init,
                   {"default": loss}, seed=0,
                   params=params_from_numpy(params), device="cpu",
                   noise_fn=_jax_noise_fn(0) if jax_noise else None)


def test_adam_state_matches_optax(jax_run):
    start, s3, _, _ = jax_run
    tr = _port_trainer(start)
    tr.run_epoch(_corpus(2), seed=1)
    st = tr.state
    adam = s3.opt_state[1][0]        # chain(clip, adam): ScaleByAdamState
    assert st.step == STEPS == int(s3.step)
    assert st.opt_state["count"] == int(adam.count) == STEPS
    for name in ("mu", "nu"):
        got = dict(named_leaves(params_to_numpy(st.opt_state[name])))
        want = dict(named_leaves(getattr(adam, name)))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=f"{name} {k}")
        # leaves Adam does not step: exactly 0, as optax has them
        for k in got:
            if k[0] in fast.FROZEN_KEYS + ("logvar_r_lookup",
                                           "logvar_n_lookup"):
                assert not got[k].any(), k
    # back into the fast layout: the pad rows' moments are exactly 0
    tr.load_state(st)
    for t in (tr.fast_params["enc_rn"]["w_ih_p"],
              tr.fast_params["grucell_g"]["w_tok_p"]):
        for key in ("exp_avg", "exp_avg_sq"):
            m = tr.optimizer.state[t][key]
            assert m.shape[-2] == 384 and not m[..., 342:, :].any()
            assert m[..., :342, :].any()


def test_resume_a_jax_run(jax_run):
    """JAX's state after 3 steps, as numpy, into `Trainer.load_state`;
    3 more steps on each side."""
    _, s3, s6, j_host = jax_run
    adam = s3.opt_state[1][0]        # chain(clip, adam): ScaleByAdamState
    tr = _port_trainer(s3.params)
    tr.load_state(TrainState(
        params_from_numpy(s3.params),
        {"count": int(adam.count), "mu": params_from_numpy(adam.mu),
         "nu": params_from_numpy(adam.nu)}, int(s3.step)))
    assert tr.step == tr._host_step == STEPS
    tr.run_epoch(_corpus(3), seed=2)
    assert tr.step == 2 * STEPS and tr._host_step == j_host
    got = dict(named_leaves(params_to_numpy(tr.params)))
    want = dict(named_leaves(s6.params))
    assert set(got) == set(want)
    for k in want:
        bound = 2 * LR * STEPS if k in NOISE_ONLY else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bound,
                                   err_msg=str(k))
    assert tr.state.opt_state["count"] == int(s6.opt_state[1][0].count)


# ------------------------------------------------ save -> restore, exact

def _leaf_dict(state):
    out = {("step",): state.step, ("count",): state.opt_state["count"]}
    for part, tree in (("params", state.params),
                       ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
        out.update({(part,) + k: v.numpy() for k, v in named_leaves(tree)})
    return out


def test_save_restore_is_bit_exact(jax_run, tmp_path):
    """3 steps + save + restore into a new Trainer + 3 steps = 6 straight
    steps, bit for bit (params, mu, nu, step and the host step); the
    default noise (seeded from the host step) resumes with it."""
    start = jax_run[0]
    straight = _port_trainer(start, jax_noise=False)
    straight.run_epoch(_corpus(2), seed=1)
    straight.run_epoch(_corpus(3), seed=2)

    first = _port_trainer(start, jax_noise=False)
    first.run_epoch(_corpus(2), seed=1)
    ckpt.save_checkpoint(str(tmp_path / "ck"), first.state)
    assert os.listdir(tmp_path / "ck") == ["state.pt"]
    ck = ckpt.restore_checkpoint(str(tmp_path / "ck"))
    assert ck["layout"] == "full" and ck["step"] == STEPS
    second = _port_trainer(jax_run[0], jax_noise=False)   # another start
    second.load_state(TrainState(ck["params"], ck["opt_state"], ck["step"]))
    second.run_epoch(_corpus(3), seed=2)
    assert second._host_step == straight._host_step == 2 * STEPS
    a, b = _leaf_dict(second.state), _leaf_dict(straight.state)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    # a state the model cannot take is refused
    bad = dict(ck["params"], mu_r={"w": torch.zeros(3, 3),
                                   "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="mu_r"):
        second.load_state(TrainState(bad, None, 0))


# --------------------------------------------------------- restore layouts

def _args(tmp_path, **kw):
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"hidden_dims": 32, "z_dims": 8, "num_clusters": 2, '
                   '"seq_len": 8, "attr_len": 4}')
    base = dict(config=str(cfg), epochs=None, batch_size=None,
                save_dir=str(tmp_path / "params"), from_pt=None, seed=0,
                device="cpu", fixed_quirks=False, data_type="short")
    base.update(kw)
    return argparse.Namespace(**base)


def test_restore_layouts_and_corruption(jax_run, tmp_path, capsys):
    """As the JAX eval CLI's `test_eval_restore_layouts_and_corruption`:
    both layouts load (and say which), a truncated file raises, an Orbax
    directory raises with the --from-pt route, a missing --from-pt file
    raises; the training CLI resumes the full state and restarts the
    optimizer on a params-only file."""
    args = _args(tmp_path)
    cfg = train_cli.config_from_args("gmm", args)
    ck_dir = str(tmp_path / "params" / "music_attr_vae_reg_gmm")
    params = params_from_numpy(jax_run[0])
    tr = _port_trainer(jax_run[0], jax_noise=False)
    tr.run_epoch(_corpus(2), seed=1)
    train_cli.checkpoint_fn("gmm", args)(tr.state, 4)

    got = eval_cli._load_params("gmm", cfg, args)
    assert "restored full-state checkpoint layout" in capsys.readouterr().out
    _assert_trees_equal(got, params_to_numpy(tr.params))
    resumed = train_cli.make_trainer("gmm", cfg, args)
    assert "resumed at step 3" in capsys.readouterr().out
    assert (resumed.step, resumed._host_step, resumed.epoch) == (3, 3, 4)
    assert resumed.state.opt_state["count"] == 3

    ckpt.save_checkpoint(ck_dir, params)                 # params only
    got = eval_cli._load_params("gmm", cfg, args)
    assert "params-only checkpoint layout" in capsys.readouterr().out
    _assert_trees_equal(got, params_to_numpy(params))
    fresh = train_cli.make_trainer("gmm", cfg, args)
    assert "optimizer reset" in capsys.readouterr().out
    assert fresh.step == fresh._host_step == fresh.epoch == 0
    assert len(fresh.optimizer.state) == 0

    state_file = os.path.join(ck_dir, "state.pt")
    raw = open(state_file, "rb").read()
    with open(state_file, "wb") as f:
        f.write(raw[: len(raw) // 2])
    for load in (functools.partial(eval_cli._load_params, "gmm", cfg, args),
                 functools.partial(train_cli.make_trainer, "gmm", cfg,
                                   args)):
        with pytest.raises(Exception) as e:
            load()
        assert not isinstance(e.value, (AssertionError, KeyError))

    orbax_dir = str(tmp_path / "orbax" / "params" /
                    "music_attr_vae_reg_gmm")
    j_ckpt.save_checkpoint(orbax_dir, {"params": jax_run[0]})
    o_args = _args(tmp_path, save_dir=str(tmp_path / "orbax" / "params"))
    for load in (eval_cli._load_params, train_cli.make_trainer):
        with pytest.raises(ValueError, match="Orbax.*--from-pt"):
            load("gmm", cfg, o_args)

    m_args = _args(tmp_path, from_pt=str(tmp_path / "missing.pt"))
    for load in (eval_cli._load_params, train_cli.make_trainer):
        with pytest.raises(FileNotFoundError, match="missing.pt"):
            load("gmm", cfg, m_args)
    # a params tree of another family is refused
    ckpt.save_checkpoint(str(tmp_path / "params" / "music_attr_cvae"),
                         params)
    with pytest.raises(ValueError, match="checkpoint parameter"):
        eval_cli._load_params("cvae", train_cli.config_from_args(
            "cvae", args), args)
