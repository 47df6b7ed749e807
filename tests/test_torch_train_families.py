"""PyTorch port, the training step of the five families beside the GM-VAE
(vanilla RegVAE, GLSR, CVAE, FaderNets, SingleVAE) against the JAX package
at a small size (H=32, z=8, T=8, attr_len=4, B=4, V=342).

For each family: the fast layout both ways; the objective's loss, metrics
and the gradient of every trainable leaf on the fast layout, the JAX side
on its kernel path (`use_pallas_gru=True`, Pallas in interpret mode), the
port on its plain versions, with the JAX objective's own random draws
handed to the port; and three `Trainer` steps against the JAX `Trainer`.
GLSR is held at step >= 21: before that its regularizer is multiplied by
0 and its masses head gets no cotangent.

Tolerances: the loss to rtol=1e-5; gradients to atol=3e-4, rtol=2e-3 (the
JAX package's own bound for a loss on its fused kernels against its scan
path, tests/test_pallas_gru.py:434); Trainer params to atol=1e-5, the
sub-decoders' output biases to the Adam bound explained in
tests/test_torch_train_trainer.py, and at most 1 element in 10,000 of a
leaf to that bound as well (an element whose gradients cancel to float32
rounding, see the test)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import fast as j_fast
from music_fader_nets_tpu.models import vae as j_vae
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu.train import objectives as j_obj
from music_fader_nets_tpu.train.trainer import Trainer as JTrainer
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data import datasets
from music_fader_nets_tpu_torch.models import fast, vae
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.train.trainer import Trainer
from music_fader_nets_tpu_torch.utils.checkpoint import (
    params_from_numpy, params_to_numpy,
)

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B, Z, LR = 4, SMALL["z_dims"], 1e-3
GRAD_TOL = dict(atol=3e-4, rtol=2e-3)


def _normal(k, shape):
    return np.array(jax.random.normal(k, shape))


def draws_vanilla(rng, n):
    """reg_vae_forward: split(rng) -> (r, n), a normal each (vae.py:172)."""
    return tuple(_normal(k, (n, Z)) for k in jax.random.split(rng))


def draws_glsr(rng, n):
    """glsr_loss: split(rng) -> (fwd, glsr) (objectives.py:176); fwd as
    vanilla; glsr split -> (kr, kn), uniform (B,) each
    (regularizers.py:225-227)."""
    r_fwd, r_glsr = jax.random.split(rng)
    kr, kn = jax.random.split(r_glsr)
    return draws_vanilla(r_fwd, n) + tuple(
        np.array(jax.random.uniform(k, (n,), jnp.float32)) for k in (kr, kn))


def draws_cvae(rng, n):
    return (_normal(rng, (n, Z)),)


def draws_fader(rng, n):
    """fader_forward: split(rng) -> (z, d); split(d) -> (kr, kn),
    bernoulli(0.7) of (B, 1) each (vae.py:372-382)."""
    r_z, r_d = jax.random.split(rng)
    keeps = tuple(np.array(jax.random.bernoulli(k, 0.7, (n, 1)),
                           dtype=np.float32)
                  for k in jax.random.split(r_d))
    return (_normal(r_z, (n, Z)),) + keeps


def draws_singlevae(rng, n):
    return (_normal(rng, (n, 2 * Z)),)


# name: (JAX init, JAX objective, port init, port objective, draws, step)
FAMILIES = {
    "vanilla": (j_vae.init_reg_vae, j_obj.vanilla_loss, vae.init_reg_vae,
                objectives.vanilla_loss, draws_vanilla, 1500),
    "glsr": (j_vae.init_reg_vae, j_obj.glsr_loss, vae.init_reg_vae,
             objectives.glsr_loss, draws_glsr, 25),
    "cvae": (j_vae.init_cvae, j_obj.cvae_loss, vae.init_cvae,
             objectives.cvae_loss, draws_cvae, 1500),
    "fader": (j_vae.init_fader, j_obj.fader_loss, vae.init_fader,
              objectives.fader_loss, draws_fader, 1500),
    "singlevae": (j_vae.init_single_vae, j_obj.singlevae_loss,
                  vae.init_single_vae, objectives.singlevae_loss,
                  draws_singlevae, 1500),
}
# the fast layout's encoder group of each family
ENC_GROUP = {"vanilla": "enc_rn", "glsr": "enc_rn", "cvae": "enc_e",
             "fader": "enc_e", "singlevae": "enc_1"}


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(pallas_gru, "INTERPRET", True)
    yield


def np_params(family):
    p = FAMILIES[family][0](jax.random.PRNGKey(0), JConfig(**SMALL))
    return jax.tree.map(np.asarray, p)


def make_batch(seed: int, n: int = B):
    """An in-schema batch from numpy: tokens in [0, 342), rhythm ids in
    [0, 3), note ids in [0, 16), chroma and densities."""
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    r = rng.integers(0, 3, (n, A)).astype(np.int32)
    nt = rng.integers(0, 16, (n, A)).astype(np.int32)
    return {"x": rng.integers(0, 342, (n, T)).astype(np.int32), "r": r,
            "n": nt, "c": rng.random((n, 24)).astype(np.float32),
            "r_density": (r == 1).mean(-1).astype(np.float32),
            "n_density": (nt / 16.0).mean(-1).astype(np.float32)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_fast_matches_jax_and_merge_inverts(family):
    """Each family's encoder group (enc_rn / enc_e / enc_1) is packed leaf
    for leaf as JAX packs it, and merge_canonical gives the canonical tree
    back exactly (CVAE's 344 input rows padded to 384)."""
    p = np_params(family)
    j_fp, j_frozen = j_fast.split_fast(p)
    tp = params_from_numpy(p)
    fp, frozen = fast.split_fast(tp)
    assert ENC_GROUP[family] in fp
    for got, want in ((fp, j_fp), (frozen, j_frozen)):
        g, w = list(_leaves(params_to_numpy(got))), list(
            _leaves(jax.tree.map(np.asarray, want)))
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, a), (_, b_) in zip(g, w):
            np.testing.assert_array_equal(a, b_, err_msg=str(k))
    back = params_to_numpy(fast.merge_canonical(fp, frozen, tp))
    g, w = list(_leaves(back)), list(_leaves(p))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b_) in zip(g, w):
        np.testing.assert_array_equal(a, b_, err_msg=str(k))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_loss_and_grads_match_jax(pallas_interpret, family):
    """The objective on the fast layout: loss, metrics and the gradient of
    every trainable leaf, with JAX's draws handed over. The JAX side must
    have taken its kernel path."""
    _, j_loss_fn, _, loss_fn, draws, step = FAMILIES[family]
    p = np_params(family)
    jcfg = JConfig(**SMALL, use_pallas_gru=True)
    batch = make_batch(7)
    rng = jax.random.PRNGKey(11)
    j_fp, _ = j_fast.split_fast(p)
    pallas_gru.LAST_TRAIN_PATH = None
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda fp_: j_loss_fn(fp_, rng, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jnp.int32(step),
                              jcfg),
        has_aux=True)(j_fp)
    assert pallas_gru.LAST_TRAIN_PATH == "kernel-single"

    cfg = ModelConfig(**SMALL)
    fp, _ = fast.split_fast(params_from_numpy(p))
    for _, t in _leaves(fp):
        t.requires_grad_(True)
    eps = tuple(torch.from_numpy(e) for e in draws(rng, B))
    for m in (cuda_gru, cuda_decoder, cuda_stacked):
        m.LAST_TRAIN_PATH = None
    loss, metrics = loss_fn(fp, eps, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, step, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_grads)))
    assert set(j_leaves) == {k for k, _ in _leaves(fp)}
    for path, t in _leaves(fp):
        want = j_leaves[path]
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=str(path), **GRAD_TOL)
    # each family reached its plain versions of the kernels it runs
    want_paths = {"cvae": (cuda_stacked, cuda_decoder),
                  "glsr": (cuda_gru, cuda_decoder)}.get(
                      family, (cuda_gru, cuda_decoder))
    assert all(m.LAST_TRAIN_PATH == "plain-cpu" for m in want_paths)
    if family == "glsr":
        # the regularizer counts at step 25, so the masses head got a
        # cotangent: the decoder gradient differs from the gated one
        assert metrics["l_r"].item() != 0.0
    if family == "cvae":
        # the encoder's padded input rows (344 -> 384) get exactly zero
        assert not fp["enc_e"]["w_ih_p"].grad[:, 344:].any()


def _jax_noise_fn(seed, draws):
    """The JAX Trainer's per-step key, fold_in(PRNGKey(seed), host_step)
    (trainer.py:277), through the family's draws."""
    base = jax.random.PRNGKey(seed)

    def noise(host_step, n, loss_fn):
        rng = jax.random.fold_in(base, host_step)
        return tuple(torch.from_numpy(e) for e in draws(rng, n))
    return noise


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trainer_steps_match_jax(pallas_interpret, family):
    """Three Trainer steps from the same canonical params, batch order and
    draws give the same canonical params and epoch metrics. GLSR starts at
    step 21, where its regularizer counts."""
    j_init, j_loss_fn, init, loss_fn, draws, _ = FAMILIES[family]
    jcfg = JConfig(**SMALL, batch_size=B, use_pallas_gru=True)
    cfg = ModelConfig(**SMALL, batch_size=B)
    j_tr = JTrainer(jcfg, j_init, {"default": j_loss_fn}, seed=0)
    start = jax.tree.map(np.asarray, j_tr.params)
    tr = Trainer(cfg, init, {"default": loss_fn}, seed=0,
                 params=params_from_numpy(start), device="cpu",
                 noise_fn=_jax_noise_fn(0, draws))
    first = 21 if family == "glsr" else 0
    j_tr.state = j_tr.state._replace(step=jnp.int32(first))
    tr.step = first
    rng = np.random.default_rng(2)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    n = 4 * B                       # 80% train split: 3 batches
    yam = datasets.YamahaDataset(
        rng.integers(0, 342, (n, T)), rng.integers(0, 3, (n, A)),
        rng.integers(0, 16, (n, A)), rng.random((n, 24)),
        mode="train").arrays()
    a = tr.run_epoch(yam, seed=1)
    b = j_tr.run_epoch(yam, compiled=False, seed=1)
    assert tr.step == first + 3 and tr.train_path == "plain-cpu"
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    got = dict(_leaves(params_to_numpy(tr.params)))
    want = dict(_leaves(jax.tree.map(np.asarray, j_tr.params)))
    assert set(got) == set(want)
    noise_only = {("linear_out_r", "b"), ("linear_out_n", "b")}
    adam_bound = 2 * LR * 3
    for k in want:
        if k in noise_only:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=adam_bound, err_msg=str(k))
            continue
        # Adam divides each element's gradient by its running RMS, so an
        # element whose gradients are sums that cancel to float32 rounding
        # (a few 1e-7 against terms of 1e-2) moves by an amount that the
        # rounding sets. Such elements are rare and depend on the data: at
        # most 1 in 10,000 of a leaf may differ by more than 1e-5, and none
        # by more than the Adam bound.
        d = np.abs(got[k] - want[k])
        assert (d > 1e-5).sum() <= d.size // 10_000, (k, d.max())
        assert d.max() <= adam_bound, (k, d.max())


def test_noise_rule_covers_every_objective():
    """`draw_noise` gives each objective the draws its forward takes, at
    the Trainer's batch size; partials resolve to their objective."""
    cfg = ModelConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    shapes = {objectives.vanilla_loss: [(B, Z)] * 2,
              objectives.gmm_loss: [(B, Z)] * 2,
              objectives.glsr_loss: [(B, Z)] * 2 + [(B,)] * 2,
              objectives.cvae_loss: [(B, Z)],
              objectives.fader_loss: [(B, Z), (B, 1), (B, 1)],
              objectives.singlevae_loss: [(B, 2 * Z)]}
    for fn, want in shapes.items():
        got = objectives.draw_noise(fn, gen, B, cfg)
        assert [tuple(e.shape) for e in got] == want, fn.__name__
    sup = functools.partial(objectives.gmm_loss, is_supervised=True)
    assert len(objectives.draw_noise(sup, gen, B, cfg)) == 2
    u = objectives.draw_noise(objectives.glsr_loss, gen, 1000, cfg)[2]
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    keep = objectives.draw_noise(objectives.fader_loss, gen, 1000, cfg)[1]
    assert set(keep.unique().tolist()) <= {0.0, 1.0}
    assert 0.6 < float(keep.mean()) < 0.8
    with pytest.raises(ValueError, match="no noise rule"):
        objectives.draw_noise(lambda *a: None, gen, B, cfg)


def test_grad_reverse_matches_jax():
    from music_fader_nets_tpu.ops.sampling import grad_reverse as j_rev
    from music_fader_nets_tpu_torch.ops.sampling import grad_reverse
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    w = np.arange(15, dtype=np.float32).reshape(3, 5)
    j_g = jax.grad(lambda x_: jnp.sum(j_rev(x_, 0.5) * w))(x)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = grad_reverse(tx, 0.5)
    assert torch.equal(out.detach(), tx.detach())
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(j_g))


@pytest.mark.parametrize("faithful", [True, False])
def test_glsr_attributes_match_jax(faithful):
    """The soft attributes on log-probs whose separator mass crosses the
    0.9 threshold at some steps, with note-on masses on both sides of the
    1e-2 rule: values and gradients of the rhythm and note densities (the
    families' random-init decodes never reach a separator step)."""
    from music_fader_nets_tpu.losses import regularizers as j_reg
    from music_fader_nets_tpu_torch.losses import regularizers as reg
    rng = np.random.default_rng(3)
    Bn, T = 3, 12
    logits = rng.standard_normal((Bn, T, 342)).astype(np.float32)
    sep_steps = rng.random((Bn, T)) < 0.4
    logits[..., 180:278] += np.where(sep_steps, 6.0, 0.0)[..., None]
    logits[..., 2:90] += rng.uniform(-6, 2, (Bn, T, 1)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(logits, axis=-1))
    w = rng.standard_normal(Bn).astype(np.float32)

    def j_fn(x):
        rd = j_reg.approx_rhythm_density(x, faithful)
        return jnp.sum(rd * w) + jnp.sum(j_reg.approx_note_density(x) * w), rd
    (_, j_rd), j_g = jax.value_and_grad(j_fn, has_aux=True)(jnp.asarray(lp))
    assert bool((j_reg.approx_time_separators(lp) >= 0.9).any())
    t = torch.from_numpy(lp).requires_grad_(True)
    rd = reg.approx_rhythm_density(t, faithful)
    ((rd * torch.from_numpy(w)).sum()
     + (reg.approx_note_density(t) * torch.from_numpy(w)).sum()).backward()
    np.testing.assert_allclose(rd.detach().numpy(), np.asarray(j_rd),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_g), rtol=1e-5,
                               atol=1e-7)
    for step in (0, 700, 2000, 5000):
        d, dens = (rng.random((Bn, 1)).astype(np.float32) for _ in range(2))
        np.testing.assert_allclose(
            float(reg.adversarial_fader_loss(step, torch.from_numpy(d),
                                             torch.from_numpy(dens))),
            float(j_reg.adversarial_fader_loss(step, jnp.asarray(d),
                                               jnp.asarray(dens))),
            rtol=1e-6)


@pytest.mark.parametrize("family,j_decode", [
    ("vanilla", j_vae.reg_vae_global_decode),
    ("singlevae", j_vae.single_vae_global_decode),
    ("cvae", j_vae.cvae_global_decode),
    ("fader", j_vae.fader_global_decode)], ids=lambda v: getattr(
        v, "__name__", v))
def test_global_decode_matches_jax(family, j_decode):
    """`vae.global_decode`, the one greedy decode of the four families,
    against each JAX family's own: the same log-probs (1e-4, the float32
    forward bound) and tokens. The head is sharpened, as
    tests/test_torch_decode.py does, so no step is a near-tie."""
    p = np_params(family)
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 8.0
    zin = p["linear_init_global"]["w"].shape[0]
    z = np.random.default_rng(5).standard_normal((3, zin)).astype(np.float32)
    want = np.asarray(j_decode(p, jnp.asarray(z), SMALL["seq_len"]))
    got = vae.global_decode(params_from_numpy(p), torch.from_numpy(z),
                            SMALL["seq_len"]).numpy()
    assert got.shape == want.shape == (3, SMALL["seq_len"], 342)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _gmm_objective():
    from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
    from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
    return (j_init, j_obj.gmm_loss, init_reg_gmvae, objectives.gmm_loss,
            draws_vanilla, 0)


# every faithful_* quirk off, a KL floor and a KL warmup: the settings the
# CLIs' --fixed-quirks, --free-bits and --kl-warmup reach
NON_DEFAULT = dict(faithful_negative_beta=False,
                   faithful_subdecoder_softmax_axis=False,
                   faithful_glsr_batch0=False, free_bits=0.5,
                   kl_warmup_steps=50)


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["gmm"])
def test_objectives_at_non_default_flags_match_jax(family):
    """The six objectives with every quirk off, free_bits=0.5 and
    kl_warmup_steps=50, at step 30 (inside the warmup, and past GLSR's
    step 20): loss and metrics to rtol=1e-5, the gradient of every leaf
    to GRAD_TOL, JAX's draws handed over. The JAX side runs its scan path
    (the kernels' parity is held above)."""
    j_init, j_loss_fn, _, loss_fn, draws, _ = (
        _gmm_objective() if family == "gmm" else FAMILIES[family])
    step = 30
    jcfg = JConfig(**SMALL, **NON_DEFAULT)
    cfg = ModelConfig(**SMALL, **NON_DEFAULT)
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    batch = make_batch(8)
    if family == "gmm":
        rng_ = np.random.default_rng(8)
        batch["a"] = rng_.uniform(-1, 1, B).astype(np.float32)
    rng = jax.random.PRNGKey(12)
    j_fp, _ = j_fast.split_fast(p)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda fp_: j_loss_fn(fp_, rng, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jnp.int32(step),
                              jcfg),
        has_aux=True))(j_fp)
    fp, _ = fast.split_fast(params_from_numpy(p))
    for _, t in _leaves(fp):
        t.requires_grad_(True)
    eps = tuple(torch.from_numpy(e) for e in draws(rng, B))
    loss, metrics = loss_fn(fp, eps, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, step, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    j_leaves = dict(_leaves(jax.tree.map(np.asarray, j_grads)))
    assert set(j_leaves) == {k for k, _ in _leaves(fp)}
    for path, t in _leaves(fp):
        want = j_leaves[path]
        got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, want, err_msg=str(path), **GRAD_TOL)
    # the flags reach the objective: at the defaults the loss differs
    with torch.no_grad():
        default, _ = loss_fn(fp, eps, {k: torch.from_numpy(v) for k, v in
                                       batch.items()}, step,
                             ModelConfig(**SMALL))
    assert abs(default.item() - loss.item()) > 1e-3 * abs(loss.item())
