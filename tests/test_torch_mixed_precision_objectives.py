"""PyTorch port, bf16 mixed precision (`ModelConfig(dtype="bfloat16")`):
the objectives that cast (here the GM-VAE's, unsupervised and supervised;
vanilla, CVAE, FaderNets and SingleVAE in
test_torch_mixed_precision_families.py, with this module's helpers)
against the JAX package's bf16 objectives at
a small size (H=32, z=8, T=8, attr_len=4, B=4, V=342), the JAX side on its
kernel path (`use_pallas_gru=True`, Pallas in interpret mode), the port
on its plain versions; the same params (float32 masters, cast inside the
loss on both sides), batch and draws (JAX's bf16 noise, drawn in the
std's dtype as its forward draws it, handed to the port). Then the
GM-VAE's validation pass (`gmm_loss(train=False)`: kernel 3's finals in
bf16 and the greedy loop) and GLSR, which ignores the dtype.

Tolerances: the loss to rtol=1e-3 (measured: equal, or 1e-7); each
gradient tensor to GRAD_REL = 4e-2 of its largest entry (measured here:
at most 2.0e-2, SingleVAE's `mu.b` and the vanilla encoder's `b_ih`,
bias gradients summed over the batch in bf16, which XLA accumulates in
bf16 in order where torch accumulates in float32 and rounds once; the
kernels' own gradients agree to 7e-3,
test_torch_mixed_precision_kernels.py); `linear_out_{r,n}.b`, whose
float32 gradient is ~0 under the time-axis softmax (bf16 leaves ~2^-11
there), to an absolute 1e-3. `test_grad_bound_below_jax_scan_vs_pallas`
computes the JAX package's own disagreement between its bf16 scan path
and its bf16 Pallas path on the same inputs (7.3e-2, `linear_out_g.b`)
and asserts that GRAD_REL lies below it. The computations of
each JAX result are cached for the module (one interpreted bf16
value-and-grad takes seconds)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models import fast as j_fast
from music_fader_nets_tpu.models import gmvae as j_gmvae
from music_fader_nets_tpu.models import vae as j_vae
from music_fader_nets_tpu.ops import pallas_gru
from music_fader_nets_tpu.train import objectives as j_obj
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models import fast, gmvae, vae
from music_fader_nets_tpu_torch.ops import cuda_decoder, cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.train import objectives
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
B, Z = 4, SMALL["z_dims"]
GRAD_REL = 4e-2
ABS_LEAVES = {("linear_out_r", "b"), ("linear_out_n", "b")}
ABS_TOL = 1e-3
STEP = 1500                      # inside the negative-beta window


def _bf16_normal(k, shape):
    """The JAX forward's noise: normal drawn in bf16 (ops/sampling.py:26),
    exact in float32."""
    return np.array(jax.random.normal(k, shape, dtype=jnp.bfloat16)
                    .astype(jnp.float32))


def draws_pair(rng, n):
    """reg_vae_forward / reg_gmvae_forward: split(rng) -> (r, n)."""
    return tuple(_bf16_normal(k, (n, Z)) for k in jax.random.split(rng))


def draws_one(width):
    return lambda rng, n: (_bf16_normal(rng, (n, width)),)


def draws_fader(rng, n):
    """fader_forward: split(rng) -> (z, d); split(d) -> the two
    bernoulli(0.7) keep-masks (vae.py:372-382)."""
    r_z, r_d = jax.random.split(rng)
    keeps = tuple(np.array(jax.random.bernoulli(k, 0.7, (n, 1)),
                           dtype=np.float32)
                  for k in jax.random.split(r_d))
    return (_bf16_normal(r_z, (n, Z)),) + keeps


# name: (JAX init, JAX objective, port objective, draws)
OBJECTIVES = {
    "gmm": (j_gmvae.init_reg_gmvae, j_obj.gmm_loss, objectives.gmm_loss,
            draws_pair),
    "gmm_supervised": (
        j_gmvae.init_reg_gmvae,
        functools.partial(j_obj.gmm_loss, is_supervised=True),
        functools.partial(objectives.gmm_loss, is_supervised=True),
        draws_pair),
    "vanilla": (j_vae.init_reg_vae, j_obj.vanilla_loss,
                objectives.vanilla_loss, draws_pair),
    "cvae": (j_vae.init_cvae, j_obj.cvae_loss, objectives.cvae_loss,
             draws_one(Z)),
    "fader": (j_vae.init_fader, j_obj.fader_loss, objectives.fader_loss,
              draws_fader),
    "singlevae": (j_vae.init_single_vae, j_obj.singlevae_loss,
                  objectives.singlevae_loss, draws_one(2 * Z)),
}


def make_batch(seed: int, n: int = B):
    rng = np.random.default_rng(seed)
    T, A = SMALL["seq_len"], SMALL["attr_len"]
    r = rng.integers(0, 3, (n, A)).astype(np.int32)
    nt = rng.integers(0, 16, (n, A)).astype(np.int32)
    return {"x": rng.integers(0, 342, (n, T)).astype(np.int32), "r": r,
            "n": nt, "c": rng.random((n, 24)).astype(np.float32),
            "r_density": (r == 1).mean(-1).astype(np.float32),
            "n_density": (nt / 16.0).mean(-1).astype(np.float32),
            "a": rng.integers(0, 2, n).astype(np.int32)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def np_params(init, sharpen: float = 1.0):
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                      JConfig(**SMALL)))
    if sharpen != 1.0:
        p["linear_out_g"] = {k: v * sharpen
                             for k, v in p["linear_out_g"].items()}
    return p


@pytest.fixture(scope="module")
def jax_results():
    """name -> (loss, metrics, gradient leaves) of the JAX objective on
    the fast layout, computed once per module under interpret mode."""
    cache = {}

    def get(name, pallas=True, train=True, sharpen=1.0):
        key = (name, pallas, train, sharpen)
        if key not in cache:
            j_init, j_loss_fn, _, _ = OBJECTIVES[name]
            jcfg = JConfig(**SMALL, use_pallas_gru=pallas, dtype="bfloat16")
            batch = {k: jnp.asarray(v) for k, v in make_batch(0).items()}
            j_fp, _ = j_fast.split_fast(np_params(j_init, sharpen))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pl, "pallas_call", functools.partial(
                    pl.pallas_call, interpret=True))
                mp.setattr(pallas_gru, "INTERPRET", True)
                pallas_gru.LAST_TRAIN_PATH = None
                (loss, metrics), grads = jax.value_and_grad(
                    lambda fp_: j_loss_fn(fp_, jax.random.PRNGKey(1), batch,
                                          jnp.int32(STEP), jcfg,
                                          train=train),
                    has_aux=True)(j_fp)
                # the scan path never consults the kernels' dispatch
                assert pallas_gru.LAST_TRAIN_PATH == (
                    "kernel-single" if pallas else None)
            cache[key] = (float(loss), {k: float(v) for k, v in
                                        metrics.items()},
                          dict(_leaves(jax.tree.map(
                              lambda g: np.asarray(g, np.float32), grads))))
        return cache[key]
    return get


def port_run(name, train=True, sharpen=1.0, dtype="bfloat16"):
    """The port's objective on the fast layout in `dtype`: (loss, metrics,
    gradient leaves, fast params)."""
    j_init, _, loss_fn, draws = OBJECTIVES[name]
    cfg = ModelConfig(**SMALL, dtype=dtype)
    fp, _ = fast.split_fast(params_from_numpy(np_params(j_init, sharpen)))
    for _, t in _leaves(fp):
        t.requires_grad_(True)
    eps = tuple(torch.from_numpy(e) for e in draws(jax.random.PRNGKey(1), B))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(0).items()}
    for m in (cuda_gru, cuda_decoder, cuda_stacked):
        m.LAST_TRAIN_PATH = None
    loss, metrics = loss_fn(fp, eps, batch, STEP, cfg, train=train)
    loss.backward()
    grads = {k: (np.zeros(t.shape, np.float32) if t.grad is None
                 else t.grad.numpy()) for k, t in _leaves(fp)}
    return loss, metrics, grads, fp


def grad_errors(got, want):
    """Per leaf: the error relative to the leaf's largest entry, and the
    absolute error of the leaves held to ABS_TOL."""
    rel, ab = {}, {}
    for k, w in want.items():
        e = float(np.abs(got[k] - w).max()) if w.size else 0.0
        if k in ABS_LEAVES:
            ab[k] = e
        else:
            rel[k] = e / max(float(np.abs(w).max()), 1e-12) if e else 0.0
    return rel, ab


def check_objective(jax_results, name):
    """Loss, metrics and the gradient of every trainable leaf against the
    JAX objective; the gradients arrive float32 at the float32 masters;
    the kernels' plain versions served."""
    j_loss, j_metrics, j_grads = jax_results(name)
    loss, metrics, grads, fp = port_run(name)
    assert loss.dtype == torch.float32
    assert all(t.dtype == torch.float32 and
               (t.grad is None or t.grad.dtype == torch.float32)
               for _, t in _leaves(fp))
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-3)
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), j_metrics[k],
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert set(grads) == set(j_grads)
    rel, ab = grad_errors(grads, j_grads)
    assert max(rel.values()) <= GRAD_REL, max(rel.items(),
                                              key=lambda kv: kv[1])
    assert all(e <= ABS_TOL for e in ab.values()), ab
    assert all(m.LAST_TRAIN_PATH in ("plain-cpu", None)
               for m in (cuda_gru, cuda_decoder, cuda_stacked))
    assert cuda_decoder.LAST_TRAIN_PATH == "plain-cpu"


@pytest.mark.parametrize("name", ["gmm", "gmm_supervised"])
def test_gmm_loss_bf16_matches_jax(jax_results, name):
    """The GM-VAE objective, unsupervised and supervised branch (the other
    four in test_torch_mixed_precision_families.py)."""
    check_objective(jax_results, name)


def test_grad_bound_below_jax_scan_vs_pallas(jax_results):
    """The JAX package's bf16 scan path against its bf16 Pallas path on
    the GM-VAE's unsupervised objective: its largest disagreement of a
    gradient tensor, relative to that tensor's largest entry (the leaves
    held to ABS_TOL apart), exceeds the port's bound GRAD_REL."""
    _, _, pallas = jax_results("gmm")
    _, _, scan = jax_results("gmm", pallas=False)
    rel, _ = grad_errors(scan, pallas)
    assert GRAD_REL < max(rel.values()), max(rel.items(),
                                             key=lambda kv: kv[1])


def test_gmm_validation_pass_bf16_matches_jax(jax_results):
    """`gmm_loss(train=False)`, the validation pass of `Trainer.fit`: the
    encoder's finals (kernel 3) in bf16 and the greedy loop of
    `global_decoder_greedy`, logits from a bf16 linear (an ulp is 2^-8).
    The head is sharpened 8x, as the float32 tests do, so that no
    near-tie parts the tokens: the loss and every metric to rtol=1e-3."""
    j_loss, j_metrics, _ = jax_results("gmm", train=False, sharpen=8.0)
    with torch.no_grad():
        loss, metrics, _, _ = port_run_no_grad("gmm", sharpen=8.0)
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-3)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), j_metrics[k],
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert cuda_gru.LAST_ENCODE_PATH == "plain-cpu"


def port_run_no_grad(name, sharpen=1.0):
    j_init, _, loss_fn, draws = OBJECTIVES[name]
    cfg = ModelConfig(**SMALL, dtype="bfloat16")
    fp, _ = fast.split_fast(params_from_numpy(np_params(j_init, sharpen)))
    eps = tuple(torch.from_numpy(e) for e in draws(jax.random.PRNGKey(1), B))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(0).items()}
    loss, metrics = loss_fn(fp, eps, batch, STEP, cfg, train=False)
    return loss, metrics, None, fp


def test_glsr_ignores_bf16():
    """GLSR stays float32 under a bf16 config (JAX objectives.py:173-174):
    at step 25, where its regularizer counts, the loss, metrics and every
    gradient are bit-equal to the float32 config's."""
    rng = jax.random.PRNGKey(3)
    r_fwd, r_glsr = jax.random.split(rng)
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, Z))))
                for k in jax.random.split(r_fwd)) + tuple(
        torch.from_numpy(np.array(jax.random.uniform(k, (B,))))
        for k in jax.random.split(r_glsr))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(9).items()}
    p = np_params(j_vae.init_reg_vae)
    runs = []
    for dtype in ("float32", "bfloat16"):
        fp, _ = fast.split_fast(params_from_numpy(p))
        for _, t in _leaves(fp):
            t.requires_grad_(True)
        loss, metrics = objectives.glsr_loss(
            fp, eps, batch, 25, ModelConfig(**SMALL, dtype=dtype))
        loss.backward()
        runs.append((loss, metrics, [t.grad for _, t in _leaves(fp)]))
    (l32, m32, g32), (l16, m16, g16) = runs
    assert m32["l_r"].item() != 0.0
    assert torch.equal(l32, l16)
    assert all(torch.equal(m32[k], m16[k]) for k in m32)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g32, g16))
