"""PyTorch port, the public GRU primitives and the modules built on them
against the JAX package (CPU, H=32, z=8, T=8, B=4): `gru_cell`,
`gru_scan` (forward and reverse, with and without h0, and T=0),
`bigru_final_state` / `bigru_apply`, `argmax_one_hot` (a tied row),
`encoder_stream_*` and `sub_decoder_*` on both softmax axes. The same
numpy params (JAX inits carried across with `params_from_numpy`) and
inputs go to both sides.

Tolerances: values to atol 1e-5 (float32 gate maths over at most 8 steps
whose exp/tanh and matmul orders differ by a few ulps); gradients to
atol 2e-4, rtol 1e-3, the bound `tests/test_pallas_gru.py` holds its
kernel gradients to.

The last test fakes a CUDA device on CPU tensors, with the kernel launches
standing in by the plain version and its autograd, to show that every
primitive reaches kernel 1 (`stacked_gru`), through `StackedGRU` (kernel
2) when a gradient is wanted, with its values and gradients unchanged."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_fader_nets_tpu.models import modules as jmod
from music_fader_nets_tpu.ops import gru as jgru
from music_fader_nets_tpu.ops import sampling as jsampling
from music_fader_nets_tpu_torch.models import modules as tmod
from music_fader_nets_tpu_torch.ops import cuda_gru, cuda_stacked
from music_fader_nets_tpu_torch.ops import gru as tgru
from music_fader_nets_tpu_torch.ops import sampling as tsampling
from music_fader_nets_tpu_torch.utils.checkpoint import (
    named_leaves, params_from_numpy, tree_map,
)

H, Z, T, B, I = 32, 8, 8, 4, 20
ATOL = 1e-5
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _one_hot(rng, n_cls, *shape):
    return np.eye(n_cls, dtype=np.float32)[rng.integers(0, n_cls, shape)]


def _assert_trees(got, want, **tol):
    g, w = list(named_leaves(got)), list(named_leaves(want))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=str(k), **tol)


def _grad(t):
    """A leaf's gradient as numpy; None (no path to the loss) as zeros,
    which is what JAX gives such an input."""
    g = torch.zeros_like(t) if t.grad is None else t.grad
    return g.numpy()


def _torch_grads(fn, args, cot):
    """(values, grads of every float arg) of sum(out_i * cot_i) in torch;
    args is a tuple of numpy trees (dicts) and arrays."""
    targs = [params_from_numpy(a) for a in args]
    for a in targs:
        tree_map(lambda t: t.requires_grad_(True), a)
    outs = fn(*targs)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
    loss.backward()
    grads = [tree_map(_grad, a) for a in targs]
    return [o.detach().numpy() for o in outs], grads, targs


def _jax_grads(fn, args, cot):
    def loss(*a):
        return sum(jnp.sum(o * c) for o, c in zip(fn(*a), cot))
    outs = fn(*args)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(o) for o in outs], _np(grads)


def _hold(tfn, jfn, args, cot):
    """Values at ATOL, then gradients of every arg at GRAD_TOL."""
    t_out, t_grads, _ = _torch_grads(tfn, args, cot)
    j_out, j_grads = _jax_grads(jfn, args, cot)
    for a, b in zip(t_out, j_out):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for a, b in zip(t_grads, j_grads):
        if isinstance(b, dict):
            _assert_trees(a, b, **GRAD_TOL)
        else:
            np.testing.assert_allclose(a, b, **GRAD_TOL)


def _gru_params(seed, in_dim=I):
    return _np(jgru.gru_init(jax.random.PRNGKey(seed), in_dim, H))


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(0)
    args = (_gru_params(0), _normal(rng, B, I), _normal(rng, B, H) * 0.5)
    _hold(lambda p, x, h: (tgru.gru_cell(p, x, h),),
          lambda p, x, h: (jgru.gru_cell(p, x, h),), args,
          [_normal(rng, B, H)])


@pytest.mark.parametrize("reverse,with_h0,steps", [
    (False, False, T), (True, False, T), (False, True, T), (True, True, T),
    (False, True, 1), (True, True, 0)])
def test_gru_scan_matches_jax(reverse, with_h0, steps):
    """outs in input order (outs[:, t] after the step that consumed
    x[:, t]) and h_final after the last step consumed, as
    `lax.scan(reverse=...)` gives them; T=0 returns h0."""
    rng = np.random.default_rng(1)
    p, x = _gru_params(1), _normal(rng, B, steps, I)
    cot = [_normal(rng, B, steps, H), _normal(rng, B, H)]
    if with_h0:
        args = (p, x, _normal(rng, B, H) * 0.5)

        def t_fn(p_, x_, h0):
            return tgru.gru_scan(p_, x_, h0, reverse=reverse)

        def j_fn(p_, x_, h0):
            return jgru.gru_scan(p_, x_, h0, reverse=reverse)
    else:
        args = (p, x)

        def t_fn(p_, x_):
            return tgru.gru_scan(p_, x_, reverse=reverse)

        def j_fn(p_, x_):
            return jgru.gru_scan(p_, x_, reverse=reverse)
    _hold(t_fn, j_fn, args, cot)
    outs, hf = tgru.gru_scan(*params_from_numpy(args), reverse=reverse)
    assert outs.dtype == hf.dtype == torch.float32
    if steps:
        t_last = 0 if reverse else steps - 1
        assert torch.equal(outs[:, t_last], hf)


@pytest.mark.parametrize("form", ["final_state", "apply"])
def test_bigru_matches_jax(form):
    rng = np.random.default_rng(2)
    p = _np(jgru.bigru_init(jax.random.PRNGKey(2), I, H))
    args = (p, _normal(rng, B, T, I))
    if form == "apply":
        t_fn = lambda p_, x_: (tgru.bigru_apply(p_, x_),)  # noqa: E731
        j_fn = lambda p_, x_: (jgru.bigru_apply(p_, x_),)  # noqa: E731
    else:
        t_fn = lambda p_, x_: (tgru.bigru_final_state(  # noqa: E731
            p_["fwd"], p_["bwd"], x_),)
        j_fn = lambda p_, x_: (jgru.bigru_final_state(  # noqa: E731
            p_["fwd"], p_["bwd"], x_),)
    _hold(t_fn, j_fn, args, [_normal(rng, B, 2 * H)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_argmax_one_hot_matches_jax(dtype):
    """The first maximal index on ties (rows 0 and 2 tie), the logits'
    dtype kept."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [0.5, -1.0, 2.0, 1.9],
                       [2.0, 2.0, 2.0, 2.0]], dtype)
    got = tsampling.argmax_one_hot(torch.from_numpy(logits))
    want = np.asarray(jsampling.argmax_one_hot(jnp.asarray(logits)))
    assert got.dtype == torch.from_numpy(logits).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().argmax(-1), [1, 2, 0])


def test_encoder_stream_matches_jax():
    rng = np.random.default_rng(3)
    V = 40
    p = _np(jmod.encoder_stream_init(jax.random.PRNGKey(3), V, H, Z))
    args = (p, _one_hot(rng, V, B, T))
    _hold(lambda p_, x_: tmod.encoder_stream_apply(p_, x_),
          lambda p_, x_: jmod.encoder_stream_apply(p_, x_), args,
          [_normal(rng, B, Z), _normal(rng, B, Z)])


@pytest.mark.parametrize("faithful,dims", [(True, 3), (False, 3),
                                           (True, 16), (False, 16)])
def test_sub_decoder_matches_jax(faithful, dims):
    """The rhythm (3) and note (16) widths, log-softmax over time
    (`faithful_softmax_axis`) or over the classes."""
    rng = np.random.default_rng(4)
    p = _np(jmod.sub_decoder_init(jax.random.PRNGKey(4), Z, dims, H))
    args = (p, _one_hot(rng, dims, B, T), _normal(rng, B, Z))
    _hold(lambda p_, a, z: (tmod.sub_decoder_apply(p_, a, z, faithful),),
          lambda p_, a, z: (jmod.sub_decoder_apply(p_, a, z, faithful),),
          args, [_normal(rng, B, T, dims)])


@pytest.mark.parametrize("which", ["encoder_stream", "sub_decoder"])
def test_inits_match_jax_layout(which):
    """The same leaves and shapes as the JAX init, every entry inside the
    torch default bound U(-1/sqrt(fan), 1/sqrt(fan))."""
    gen = torch.Generator().manual_seed(0)
    if which == "encoder_stream":
        got = tmod.encoder_stream_init(gen, 30, H, Z)
        want = jmod.encoder_stream_init(jax.random.PRNGKey(0), 30, H, Z)
    else:
        got = tmod.sub_decoder_init(gen, Z, 3, H)
        want = jmod.sub_decoder_init(jax.random.PRNGKey(0), Z, 3, H)
    g, w = list(named_leaves(got)), list(named_leaves(_np(want)))
    assert [(k, tuple(t.shape)) for k, t in g] == [(k, a.shape)
                                                   for k, a in w]
    for k, t in g:
        fan = H if k[0] == "gru" else got[k[0]]["w"].shape[0]
        assert float(t.abs().max()) <= 1.0 / np.sqrt(fan), k


PRIMITIVES = {
    "gru_scan": (lambda rng: (_gru_params(5), _normal(rng, B, T, I)),
                 lambda p, x: tgru.gru_scan(p, x)[0]),
    "gru_scan_reverse": (lambda rng: (_gru_params(5), _normal(rng, B, T, I)),
                         lambda p, x: tgru.gru_scan(p, x, reverse=True)[0]),
    "bigru_final_state": (
        lambda rng: (_np(jgru.bigru_init(jax.random.PRNGKey(5), I, H)),
                     _normal(rng, B, T, I)),
        lambda p, x: tgru.bigru_final_state(p["fwd"], p["bwd"], x)),
    "encoder_stream": (
        lambda rng: (_np(jmod.encoder_stream_init(jax.random.PRNGKey(5), I,
                                                  H, Z)),
                     _one_hot(rng, I, B, T)),
        lambda p, x: torch.cat(tmod.encoder_stream_apply(p, x), -1)),
    "sub_decoder": (
        lambda rng: (_np(jmod.sub_decoder_init(jax.random.PRNGKey(5), Z, 16,
                                               H)),
                     _one_hot(rng, 16, B, T), _normal(rng, B, Z)),
        lambda p, a, z: tmod.sub_decoder_apply(p, a, z)),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitives_route_through_stacked_kernels(monkeypatch, name):
    """On a (faked) CUDA device each primitive makes its recurrence one
    `stacked_gru` launch (kernel 1; `bigru_final_state` both directions in
    one), through `StackedGRU` with one backward launch (kernel 2) when a
    gradient is wanted, and only the forward under no_grad. No gradient is
    lost: every float input gets the gradient the plain path gives it."""
    make, fn = PRIMITIVES[name]
    args = make(np.random.default_rng(6))
    rng = np.random.default_rng(7)
    out_shape = fn(*params_from_numpy(args)).shape
    cot = [_normal(rng, *out_shape)]
    ref_out, ref_grads, _ = _torch_grads(lambda *a: (fn(*a),), args, cot)

    saved = {}

    def fwd(pre, w_hh, b_hh, h0, stash):
        saved["args"] = tuple(t.detach() for t in (pre, w_hh, b_hh, h0))
        h_seq = cuda_stacked.stacked_gru_plain(*saved["args"])
        return h_seq, (torch.zeros(h_seq.shape[:-1] + (4 * H,))
                       if stash else None)

    def bwd(g, stash, h_seq, h0, w_hh):
        ts = [t.clone().requires_grad_(True) for t in saved["args"]]
        with torch.enable_grad():
            out = cuda_stacked.stacked_gru_plain(*ts)
            return torch.autograd.grad(out, ts, g)

    monkeypatch.setattr(cuda_gru, "kernel_device",
                        lambda ts: torch.device("cuda"))
    monkeypatch.setattr(cuda_stacked, "_launch_fwd", fwd)
    monkeypatch.setattr(cuda_stacked, "_launch_bwd", bwd)
    before = dict(cuda_stacked.LAUNCHES)
    out, grads, leaves = _torch_grads(lambda *a: (fn(*a),), args, cot)
    delta = {k: v - before[k] for k, v in cuda_stacked.LAUNCHES.items()
             if v != before[k]}
    assert delta == {"stacked_gru": 1, "stacked_gru_bwd": 1}
    assert cuda_stacked.LAST_TRAIN_PATH == "kernel"
    assert all(t.grad is not None for a in leaves
               for _, t in named_leaves(a)), "a gradient was lost"
    np.testing.assert_allclose(out[0], ref_out[0], rtol=0, atol=1e-6)
    for a, b in zip(grads, ref_grads):
        if isinstance(b, dict):
            _assert_trees(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():
        fn(*params_from_numpy(args))
    assert cuda_stacked.LAUNCHES["stacked_gru"] == before["stacked_gru"] + 2
    assert cuda_stacked.LAUNCHES["stacked_gru_bwd"] == before[
        "stacked_gru_bwd"] + 1
