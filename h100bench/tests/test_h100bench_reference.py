"""The references against the port's plain CPU path at a small size: the
same weights, batch and noise give the same loss, gradients and steps, and
the served transfer the same log-probabilities."""
from pathlib import Path

import pytest
import torch

from h100bench import weights
from h100bench.reference import gmvae
from h100bench.reference.common import Arith, leaves
from h100bench.tests.small import small_cell
from h100bench.train_cell import PortTrainer, ReferenceTrainer

CPU = torch.device("cpu")


def _spec_shapes(spec):
    return {path: tuple(shape) for path, shape, _, _ in spec}


@pytest.mark.parametrize("name,init", [
    ("gmvae-train-b128", "init_reg_gmvae"), ("cvae-train-b128", "init_cvae")])
def test_parameter_layout_is_the_ports(tmp_path, name, init):
    from music_fader_nets_tpu_torch.config import load_config
    from music_fader_nets_tpu_torch.models import gmvae as port_gmvae, vae
    cell = small_cell(name, tmp_path)
    fn = getattr(port_gmvae if init == "init_reg_gmvae" else vae, init)
    tree = fn(torch.Generator().manual_seed(0), load_config(cell.config_path))
    port = {p: tuple(t.shape) for p, t in leaves(tree)}
    assert port == _spec_shapes(cell.reference.param_spec(cell.cfg))


@pytest.mark.parametrize("name", ["gmvae-train-b128", "cvae-train-b128"])
def test_training_steps_match_the_ports_plain_path(tmp_path, name):
    cell = small_cell(name, tmp_path)
    gen = torch.Generator().manual_seed(7)
    tree0 = weights.make_params(cell.reference.param_spec(cell.cfg), gen, CPU)
    pool = weights.train_pool(gen, cell.cfg, 8, 3, cell.cfg["noise_draws"],
                              CPU)
    port = PortTrainer(cell, tree0, CPU)
    ref = ReferenceTrainer(cell, tree0, CPU, Arith())
    for prog in (port, ref):
        prog.set_step(cell.traffic["start_step"])
    for k in range(3):
        a = float(port.step(*pool[k])["loss"].detach())
        b = float(ref.step(*pool[k])["loss"])
        assert a == pytest.approx(b, rel=1e-5)
        if k == 0:
            g_port = dict(leaves(port.first_grad()))
            for path, g in leaves(ref.first_grad()):
                tol = 1e-4 * float(g.abs().max()) + 1e-7
                assert float((g_port[path] - g).abs().max()) <= tol, path
    p_port = dict(leaves(port.params()))
    for path, t in leaves(ref.params()):
        assert float((p_port[path] - t).abs().max()) <= 1e-5, path
    assert port.path() == "plain-cpu"


def test_served_transfer_matches_the_ports_plain_path(tmp_path):
    from music_fader_nets_tpu_torch.models.gmvae import reg_gmvae_encode
    from music_fader_nets_tpu_torch.models.modules import \
        global_decoder_greedy
    from music_fader_nets_tpu_torch.models.vae import _global_view
    from music_fader_nets_tpu_torch.transfer.arousal import \
        compute_shift_vectors
    cell = small_cell("gmvae-serve-closed", tmp_path)
    cfg = cell.cfg
    gen = torch.Generator().manual_seed(11)
    tree = weights.make_params(gmvae.param_spec(cfg), gen, CPU)
    N, T, S = 6, cfg["seq_len"], cfg["transfer_decode_steps"]
    tokens = torch.randint(0, cfg["roll_dims"], (N, T), generator=gen)
    chroma = torch.rand((N, cfg["chroma_dims"]), generator=gen)
    sign = torch.tensor([1.0, -1.0, 0.0, 1.0, -1.0, 0.0])
    lam = torch.full((N,), 0.7)
    served = torch.randint(0, cfg["roll_dims"], (N, S), generator=gen)
    (mu_r, _), (mu_n, _) = reg_gmvae_encode(tree, tokens, device="cpu")
    shifts = compute_shift_vectors(tree)
    k = (sign * lam)[:, None]
    z = torch.cat([mu_r + k * torch.from_numpy(shifts["r_low_to_high"]),
                   mu_n + k * torch.from_numpy(shifts["n_low_to_high"]),
                   chroma], -1)
    with torch.no_grad():
        port = global_decoder_greedy(_global_view(tree), z, S, feed=served)
        ref = torch.stack([torch.log_softmax(x, -1) for x in
                           gmvae.served_logits(Arith(), tree, {
                               "tokens": tokens, "chroma": chroma,
                               "sign": sign, "lam": lam, "served": served},
                               cfg)], 1)
    assert float((port - ref).abs().max()) <= 1e-5


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0 + 2.0 ** -10])
    y = Arith(tf32=True).mm(x[None], torch.eye(3))[0]
    assert y.tolist() == [1.0 + 2.0 ** -10, 1.0, 3.0 + 2.0 ** -9]


def test_references_import_no_program_module():
    import ast
    for f in Path(gmvae.__file__).parent.glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "typing",
                                           "__future__", "h100bench"), (f, n)
                if n.startswith("h100bench"):
                    assert n.startswith("h100bench.reference"), (f, n)
