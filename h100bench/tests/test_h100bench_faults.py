"""`correct` comes out false when the timed path is broken underneath: a
whole run at a small size on the CPU (the look for a card skipped), with
a planted fault in the port's place, once for each fault the cell can
have, and with the control (the reference in TF32) in the port's place."""
import time

import pytest
import torch

from h100bench import faults, harness
from h100bench.reference.common import Arith
from h100bench.tests.small import small_cell
from h100bench.train_cell import ReferenceTrainer

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345          # more than 32 signed bits hold


def _run(tmp_path, name, make_program=None, trace=False):
    cell = small_cell(name, tmp_path)
    result, lines = harness.run(cell, SEED, 0.5, trace, CPU,
                                time.perf_counter(), make_program)
    assert lines[-1].startswith("check failed")
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("name", ["gmvae-train-b128", "cvae-train-b128",
                                  "gmvae-serve-closed"])
def test_an_unbroken_run_is_correct(tmp_path, name):
    assert _run(tmp_path, name)["correct"]


@pytest.mark.parametrize("name", ["gmvae-train-b128", "cvae-train-b128"])
@pytest.mark.parametrize("fault", [faults.Unchanged, faults.HalfBatch])
def test_a_training_fault_is_not_correct(tmp_path, name, fault):
    assert not _run(tmp_path, name, fault)["correct"]


@pytest.mark.parametrize("fault", [faults.AlteredToken, faults.HalfRows])
def test_a_serving_fault_is_not_correct(tmp_path, fault):
    assert not _run(tmp_path, "gmvae-serve-closed", fault)["correct"]


@pytest.mark.parametrize("name", ["gmvae-train-b128", "cvae-train-b128"])
def test_the_tf32_control_is_not_correct(tmp_path, name):
    """The control at a size a test can hold; on the CPU TF32 is emulated
    by rounding every matmul operand to its 10-bit mantissa."""
    def control(cell, tree0, device):
        return ReferenceTrainer(cell, tree0, device, Arith(tf32=True))

    result = _run(tmp_path, name, control)
    assert not result["correct"]
    bad = [k for k, v in result["checks"].items()
           if k not in ("path", "failed") and v["value"] > v["limit"]]
    assert bad, result["checks"]


def test_the_tf32_serving_control_reads_over_the_limit(tmp_path):
    """The serving control at a size a test can hold (512 requests x 64
    greedy tokens at H=64): the port's plain path serves the float32
    reference's own tokens, and at their positions the token that TF32
    (emulated) puts first lies below the reference's best by more than
    the limit."""
    from h100bench import compare, weights
    from h100bench.calibrate import serve_control
    from music_fader_nets_tpu_torch.models.gmvae import \
        reg_gmvae_decode_tokens
    N, S = 512, 64
    cell = small_cell("gmvae-serve-closed", tmp_path, hidden_dim=64,
                      z_dim=32, transfer_decode_steps=S)
    cell.traffic["check_block"] = N
    cfg, ref = cell.cfg, cell.reference
    gen = torch.Generator().manual_seed(SEED)
    tree = weights.make_params(ref.param_spec(cfg), gen, CPU)
    req = {"tokens": torch.randint(0, cfg["roll_dims"], (N, cfg["seq_len"]),
                                   generator=gen),
           "chroma": torch.rand((N, cfg["chroma_dims"]), generator=gen),
           "sign": torch.tensor([1.0, -1.0, 0.0, 1.0] * (N // 4)),
           "lam": torch.ones(N)}
    with torch.no_grad():
        z = ref.served_latent(Arith(), tree, req["tokens"], req["chroma"],
                              req["sign"], req["lam"], cfg)
        req["served"] = reg_gmvae_decode_tokens(tree, z, S, "cpu").long()
        program = compare.serve_gap(ref.served_logits(Arith(), tree, req,
                                                      cfg), req["served"])
    limit = cell.limits["logit_gap"]
    assert program <= limit
    assert serve_control(cell)(tree, req)["control_tf32"] > limit


def test_an_open_loop_mix_runs_from_data_alone(tmp_path):
    """A later cell with Poisson arrivals in bursts needs only a traffic
    file: `serve_cell` reads `arrival` {"kind": "poisson", "rate", "burst"}
    and times each request from when it was due."""
    cell = small_cell("gmvae-serve-closed", tmp_path)
    cell.traffic["arrival"] = {"kind": "poisson", "rate": 150.0, "burst": 2}
    result, _ = harness.run(cell, SEED, 1.0, True, CPU, time.perf_counter())
    assert result["correct"] and result["attempted"] > 50
    assert result["metrics"]["serve_p95_ms"]["value"] > 0
