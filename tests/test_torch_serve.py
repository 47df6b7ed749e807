"""PyTorch port, the serving slice as a whole: the port's TransferServer on
the CPU (plain versions of every kernel) against the JAX package's
TransferServer (XLA scan path) with the same params and requests, plus the
port's own serving behaviour and CLI protocol.

Tokens must be identical (the decoder head is sharpened 4x so float32
reduction-order noise between XLA and PyTorch cannot flip a near-tie
argmax); z agrees to 5e-5, the bound tests/test_serve.py uses for z."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from music_fader_nets_tpu.config import ModelConfig as JConfig
from music_fader_nets_tpu.models.gmvae import init_reg_gmvae as j_init
from music_fader_nets_tpu.serve import TransferServer as JServer
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.vae import init_reg_vae
from music_fader_nets_tpu_torch.serve.server import TransferServer
from music_fader_nets_tpu_torch.utils.checkpoint import params_from_numpy

SMALL = dict(hidden_dims=32, z_dims=8, seq_len=12)
CFG = ModelConfig(**SMALL)
STEPS = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def np_params():
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3),
                                        JConfig(**SMALL)))
    p["linear_out_g"]["w"] = p["linear_out_g"]["w"] * 4.0
    return p


@pytest.fixture(scope="module")
def server(np_params):
    with TransferServer(params_from_numpy(np_params), CFG, steps=STEPS,
                        max_batch=4, max_wait_ms=200.0,
                        device="cpu") as srv:
        yield srv


def _req(i, rng, direction="low_to_high", **kw):
    tokens = rng.integers(2, CFG.roll_dims, size=CFG.seq_len).tolist()
    return {"id": i, "tokens": tokens, "direction": direction,
            "lam": 0.7, "return_z": True, **kw}


def _mixed(seed):
    rng = np.random.default_rng(seed)
    return [_req(0, rng, direction="none"),
            _req(1, rng),
            _req(2, rng, direction="high_to_low", lam=1.3),
            _req(3, rng, seed=1234),
            _req(4, rng, direction="none", seed=5, steps=9)]


def test_port_server_matches_jax_server(server, np_params):
    """Greedy, shifted and seeded-z rows: same tokens, z within 5e-5."""
    reqs = _mixed(0)
    with JServer(jax.tree.map(jax.numpy.asarray, np_params),
                 JConfig(**SMALL), steps=STEPS, max_batch=4,
                 max_wait_ms=200.0, use_pallas=False) as jsrv:
        want = [f.result(timeout=300)
                for f in [jsrv.submit(dict(r)) for r in reqs]]
    got = [f.result(timeout=300) for f in [server.submit(dict(r))
                                           for r in reqs]]
    for r, g, w in zip(reqs, got, want):
        assert "error" not in g and "error" not in w, (g, w)
        assert g["tokens"] == w["tokens"], r["id"]
        assert len(g["tokens"]) == r.get("steps", STEPS)
        np.testing.assert_allclose(np.asarray(g["z"]), np.asarray(w["z"]),
                                   rtol=0, atol=5e-5)
    st = server.stats()
    assert st["serving_path"] == "plain-cpu"
    assert st["batches"] >= 1 and st["requests"] >= len(reqs)


def test_batched_rows_equal_single_rows(server):
    """Padding rows and batch position do not leak into results."""
    reqs = _mixed(1)[:3]
    together = [f.result(timeout=300)
                for f in [server.submit(dict(r)) for r in reqs]]
    alone = [server.request(dict(r)) for r in reqs]
    assert any(t["batch_rows"] > 1 for t in together)
    for t, a in zip(together, alone):
        assert t["tokens"] == a["tokens"] and t["z"] == a["z"]


def test_sampled_rows(server):
    """A greedy row in a mixed batch decodes as the all-greedy program
    does; sampled rows repeat per seed, vary without one, stay in-vocab."""
    rng = np.random.default_rng(5)
    greedy = _req(0, rng)
    sampled = _req(1, np.random.default_rng(6), temperature=0.9, seed=77)
    base = server.request(dict(greedy))
    for _attempt in range(5):
        futs = [server.submit(dict(greedy)), server.submit(dict(sampled))]
        got_g, got_s = [f.result(timeout=300) for f in futs]
        if got_g["batch_rows"] == 2:
            break
    assert got_g["batch_rows"] == 2, "requests never coalesced"
    assert got_g["tokens"] == base["tokens"]
    assert server.request(dict(sampled))["tokens"] == got_s["tokens"]
    free = {**sampled, "seed": None}
    assert (server.request(dict(free))["tokens"]
            != server.request(dict(free))["tokens"])
    toks = np.asarray(got_s["tokens"])
    assert toks.min() >= 0 and toks.max() < CFG.roll_dims


def test_validation_errors(server):
    """The rejections of tests/test_serve.py, request for request."""
    before = server.stats()["rejected"]
    bad = ({"tokens": []},
           {"tokens": [1, 2], "direction": "sideways"},
           {"tokens": [1, 2], "steps": STEPS + 1},
           {"tokens": [1, 2], "steps": 0},
           {"tokens": [999999]},
           {"tokens": [2 ** 40]},
           {"tokens": [1] * (CFG.seq_len + 1)},
           {"tokens": [1, 2], "chroma": [0.0] * 3},
           {"tokens": [1, 2], "temperature": -0.5},
           {"tokens": [1, 2], "temperature": float("nan")},
           {"tokens": [1, 2], "temperature": float("inf")},
           {"tokens": [1, 2], "temperature": 1e300},
           {"tokens": [1, 2], "temperature": 1e-30},
           {"tokens": [1, 2], "seed": -7},
           [1, 2, 3],
           "nonsense")
    for b in bad:
        assert "error" in server.request(b), b
    assert server.stats()["rejected"] == before + len(bad)
    ok = server.request({"tokens": [1, 2], "steps": 5})
    assert "error" not in ok and len(ok["tokens"]) == 5


def test_reconstruct_only_and_closed():
    import torch
    params = init_reg_vae(torch.Generator().manual_seed(5), CFG)
    with TransferServer(params, CFG, steps=STEPS, max_batch=2,
                        max_wait_ms=1.0, device="cpu") as srv:
        rng = np.random.default_rng(3)
        ok = srv.request(_req(0, rng, direction="none"))
        assert "error" not in ok and len(ok["tokens"]) == STEPS
        bad = srv.request(_req(1, rng, direction="low_to_high"))
        assert "mixture tables" in bad["error"]
    assert srv.request({"tokens": [1, 2]})["error"] == "server closed"


def test_cli_stdin_protocol(tmp_path):
    """`python -m music_fader_nets_tpu_torch.serve.cli --device cpu
    --random-init`: pipelined requests, ordered responses, error lines for
    bad input, the stats op."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps({**SMALL, "num_clusters": 2}))
    rng = np.random.default_rng(4)
    lines = [json.dumps(_req(i, rng, return_z=False)) for i in range(3)]
    lines += ["42", "{not json", json.dumps({"op": "stats"})]
    out = subprocess.run(
        [sys.executable, "-m", "music_fader_nets_tpu_torch.serve.cli",
         "--device", "cpu", "--random-init", "--config", str(cfg_path),
         "--steps", str(STEPS), "--max-batch", "4", "--max-wait-ms", "50"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    resps = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert len(resps) == 6
    for i, r in enumerate(resps[:3]):
        assert r["id"] == i and "error" not in r
        assert len(r["tokens"]) == STEPS
    assert "error" in resps[3] and "error" in resps[4]
    assert resps[5]["requests"] == 3
    assert resps[5]["serving_path"] == "plain-cpu"
