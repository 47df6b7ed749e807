"""PyTorch port, boundaries: the port imports nothing of JAX or of the JAX
package, sets TF32 off, runs its entry points on CUDA unless the CPU is
asked for, and builds its kernels only when a kernel is first launched."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import music_fader_nets_tpu_torch as port
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.models.gmvae import (
    init_reg_gmvae, reg_gmvae_encode,
)
from music_fader_nets_tpu_torch.models.vae import _global_view
from music_fader_nets_tpu_torch.ops import _build, cuda_decode
from music_fader_nets_tpu_torch.serve import cli
from music_fader_nets_tpu_torch.serve.server import TransferServer

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "music_fader_nets_tpu_torch"
TINY = ModelConfig(hidden_dims=16, z_dims=4, seq_len=6)


def test_imports_without_jax_or_reference_package():
    """Every module of the port, and chip_smoke.py, import with `jax` and
    `music_fader_nets_tpu` made unimportable."""
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['music_fader_nets_tpu'] = None\n"
        "import music_fader_nets_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, "
        "'music_fader_nets_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert importlib.import_module("
        "'music_fader_nets_tpu_torch.ops._build')._lib is None\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) >= 15


def test_no_reference_imports_in_sources():
    """Static scan: no import statement of the port or chip_smoke.py names
    jax or the JAX package (the `_torch` suffix is the port itself)."""
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:jax\b|music_fader_nets_tpu(?!_torch))",
        re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    hits = [(f.name, m.group(0).strip()) for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []
    # the scan itself finds a real reference import
    assert pat.search("from music_fader_nets_tpu.ops import gru\n")
    assert not pat.search("from music_fader_nets_tpu_torch.ops import gru\n")


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = init_reg_gmvae(torch.Generator().manual_seed(0), TINY)
    z = torch.zeros((1, 2 * TINY.z_dims + TINY.chroma_dims))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferServer(params, TINY, steps=3, max_batch=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_decode.greedy_decode_tokens(_global_view(params), z, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_decode.sample_decode_tokens(_global_view(params), z, 3, [1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg_gmvae_encode(params, torch.zeros((1, 6), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_server(["--random-init", "--bench", "1"])
    # the CPU, asked for explicitly, works
    assert port.resolve_device("cpu").type == "cpu"
    toks = cuda_decode.greedy_decode_tokens(_global_view(params), z, 3,
                                            device="cpu")
    assert toks.shape == (1, 3)


def test_kernel_build_is_lazy_and_loud(monkeypatch, tmp_path):
    """A build without nvcc raises instead of degrading to the plain path;
    the cache key follows the sources. (That importing builds nothing is
    checked in the fresh interpreter above.)"""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._build(tmp_path / "out")
    srcs, hdrs = _build._sources()
    assert {p.name for p in srcs} == {
        "embed_gru.cu", "decode.cu", "embed_gru_bwd.cu", "decoder_ce.cu",
        "decoder_ce_bwd.cu", "grad_reduce.cu", "stacked_gru.cu"}
    assert {p.name for p in hdrs} == {"gru_tile.cuh", "train_ops.cuh"}
    assert len(_build._digest()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS


def test_decode_wrappers_refuse_non_cpu_tensors():
    params = init_reg_gmvae(torch.Generator().manual_seed(0), TINY)
    gview = {k: {n: t.to("meta") for n, t in v.items()}
             for k, v in _global_view(params).items()}
    z = torch.zeros((1, 2 * TINY.z_dims + TINY.chroma_dims), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_decode.cuda_greedy_decode(gview, z, 3)
    with pytest.raises(ValueError, match="decoder weights"):
        cuda_decode.cuda_greedy_decode(_global_view(params), z, 3)
