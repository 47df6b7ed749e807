"""PyTorch port, its package surface: every name that a subpackage of the
JAX package re-exports in its `__init__.py` is an attribute of the port's
subpackage of the same name, so code written against the JAX package's
import paths (`from ...data import YamahaDataset`) finds the port's
counterpart. The JAX `__init__.py` files are read with `ast`, not imported
(no JAX import here)."""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "music_fader_nets_tpu"
SUBPACKAGES = ("ops", "models", "data", "eval", "train", "serve",
               "transfer", "utils", "tokenizer", "losses", "parallel")


def reexported(subpackage: str):
    """The names the JAX subpackage's `__init__.py` imports from its
    modules (`from music_fader_nets_tpu.x.y import a, b`)."""
    tree = ast.parse((JAX_PKG / subpackage / "__init__.py").read_text())
    return sorted(alias.asname or alias.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  and (node.module or "").startswith("music_fader_nets_tpu.")
                  for alias in node.names)


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_port_exports_the_jax_names(subpackage):
    names = reexported(subpackage)
    assert names, f"no re-exports parsed from {subpackage}/__init__.py"
    port = importlib.import_module(f"music_fader_nets_tpu_torch.{subpackage}")
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == []


def test_parser_reads_the_reexports():
    assert "gru_scan" in reexported("ops")
    assert "YamahaDataset" in reexported("data")
    assert "TrainState" in reexported("train")


def test_exports_build_nothing():
    """Importing every subpackage with its re-exports compiles nothing:
    neither the CUDA kernels nor the native tokenizer."""
    code = (
        "import importlib\n"
        f"for s in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('music_fader_nets_tpu_torch.' + s)\n"
        "from music_fader_nets_tpu_torch import native\n"
        "from music_fader_nets_tpu_torch.ops import _build\n"
        "assert _build._lib is None and native._module is None\n"
        "assert native.PATH is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
