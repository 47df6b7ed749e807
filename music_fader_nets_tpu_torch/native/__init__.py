"""The port's native tokenizer: `fadertok.cc`, a C++ CPython extension
(the port's copy of the JAX package's `native/fadertok.cc`).

It is built at the first call that dispatches to it, never at import:
`g++ -O3 -std=c++17 -fPIC -shared` against the Python and numpy headers,
into `build/torch_native/<hash>/` at the repository root, the hash over
the source, the compiler command (headers included), the numpy version,
the platform (C library) and the extension suffix, so a build made for
another interpreter or machine is never loaded. It is built in a
temporary directory and renamed into place, so concurrent processes
(test workers) take one finished build. It is loaded under the port's
own module name, never from the JAX package's build.

`tokenizer/event_codec.py` and `tokenizer/performance_codec.py` dispatch
to it at the JAX package's three sites through `select`; `PATH` records
which path served the last call. `FADERNETS_NO_NATIVE=1` at import selects
the pure-Python paths, as in the JAX package (`HAVE_NATIVE` is then
False). A failed build raises with the compiler's output; it does not fall
back. Both paths give the same bits (tests/test_torch_tokenizer_compat.py).
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import platform
import shutil
import subprocess
import sysconfig
import tempfile
import threading
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "fadertok.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
MODULE = "music_fader_nets_tpu_torch.native.fadertok"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

HAVE_NATIVE = os.environ.get("FADERNETS_NO_NATIVE") != "1"
PATH = None                # "native" or "python": what served the last call
BUILD_SECONDS = None       # wall time of the build this process ran, if any

_lock = threading.Lock()
_module = None


def _file_name() -> str:
    return "fadertok" + sysconfig.get_config_var("EXT_SUFFIX")


def _command(out) -> list:
    import numpy
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native tokenizer needs it "
                           "(FADERNETS_NO_NATIVE=1 selects the pure-Python "
                           "path)")
    return [cxx, *FLAGS, f"-I{sysconfig.get_paths()['include']}",
            f"-I{numpy.get_include()}", str(SOURCE), "-o", str(out)]


def build_dir() -> Path:
    import numpy
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(_command("OUT")).encode())
    h.update(numpy.__version__.encode())
    h.update(platform.platform().encode())
    h.update(_file_name().encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(final: Path) -> None:
    """Compile into a temporary directory beside `final`, then rename it
    into place; when another process got there first, keep its build."""
    global BUILD_SECONDS
    t0 = time.monotonic()
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=final.parent, prefix=".tmp-"))
    try:
        out = subprocess.run(_command(tmp / _file_name()),
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n"
                               f"{out.stdout}{out.stderr}")
        try:
            os.rename(tmp, final)
        except OSError:
            if not (final / _file_name()).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.monotonic() - t0


def fadertok():
    """The loaded native module, built first if this checkout's source has
    not been built for this interpreter yet."""
    global _module
    with _lock:
        if _module is None:
            final = build_dir()
            path = final / _file_name()
            if not path.exists():
                _build(final)
            loader = importlib.machinery.ExtensionFileLoader(MODULE,
                                                             str(path))
            mod = importlib.util.module_from_spec(
                importlib.util.spec_from_loader(MODULE, loader))
            loader.exec_module(mod)
            _module = mod
        return _module


def select(applies: bool = True):
    """The native module for this call, or None for the pure-Python path
    (switched off, or the call is one the native code does not take, such
    as an empty input); records which in `PATH`."""
    global PATH
    mod = fadertok() if HAVE_NATIVE and applies else None
    PATH = "python" if mod is None else "native"
    return mod
