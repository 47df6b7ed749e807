"""Nothing the benchmark runs is JAX, one of its libraries or the JAX
package, compared by whole top-level module names (the port's name begins
with the JAX package's), and the references reach nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench.harness import FORBIDDEN, HERE
from h100bench.tests.small import ROOT

PORT = "music_fader_nets_tpu_torch"


def _imports(path: Path):
    """The absolute module names a source file imports."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
            out += [f"{node.module}.{a.name}" for a in node.names]
    return out


def _walk(start: Path):
    """Every module name reachable from `start` through h100bench's own
    modules, and the modules found by name (readers, references)."""
    seen, todo, names = set(), [start], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for mod in _imports(f):
            names.add(mod)
            if mod.split(".")[0] == "h100bench":
                p = ROOT.joinpath(*mod.split("."))
                for cand in (p.with_suffix(".py"), p / "__init__.py"):
                    if cand.is_file():
                        todo.append(cand)
        if f.name == "harness.py":
            todo += sorted((HERE / "metrics").glob("*.py"))
            todo += sorted((HERE / "reference").glob("*.py"))
    return names, seen


def test_the_run_imports_no_jax_by_name():
    names, files = _walk(HERE / "run.py")
    assert HERE / "serve_cell.py" in files
    tops = {n.split(".")[0] for n in names}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    assert PORT not in FORBIDDEN and PORT.startswith(FORBIDDEN[-1])


def test_the_references_reach_nothing_of_the_port():
    for f in sorted((HERE / "reference").glob("*.py")):
        names, _ = _walk(f)
        tops = {n.split(".")[0] for n in names}
        assert not tops & (set(FORBIDDEN) | {PORT}), (f, tops)


_PROBE = """
import sys, tempfile
from pathlib import Path
sys.path.insert(0, {root!r})
{body}
bad = sorted(m for m in sys.modules if m.split('.')[0] in {names!r})
print('FOUND', bad)
"""


def _probe(body: str, names) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT), body=body,
                                             names=tuple(names))],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_loading_the_references_loads_no_program_module():
    body = "import h100bench.reference.gmvae, h100bench.reference.cvae"
    assert _probe(body, FORBIDDEN + (PORT,)) == "FOUND []"


@pytest.mark.parametrize("cell", ["gmvae-train-b128", "gmvae-serve-closed"])
def test_a_run_loads_no_jax_module(cell):
    """Drives a whole run at a small size on the CPU in a fresh process,
    then looks at what it loaded."""
    body = (
        "import time, torch\n"
        "from h100bench import harness\n"
        "from h100bench.tests.small import small_cell\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        f"    c = small_cell({cell!r}, Path(d))\n"
        "    r, _ = harness.run(c, 5, 0.5, True, torch.device('cpu'),"
        " time.perf_counter())\n"
        "    assert r['correct'], r\n")
    assert _probe(body, FORBIDDEN) == "FOUND []"
