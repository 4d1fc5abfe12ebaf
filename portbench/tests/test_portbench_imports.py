"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's ``repro_torch`` begins with ``repro``),
and nothing reads the JAX benchmarks' folder."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN, loaded_forbidden
from portbench.spec import ROOT

PKG = ROOT / "portbench"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = {(str(f.relative_to(ROOT)), top) for f in files
           for top in _imports(f) if top in FORBIDDEN}
    assert not bad, bad
    tops = {top for f in files for top in _imports(f)}
    assert "repro_torch" in tops              # the port, by its whole name


def test_nothing_reads_the_jax_benchmarks():
    for f in PKG.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value.strip("/")
                assert v != "benchmarks" and not v.startswith(
                    "benchmarks/"), (f, node.value)


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setattr(sys, "modules", {"repro_torch": 1,
                                         "repro_torch.serving": 1,
                                         "jaxtyping": 1, "numpy": 1})
    assert loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", {"repro.core": 1, "jax.numpy": 1})
    assert loaded_forbidden() == ["jax", "repro"]


def test_a_run_loads_no_jax():
    """A whole CPU run of a cell in a fresh interpreter leaves none of
    JAX, jaxlib, flax or ``repro`` in ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench.spec import load_cell\n"
        "from portbench.run import run_cell, loaded_forbidden\n"
        "run_cell(load_cell('qwen3-4b.chat_backlog'), 3, 0.5, False,\n"
        "         device='cpu', small=True, pool_tokens=4096,\n"
        "         log=lambda *a, **k: None)\n"
        "print('FOUND', loaded_forbidden())\n" % (str(ROOT / "src"),
                                                  str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout
