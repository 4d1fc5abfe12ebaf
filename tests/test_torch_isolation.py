"""The PyTorch port stands alone: importing any of its modules loads
neither ``jax`` nor the JAX package ``repro``, and its examples import
neither; its copies of the pure-
Python control plane are the JAX package's sources with only the import
lines renamed; and the kernels' build directory is ignored by git."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
JAXPKG = REPO / "src" / "repro"

#: modules the port keeps word for word (ROADMAP A1-A4, A5a, A5b, A6, A7,
#: A8, A14)
COPIES = [
    "configs/base.py", "configs/tinyllama_1_1b.py", "configs/llama2_7b.py",
    "configs/llama3_8b.py", "configs/qwen3_4b.py", "configs/smollm_360m.py",
    "configs/starcoder2_3b.py", "configs/rwkv6_7b.py",
    "configs/qwen2_moe_a2_7b.py", "configs/qwen3_moe_30b_a3b.py",
    "configs/hymba_1_5b.py", "configs/paligemma_3b.py",
    "configs/musicgen_medium.py", "configs/__init__.py",
    "core/csp.py", "core/slo.py", "core/invariants.py", "core/stat_keys.py", "core/histogram.py",
    "core/request.py", "core/policies.py", "core/kvcache.py",
    "core/cost_model.py", "core/scheduler.py", "core/five_minute_rule.py",
    "data/workloads.py", "serving/swap_store.py", "serving/faults.py",
    "serving/txn.py",
    # A14: the analysis modules that need no word of their own
    "analysis/astutil.py", "analysis/charges.py",
]

_IMPORT = re.compile(r"^(\s*)(from|import) repro(\.|\s)", re.M)


def _renamed(src: str) -> str:
    return _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} repro_torch"
                                 f"{m.group(3)}", src)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    for m in ("serving.engine", "serving.serve_step",
              "kernels.flash_attention.ops", "training.train_step",
              "checkpoint.manager", "distributed.fault_tolerance",
              "data.synthetic", "launch.train", "kernels.rwkv_scan.ops",
              "models.rwkv", "distributed.collectives",
              "distributed.context", "distributed.sharding",
              "distributed.compression", "launch.mesh", "serving.spmd",
              "launch.dryrun", "launch.comm_analysis", "analysis",
              "analysis.__main__", "analysis.findings", "analysis.astutil",
              "analysis.runner", "analysis.program", "analysis.flow",
              "analysis.charges", "analysis.asserts", "analysis.txncov",
              "analysis.statmirror", "analysis.hostsync", "analysis.capture",
              "analysis.asyncdrain", "analysis.ranklocal",
              "analysis.artifact"):
        assert f"repro_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _imported_names(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_repro(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


#: the port's examples, beside the JAX package's four
EXAMPLES = ["torch_quickstart.py", "torch_serve_continuous_batching.py",
            "torch_train_multipod.py", "torch_whatif_analysis.py"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_import_only_torch_and_the_port(name):
    """Each example imports the port, never ``jax`` or ``repro``."""
    names = {n.split(".")[0] for n in
             _imported_names(REPO / "examples" / name)}
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}, names


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_is_the_jax_source(rel):
    assert (PORT / rel).read_text() == _renamed((JAXPKG / rel).read_text())


def test_simulator_is_the_jax_source_up_to_comments():
    """``core/simulator.py`` carries inline analyser allows (comments) at
    the shadow allocator's four ``pre_items`` mutations, which the JAX
    path has in the analyser's baseline instead; apart from comments it
    is the renamed JAX module: the same syntax tree."""
    rel = "core/simulator.py"
    port = (PORT / rel).read_text()
    jax_src = _renamed((JAXPKG / rel).read_text())
    assert port != jax_src                  # the allows are there
    assert ast.dump(ast.parse(port)) == ast.dump(ast.parse(jax_src))


@pytest.mark.parametrize("cls", ["BatchLog", "SimResult"])
def test_simulator_records_are_the_jax_classes(cls):
    def segment(path):
        tree = ast.parse(path.read_text())
        node = next(n for n in tree.body
                    if isinstance(n, ast.ClassDef) and n.name == cls)
        return ast.get_source_segment(path.read_text(), node)
    assert segment(PORT / "core" / "simulator.py") == \
        segment(JAXPKG / "core" / "simulator.py")


def test_kernel_build_directory_is_ignored_by_git():
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    lib = cuda_build._lib_path(pa.DECODE_SRC)
    assert lib.parent.name == "build"
    patterns = [ln.strip() for ln in
                (REPO / ".gitignore").read_text().splitlines()]
    assert "build/" in patterns


def test_kernel_sources_are_plain_c_interfaces():
    """Built with nvcc alone (seconds), never against PyTorch's headers
    (minutes per build); every kernels/*/csrc directory."""
    csrcs = sorted((PORT / "kernels").glob("*/csrc"))
    srcs = sorted(p for c in csrcs for p in c.glob("*.cu"))
    assert [str(p.relative_to(PORT / "kernels")) for p in srcs] == [
        "flash_attention/csrc/flash_attention.cu",
        "paged_attention/csrc/paged_decode.cu",
        "paged_attention/csrc/paged_prefill.cu",
        "rwkv_scan/csrc/wkv6.cu"]
    for p in srcs + sorted(p for c in csrcs for p in c.glob("*.cuh")):
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text, p
    for p in srcs:
        assert 'extern "C" int' in p.read_text(), p
