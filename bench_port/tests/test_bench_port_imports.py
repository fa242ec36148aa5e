"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole, so ``rspc_tpu_torch`` passes and ``rspc_tpu``
fails), and nothing reads the JAX package's benchmark files."""

import ast
import subprocess
import sys

import pytest

from _tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rspc_tpu"}
SOURCES = sorted(p for p in (ROOT / "bench_port").rglob("*.py") if "tests" not in p.parts)


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _strings(tree):
    """String constants outside docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_and_no_jax_benchmark_file(path):
    tree = ast.parse(path.read_text())
    tops = {m.split(".")[0] for m in _imports(tree)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    for s in _strings(tree):
        for name in ("benchmarks/", "bench.py", "chip_smoke"):
            assert name not in s, f"{path} names {name}"


def test_top_level_names_compared_whole():
    from bench_port.harness import forbidden_modules

    assert "rspc_tpu_torch" not in forbidden_modules()
    assert forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def test_the_run_loads_no_jax():
    """Every module a run imports, through the port too."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import harness, spec, control\n"
            "for c in spec.load()['configs']:\n"
            "    import json; cfg = json.load(open(%r + '/' + c['file']))\n"
            "    spec.entry(cfg); spec.reference(cfg)\n"
            "import rspc_tpu_torch.parallel, rspc_tpu_torch.registration.schemes\n"
            "print(harness.forbidden_modules())\n") % (str(ROOT), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
