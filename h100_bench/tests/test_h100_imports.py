"""Nothing the benchmark runs loads JAX or the JAX package ``nkbx`` (top-level
names compared whole: the port ``nkbx_torch`` passes), and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from h100_bench.run import BANNED, banned_modules

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_benchmark_file_imports_jax_or_nkbx():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not (_imports(p) & BANNED), p


def test_the_reference_imports_nothing_of_the_program():
    for p in (HERE / "reference").glob("*.py"):
        tops = _imports(p)
        assert "nkbx_torch" not in tops, p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert node.module.startswith("h100_bench.reference") or \
                    not node.module.startswith("h100_bench"), (p, node.module)


def test_banned_names_compare_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "nkbx_torch_fake.sub", types.ModuleType("x"))
    assert banned_modules() == []
    monkeypatch.setitem(sys.modules, "nkbx.transforms", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert banned_modules() == ["jax", "nkbx"]


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_tiny_run_loads_neither_jax_nor_nkbx():
    code = ("import time; t0 = time.perf_counter()\n"
            "from h100_bench.tests.tiny import tiny_cell\n"
            "from h100_bench import run\n"
            "for w in ('convnext_t.train.b128', 'vit_b16.serve.crops'):\n"
            "    assert run.execute(tiny_cell(w), 5, 0.2, True, 'cpu', t0)['correct']\n"
            "print(run.banned_modules())")
    assert _run(code) == "[]"


def test_the_reference_alone_loads_no_program_module():
    code = ("import sys, h100_bench.reference.vit, h100_bench.reference.convnext, "
            "h100_bench.reference.train, h100_bench.reference.optim_nadam\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('nkbx_torch', 'nkbx', 'jax', 'flax')))")
    assert _run(code) == "[]"
