"""Nothing under reference/ imports the program, the JAX package or JAX,
and the harness's guard compares top-level module names whole."""

from __future__ import annotations

import ast
import subprocess
import sys

from harness.core import BENCH, FORBIDDEN_MODULES, forbidden_modules

PROGRAM = "pegasus_tpu_torch"


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_neither_program_nor_jax():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) > 30
    for f in files:
        bad = imported_top_names(f) & {PROGRAM, *FORBIDDEN_MODULES}
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for f in sorted(BENCH.rglob("*.py")):
        assert not imported_top_names(f) & set(FORBIDDEN_MODULES), f


def test_loading_the_reference_loads_no_program_module():
    code = ("import sys, importlib, pkgutil; sys.path[:0] = [%r]; import reference, reference.frozen as F; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages(F.__path__, 'reference.frozen.')]; "
            "import reference.generation, reference.training, reference.compare, reference.precision, "
            "harness.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {%r, 'pegasus_tpu', 'jax', 'jaxlib', 'flax'}))"
            % (str(BENCH), PROGRAM))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(BENCH))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "pegasus_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxish.sub", types.ModuleType("x"))
    before = forbidden_modules()
    assert "pegasus_tpu" not in before and "jax" not in before  # the port's own name is no match
    monkeypatch.setitem(sys.modules, "pegasus_tpu.ops", types.ModuleType("x"))
    assert "pegasus_tpu" in forbidden_modules()
