"""Nothing of the benchmark imports JAX, the JAX package or the repo's
older bench code, and the reference imports nothing of the port."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sift3d_tpu", "benches", "bench",
             "scripts", "chip_smoke"}


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _files():
    return sorted(HERE.rglob("*.py"))


def test_no_jax_and_no_old_bench_code():
    bad = {str(p.relative_to(HERE)): sorted(_imports(p) & FORBIDDEN)
           for p in _files() if _imports(p) & FORBIDDEN}
    assert not bad, bad


def test_whole_name_is_compared():
    # The port's name begins with the JAX package's: only the whole
    # top-level name counts.
    assert "sift3d_tpu_torch" not in FORBIDDEN
    assert "sift3d_tpu_torch".split(".")[0] != "sift3d_tpu"


def test_loaded_jax_is_found(monkeypatch):
    """The run's last look before its result line names JAX or the JAX
    package once loaded, compared by whole top-level names."""
    import sys
    import types

    from portbench import run
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sift3d_tpu_torch_x",
                        types.ModuleType("sift3d_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sift3d_tpu.api",
                        types.ModuleType("sift3d_tpu.api"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "sift3d_tpu"]


def test_reference_imports_nothing_of_the_port():
    ref = HERE / "reference"
    files = sorted(ref.glob("*.py"))
    assert files
    for p in files:
        assert "sift3d_tpu_torch" not in _imports(p), p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, (p, node.module)


def _code_strings(path: Path) -> list:
    """The string constants of a file that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_file_reads_the_old_bench_paths():
    for p in _files():
        if p.name == Path(__file__).name:
            continue
        for text in _code_strings(p):
            for old in ("benches", "bench.py", "scripts", "chip_smoke"):
                assert old not in text, (p, old)
