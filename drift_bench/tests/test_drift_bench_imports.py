"""The benchmark imports neither JAX nor the JAX package ``repro``, and its
plain reference imports nothing of the port, directly or through another
module of the benchmark."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names and ``drift_bench`` modules a file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


def _module_file(name: str):
    parts = name.split(".")
    if parts[0] != "drift_bench":
        return None
    base = BENCH.joinpath(*parts[1:])
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_never_reaches_the_port(path):
    seen, todo = set(), [path]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            assert name.split(".")[0] != "repro_torch", \
                f"{f} (reached from {path.name}) imports {name}"
            dep = _module_file(name)
            if dep is not None:
                todo.append(dep)


def test_forbidden_names_compare_whole():
    from drift_bench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro.core.fault", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
