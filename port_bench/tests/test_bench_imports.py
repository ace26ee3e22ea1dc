"""No run loads JAX or the JAX package, compared by whole top-level names,
and the reference imports nothing of the program."""
import ast
import pathlib

from port_bench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "numpy", "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.core"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_harness_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "math", "torch"}, (path, tops)
