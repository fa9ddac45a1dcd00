"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package, and the reference imports nothing of the port: each imported
module's top-level name (the part before the first dot) compared
whole."""

import ast

import pytest

from smmc_bench.tests._tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "stock_market_monte_carlo_tpu"}
PORT = "stock_market_monte_carlo_torch"
SOURCES = sorted((REPO / "smmc_bench").rglob("*.py"))


def _tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert not _tops(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = [p for p in SOURCES if "reference" in p.parts]
    assert ref
    for path in ref:
        assert PORT not in _tops(path), path
    # the port's name begins with the JAX package's stem: compared whole
    assert "stock_market_monte_carlo" not in FORBIDDEN
