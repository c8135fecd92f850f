"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Names are compared by their whole
top-level part: ``nafp_tpu_torch`` begins with ``nafp_tpu`` and is not it."""
import ast
import os

import pytest

from portbench import registry, run

FORBIDDEN = {"jax", "jaxlib", "flax", "nafp_tpu"}


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


def _sources(sub=""):
    top = os.path.join(registry.HERE, sub)
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, registry.HERE))
def test_no_jax_and_no_jax_package(path):
    assert not set(_modules(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, registry.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "nafp_tpu_torch" not in set(_modules(path))


def test_whole_name_comparison():
    assert set(run.FORBIDDEN) == FORBIDDEN
    assert run.forbidden_modules(["nafp_tpu_torch", "nafp_tpu_torch.search",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["nafp_tpu.models", "jax", "torch"]) == [
        "jax", "nafp_tpu"]
