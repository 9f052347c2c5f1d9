"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level module name, and the reference imports nothing of the
port."""

import ast
import subprocess
import sys

import pytest

from h100_bench import common


def test_forbidden_names_are_whole_words():
    assert common.forbidden_in(["mspl_tpu_torch.ops", "mspl_tpu_torch",
                                "jaxtyping", "flaxen", "optaxx"]) == []
    assert common.forbidden_in(["mspl_tpu.ops", "jax.numpy", "jaxlib",
                                "flax.linen", "optax"]) == [
        "flax", "jax", "jaxlib", "mspl_tpu", "optax"]


@pytest.mark.parametrize("driver", ["sweep", "finetune"])
def test_a_run_loads_no_jax(driver):
    code = (
        "import sys; sys.path.insert(0, %r);"
        "import h100_bench.run, h100_bench.control, h100_bench.layers_read;"
        "import h100_bench.drivers.%s as d;"
        "import mspl_tpu_torch.pseudo.generate, mspl_tpu_torch.engine.train;"
        "import mspl_tpu_torch.models.factory, mspl_tpu_torch.ops._cuda;"
        "from h100_bench import common;"
        "print(common.forbidden_loaded())" % (str(common.ROOT), driver))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    paths = list((common.HERE / "reference").rglob("*.py"))
    assert (common.HERE / "reference" / "models" / "espnetv2.py") in paths
    for path in paths:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"mspl_tpu_torch", *common.FORBIDDEN}, path
