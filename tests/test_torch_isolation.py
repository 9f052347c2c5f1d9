"""The PyTorch port stands alone: no module of `mspl_tpu_torch/`, nor
`chip_smoke.py`, imports JAX, flax or the JAX package (the port runs on
machines that have neither), and importing the port loads no JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mspl_tpu")
PORT_FILES = sorted((ROOT / "mspl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mspl_tpu_torch.pseudo.generate, "
            "mspl_tpu_torch.pseudo.cbst, mspl_tpu_torch.data.loader, "
            "mspl_tpu_torch.engine.train, mspl_tpu_torch.cli, "
            "mspl_tpu_torch.data.datasets, mspl_tpu_torch.utils.checkpoint, "
            "mspl_tpu_torch.utils.torch_import; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
