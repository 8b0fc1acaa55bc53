"""Import hygiene of the port: deeppowers_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and importing the port loads no JAX."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "deeppowers_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deeppowers_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import deeppowers_tpu_torch, sys\n"
            "import deeppowers_tpu_torch.runtime.engine\n"
            "import deeppowers_tpu_torch.serving.server\n"
            "import deeppowers_tpu_torch.models.convert\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeppowers_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
