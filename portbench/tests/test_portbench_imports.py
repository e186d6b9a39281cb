"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Module names are compared by their
first dotted part as a whole: the port's name begins with the JAX
package's."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN, PKG, ROOT

SOURCES = sorted(PKG.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "pnpflow_tpu_torch" not in top_level_imports(path)


def test_the_names_are_compared_whole():
    assert "pnpflow_tpu_torch" not in FORBIDDEN
    assert top_level_imports(PKG / "drivers" / "pnp_restore.py") >= {
        "portbench", "torch"}


CHILD = """
import json, sys, torch
torch.set_num_threads(2)
from portbench.harness import execute, forbidden_modules
from portbench.tests.conftest import tiny_run
out = execute(tiny_run("restore-unet128-deblur", seconds=1.5))
print(json.dumps({"correct": out["correct"],
                  "found": forbidden_modules(),
                  "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["found"] == []
    assert "pnpflow_tpu_torch" in out["loaded"]
